"""Lease-based leader election for controller replicas.

Reference: controller/tasks/etcd/leader_elector.go:105 — campaign on an
etcd election key, resign on shutdown, observe leadership changes. The
coordination substrate is abstracted behind cluster.kvstore.KVStore
(get/put/delete/cas — an etcd client is one adapter); the default backend
is the controllers' SHARED STATE DIRECTORY (FileKVStore: they already
share `root_path` for snapshots, standing in for the etcd keyspace; see
the NFS caveat in cluster/kvstore.py).

Protocol (pure CAS, substrate-independent):
- the lease key holds JSON {name, address, epoch, expires}.
- the holder renews (CAS the current raw value -> fresh expiry) every
  ttl/3; a CAS failure means someone changed the lease — step down.
- a candidate acquires by CAS'ing the absent/expired raw value to a new
  lease with epoch+1 — the monotonically increasing epoch is the fencing
  token: an old leader that wakes from a pause sees a lease it no longer
  owns (name/epoch mismatch) and steps down.

Unlike the JAX package's copy, a leader serves only while its lease is
unexpired by its own clock (`is_leader`: the last successful acquire or
renew plus ttl, on time.monotonic()), so a leader that wakes from a pause
refuses requests before its elector's next tick; and `fenced` runs a
write only while the lease still names this elector and epoch, checked
under the KV store's lock, so that a request paused between the check
and its write cannot overwrite a successor's state (NotLeader).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Optional

from aresdb_tpu_torch.cluster.kvstore import FileKVStore, KVStore

log = logging.getLogger("aresdb.election")

LEASE_KEY = "leader.lease"


class NotLeader(RuntimeError):
    """A write refused: the lease no longer names this elector and epoch."""


class LeaderElector:
    def __init__(self, root_path: Optional[str] = None, name: str = "",
                 address: str = "", ttl: float = 3.0,
                 on_elected: Optional[Callable[[], None]] = None,
                 on_revoked: Optional[Callable[[], None]] = None,
                 kv: Optional[KVStore] = None):
        if kv is None:
            if root_path is None:
                raise ValueError("LeaderElector needs root_path or kv")
            kv = FileKVStore(root_path, lock_ttl=ttl)
        self.kv = kv
        self.root_path = root_path
        self.name = name
        self.address = address
        self.ttl = ttl
        self.on_elected = on_elected
        self.on_revoked = on_revoked
        self._is_leader = False
        self._epoch = -1
        self._valid_until = 0.0   # time.monotonic() the lease held lapses at
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- public --

    @property
    def is_leader(self) -> bool:
        """Elected, and the lease unexpired by this elector's own clock."""
        return self._is_leader and time.monotonic() < self._valid_until

    @property
    def epoch(self) -> int:
        return self._epoch

    def current_leader(self) -> Optional[dict]:
        """The current UNEXPIRED lease, or None."""
        lease = self._read_lease()[1]
        if lease and lease["expires"] > time.time():
            return lease
        return None

    def fenced(self, write: Callable[[], None]) -> None:
        """write() while the lease names this elector and its epoch, under
        the KV store's lock of the lease, so that no candidate takes the
        lease between the check and the write. Raises NotLeader where the
        lease names another elector or epoch, or its lock stays busy."""
        try:
            with self.kv.locked(LEASE_KEY, timeout=self.ttl):
                lease = self._read_lease()[1]
                if not lease or lease.get("name") != self.name or \
                        lease.get("epoch") != self._epoch:
                    raise NotLeader(f"the lease is {lease}, not "
                                    f"{self.name}'s of epoch {self._epoch}")
                write()
        except TimeoutError as e:
            raise NotLeader(str(e)) from e

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"elector-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        """Resign: drop the lease if held so a peer takes over immediately
        (reference elector resigns on Close rather than letting the lease
        time out)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.ttl * 2)
            self._thread = None
        if self._is_leader:
            raw, lease = self._read_lease()
            if lease and lease.get("name") == self.name and \
                    lease.get("epoch") == self._epoch:
                # expire in place (keeps the epoch for fencing continuity)
                self.kv.cas(LEASE_KEY, raw,
                            json.dumps({**lease, "expires": 0.0}))
            self._set_leader(False)

    # -- internals --

    def _read_lease(self):
        raw = self.kv.get(LEASE_KEY)
        if raw is None:
            return None, None
        try:
            return raw, json.loads(raw)
        except ValueError:
            return raw, None

    def _lease_json(self, epoch: int) -> str:
        return json.dumps({"name": self.name, "address": self.address,
                           "epoch": epoch,
                           "expires": time.time() + self.ttl})

    def _try_acquire(self) -> bool:
        raw, lease = self._read_lease()
        if lease and lease["expires"] > time.time():
            return False
        epoch = (lease["epoch"] + 1) if lease else 0
        t0 = time.monotonic()
        if not self.kv.cas(LEASE_KEY, raw, self._lease_json(epoch)):
            return False
        self._epoch = epoch
        self._valid_until = t0 + self.ttl
        return True

    def _set_leader(self, val: bool) -> None:
        """On election on_elected runs before the first request is served
        (the promoted state is loaded), on_revoked after the last."""
        if val == self._is_leader:
            return
        if val:
            self._callback(self.on_elected)
        self._is_leader = val
        log.info("controller %s %s leadership (epoch %d)", self.name,
                 "gained" if val else "lost", self._epoch)
        if not val:
            self._callback(self.on_revoked)

    @staticmethod
    def _callback(cb) -> None:
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — callback must not kill loop
                log.exception("election callback failed")

    def _renew(self) -> None:
        """Renew via CAS on the exact raw value, re-verifying ownership AND
        expiry: a leader that paused past its ttl must NOT blind-renew — a
        candidate may be about to CAS epoch+1, and an unserialized
        overwrite would leave two leaders accepting mutations. A failed
        CAS means the lease changed under us; the ownership pre-check
        fences us next tick."""
        raw, lease = self._read_lease()
        if (lease and lease.get("name") == self.name
                and lease.get("epoch") == self._epoch
                and lease.get("expires", 0) > time.time()):
            t0 = time.monotonic()
            if self.kv.cas(LEASE_KEY, raw, self._lease_json(self._epoch)):
                self._valid_until = t0 + self.ttl
        else:
            self._set_leader(False)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._is_leader:
                _, lease = self._read_lease()
                if lease is None or lease.get("name") != self.name or \
                        lease.get("epoch") != self._epoch or \
                        lease.get("expires", 0) <= time.time():
                    # fenced out (paused past expiry, peer took over)
                    self._set_leader(False)
                else:
                    self._renew()
                self._stop.wait(self.ttl / 3)
            else:
                if self._try_acquire():
                    self._set_leader(True)
                    self._stop.wait(self.ttl / 3)
                else:
                    self._stop.wait(self.ttl / 2)
