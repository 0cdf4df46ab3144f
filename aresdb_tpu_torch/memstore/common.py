"""Shared memstore primitives: RecordID, batch id conventions.

Reference: memstore/common/primary_key.go:36 (RecordID),
memstore/live_store.go:30 (BaseBatchID), memstore/archive_store.go
(archive batch id = days since epoch).
"""

from __future__ import annotations

from typing import NamedTuple

# Live batch ids count up from the most negative int32, so that all live
# batch ids are strictly smaller than any archive batch id (days since epoch).
BASE_BATCH_ID = -(2**31)

SECONDS_PER_DAY = 86400


class RecordID(NamedTuple):
    batch_id: int
    index: int


def archive_batch_id_for_time(event_time: int) -> int:
    """Archive batch id for an event timestamp: UTC days since epoch."""
    return int(event_time) // SECONDS_PER_DAY


def archive_batch_time_range(batch_id: int) -> tuple[int, int]:
    return batch_id * SECONDS_PER_DAY, (batch_id + 1) * SECONDS_PER_DAY


class BootstrapToken:
    """Per-(table, shard) exclusion between data jobs and peer copies.

    Reference: memstore/common/types.go:23 BootStrapToken (implemented by
    the bootstrap server, datanode/bootstrap/bootstrap_server.go:88) —
    archiving/backfill/snapshot/purge must not run while a peer is
    streaming the shard's files, and vice versa.
    """

    def __init__(self):
        import threading

        self._locks = {}
        self._guard = threading.Lock()

    def _lock(self, table: str, shard: int):
        with self._guard:
            # plain Lock, NOT RLock: a peer-copy session acquires in one
            # HTTP handler thread and releases in another (close/keep-alive
            # expiry), which RLock's owner check would forbid
            return self._locks.setdefault((table, shard),
                                          __import__("threading").Lock())

    def acquire(self, table: str, shard: int, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not blocking:
            return self._lock(table, shard).acquire(blocking=False)
        return self._lock(table, shard).acquire(timeout=timeout)

    def release(self, table: str, shard: int) -> None:
        self._lock(table, shard).release()


GLOBAL_BOOTSTRAP_TOKEN = BootstrapToken()


class BootstrapSessionManager:
    """Peer-copy sessions that hold a shard's bootstrap token for the whole
    copy, renewed by client keep-alives.

    Reference: datanode/bootstrap/bootstrap_server.go:76-463 — sessions are
    created per (table, shard), hold the BootStrapToken so archiving/
    backfill/snapshot/purge cannot swap or delete files mid-copy, and are
    reaped when the client stops sending keep-alives.
    """

    def __init__(self, token: BootstrapToken = None, ttl: float = 30.0):
        import threading

        self.token = token or GLOBAL_BOOTSTRAP_TOKEN
        self.ttl = ttl
        self._sessions = {}  # sid -> [table, shard, deadline]
        self._guard = threading.Lock()
        self._sweeper = None

    def _ensure_sweeper(self):
        import threading

        if self._sweeper is not None and self._sweeper.is_alive():
            return
        t = threading.Thread(target=self._sweep_loop,
                             name="bootstrap-session-sweeper", daemon=True)
        self._sweeper = t
        t.start()

    def _sweep_loop(self):
        import time as _t

        while True:
            _t.sleep(self.ttl / 2)
            self.sweep()
            with self._guard:
                if not self._sessions:
                    self._sweeper = None
                    return

    def sweep(self) -> int:
        """Release tokens of sessions whose keep-alives stopped."""
        import time as _t

        now = _t.time()
        reaped = 0
        with self._guard:
            for sid in [s for s, v in self._sessions.items()
                        if v[2] < now]:
                table, shard, _ = self._sessions.pop(sid)
                self.token.release(table, shard)
                reaped += 1
        return reaped

    def open(self, table: str, shard: int,
             acquire_timeout: float = 20.0) -> str:
        import time as _t
        import uuid as _uuid

        if not self.token.acquire(table, shard, timeout=acquire_timeout):
            raise TimeoutError(
                f"bootstrap token for {table}/{shard} busy (data job or "
                f"another peer-copy session holds it)")
        sid = _uuid.uuid4().hex
        with self._guard:
            self._sessions[sid] = [table, shard, _t.time() + self.ttl]
        self._ensure_sweeper()
        return sid

    def keepalive(self, sid: str) -> bool:
        import time as _t

        with self._guard:
            v = self._sessions.get(sid)
            if v is None:
                return False
            v[2] = _t.time() + self.ttl
            return True

    def validate(self, sid: str, table: str = None,
                 shard: int = None) -> bool:
        import time as _t

        with self._guard:
            v = self._sessions.get(sid)
            if v is None or v[2] < _t.time():
                return False
            if table is not None and (v[0], v[1]) != (table, shard):
                return False
            return True

    def close(self, sid: str) -> bool:
        with self._guard:
            v = self._sessions.pop(sid, None)
        if v is None:
            return False
        self.token.release(v[0], v[1])
        return True


GLOBAL_BOOTSTRAP_SESSIONS = BootstrapSessionManager()
