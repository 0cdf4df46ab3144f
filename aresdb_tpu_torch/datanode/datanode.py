"""DataNode: distributed-mode node runtime.

Reference: datanode/datanode.go — Open (schema fetch, watches) / Serve
(advertise + heartbeat :538, topology watch → assignShardSet :597,
availability analysis :416). etcd watches become controller polls with hash
short-circuit (the reference's own SchemaFetchJob pattern,
metastore/schema_fetch.go:29).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Set

from aresdb_tpu_torch.utils import http_client

from aresdb_tpu_torch.api.server import ApiServer
from aresdb_tpu_torch.cluster.topology import DynamicTopology
from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.datanode.bootstrap import (bootstrap_shard,
                                                find_bootstrap_source)

_log = logging.getLogger("aresdb.datanode")


class DataNode:
    def __init__(self, memstore, scheduler, *, controller_address: str,
                 namespace: str, instance_name: str, host: str = "localhost",
                 port: int = 0, heartbeat_seconds: float = 5.0,
                 poll_seconds: float = 3.0, session=None, device=None):
        from aresdb_tpu_torch.cluster.failover import (
            FailoverSession, parse_addresses)

        self.memstore = memstore
        self.scheduler = scheduler
        addresses = parse_addresses(controller_address)
        self.controller = f"http://{addresses[0]}"
        self.namespace = namespace
        self.instance_name = instance_name
        self.host = host
        # failover across controller replicas (HA mode); single-address
        # lists behave exactly like a plain session
        self.session = session or FailoverSession(addresses)
        # device: where the node's queries run; `cuda` unless asked
        self.server = ApiServer(memstore, scheduler, port=port,
                                device=device)
        self.server.ctx.datanode = self  # /dbg/bootstrap/retry
        self.topology = DynamicTopology(controller_address, namespace,
                                        poll_seconds=poll_seconds,
                                        session=self.session)
        self.heartbeat_seconds = heartbeat_seconds
        self.poll_seconds = poll_seconds
        self._stop = threading.Event()
        self._threads = []
        self._schema_hash = ""
        self.owned_shards: Set[int] = set()
        self._add_lock = threading.Lock()
        self.port = 0

    # -- lifecycle (reference datanode.go Open/Serve) --

    def open(self) -> int:
        self.fetch_schema()
        self.port = self.server.start_background()
        return self.port

    def serve(self, scheduler_on: bool = True) -> None:
        """Advertise the node and start its loops; `scheduler_on` False
        (the daemon's --scheduler-off) leaves the scheduler paused, so that
        jobs run only through /dbg."""
        # advertise membership
        r = self.session.post(
            f"{self.controller}/membership/{self.namespace}/instances",
            json={"name": self.instance_name, "host": self.host,
                  "port": self.port})
        r.raise_for_status()
        self.topology.start()
        self._spawn(self._heartbeat_loop, "datanode-heartbeat")
        self._spawn(self._placement_loop, "datanode-placement")
        self._spawn(self._schema_loop, "datanode-schema")
        if self.scheduler is not None and scheduler_on:
            self.scheduler.start()
            self.scheduler.enable()

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.topology.stop()
        self.server.stop()
        if self.scheduler is not None:
            self.scheduler.stop()

    def _spawn(self, fn, name):
        t = threading.Thread(target=fn, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    # -- schema sync (reference SchemaFetchJob) --

    def fetch_schema(self) -> bool:
        r = self.session.get(
            f"{self.controller}/schema/{self.namespace}/hash", timeout=10)
        r.raise_for_status()
        h = r.json()["hash"]
        if h == self._schema_hash:
            return False
        r = self.session.get(
            f"{self.controller}/schema/{self.namespace}/tables", timeout=10)
        r.raise_for_status()
        for td in r.json():
            table = Table.from_json(td)
            existing = self.memstore.schemas.get(table.name)
            if existing is None:
                try:
                    self.memstore.create_table(table)
                except ValueError:
                    # present in metastore but not yet loaded
                    self.memstore.fetch_schema()
            elif existing.table.version < table.version:
                old = existing.table
                self.memstore.metastore.update_table(table)
                existing.set_table(table)
                hmm = self.memstore.host_memory_manager
                if hmm is not None:
                    hmm.handle_table_update(old, table)
            # sync enum dictionaries
            schema = self.memstore.get_schema(table.name)
            for col in table.columns:
                if not col.is_enum_column():
                    continue
                er = self.session.get(
                    f"{self.controller}/schema/{self.namespace}/tables/"
                    f"{table.name}/columns/{col.name}/enum-cases", timeout=10)
                if er.status_code == 200:
                    schema.enum_dicts[col.name].extend(er.json())
        self._schema_hash = h
        return True

    # -- background loops --

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_seconds):
            try:
                self.session.put(
                    f"{self.controller}/membership/{self.namespace}"
                    f"/instances/{self.instance_name}",
                    json={"shardRows": self._shard_row_counts()}, timeout=5)
            except http_client.RequestException:
                pass

    def _shard_row_counts(self) -> Dict[int, int]:
        """Per-shard row totals (live + archive) across all tables — the
        load stats the controller's skew-aware rebalance weighs shards by
        (BASELINE.md config 5)."""
        counts: Dict[int, int] = {}
        for (table, shard_id) in list(self.memstore.list_shards()):
            try:
                shard = self.memstore.get_table_shard(table, shard_id)
                rows = shard.live_store.rows_visible()
                av = shard.archive_store.get_current_version()
                rows += sum(b.size for b in list(av.batches.values()))
                counts[shard_id] = counts.get(shard_id, 0) + int(rows)
            except Exception:  # noqa: BLE001 — stats must never kill
                continue      # the heartbeat loop (e.g. racing a version swap)
        return counts

    def _schema_loop(self):
        while not self._stop.wait(self.poll_seconds * 3):
            try:
                self.fetch_schema()
            except http_client.RequestException:
                pass

    def _placement_loop(self):
        while not self._stop.wait(self.poll_seconds):
            try:
                self.check_placement()
            except http_client.RequestException:
                pass

    # -- shard assignment (reference assignShardSet :597) --

    def desired_shards(self) -> Set[int]:
        view = self.topology.get()
        out = set()
        for sid, entries in view.shards.items():
            for inst, _state in entries:
                # Leaving shards stay owned: the node keeps serving as the
                # bootstrap source until the joiner turns Available and the
                # controller drops the Leaving entry (m3 replace semantics)
                if inst.name == self.instance_name:
                    out.add(sid)
        return out

    def check_placement(self) -> None:
        desired = self.desired_shards()
        added = desired - self.owned_shards
        removed = self.owned_shards - desired
        for sid in sorted(added):
            self._add_shard(sid)
        for sid in sorted(removed):
            self._remove_shard(sid)

    BOOTSTRAP_RETRIES = 4
    BOOTSTRAP_BACKOFF_S = 0.5
    RECOVERY_TOKEN_TIMEOUT_S = 60.0

    def _add_shard(self, shard_id: int) -> None:
        """Copy every table of the shard from a peer, recover it, own it
        and mark it Available.

        A table's copy is retried with exponential backoff, each attempt
        re-picking a peer (reference: datanode/bootstrap_manager.go:172 m3
        retry) and starting from an empty local shard. Where every attempt
        fails, or a recovery fails, the shard's copies are deleted and it
        is neither recovered, owned nor marked Available: it stays
        Initializing, the Leaving source keeps serving it, and the
        placement loop (or /dbg/bootstrap/retry) tries it again. Only a
        shard that no peer owns starts from the local disk (empty on a new
        node). Marking a short copy Available would drop the Leaving
        replica (ControllerState.mark_available) and route the shard to
        a node that lacks its rows."""
        with self._add_lock:
            if shard_id in self.owned_shards:
                return
            tables = sorted(self.memstore.get_schemas())
            copied = []
            for table in tables:
                outcome = self._copy_table_shard(table, shard_id)
                if outcome == "failed":
                    for t in copied:
                        self._discard_copy(t, shard_id)
                    return
                if outcome == "copied":
                    copied.append(table)
            recovered = []
            try:
                for table in tables:
                    recovered.append(table)
                    self._recover_table_shard(table, shard_id)
            except Exception as e:  # noqa: BLE001 — the shard stays
                _log.warning(        # Initializing and is retried
                    "recovery of %s/%s failed: %s; the shard stays "
                    "Initializing", recovered[-1], shard_id, e)
                for t in recovered:
                    self.memstore.remove_table_shard(t, shard_id)
                for t in copied:
                    self._discard_copy(t, shard_id)
                return
            self.owned_shards.add(shard_id)
        # mark available for query routing
        try:
            self.session.post(
                f"{self.controller}/placement/{self.namespace}/datanode/"
                f"{self.instance_name}/available",
                json={"shardId": shard_id}, timeout=5)
        except http_client.RequestException:
            pass

    def _copy_table_shard(self, table: str, shard_id: int) -> str:
        """Copy one table's shard from a peer into an emptied local shard:
        "copied", "no peer" (nothing was copied or deleted) or "failed"
        (every attempt failed, or the node closed mid-backoff; nothing of
        the copy is left)."""
        backoff = self.BOOTSTRAP_BACKOFF_S
        for attempt in range(self.BOOTSTRAP_RETRIES):
            view = self.topology.refresh()
            peer = find_bootstrap_source(view, shard_id, self.instance_name)
            if peer is None:
                if attempt:
                    self._discard_copy(table, shard_id)
                return "no peer"
            self._discard_copy(table, shard_id)
            try:
                copied = bootstrap_shard(peer, table, shard_id,
                                         self.memstore.diskstore,
                                         self.memstore.metastore,
                                         session=self.session)
                _log.info(
                    "bootstrap of %s/%s from %s: %d files, %.1f MB in "
                    "%.2fs (%.1f MB/s)", table, shard_id, peer,
                    copied["archive"] + copied["snapshot"]
                    + copied["redolog"], copied["bytes"] / 1e6,
                    copied["seconds"], copied["mb_per_sec"])
                return "copied"
            except Exception as e:  # noqa: BLE001 — any fault of the copy
                if attempt + 1 >= self.BOOTSTRAP_RETRIES:
                    _log.warning(
                        "bootstrap of %s/%s failed after %d attempts "
                        "(last peer %s): %s; the shard stays Initializing",
                        table, shard_id, self.BOOTSTRAP_RETRIES, peer, e)
                else:
                    _log.warning(
                        "bootstrap of %s/%s from %s failed (attempt "
                        "%d/%d): %s; retrying in %.1fs", table, shard_id,
                        peer, attempt + 1, self.BOOTSTRAP_RETRIES, e,
                        backoff)
                    if self._stop.wait(backoff):
                        break
                    backoff *= 2
        self._discard_copy(table, shard_id)
        return "failed"

    def _discard_copy(self, table: str, shard_id: int) -> None:
        """Delete a copy's files and metastore entries (archive batches,
        snapshots, redo logs, watermarks), so that no attempt or recovery
        reads what an earlier attempt left."""
        self.memstore.diskstore.delete_table_shard(table, shard_id)
        self.memstore.metastore.delete_table_shard(table, shard_id)

    def _recover_table_shard(self, table: str, shard_id: int) -> None:
        """Add the table's shard to the store and replay it, holding its
        bootstrap token from before the shard is listed until its
        recovery ends: a data job (Scheduler.run_job) skips a shard whose
        token is held, and one that ran on a half-recovered shard would
        publish a cutoff past rows that are not yet visible, hiding
        them."""
        from aresdb_tpu_torch.memstore.common import GLOBAL_BOOTSTRAP_TOKEN

        if not GLOBAL_BOOTSTRAP_TOKEN.acquire(
                table, shard_id, timeout=self.RECOVERY_TOKEN_TIMEOUT_S):
            raise TimeoutError(f"bootstrap token for {table}/{shard_id} "
                               "busy")
        try:
            shard = self.memstore.add_table_shard(table, shard_id)
            self.memstore._recover_shard(shard)
        finally:
            GLOBAL_BOOTSTRAP_TOKEN.release(table, shard_id)

    def retry_bootstrap(self):
        """Bootstrap desired-but-not-owned shards now (reference
        api/debug_handler.go:97 bootstrap retry endpoint). Owned shards are
        untouched — re-copying over a live shard would clobber it."""
        try:
            pending = sorted(self.desired_shards() - self.owned_shards)
        except Exception:
            return []
        for sid in pending:
            self._add_shard(sid)
        return pending

    def _remove_shard(self, shard_id: int) -> None:
        for table in sorted(self.memstore.get_schemas()):
            self.memstore.remove_table_shard(table, shard_id)
        self.owned_shards.discard(shard_id)
