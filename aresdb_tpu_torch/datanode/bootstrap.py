"""Peer bootstrap client: copy a shard's persisted state from a peer.

Reference: memstore/bootstrap.go (TableShard.Bootstrap :107 —
findBootstrapSource, stream metadata + VP files to local disk, set local
metadata, then normal recovery) and datanode/bootstrap/bootstrap_server.go
(the serving side, exposed here as the /peer/* HTTP routes in api/server.py).
"""

from __future__ import annotations

import random
import time as _time
from typing import List, Optional

from aresdb_tpu_torch.utils import http_client

from aresdb_tpu_torch.cluster.topology import TopologyView


class BootstrapError(Exception):
    pass


def _report_vp_fetch(table: str, shard_id: int, nbytes: int,
                     seconds: float) -> None:
    """Per-file transfer metrics (utils/metrics.go RawVPFetch*; throughput
    parity surface for bootstrap_server_bm_test.go BenchmarkFileTransfer)."""
    from aresdb_tpu_torch.utils import metrics as M

    rep = M.root().scoped(table=table, shard=str(shard_id))
    rep.count(M.RAW_VP_BYTES_FETCHED, nbytes)
    rep.count(M.RAW_VP_FETCH_SUCCESS, 1)
    rep.record_timer(M.RAW_VP_FETCH_TIME, seconds)


def find_bootstrap_source(view: TopologyView, shard_id: int,
                          self_name: str) -> Optional[str]:
    """Pick a random Available/Leaving peer owning the shard
    (bootstrap.go:611 findBootstrapSource)."""
    peers = [h for h in view.bootstrap_sources(shard_id)
             if h.name != self_name]
    if not peers:
        return None
    return random.choice(peers).address


class _SessionKeepalive:
    """Background keep-alive pings so the peer holds the shard's bootstrap
    token for the whole copy (bootstrap_server.go keep-alive stream)."""

    def __init__(self, s, peer_address: str, session_id: str, ttl: float):
        import threading

        self._s = s
        self._url = (f"http://{peer_address}/peer/session/"
                     f"{session_id}/keepalive")
        self._interval = max(ttl / 3.0, 0.5)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bootstrap-keepalive")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self._interval):
            try:
                self._s.put(self._url, timeout=5)
            except http_client.RequestException:
                pass

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)


def _copy_redolog(s, base: str, qs: str, diskstore, table: str,
                  shard_id: int, creation_time: int, offset: int) -> int:
    """Fetch redolog bytes past `offset` and append locally; returns the
    new local size."""
    fr = s.get(f"{base}/redolog/{creation_time}?offset={offset}{qs}",
               timeout=600)
    fr.raise_for_status()
    with diskstore.open_log_for_append(table, shard_id,
                                       creation_time) as f:
        f.seek(0, 2)
        if f.tell() > offset:
            f.truncate(offset)
        f.seek(offset)
        # the whole tail at once: one write, no per-chunk loop
        f.write(fr.content)
    return offset + len(fr.content)


def bootstrap_shard(peer_address: str, table: str, shard_id: int,
                    diskstore, metastore, session=None) -> dict:
    """Copy archive batches, snapshots, and redologs from the peer, under a
    peer-copy session that holds the shard's bootstrap token end to end.

    The session guarantees archiving/backfill/snapshot/purge cannot swap or
    delete the peer's files mid-copy (bootstrap_server.go:76-463). After
    the file copy a second metadata fetch drives a redolog DELTA catch-up
    (memstore/bootstrap.go:487): rows the peer ingested during the copy are
    appended from each log's previously-copied offset, so recovery replays
    them and nothing is silently lost.

    After this, the normal recovery path (MemStore._recover_shard) replays
    the copied state exactly as a local restart would.
    """
    s = session or http_client.Session()
    base = f"http://{peer_address}/peer/{table}/{shard_id}"

    r = s.post(f"{base}/session", timeout=60)
    if r.status_code == 404:
        raise BootstrapError(f"peer has no shard {table}/{shard_id}")
    if r.status_code == 503:
        raise BootstrapError(f"peer busy: {r.text}")
    r.raise_for_status()
    sess = r.json()
    session_id = sess["sessionId"]
    qs = f"&session={session_id}"
    keepalive = _SessionKeepalive(s, peer_address, session_id,
                                  float(sess.get("ttl", 30)))
    try:
        r = s.get(f"{base}/metadata?session={session_id}", timeout=30)
        if r.status_code == 410:
            raise BootstrapError("bootstrap session expired mid-copy")
        r.raise_for_status()
        meta = r.json()

        copied = {"archive": 0, "snapshot": 0, "redolog": 0, "delta": 0,
                  "bytes": 0}
        t_copy0 = _time.perf_counter()

        # archive batches
        for bid_s, (version, seq, size) in meta["batches"].items():
            bid = int(bid_s)
            cols = meta["archiveColumns"].get(f"{bid}_{version}_{seq}", [])
            for col in cols:
                t0 = _time.perf_counter()
                fr = s.get(f"{base}/archive/{bid}/{version}/{seq}/{col}"
                           f"?session={session_id}", timeout=300)
                fr.raise_for_status()
                diskstore.write_archive_column(
                    table, shard_id, bid, version, seq, col, fr.content)
                copied["archive"] += 1
                copied["bytes"] += len(fr.content)
                _report_vp_fetch(table, shard_id, len(fr.content),
                                 _time.perf_counter() - t0)
            metastore.add_archive_batch_version(
                table, shard_id, bid, version, seq, size)

        # snapshots (dimension tables)
        srf, soff, sbid, sidx = meta["snapshotProgress"]
        for bid_s, cols in meta.get("snapshotBatches", {}).items():
            for col in cols:
                t0 = _time.perf_counter()
                fr = s.get(f"{base}/snapshot/{srf}/{soff}/{bid_s}/{col}"
                           f"?session={session_id}", timeout=300)
                fr.raise_for_status()
                diskstore.write_snapshot_column(
                    table, shard_id, srf, soff, int(bid_s), col, fr.content)
                copied["snapshot"] += 1
                copied["bytes"] += len(fr.content)
                _report_vp_fetch(table, shard_id, len(fr.content),
                                 _time.perf_counter() - t0)
        if (srf, soff) != (0, 0):
            metastore.update_snapshot_progress(
                table, shard_id, srf, soff, sbid, sidx)

        # redo logs (catch-up replay source)
        log_sizes = {}
        for creation_time in meta["redologs"]:
            log_sizes[creation_time] = _copy_redolog(
                s, base, qs, diskstore, table, shard_id, creation_time, 0)
            copied["redolog"] += 1
            copied["bytes"] += log_sizes[creation_time]

        # delta catch-up: rows ingested on the peer while the files were
        # copying live in redolog tails (archive/snapshot files cannot have
        # changed — the session holds the bootstrap token). Fetch metadata
        # again and append only the new bytes of each log.
        r = s.get(f"{base}/metadata?session={session_id}", timeout=30)
        r.raise_for_status()
        meta2 = r.json()
        for creation_time in meta2["redologs"]:
            prev = log_sizes.get(creation_time, 0)
            new_size = _copy_redolog(s, base, qs, diskstore, table,
                                     shard_id, creation_time, prev)
            if new_size > prev:
                copied["delta"] += new_size - prev

        metastore.update_archiving_cutoff(
            table, shard_id, meta2["archivingCutoff"])
        rf, off = meta2["backfillProgress"]
        metastore.update_backfill_progress(table, shard_id, rf, off)
        elapsed = max(_time.perf_counter() - t_copy0, 1e-9)
        copied["seconds"] = round(elapsed, 3)
        copied["mb_per_sec"] = round(copied["bytes"] / elapsed / 1e6, 2)
        from aresdb_tpu_torch.utils import metrics as M

        rep = M.root().scoped(table=table, shard=str(shard_id))
        rep.record_timer(M.TOTAL_RAW_VP_FETCH_TIME, elapsed)
        rep.gauge(M.RAW_VP_FETCH_BYTES_PER_SEC, copied["bytes"] / elapsed)
        return copied
    finally:
        keepalive.stop()
        try:
            s.delete(f"http://{peer_address}/peer/session/{session_id}",
                     timeout=10)
        except http_client.RequestException:
            pass
