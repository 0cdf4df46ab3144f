"""BatchStatsReporter: periodic per-batch row-count gauges.

Reference: memstore/batchstats.go:24 BatchStatsReporter (started from
cmd/aresd/cmd/cmd.go:292) — reports live/archive batch sizes per
(table, shard) into the metrics registry.
"""

from __future__ import annotations

import threading

from aresdb_tpu_torch.utils import metrics as M


class BatchStatsReporter:
    def __init__(self, memstore, interval_seconds: int = 60):
        self.memstore = memstore
        self.interval_seconds = interval_seconds
        self._stop = threading.Event()
        self._thread = None

    def report_once(self) -> None:
        reg = M.root()
        for table, shard_id in self.memstore.list_shards():
            shard = self.memstore.get_table_shard(table, shard_id)
            tags = {"table": table, "shard": str(shard_id)}
            ls = shard.live_store
            reg.gauge("memstore.live_rows", ls.rows_visible(), tags)
            reg.gauge("memstore.live_batches", len(ls.batches), tags)
            reg.gauge("memstore.primary_keys", len(ls.primary_key), tags)
            reg.gauge("memstore.live_bytes", ls.bytes_estimate(), tags)
            version = shard.archive_store.get_current_version()
            reg.gauge("memstore.archive_batches", len(version.batches), tags)
            reg.gauge("memstore.archive_rows",
                      sum(b.size for b in version.batches.values()), tags)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_seconds):
                try:
                    self.report_once()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="batch-stats")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
