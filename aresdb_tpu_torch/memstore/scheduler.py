"""Job scheduler: periodic archiving/backfill/snapshot/purge per shard.

Reference: memstore/scheduler.go (single-threaded job executor),
memstore/job_manager.go (per-jobtype managers generating jobs on intervals),
memstore/job_status.go (status reporting for /dbg).
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional

from aresdb_tpu_torch.memstore.archiving import Archiver
from aresdb_tpu_torch.utils import clock, tracing

JOB_TYPES = ("archiving", "backfill", "snapshot", "purge")


class JobStatus:
    def __init__(self):
        self.last_run = 0
        self.last_duration = 0.0
        self.last_error: Optional[str] = None
        self.num_runs = 0
        self.last_result = None

    def to_json(self):
        return {
            "lastRun": self.last_run,
            "lastDuration": self.last_duration,
            "lastError": self.last_error,
            "numRuns": self.num_runs,
            "lastResult": self.last_result,
        }


class Scheduler:
    """Runs due jobs for every shard of a MemStore.

    Single job-executor thread like the reference (scheduler.go:44); jobs
    are generated per (table, shard, jobtype) when their interval elapses.
    """

    def __init__(self, memstore, interval_seconds: int = 60):
        self.memstore = memstore
        self.interval_seconds = interval_seconds
        self.enabled = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_run: Dict[tuple, int] = {}
        self.statuses: Dict[tuple, JobStatus] = {}
        self.lock = threading.RLock()

    # -- lifecycle --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ares-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def enable(self) -> None:
        self.enabled.set()

    def disable(self) -> None:
        self.enabled.clear()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=1.0):
            if self.enabled.is_set():
                try:
                    self.run_due_jobs()
                except Exception:  # keep the scheduler alive
                    traceback.print_exc()

    # -- job generation/execution --

    def _intervals(self, schema) -> Dict[str, int]:
        cfg = schema.table.config
        if schema.table.is_fact_table:
            return {
                "archiving": cfg.archiving_interval_minutes * 60,
                "backfill": cfg.backfill_interval_minutes * 60,
                "purge": 24 * 3600,
            }
        return {"snapshot": cfg.snapshot_interval_minutes * 60}

    def run_due_jobs(self, now: Optional[int] = None) -> List[tuple]:
        now = now or clock.now_unix()
        ran = []
        for (table, shard_id) in self.memstore.list_shards():
            shard = self.memstore.get_table_shard(table, shard_id)
            for jobtype, interval in self._intervals(shard.schema).items():
                key = (table, shard_id, jobtype)
                last = self._last_run.get(key, 0)
                if now - last < max(interval, 1):
                    continue
                if jobtype == "archiving":
                    # restart-proof readiness from the PERSISTED cutoff:
                    # ready iff now - delay > currentCutoff + interval
                    # (reference archiveJobManager.generateJobs,
                    # memstore/job_manager.go:66-83)
                    cfg = shard.schema.table.config
                    delay = cfg.archiving_delay_minutes * 60
                    cur = shard.archive_store.get_current_version(
                        ).archiving_cutoff
                    if now - delay <= cur + interval:
                        continue
                # backpressure-driven early backfill (backfill_manager.go)
                self.run_job(table, shard_id, jobtype, now)
                ran.append(key)
        return ran

    def run_job(self, table: str, shard_id: int, jobtype: str,
                now: Optional[int] = None):
        """Execute one job immediately (also the debug-endpoint entry), in
        a `job` span with its kind, table and shard."""
        with tracing.span("job") as span:
            if span is not None:
                span.attrs.update(kind=jobtype, table=table, shard=shard_id)
            return self._run_job(table, shard_id, jobtype, now)

    def _run_job(self, table: str, shard_id: int, jobtype: str,
                 now: Optional[int]):
        now = now or clock.now_unix()
        shard = self.memstore.get_table_shard(table, shard_id)
        archiver = Archiver(shard, self.memstore.metastore,
                            self.memstore.diskstore)
        key = (table, shard_id, jobtype)
        status = self.statuses.setdefault(key, JobStatus())
        start = clock.now()
        result = None
        from aresdb_tpu_torch.memstore.common import GLOBAL_BOOTSTRAP_TOKEN

        from aresdb_tpu_torch.utils import metrics as M

        rep = M.root().scoped(table=table, shard=str(shard_id))
        # Reference parity (purge.go:25, archiving.go:319, backfill.go:224):
        # every job acquires the shard's bootstrap token NON-blocking and
        # SKIPS the run when a peer-copy session holds it — blocking here
        # would freeze the single job-executor thread (and every other
        # table's jobs) behind a long shard copy.
        if not GLOBAL_BOOTSTRAP_TOKEN.acquire(table, shard_id,
                                              blocking=False):
            # leave _last_run untouched: the job stays due and retries on
            # the next scheduler tick once the copy finishes
            status.last_result = {"skipped": "bootstrap in progress"}
            return None
        try:
            if jobtype == "archiving":
                delay = shard.schema.table.config.archiving_delay_minutes * 60
                cutoff = max(0, now - delay)
                old_cutoff = shard.live_store.archiving_cutoff_high_watermark
                st = archiver.archive(cutoff)
                result = {"rowsArchived": st.rows_archived, "days": st.days,
                          "cutoff": cutoff}
                rep.count(M.ARCHIVING_COUNT, 1)
                rep.count(M.ARCHIVING_RECORDS, st.rows_archived)
                rep.gauge(M.ARCHIVING_HIGH_WATERMARK, cutoff)
                rep.gauge(M.ARCHIVING_LOW_WATERMARK, old_cutoff)
                if st.rows_archived and \
                        self.memstore.host_memory_manager is not None:
                    # async: don't stall the job loop on disk reads
                    self.memstore.host_memory_manager.trigger_preload_sweep()
            elif jobtype == "backfill":
                result = {"rowsBackfilled": archiver.backfill()}
                rep.count(M.BACKFILL_COUNT, 1)
                rep.count(M.BACKFILL_RECORDS, result["rowsBackfilled"])
            elif jobtype == "snapshot":
                result = {"rowsSnapshotted": archiver.snapshot()}
                rep.count(M.SNAPSHOT_COUNT, 1)
            elif jobtype == "purge":
                result = {"batchesPurged": archiver.purge(now)}
                rep.count(M.PURGE_COUNT, 1)
                rep.count(M.PURGED_BATCHES, result["batchesPurged"])
            else:
                raise ValueError(f"unknown job type {jobtype!r}")
            status.last_error = None
        except Exception as e:
            status.last_error = f"{type(e).__name__}: {e}"
            rep.count(M.JOB_FAILURES_COUNT, 1, tags={"jobType": jobtype})
            raise
        finally:
            GLOBAL_BOOTSTRAP_TOKEN.release(table, shard_id)
            status.last_run = now
            status.num_runs += 1
            status.last_duration = clock.now() - start
            status.last_result = result
            self._last_run[key] = now
            _JOB_TIMERS = {"archiving": M.ARCHIVING_TIMING_TOTAL,
                           "backfill": M.BACKFILL_TIMING_TOTAL,
                           "snapshot": M.SNAPSHOT_TIMING_TOTAL,
                           "purge": M.PURGE_TIMING_TOTAL}
            t = _JOB_TIMERS.get(jobtype)
            if t is not None:
                rep.record_timer(t, status.last_duration)
        return result

    def job_statuses(self) -> Dict[str, dict]:
        return {"/".join(map(str, k)): v.to_json()
                for k, v in self.statuses.items()}
