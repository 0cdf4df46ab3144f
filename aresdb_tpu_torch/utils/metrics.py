"""Metrics registry: the reference's full tally catalog + scoped reporters.

Reference: utils/metrics.go (the ~105-name MetricName catalog with typed
definitions and static component/operation tags, :25-140 and the
metricDefs table :309-1100; per-(table,shard) TableShardReporter
:1113-1251) and common/metrics.go (pluggable reporter interface).

This implementation is dependency-free and keeps the reference's scope
names, metric types, and static tags verbatim so dashboards port over:
each constant below holds a catalog KEY (the reference's Go identifier);
the registry resolves it to the tally scope name + static tags at emission
time. Ad-hoc string names not in the catalog still work (e.g. the mesh
fallback counters), mirroring tally's free-form scopes.

tests/test_metrics_emission.py::test_catalog_name_diff_vs_reference
parses the reference file's MetricName enum and asserts set equality
(minus the documented N/As).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple


class MetricDef:
    __slots__ = ("key", "name", "kind", "tags")

    def __init__(self, key: str, name: str, kind: str, tags: tuple):
        self.key = key
        self.name = name
        self.kind = kind          # counter | gauge | timer
        self.tags = dict(tags)


CATALOG: Dict[str, MetricDef] = {}


def _d(key: str, name: str, kind: str, tags: tuple) -> str:
    CATALOG[key] = MetricDef(key, name, kind, tags)
    return key


# ---------------------------------------------------------------------------
# catalog — generated from the reference's utils/metrics.go metricDefs
# (same scope names, metric types, and static tags; one line per reference
# MetricName enum entry)
# ---------------------------------------------------------------------------

ALLOCATED_DEVICE_MEMORY = _d("AllocatedDeviceMemory", "allocated_device_memory", "gauge", (("component", "query"),))
ARCHIVING_IGNORED_RECORDS = _d("ArchivingIgnoredRecords", "backfill_records", "counter", (("component", "memstore"), ("operation", "archiving"),))
ARCHIVING_COUNT = _d("ArchivingCount", "count", "counter", (("component", "memstore"), ("operation", "archiving"),))
ARCHIVING_RECORDS = _d("ArchivingRecords", "archiving_records", "counter", (("component", "memstore"), ("operation", "archiving"),))
ARCHIVING_HIGH_WATERMARK = _d("ArchivingHighWatermark", "archiving_high_watermark", "gauge", (("component", "memstore"), ("operation", "archiving"),))
ARCHIVING_LOW_WATERMARK = _d("ArchivingLowWatermark", "archiving_low_watermark", "gauge", (("component", "memstore"), ("operation", "archiving"),))
ARCHIVING_TIMING_TOTAL = _d("ArchivingTimingTotal", "total", "timer", (("component", "memstore"), ("operation", "archiving"),))
BACKFILL_TIMING_TOTAL = _d("BackfillTimingTotal", "total", "timer", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_LOCK_TIMING = _d("BackfillLockTiming", "backfill_lock_timing", "timer", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_COUNT = _d("BackfillCount", "count", "counter", (("component", "memstore"), ("operation", "backfill"),))
ESTIMATED_DEVICE_MEMORY = _d("EstimatedDeviceMemory", "estimated_device_memory", "gauge", (("component", "query"),))
HTTP_HANDLER_CALL = _d("HTTPHandlerCall", "http.call", "counter", (("component", "api"),))
HTTP_HANDLER_LATENCY = _d("HTTPHandlerLatency", "http.latency", "timer", (("component", "api"),))
INGESTED_RECORDS = _d("IngestedRecords", "ingested_records", "counter", (("component", "memstore"), ("operation", "ingestion"),))
APPENDED_RECORDS = _d("AppendedRecords", "appended_records", "counter", (("component", "memstore"), ("operation", "ingestion"),))
UPDATED_RECORDS = _d("UpdatedRecords", "updated_records", "counter", (("component", "memstore"), ("operation", "ingestion"),))
INGEST_SKIPPED_RECORDS = _d("IngestSkippedRecords", "skipped_records", "counter", (("component", "memstore"), ("operation", "ingestion"),))
INGESTED_UPSERT_BATCHES = _d("IngestedUpsertBatches", "ingested_upsert_batches", "counter", (("component", "memstore"), ("operation", "ingestion"),))
INGESTED_RECOVERY_BATCHES = _d("IngestedRecoveryBatches", "ingested_recovery_batches", "counter", (("component", "memstore"), ("operation", "ingestion"),))
INGESTED_ERROR_BATCHES = _d("IngestedErrorBatches", "ingested_error_batches", "counter", (("component", "memstore"), ("operation", "ingestion"),))
UPSERT_BATCH_SIZE = _d("UpsertBatchSize", "upsert_batch_size", "gauge", (("component", "memstore"), ("operation", "ingestion"),))
RECOVERY_UPSERT_BATCH_SIZE = _d("RecoveryUpsertBatchSize", "recovery_upsert_batch_size", "gauge", (("component", "memstore"), ("operation", "ingestion"),))
PRIMARY_KEY_MISSING = _d("PrimaryKeyMissing", "primary_key_missing", "counter", (("component", "memstore"), ("operation", "ingestion"),))
TIME_COLUMN_MISSING = _d("TimeColumnMissing", "time_column_missing", "counter", (("component", "memstore"), ("operation", "ingestion"),))
DUPLICATE_RECORD_RATIO = _d("DuplicateRecordRatio", "duplicate_record_ratio", "gauge", (("component", "memstore"),))
BACKFILL_RECORDS = _d("BackfillRecords", "backfill_records", "counter", (("component", "memstore"), ("operation", "ingestion"),))
BACKFILL_RECORDS_TIME_DIFFERENCE = _d("BackfillRecordsTimeDifference", "backfill_records_time_diff", "gauge", (("component", "memstore"), ("operation", "ingestion"),))
BACKFILL_RECORDS_RATIO = _d("BackfillRecordsRatio", "backfill_records_ratio_per_batch", "gauge", (("component", "memstore"), ("operation", "ingestion"),))
BACKFILL_RECORDS_COLUMN_REMOVED = _d("BackfillRecordsColumnRemoved", "backfill_records_column_removed", "counter", (("component", "memstore"), ("operation", "ingestion"),))
BACKFILL_AFFECTED_DAYS = _d("BackfillAffectedDays", "backfill_affected_days", "gauge", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_NEW_RECORDS = _d("BackfillNewRecords", "backfill_new_records", "counter", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_INPLACE_UPDATE_RECORDS = _d("BackfillInplaceUpdateRecords", "backfill_inplace_records", "counter", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_DELETE_THEN_INSERT_RECORDS = _d("BackfillDeleteThenInsertRecords", "backfill_delete_insert_records", "counter", (("component", "memstore"), ("operation", "backfill"),))
BACKFILL_NO_EFFECT_RECORDS = _d("BackfillNoEffectRecords", "backfill_no_effect_records", "counter", (("component", "memstore"), ("operation", "backfill"),))
RECOVERY_IGNORED_RECORDS = _d("RecoveryIgnoredRecords", "backfill_records", "counter", (("component", "memstore"), ("operation", "recovery"),))
RECOVERY_IGNORED_RECORDS_TIME_DIFFERENCE = _d("RecoveryIgnoredRecordsTimeDifference", "backfill_records_time_diff", "gauge", (("component", "memstore"), ("operation", "recovery"),))
RECOVERY_LATENCY = _d("RecoveryLatency", "recovery_latency", "timer", (("component", "memstore"), ("operation", "recovery"),))
TOTAL_MEMORY_SIZE = _d("TotalMemorySize", "total_memory_size", "gauge", (("component", "memstore"),))
UNMANAGED_MEMORY_SIZE = _d("UnmanagedMemorySize", "unmanaged_memory_size", "gauge", (("component", "memstore"),))
MANAGED_MEMORY_SIZE = _d("ManagedMemorySize", "managed_memory_size", "gauge", (("component", "memstore"),))
BACKFILL_BUFFER_FILL_RATIO = _d("BackfillBufferFillRatio", "backfill_buffer_fill_ratio", "gauge", (("component", "memstore"),))
BACKFILL_BUFFER_SIZE = _d("BackfillBufferSize", "backfill_buffer_size", "gauge", (("component", "memstore"),))
BACKFILL_BUFFER_NUM_RECORDS = _d("BackfillBufferNumRecords", "backfill_buffer_num_records", "gauge", (("component", "memstore"),))
INGESTION_LAG_PER_COLUMN = _d("IngestionLagPerColumn", "ingestion_lag", "gauge", (("component", "memstore"),))
INGESTION_WRITELOCK_AQUIRE_TIME = _d("IngestionWritelockAquireTime", "writelock_acquire_time", "timer", (("component", "memstore"), ("operation", "ingestion"),))
INGESTION_PRIMARY_KEY_LOOKUP_TIME = _d("IngestionPrimaryKeyLookupTime", "pk_lookup_time", "timer", (("component", "memstore"), ("operation", "ingestion"),))
CURRENT_REDOLOG_CREATION_TIME = _d("CurrentRedologCreationTime", "current_redolog_creation_time", "gauge", (("component", "diskstore"),))
CURRENT_REDOLOG_SIZE = _d("CurrentRedologSize", "current_redolog_size", "gauge", (("component", "diskstore"),))
NUMBER_OF_REDOLOGS = _d("NumberOfRedologs", "number_of_redologs", "gauge", (("component", "diskstore"),))
SIZE_OF_REDOLOGS = _d("SizeOfRedologs", "size_of_redologs", "gauge", (("component", "diskstore"),))
NUMBER_OF_ENUM_CASES_PER_COLUMN = _d("NumberOfEnumCasesPerColumn", "number_of_enum_cases", "gauge", (("component", "metastore"),))
QUERY_FAILED = _d("QueryFailed", "query_failed", "counter", (("component", "query"),))
QUERY_SUCCEEDED = _d("QuerySucceeded", "query_succeeded", "counter", (("component", "query"),))
QUERY_LATENCY = _d("QueryLatency", "query_latency", "timer", (("component", "query"),))
QUERY_SQL_PARSING_LATENCY = _d("QuerySQLParsingLatency", "sql_parsing_latency", "timer", (("component", "query"),))
QUERY_DIM_READ_LATENCY = _d("QueryDimReadLatency", "query_dim_read_latency", "timer", (("component", "query"),))
QUERY_WAIT_FOR_MEMORY_DURATION = _d("QueryWaitForMemoryDuration", "query_wait_for_memory_duration", "timer", (("component", "query"),))
QUERY_READ_LOCK_ACQUIRE_TIME = _d("QueryReadLockAcquireTime", "readlock_acquire_time", "timer", (("component", "query"),))
QUERY_RECEIVED = _d("QueryReceived", "query_received", "counter", (("component", "query"),))
QUERY_LIVE_RECORDS_PROCESSED = _d("QueryLiveRecordsProcessed", "records_processed", "counter", (("component", "query"), ("store", "live"),))
QUERY_ARCHIVE_RECORDS_PROCESSED = _d("QueryArchiveRecordsProcessed", "records_processed", "counter", (("component", "query"), ("store", "archive"),))
QUERY_BATCH_TRANSFER_TIME = _d("QueryBatchTransferTime", "batch_transfer_time", "timer", (("component", "query"),))
QUERY_LIVE_BATCH_PROCESSED = _d("QueryLiveBatchProcessed", "batch_processed", "counter", (("component", "query"), ("store", "live"),))
QUERY_ARCHIVE_BATCH_PROCESSED = _d("QueryArchiveBatchProcessed", "batch_processed", "counter", (("component", "query"), ("store", "archive"),))
QUERY_LIVE_BYTES_TRANSFERRED = _d("QueryLiveBytesTransferred", "bytes_transferred", "counter", (("component", "query"), ("store", "live"),))
QUERY_ARCHIVE_BYTES_TRANSFERRED = _d("QueryArchiveBytesTransferred", "bytes_transferred", "counter", (("component", "query"), ("store", "archive"),))
QUERY_ROWS_RETURNED = _d("QueryRowsReturned", "rows_returned", "counter", (("component", "query"),))
RECORDS_OUT_OF_RETENTION = _d("RecordsOutOfRetention", "records_out_of_retention", "counter", (("component", "memstore"), ("operation", "ingestion"),))
SNAPSHOT_TIMING_TOTAL = _d("SnapshotTimingTotal", "total", "timer", (("component", "memstore"), ("operation", "snapshot"),))
SNAPSHOT_TIMING_LOAD = _d("SnapshotTimingLoad", "load", "timer", (("component", "memstore"), ("operation", "snapshot"),))
SNAPSHOT_TIMING_BUILD_INDEX = _d("SnapshotTimingBuildIndex", "build_index", "timer", (("component", "memstore"), ("operation", "snapshot"),))
SNAPSHOT_COUNT = _d("SnapshotCount", "count", "counter", (("component", "memstore"), ("operation", "snapshot"),))
TIMEZONE_LOOKUP_TABLE_CREATION_TIME = _d("TimezoneLookupTableCreationTime", "timezone_lookup_table_creation_time", "timer", (("component", "query"),))
REDO_LOG_FILE_CORRUPT = _d("RedoLogFileCorrupt", "redo_log_file_corrupt", "counter", (("component", "diskstore"),))
MEMORY_OVERFLOW = _d("MemoryOverflow", "memory_overflow", "counter", (("component", "memstore"),))
RAW_VP_FETCH_TIME = _d("RawVPFetchTime", "raw_vp_fetch_time", "timer", (("component", "memstore"), ("operation", "bootstrap"),))
RAW_VP_BYTES_FETCHED = _d("RawVPBytesFetched", "raw_vp_bytes_fetched", "counter", (("component", "memstore"), ("operation", "bootstrap"),))
RAW_VP_FETCH_SUCCESS = _d("RawVPFetchSuccess", "raw_vp_fetch_success", "counter", (("component", "memstore"), ("operation", "bootstrap"),))
RAW_VP_FETCH_FAILURE = _d("RawVPFetchFailure", "raw_vp_fetch_failure", "counter", (("component", "memstore"), ("operation", "bootstrap"),))
TOTAL_RAW_VP_FETCH_TIME = _d("TotalRawVPFetchTime", "total_raw_vp_fetch_time", "timer", (("component", "memstore"), ("operation", "bootstrap"),))
RAW_VP_FETCH_BYTES_PER_SEC = _d("RawVPFetchBytesPerSec", "raw_vp_fetch_bytes_per_sec", "gauge", (("component", "memstore"), ("operation", "bootstrap"),))
PRELOADING_ZONE_EVICTED = _d("PreloadingZoneEvicted", "preloading_zone_evicted", "counter", (("component", "memstore"),))
PURGE_TIMING_TOTAL = _d("PurgeTimingTotal", "total", "timer", (("component", "memstore"), ("operation", "purge"),))
PURGED_BATCHES = _d("PurgedBatches", "purged_batches", "counter", (("component", "memstore"), ("operation", "purge"),))
RECORDS_FROM_FUTURE = _d("RecordsFromFuture", "records_from_future", "counter", (("component", "memstore"), ("operation", "ingestion"),))
BATCH_SIZE = _d("BatchSize", "batch_size", "gauge", (("component", "stats"),))
BATCH_SIZE_REPORT_TIME = _d("BatchSizeReportTime", "batch_size_report_time", "timer", (("component", "stats"),))
SCHEMA_FETCH_SUCCESS = _d("SchemaFetchSuccess", "schema_fetch_success", "counter", (("component", "metastore"),))
SCHEMA_FETCH_FAILURE = _d("SchemaFetchFailure", "schema_fetch_failure", "counter", (("component", "metastore"),))
SCHEMA_FETCH_FAILURE_ENUM = _d("SchemaFetchFailureEnum", "schema_fetch_failure_enum", "counter", (("component", "metastore"),))
SCHEMA_UPDATE_COUNT = _d("SchemaUpdateCount", "schema_updates", "counter", (("component", "metastore"),))
SCHEMA_DELETION_COUNT = _d("SchemaDeletionCount", "schema_deletions", "counter", (("component", "metastore"),))
SCHEMA_CREATION_COUNT = _d("SchemaCreationCount", "schema_creations", "counter", (("component", "metastore"),))
PURGE_COUNT = _d("PurgeCount", "count", "counter", (("component", "memstore"), ("operation", "purge"),))
JOB_FAILURES_COUNT = _d("JobFailuresCount", "job_failures_count", "counter", ())
AQL_QUERY_RECEIVED_BROKER = _d("AQLQueryReceivedBroker", "aql_query_received_broker", "counter", (("component", "query"),))
SQL_QUERY_RECEIVED_BROKER = _d("SQLQueryReceivedBroker", "sql_query_received_broker", "counter", (("component", "query"),))
QUERY_FAILED_BROKER = _d("QueryFailedBroker", "query_failed_broker", "counter", (("component", "query"),))
QUERY_SUCCEEDED_BROKER = _d("QuerySucceededBroker", "query_succeeded_broker", "counter", (("component", "query"),))
QUERY_LATENCY_BROKER = _d("QueryLatencyBroker", "query_latency_broker", "timer", (("component", "query"),))
SQL_PARSING_LATENCY_BROKER = _d("SQLParsingLatencyBroker", "sql_parsing_latency_broker", "timer", (("component", "query"),))
QUERY_PLAN_EXECUTE_FAILURES = _d("QueryPlanExecuteFailures", "query_plan_execute_failures", "counter", (("component", "query"),))
DATA_NODE_QUERY_FAILURES = _d("DataNodeQueryFailures", "datanode_query_failures", "counter", (("component", "query"),))
TIME_WAITED_FOR_DATA_NODE = _d("TimeWaitedForDataNode", "time_waited_for_datanodes", "timer", (("component", "query"),))
TIME_SER_DE_DATA_NODE_RESPONSE = _d("TimeSerDeDataNodeResponse", "time_serde_response", "timer", (("component", "query"),))

# back-compat aliases (round-1/2 call sites)
QUERY_WAIT_FOR_MEMORY = QUERY_WAIT_FOR_MEMORY_DURATION

# the port's own series, outside the reference's catalog: a kernel built
# on a kernel-cache miss or a plan structure's NVRTC compile (tag: kind)
QUERY_KERNEL_BUILDS = "query.kernel_builds"
QUERY_KERNEL_BUILD = "query.kernel_build"
# K1's launcher calls, one a query's group of batches of one structure,
# literal block and dense plan, and the batches launched in them
QUERY_DENSE_LAUNCH_CALLS = "query.dense_launch_calls"
QUERY_DENSE_BATCHES_LAUNCHED = "query.dense_batches_launched"
# batches that took the sort (keyed) route, and capacity-ladder reruns of
# keyed and HLL batches
QUERY_SORT_BATCHES = "query.sort_batches"
QUERY_LADDER_RERUNS = "query.ladder_reruns"


class _Timer:
    def __init__(self, registry: "MetricsRegistry", name: str, tags):
        self.registry = registry
        self.name = name
        self.tags = tags
        self._start = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.record_timer(
            self.name, time.perf_counter() - self._start, self.tags)


def _resolve(name: str, tags: Optional[dict]):
    """Catalog key -> (scope name, merged static+dynamic tags)."""
    d = CATALOG.get(name)
    if d is None:
        return name, tags
    merged = dict(d.tags)
    if tags:
        merged.update(tags)
    return d.name, merged


class MetricsRegistry:
    """Thread-safe in-process metrics store with optional reporter hook."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[Tuple, float] = defaultdict(float)
        self.gauges: Dict[Tuple, float] = {}
        self.timers: Dict[Tuple, list] = defaultdict(
            lambda: [0, 0.0, float("inf"), 0.0])  # count, sum, min, max
        self.reporter = None  # optional callable(kind, name, value, tags)

    @staticmethod
    def _key(name: str, tags: Optional[dict]):
        return (name, tuple(sorted((tags or {}).items())))

    def count(self, name: str, delta: float = 1, tags: Optional[dict] = None):
        name, tags = _resolve(name, tags)
        with self.lock:
            self.counters[self._key(name, tags)] += delta
        if self.reporter:
            self.reporter("counter", name, delta, tags)

    def gauge(self, name: str, value: float, tags: Optional[dict] = None):
        name, tags = _resolve(name, tags)
        with self.lock:
            self.gauges[self._key(name, tags)] = value
        if self.reporter:
            self.reporter("gauge", name, value, tags)

    def record_timer(self, name: str, seconds: float,
                     tags: Optional[dict] = None):
        name, tags = _resolve(name, tags)
        with self.lock:
            t = self.timers[self._key(name, tags)]
            t[0] += 1
            t[1] += seconds
            t[2] = min(t[2], seconds)
            t[3] = max(t[3], seconds)
        if self.reporter:
            self.reporter("timer", name, seconds, tags)

    def timer(self, name: str, tags: Optional[dict] = None) -> _Timer:
        return _Timer(self, name, tags)

    def scoped(self, **tags) -> "ScopedReporter":
        """Per-(table, shard) reporter (reference TableShardReporter,
        utils/metrics.go:1113)."""
        return ScopedReporter(self, tags)

    def snapshot(self) -> dict:
        with self.lock:
            out = {"counters": {}, "gauges": {}, "timers": {}}
            for (name, tags), v in self.counters.items():
                out["counters"][_fmt(name, tags)] = v
            for (name, tags), v in self.gauges.items():
                out["gauges"][_fmt(name, tags)] = v
            for (name, tags), (cnt, total, mn, mx) in self.timers.items():
                out["timers"][_fmt(name, tags)] = {
                    "count": cnt, "sum": total,
                    "min": mn if cnt else 0, "max": mx,
                    "avg": total / cnt if cnt else 0,
                }
            return out

    def find(self, name: str) -> dict:
        """All emitted series for one catalog key / scope name (tests)."""
        d = CATALOG.get(name)
        scope = d.name if d else name
        out = {}
        with self.lock:
            for store in (self.counters, self.gauges):
                for (n, tags), v in store.items():
                    if n == scope:
                        out[_fmt(n, tags)] = v
            for (n, tags), t in self.timers.items():
                if n == scope:
                    out[_fmt(n, tags)] = t[0]
        return out


def _fmt(name, tags):
    if not tags:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in tags) + "}"


class ScopedReporter:
    def __init__(self, registry: MetricsRegistry, tags: dict):
        self.registry = registry
        self.tags = tags

    def count(self, name, delta=1):
        self.registry.count(name, delta, self.tags)

    def gauge(self, name, value):
        self.registry.gauge(name, value, self.tags)

    def timer(self, name):
        return self.registry.timer(name, self.tags)

    def record_timer(self, name, seconds):
        self.registry.record_timer(name, seconds, self.tags)


_ROOT = MetricsRegistry()


def root() -> MetricsRegistry:
    return _ROOT
