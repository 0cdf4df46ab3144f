"""Archive batches of the port against the JAX package.

Two shards are filled from the same upsert-batch wire bytes, each through
its own package's `TableShard`, and each archived by its own package's
`Archiver` through its own `DiskMetaStore` and `LocalDiskStore`. The rows
are ingested in time order over three days and the cutoff falls inside a
live batch, so queries cross the cutoff: archive chunks, the live batch
that straddles it (its rows below the cutoff dropped in the kernel), and
the live batches above it. The same AQL requests go to the JAX package's
`QueryService` (ARES_FUSED=interp, its Pallas kernels interpreted) and to
the port's on the CPU. Keys and counts must agree exactly, float sums
within the JAX package's 2^-17 relative measure error
(aresdb_tpu/query/pallas_ops.py:365-371), and both must equal a numpy
oracle over the ingested rows.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.schema import Table as JTable
from aresdb_tpu.common.schema import TableSchema as JTableSchema
from aresdb_tpu.common.upsert_batch import UpsertBatch as JUpsertBatch
from aresdb_tpu.common.upsert_batch import build_columnar_upsert
from aresdb_tpu.diskstore.local_diskstore import LocalDiskStore as JDisk
from aresdb_tpu.memstore.archiving import Archiver as JArchiver
from aresdb_tpu.memstore.table_shard import TableShard as JTableShard
from aresdb_tpu.memstore.vector_party import \
    ArchiveVectorParty as JArchiveVectorParty
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JMeta
from aresdb_tpu.query import executor as JX
from aresdb_tpu.query import kernels as JK
from aresdb_tpu.query.service import QueryService as JQueryService
from aresdb_tpu_torch.common.schema import Table as TTable
from aresdb_tpu_torch.common.schema import TableSchema as TTableSchema
from aresdb_tpu_torch.common.upsert_batch import UpsertBatch as TUpsertBatch
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore as TDisk
from aresdb_tpu_torch.memstore.archiving import Archiver as TArchiver
from aresdb_tpu_torch.memstore.table_shard import TableShard as TTableShard
from aresdb_tpu_torch.memstore.vector_party import \
    ArchiveVectorParty as TArchiveVectorParty
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore as TMeta
from aresdb_tpu_torch.query import executor as TX
from aresdb_tpu_torch.query.service import QueryService as TQueryService

DAY = 86400
BASE = 1_600_000_000 - (1_600_000_000 % DAY)
NOW = BASE + 3 * DAY
CUTOFF = BASE + 2 * DAY
STATUSES = ["completed", "canceled", "rejected"]
REL = 2.0 ** -17   # the JAX package's relative measure error
N_ROWS = 12_000
BATCH = 4096

FACT = {
    "name": "trips",
    "columns": [
        {"name": "request_at", "type": "Uint32"},
        {"name": "id", "type": "Uint32"},
        {"name": "city_id", "type": "Uint16"},
        {"name": "status", "type": "SmallEnum"},
        {"name": "fare", "type": "Float32"},
        {"name": "tip", "type": "Int64"},
        {"name": "dropoff_at", "type": "Uint32"},
    ],
    "primaryKeyColumns": [1],
    "archivingSortColumns": [2, 3],
    "isFactTable": True,
    "config": {"batchSize": BATCH, "recordRetentionInDays": 0},
}


def make_rows(n=N_ROWS, seed=0, n_cities=12, days=3):
    """n trips timed uniformly over `days` days from BASE, in time order;
    cities 0..n_cities-1, fares 10% null."""
    rng = np.random.RandomState(seed)
    ts = np.sort(BASE + rng.randint(0, days * DAY, n)).astype(np.uint32)
    return dict(
        ts=ts, id=np.arange(n, dtype=np.uint32),
        city=rng.randint(0, n_cities, n).astype(np.uint16),
        status=rng.randint(0, 3, n).astype(np.uint8),
        fare=(rng.rand(n) * 50).astype(np.float32),
        fare_valid=rng.rand(n) > 0.1,
        tip=rng.randint(0, 100, n).astype(np.int64),
        dropoff=(ts + rng.randint(0, 3600, n)).astype(np.uint32))


def upserts(d, rows_per_upsert=BATCH):
    """The rows' upsert-batch wire bytes, one batch of live rows each."""
    out = []
    for lo in range(0, len(d["ts"]), rows_per_upsert):
        s = slice(lo, lo + rows_per_upsert)
        n = len(d["ts"][s])
        cols = [(0, dt.Uint32, d["ts"][s], None, 0),
                (1, dt.Uint32, d["id"][s], None, 0),
                (2, dt.Uint16, d["city"][s], None, 0),
                (3, dt.SmallEnum, d["status"][s], None, 0),
                (4, dt.Float32, d["fare"][s], d["fare_valid"][s], 0),
                (5, dt.Int64, d["tip"][s], None, 0),
                (6, dt.Uint32, d["dropoff"][s], None, 0)]
        out.append(build_columnar_upsert(cols, n))
    return out


class Store:
    """The store protocol the executors use, over one archived fact
    table."""

    def __init__(self, shard, schema):
        self.shard, self.schema = shard, schema

    def get_schemas(self):
        return {self.schema.table.name: self.schema}

    def get_table_shard(self, name, shard_id=0):
        return self.shard


JAX_SIDE = (JTable, JTableSchema, JTableShard, JUpsertBatch, JMeta, JDisk,
            JArchiver)
PORT_SIDE = (TTable, TTableSchema, TTableShard, TUpsertBatch, TMeta, TDisk,
             TArchiver)


def build(side, root, bufs, schema=FACT, cutoff=CUTOFF):
    """One package's shard of `bufs`, archived to `cutoff` through its
    own stores under `root`: (store, shard)."""
    table_cls, schema_cls, shard_cls, batch_cls, meta_cls, disk_cls, \
        archiver_cls = side
    ts = schema_cls(table_cls.from_json(schema))
    if "status" in [c.name for c in ts.table.columns]:
        ts.extend_enum("status", STATUSES)
    meta, disk = meta_cls(root), disk_cls(root)
    shard = shard_cls(ts, diskstore=disk, metastore=meta)
    for buf in bufs:
        shard.save_upsert_batch(batch_cls(buf))
    archiver_cls(shard, meta, disk).archive(cutoff)
    return Store(shard, ts), shard


def services(tmp, bufs, schema=FACT, cutoff=CUTOFF):
    """(JAX service, port service, JAX shard, port shard) over the same
    archived rows."""
    jstore, jshard = build(JAX_SIDE, os.path.join(tmp, "jax"), bufs, schema,
                           cutoff)
    tstore, tshard = build(PORT_SIDE, os.path.join(tmp, "port"), bufs, schema,
                           cutoff)
    jsvc = JQueryService(jstore)
    # a kernel cache of its own, so interpret-mode kernels stay here
    jsvc.executor = JX.ShardExecutor(jstore, kernel_cache=JK.KernelCache())
    return jsvc, TQueryService(tstore, device="cpu"), jshard, tshard


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def rows():
    return make_rows()


@pytest.fixture(scope="module")
def archived(rows, tmp_path_factory):
    return services(str(tmp_path_factory.mktemp("archived")), upserts(rows))


def ask(svc, query):
    resp = svc.handle_aql({"queries": [dict(query, table="trips", now=NOW)],
                           "verbose": True})
    assert "errors" not in resp, resp.get("errors")
    return resp["results"][0], resp["context"][0]


def flatten(result, prefix=()):
    out = {}
    for k, v in result.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def assert_same(got, want, exact=False, rel=REL):
    """Keys exact; measures exactly, or within rel (and 1e-3 absolute)."""
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for k, v in w.items():
        if exact or v is None or g[k] is None:
            assert g[k] == v, (k, g[k], v)
        else:
            assert abs(g[k] - v) <= max(abs(v) * rel, 1e-3), (k, g[k], v)


def both(archived, query, exact=False):
    """The query through both services: (port result, port context, JAX
    context), the results held equal."""
    jres, jctx = ask(archived[0], query)
    tres, tctx = ask(archived[1], query)
    assert_same(tres, jres, exact)
    return tres, tctx, jctx


def _sum_by_city(d, sel):
    out = {}
    for c in np.unique(d["city"][sel]):
        m = sel & (d["city"] == c)
        out[str(int(c))] = float(d["fare"][m].astype(np.float64).sum())
    return out


def test_archiver_writes_the_same_batches(archived, tmp_path_factory):
    """Day by day and column by column, both packages archive the same
    values, validity and run-length counts, and write byte-identical
    column files, so an archive written by either loads in the other."""
    jshard, tshard = archived[2], archived[3]
    jv = jshard.archive_store.get_current_version()
    tv = tshard.archive_store.get_current_version()
    assert jv.archiving_cutoff == tv.archiving_cutoff == CUTOFF
    days = sorted(jv.batches)
    assert days == sorted(tv.batches) == [BASE // DAY, BASE // DAY + 1]
    compressed = 0
    for day in days:
        jb, tb = jv.batches[day], tv.batches[day]
        assert (jb.size, jb.version, jb.seq) == (tb.size, tb.version, tb.seq)
        for cid in range(len(FACT["columns"])):
            jvp, tvp = jb.request_column(cid), tb.request_column(cid)
            for a, b in ((jvp.values, tvp.values), (jvp.validity,
                                                    tvp.validity),
                         (jvp.counts, tvp.counts)):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            compressed += tvp.is_compressed
            jbytes = jshard.diskstore.read_archive_column(
                "trips", 0, day, jb.version, jb.seq, cid)
            tbytes = tshard.diskstore.read_archive_column(
                "trips", 0, day, tb.version, tb.seq, cid)
            assert jbytes == tbytes == tvp.to_bytes()
            # each package loads the other's file
            for vp, cls in ((JArchiveVectorParty.from_bytes(tbytes), jvp),
                            (TArchiveVectorParty.from_bytes(jbytes), tvp)):
                np.testing.assert_array_equal(vp.validity, cls.validity)
                np.testing.assert_array_equal(vp.values, cls.values)
    # both sort columns of both days are run-length (mode-3) compressed
    assert compressed >= 4
    # the metastore's records of the archive are the same files too
    jroot = jshard.metastore.root
    troot = tshard.metastore.root
    for sub, _, files in os.walk(jroot):
        for f in files:
            rel = os.path.relpath(os.path.join(sub, f), jroot)
            with open(os.path.join(jroot, rel), "rb") as a, \
                    open(os.path.join(troot, rel), "rb") as b:
                assert a.read() == b.read(), rel


def test_cutoff_splits_a_live_batch_and_nothing_counts_twice(archived, rows):
    """Rows below the cutoff are archived and purged from the live
    batches wholly below it; the live batch that straddles it keeps
    them, and the query drops them there."""
    tshard = archived[3]
    live = tshard.live_store
    straddling = 0
    for _, n, batch in live.snapshot_columns([0]):
        t = batch.column(0).values[:n]
        straddling += bool((t < CUTOFF).any() and (t >= CUTOFF).any())
    assert straddling == 1
    query = {"measures": [{"sqlExpression": "count(*)"}],
             "dimensions": [{"sqlExpression": "city_id"}]}
    res, ctx, jctx = both(archived, query, exact=True)
    want = np.bincount(rows["city"], minlength=12)
    assert res == {str(c): float(v) for c, v in enumerate(want)}
    assert ctx["batches"] == jctx["batches"]
    res, _, _ = both(archived, {"measures": [{"sqlExpression": "sum(fare)"}],
                                "dimensions": [{"sqlExpression": "city_id"}]})
    assert_same(res, _sum_by_city(rows, rows["fare_valid"]), rel=1e-5)


@pytest.mark.parametrize("query", [
    {"measures": [{"sqlExpression": "sum(fare)",
                   "rowFilters": ["status='completed'"]}],
     "dimensions": [{"sqlExpression": "request_at",
                     "timeBucketizer": "day"},
                    {"sqlExpression": "status"}]},
    {"measures": [{"sqlExpression": "avg(fare)"}],
     "dimensions": [{"sqlExpression": "status"}]},
    {"measures": [{"sqlExpression": "sum(tip)"}],
     "dimensions": [{"sqlExpression": "city_id % 5"}]},
    {"measures": [{"sqlExpression": "max(fare)"}],
     "dimensions": [{"sqlExpression": "city_id"}]},
    {"measures": [{"sqlExpression": "count(*)"}],
     "dimensions": [{"sqlExpression": "fare"}]},
    {"measures": [{"sqlExpression": "countdistincthll(id)"}],
     "dimensions": [{"sqlExpression": "status"}]},
], ids=["dense day x status", "avg", "int64 sum", "max", "sort path",
        "hll"])
def test_queries_across_the_cutoff(archived, query):
    """Each path of the port reads archive chunks as the JAX package
    does: the dense kernel, min/max, integer sums, the keyed sort path
    and HLL."""
    exact = query["measures"][0]["sqlExpression"].startswith(
        ("count", "max", "sum(tip)"))
    both(archived, query, exact=exact)


def test_listing_reads_archive_rows(archived, rows):
    """A listing scans the archive days after the live batches, as the
    JAX package does."""
    query = {"measures": [{"sqlExpression": "1"}],
             "dimensions": [{"sqlExpression": "id"},
                            {"sqlExpression": "city_id"}],
             "rowFilters": ["fare > 49"], "limit": 10_000}
    jres, _ = ask(archived[0], query)
    tres, _ = ask(archived[1], query)
    assert tres == jres
    want = rows["fare_valid"] & (rows["fare"] > 49)
    assert sorted(int(r[0]) for r in tres["matrixData"]) == \
        rows["id"][want].tolist()


def test_time_filter_on_column_0_ranges_the_archive_days(archived, rows):
    """The last 36 hours start inside the second archived day: the first
    day is not scanned, and the answer equals the oracle's."""
    query = {"measures": [{"sqlExpression": "sum(fare)"}],
             "dimensions": [{"sqlExpression": "city_id"}],
             "timeFilter": {"column": "request_at", "from": "36 hours ago",
                            "to": "now"}}
    res, ctx, jctx = both(archived, query)
    since = NOW - 36 * 3600
    assert_same(res, _sum_by_city(rows, rows["fare_valid"]
                                  & (rows["ts"] >= since)), rel=1e-5)
    n_live = len(archived[3].live_store.snapshot_columns([0]))
    # one archive day (one chunk), and the live batches
    assert ctx["batches"] == jctx["batches"] == n_live + 1


def test_time_filter_on_another_column_ranges_no_archive_day(archived, rows):
    """A time filter on dropoff_at is a plain row filter: every archive
    day is scanned."""
    query = {"measures": [{"sqlExpression": "count(*)"}],
             "dimensions": [{"sqlExpression": "status"}],
             "timeFilter": {"column": "dropoff_at", "from": "36 hours ago",
                            "to": "now"}}
    res, ctx, jctx = both(archived, query, exact=True)
    since = NOW - 36 * 3600
    sel = (rows["dropoff"] >= since) & (rows["dropoff"] < NOW)
    assert res == {s: float(((rows["status"] == i) & sel).sum())
                   for i, s in enumerate(STATUSES) if (
                       (rows["status"] == i) & sel).any()}
    n_live = len(archived[3].live_store.snapshot_columns([0]))
    assert ctx["batches"] == jctx["batches"] == n_live + 2


@pytest.mark.parametrize("filters,exact,select", [
    (["city_id = 7"], False, lambda c, s: c == 7),
    (["city_id = 7", "status = 'completed'"], False,
     lambda c, s: (c == 7) & (s == 0)),
    (["city_id >= 9"], True, lambda c, s: c >= 9),
    (["city_id < 3"], True, lambda c, s: c < 3),
], ids=["eq", "eq on both sort columns", "ge", "lt"])
def test_prefilter_on_the_sort_columns(archived, rows, filters, exact,
                                       select):
    """Filters on the sort columns narrow each archive day by a binary
    search of the run-length (mode-3) entries; the skipped rows are
    counted in prefilterRowsSkipped, as in the JAX package."""
    measure = "count(*)" if exact else "sum(fare)"
    query = {"measures": [{"sqlExpression": measure, "rowFilters": filters}]}
    res, ctx, jctx = both(archived, query, exact)
    assert ctx["prefilterRowsSkipped"] == jctx["prefilterRowsSkipped"] > 0
    sel = select(rows["city"], rows["status"])
    if exact:
        assert res == {"": float(sel.sum())}
    else:
        want = float(rows["fare"][sel & rows["fare_valid"]]
                     .astype(np.float64).sum())
        assert abs(res[""] - want) <= want * 1e-5


@pytest.mark.parametrize("op", ["=", ">=", ">", "<", "<="])
def test_prefilter_slice_searches_mode3_entries(archived, op):
    """_prefilter_slice on a compressed column searches its entries and
    maps them to rows through the counts: both packages narrow a day to
    the same rows, which are exactly the rows the filter keeps."""
    tb = archived[3].archive_store.get_current_version().batches[BASE // DAY]
    vps = {2: tb.request_column(2), 3: tb.request_column(3)}
    assert vps[2].is_compressed
    n = tb.size
    rows = vps[2].expanded().values
    for val in (0, 5, 11, 12):
        got_stats, want_stats = {}, {}
        got = TX.ShardExecutor._prefilter_slice([(2, op, val)], vps, n,
                                                got_stats)
        want = JX.ShardExecutor._prefilter_slice([(2, op, val)], vps, n,
                                                 want_stats)
        assert got == want and got_stats == want_stats
        keep = {"=": rows == val, ">=": rows >= val, ">": rows > val,
                "<": rows < val, "<=": rows <= val}[op]
        lo, hi = got
        assert keep[lo:hi].all() and keep.sum() == max(hi - lo, 0)
        assert got_stats.get("prefilterRowsSkipped", 0) == n - keep.sum()


def test_chunks_of_an_archive_day(archived, rows, monkeypatch):
    """With the chunk cut to 1,000 rows in both packages, each archived
    day stages as several chunks, and the answers stay the same."""
    monkeypatch.setattr(TX.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 1000)
    monkeypatch.setattr(JX.ShardExecutor, "ARCHIVE_CHUNK_ROWS", 1000)
    tv = archived[3].archive_store.get_current_version()
    chunks = sum(-(-b.size // 1000) for b in tv.batches.values())
    n_live = len(archived[3].live_store.snapshot_columns([0]))
    for query, exact in (
            ({"measures": [{"sqlExpression": "count(*)"}],
              "dimensions": [{"sqlExpression": "city_id"},
                             {"sqlExpression": "status"}]}, True),
            ({"measures": [{"sqlExpression": "sum(fare)"}],
              "dimensions": [{"sqlExpression": "city_id"}]}, False)):
        res, ctx, jctx = both(archived, query, exact)
        assert ctx["batches"] == jctx["batches"] == n_live + chunks
    assert_same(res, _sum_by_city(rows, rows["fare_valid"]), rel=1e-5)
