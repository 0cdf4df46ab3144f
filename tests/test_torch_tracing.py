"""The port's spans (`aresdb_tpu_torch/utils/tracing.py`) through its HTTP
API on `cpu`: nothing recorded while tracing is off and `plan.stats`
unchanged; with it on, one trace a request from the HTTP read to the
card's wait, its parents kept across the query pool's hop, and the
stages' spans summing to `plan.stats`; the ring, `/dbg/trace`, the
kernel-build counter, and the ingest and job spans.

One daemon serves every test of the file, over a fact table of 400 rows
in 4 live batches (batchSize 128), the clock frozen at NOW. The tables
are named trc_* so that no other test file's table of one name shares a
kernel with them.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from aresdb_tpu_torch.api.server import ApiServer
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.memstore.scheduler import Scheduler
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.utils import clock
from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils import tracing

NOW = 1_600_000_000
N_ROWS = 400
TRIPS = {"name": "trc_trips",
         "columns": [{"name": "request_at", "type": "Uint32"},
                     {"name": "id", "type": "Uint32"},
                     {"name": "city_id", "type": "Uint16"},
                     {"name": "fare", "type": "Float32"}],
         "primaryKeyColumns": [1], "isFactTable": True,
         "config": {"batchSize": 128, "recordRetentionInDays": 0}}
# the verbose context of a live dense query, in order
STATS_KEYS = ["batches", "rows_scanned", "stagedBytes",
              "peakBatchStagedBytes", "overflowReruns", "ladderReruns",
              "sortBatches", "sortExec", "sortMerge",
              "foreignTransfer", "transfer", "batchExec", "resultFetch",
              "hostFetches", "compile", "memoryRequired", "postprocess"]
QUERY_STAGES = ("compile", "admission", "foreignTransfer", "transfer",
                "batchExec", "resultFetch", "postprocess")


def _query(measure="sum(fare)", dims=("city_id",), filters=()):
    return {"table": "trc_trips", "now": NOW,
            "measures": [{"sqlExpression": measure,
                          "rowFilters": list(filters)}],
            "dimensions": [{"sqlExpression": d} for d in dims],
            "timeFilter": {"column": "request_at", "from": "-2h",
                           "to": "now"}}


def _upsert(ids):
    rng = np.random.RandomState(int(ids[0]))
    n = len(ids)
    return build_columnar_upsert(
        [(0, mdt.Uint32, (NOW - 1 - rng.randint(0, 3600, n))
          .astype(np.uint32), None, 0),
         (1, mdt.Uint32, np.asarray(ids, np.uint32), None, 0),
         (2, mdt.Uint16, rng.randint(0, 20, n).astype(np.uint16), None, 0),
         (3, mdt.Float32, (rng.rand(n) * 50).astype(np.float32), None, 0)],
        n, arrival_time=NOW)


class Daemon:
    def __init__(self, root):
        self.ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
        self.ms.fetch_schema()
        self.server = ApiServer(self.ms, Scheduler(self.ms), port=0,
                                device="cpu")
        self.port = self.server.start_background()

    def send(self, path, body=None, headers=None):
        """(status, JSON body) of one POST."""
        data = body if isinstance(body, bytes) else \
            json.dumps(body or {}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def aql(self, *queries, headers=None, verbose=False):
        status, body = self.send(
            "/query/aql" + ("?verbose=1" if verbose else ""),
            {"queries": list(queries)}, headers)
        assert status == 200 and not body.get("errors"), body
        return body

    def stop(self):
        self.server.stop()
        self.ms.host_memory_manager.stop()
        self.ms.redolog_master.stop_all()


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    clock.set_current_time(NOW)
    d = Daemon(str(tmp_path_factory.mktemp("trc")))
    try:
        assert d.send("/schema/tables", TRIPS)[0] == 200
        assert d.send("/data/trc_trips/0",
                      _upsert(range(1, N_ROWS + 1)))[0] == 200
        d.aql(_query())      # kernels built before any test counts them
        yield d
    finally:
        if tracing.active:
            tracing.stop()
        d.stop()
        clock.reset_clock()


@pytest.fixture
def traced():
    """Tracing on for the test; the spans it kept, once stopped, by
    `traced.stop(requests)`, which first waits for the server to close
    the `http` spans of the requests sent: it answers before it closes
    them."""
    class T:
        def stop(self, requests=1):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with tracing._lock:
                    done = sum(s[0] == "http" for s in tracing._ring)
                if done >= requests:
                    break
                time.sleep(0.005)
            return tracing.stop()

    t = T()
    tracing.start()
    try:
        yield t
    finally:
        if tracing.active:
            tracing.stop()


def _by_trace(spans):
    out = {}
    for s in spans:
        out.setdefault(s.trace, []).append(s)
    return out


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, [s.name for s in spans])
    return found[0]


def _within(child, parent):
    return parent.start <= child.start and child.end <= parent.end


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_the_stats_keys_stay_and_off_keeps_nothing(daemon, monkeypatch, on):
    """Off: no span made, no thread CPU read; on or off, the verbose
    context has the parent commit's keys, in its order."""
    made, cpu_reads = [], []
    real_span, real_cpu = tracing.Span, tracing.time.thread_time_ns

    class Counted(real_span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(1)
            super().__init__(*a)

    def counted_cpu():
        cpu_reads.append(1)
        return real_cpu()

    monkeypatch.setattr(tracing, "Span", Counted)
    monkeypatch.setattr(tracing.time, "thread_time_ns", counted_cpu)
    if on:
        tracing.start()
    try:
        ctx = daemon.aql(_query(), verbose=True)["context"][0]
    finally:
        spans = tracing.stop() if on else None
    assert list(ctx) == STATS_KEYS
    assert ctx["batches"] == 4
    if on:
        assert len(made) >= len(spans) > 0 and cpu_reads
    else:
        assert made == [] and cpu_reads == []
        assert tracing.span("x") is tracing.span("y")
        with tracing.stage({}, "x") as span:
            assert span is None


def test_one_request_is_one_trace_from_http_to_the_cards_wait(daemon,
                                                               traced):
    body = daemon.aql(_query(), verbose=True)
    traces = _by_trace(traced.stop())
    assert len(traces) == 1
    spans = next(iter(traces.values()))
    http = _one(spans, "http")
    queue, service = _one(spans, "queue"), _one(spans, "service")
    assert http.parent is None
    assert http.attrs == {"handler": "AQLHandler", "status": 200}
    assert queue.parent == service.parent == http.id
    assert service.thread != http.thread       # the pool's hop
    assert queue.end <= service.start
    for s in spans:
        if s.name in QUERY_STAGES:
            assert s.parent == service.id, s.name
    assert {s.name for s in spans} == {
        "http", "queue", "service", "respond", "deviceWait", *QUERY_STAGES}
    result = _one(spans, "resultFetch")
    waits = [s for s in spans if s.name == "deviceWait"]
    assert waits and all(w.parent == result.id for w in waits)
    assert [s.parent for s in spans if s.name == "respond"] == [http.id] * 2
    batches = [s for s in spans if s.name == "batchExec"]
    transfers = [s for s in spans if s.name == "transfer"]
    assert [b.attrs["route"] for b in batches] == ["dense"] * 4
    # a transfer a batch, and the one that ends the shard's batches
    assert [t.attrs.get("store") for t in transfers] == ["live"] * 4 + [None]
    assert sum(t.attrs.get("rows", 0) for t in transfers) == N_ROWS
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            assert _within(s, by_id[s.parent]), (s.name, by_id[s.parent].name)
        if s.cpu is not None:
            assert s.cpu >= 0
    # the spans' sum is the stats' seconds
    stats = body["context"][0]
    for name in ("batchExec", "transfer", "resultFetch"):
        got = sum(s.end - s.start for s in spans if s.name == name) / 1e9
        assert got == pytest.approx(stats[name], rel=0.01), name


def test_concurrent_requests_keep_their_traces_apart(daemon, traced):
    """Eight requests at once, half with an X-Request-ID."""
    def ask(i):
        headers = {"X-Request-ID": f"req-{i}"} if i % 2 else None
        daemon.aql(_query(), headers=headers)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    traces = _by_trace(traced.stop(requests=8))
    assert len(traces) == 8
    assert {f"req-{i}" for i in (1, 3, 5, 7)} <= set(traces)
    for trace, spans in traces.items():
        ids = {s.id for s in spans}
        assert all(s.parent is None or s.parent in ids for s in spans), trace
        _one(spans, "http")
        service = _one(spans, "service")
        assert sum(s.name == "batchExec" for s in spans) == 4
        assert all(s.parent == service.id for s in spans
                   if s.name in QUERY_STAGES)


def test_the_ring_keeps_the_newest_spans():
    tracing.start(capacity=5)
    try:
        for i in range(8):
            with tracing.span("s", i=i):
                pass
    finally:
        spans = tracing.stop()
    assert [s.attrs["i"] for s in spans] == [3, 4, 5, 6, 7]
    assert tracing.dropped() == 3
    with pytest.raises(RuntimeError):
        tracing.stop()


def test_dbg_trace_writes_a_chrome_trace(daemon, tmp_path):
    assert daemon.send("/dbg/trace/stop")[0] == 400
    (tmp_path / "file").write_text("")
    bad = str(tmp_path / "file" / "spans")
    assert daemon.send("/dbg/trace/start", {"dir": bad})[0] == 400
    assert not tracing.active
    assert daemon.send("/dbg/trace/start", {"dir": str(tmp_path)})[0] == 200
    try:
        assert daemon.send("/dbg/trace/start")[0] == 400
        daemon.aql(_query())
    finally:
        status, body = daemon.send("/dbg/trace/stop")
    assert status == 200 and body["dropped"] == 0
    with open(body["path"]) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert len(events) == body["spans"] > 0
    assert {e["ph"] for e in events} == {"X"}
    names = {e["name"] for e in events}
    assert {"http", "queue", "service", "batchExec", "deviceWait"} <= names
    for e in events:
        assert {"trace", "span", "parent"} <= set(e["args"])
        assert e["dur"] >= 0 and e["ts"] > 0


def _builds(kind):
    return M.root().snapshot()["counters"].get(
        f"{M.QUERY_KERNEL_BUILDS}{{kind={kind}}}", 0)


def test_a_new_plan_structure_builds_one_kernel_and_a_repeat_none(daemon,
                                                                  traced):
    """A filter no other test uses, and no dimension: one dense kernel
    for the four batches."""
    q = _query("count(*)", dims=(), filters=["fare > 17.125"])
    before = _builds("dense")
    daemon.aql(q)
    assert _builds("dense") == before + 1
    daemon.aql(q)
    assert _builds("dense") == before + 1
    spans = traced.stop(requests=2)
    built = [s for s in spans if s.name == "kernelBuild"]
    by_id = {s.id: s for s in spans}
    assert [(b.attrs, by_id[b.parent].name) for b in built] == [
        ({"kind": "dense"}, "batchExec")]


@pytest.mark.parametrize("what", ["upsert", "archiving job"])
def test_ingest_and_job_spans_lie_under_the_request(daemon, traced, what):
    if what == "upsert":
        status, _ = daemon.send("/data/trc_trips/0",
                                _upsert(range(N_ROWS + 1, N_ROWS + 11)))
        names = {"saveUpsertBatch", "redoLogAppend", "applyUpsertBatch"}
    else:
        status, _ = daemon.send("/dbg/trc_trips/0/archiving")
        names = {"job"}
    assert status == 200
    spans = [s for s in traced.stop() if s.name != "respond"]
    assert len(_by_trace(spans)) == 1
    http = _one(spans, "http")
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} - {"http"} >= names
    for s in spans:
        if s.name in names:
            assert _within(s, by_id[s.parent])
    if what == "upsert":
        save = _one(spans, "saveUpsertBatch")
        append = _one(spans, "redoLogAppend")
        assert save.parent == http.id and save.attrs["rows"] == 10
        assert append.parent == save.id and append.thread != save.thread
        assert _one(spans, "applyUpsertBatch").parent == save.id
    else:
        job = _one(spans, "job")
        assert job.parent == http.id
        assert job.attrs == {"kind": "archiving", "table": "trc_trips",
                             "shard": 0}
