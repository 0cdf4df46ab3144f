"""The readers of the program's own spans and of the in-query idle share:
each on a hand-built context whose answer is worked out by hand, None
where its input is absent, importing no JAX; the five span readers on a
CPU rehearsal with the program's tracing on over the window; and
`span_run.py`, which measures them: its idle split and K1 placement on
hand-built spans, and its windows rehearsed on the CPU."""

import importlib
from types import SimpleNamespace as NS

import pytest

from conftest import ROOT  # noqa: F401  (puts the repo on the path)
from portbench import bench, span_run
from test_portbench_isolation import JAX, loaded
from test_portbench_rehearsal import rehearse

SPAN_METRICS = ["queue_wait_ms", "http_self_ms", "batch_cpu_ms",
                "host_wait_pct", "device_wait_ms"]
MODULES = [f"portbench.metrics.{m}"
           for m in SPAN_METRICS + ["idle_in_query_pct"]] + \
    ["portbench.span_run"]
MS = 1_000_000
BASE = 10_000       # the window opens 10 s into the clock


def span(name, sid, parent, trace, start, end, cpu=None, thread=7):
    """A span between start and end ms after BASE ms, cpu ms."""
    return NS(name=name, id=sid, parent=parent, trace=trace,
              start=(BASE + start) * MS, end=(BASE + end) * MS,
              cpu=None if cpu is None else cpu * MS, thread=thread)


def program_spans():
    """Two queries in the window, a (thread 7) and b (thread 8), and c
    after it."""
    return [
        span("http", 1, None, "a", 500, 600, 2),
        span("queue", 2, 1, "a", 500, 510),
        span("service", 3, 1, "a", 510, 590, 40),
        span("admission", 4, 3, "a", 511, 516, 5),
        span("batchExec", 5, 3, "a", 520, 550, 20),
        span("batchExec", 6, 3, "a", 550, 560, 5),
        span("deviceWait", 7, 3, "a", 560, 580, 15),
        span("http", 11, None, "b", 1000, 1200, 3, thread=9),
        span("queue", 12, 11, "b", 1000, 1050, thread=9),
        span("service", 13, 11, "b", 1050, 1150, 30, thread=8),
        span("admission", 14, 13, "b", 1050, 1060, 10, thread=8),
        span("batchExec", 15, 13, "b", 1060, 1100, 10, thread=8),
        span("deviceWait", 16, 13, "b", 1100, 1140, 0, thread=8),
        span("http", 21, None, "c", 15000, 15100, 1),
        span("service", 23, 21, "c", 15010, 15090, 70),
        span("batchExec", 25, 23, "c", 15020, 15080, 60),
    ]


def context(**kw):
    ctx = dict(window=(10.0, 20.0), program_spans=program_spans(),
               spans={"0-1": (10.51, 10.59, None),
                      "0-2": (10.55, 10.65, None),
                      "0-3": (19.95, 20.5, None)},
               device=[("k1", 10.50, 10.53), ("k2", 10.60, 10.62),
                       ("k3", 11.0, 11.1)])
    ctx.update(kw)
    return bench.Context(**ctx)


def read(metric, ctx):
    return importlib.import_module(f"portbench.metrics.{metric}").read(ctx)


@pytest.mark.parametrize("metric,want", [
    ("queue_wait_ms", (10 + 5 + 50 + 10) / 2),
    ("http_self_ms", ((100 - 10 - 80) + (200 - 50 - 100)) / 2),
    ("batch_cpu_ms", (25 + 10) / 2),
    ("device_wait_ms", (20 + 40) / 2),
    # off the CPU outside a device wait: a 80 - 40 - (20 - 15), b 100 -
    # 30 - (40 - 0), over 180 ms of service
    ("host_wait_pct", 100 * 65 / 180),
    # service from 10.51 to 10.65 s, the card busy 10.51-10.53 and
    # 10.60-10.62 in it; the span past the window's close left out
    ("idle_in_query_pct", 100 * (1 - 0.04 / 0.14)),
])
def test_a_reader_on_a_hand_built_context(metric, want):
    assert read(metric, context(window=(10.0, 12.0))) == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("metric", SPAN_METRICS + ["idle_in_query_pct"])
def test_a_reader_reads_none_without_its_input(metric):
    empty = context(window=(30.0, 40.0), program_spans=[], device=[])
    assert read(metric, empty) is None
    missing = context()
    del missing.program_spans
    missing.device = None
    assert read(metric, missing) is None


def test_the_readers_load_no_jax():
    assert loaded(MODULES, JAX) == []


def test_a_rehearsal_with_the_programs_tracing_reads_the_span_metrics(
        monkeypatch):
    """The window traced by the program as well (what the harness's
    Tracer would do): the five span metrics read values; the in-query
    idle share, with no device trace on the CPU, reads none."""
    from aresdb_tpu_torch.utils import tracing

    got = {}
    start, close, per_layer = (bench.Tracer.start, bench.Tracer.close,
                               bench.per_layer)

    def traced_start(self):
        tracing.start()
        start(self)

    def traced_close(self):
        close(self)
        got["spans"] = tracing.stop()

    def reading(cell, ctx):
        ctx.program_spans = got["spans"]
        got.update((m, read(m, ctx))
                   for m in SPAN_METRICS + ["idle_in_query_pct"])
        return per_layer(cell, ctx)

    monkeypatch.setattr(bench.Tracer, "start", traced_start)
    monkeypatch.setattr(bench.Tracer, "close", traced_close)
    monkeypatch.setattr(bench, "per_layer", reading)
    out = rehearse("uber_trips.dash", trace=True)
    assert out["correct"], out["checks"]
    assert "idle_in_query_pct" not in out["metrics"]
    assert got["idle_in_query_pct"] is None
    for m in SPAN_METRICS:
        assert isinstance(got[m], float) and got[m] >= 0, (m, got[m])
    assert got["host_wait_pct"] <= 100


def test_span_run_splits_the_idle_time_in_query_by_the_innermost_span():
    """Query a is in the service 10.51-10.59 s, b 11.05-11.15 s; the card
    runs 10.50-10.53 and 10.60-10.62 (a's second batch and its wait find
    it idle), and nothing in b's time."""
    spans = program_spans()
    device = [("fused_dense_kernel", 10.50, 10.53),
              ("fused_dense_kernel", 10.60, 10.62)]
    got = span_run.idle_split(spans, device, 10.0, 12.0)
    assert got["served_s"] == pytest.approx(0.18)
    assert got["idle_in_query_s"] == pytest.approx(0.06 + 0.10)
    # a: batchExec 10.53-10.56, deviceWait 10.56-10.58, service alone
    # 10.58-10.59; b: admission 11.05-11.06, batchExec 11.06-11.10,
    # deviceWait 11.10-11.14, service alone 11.14-11.15
    assert got["split_s"] == pytest.approx({
        "batchExec": 0.03 + 0.04, "deviceWait": 0.02 + 0.04,
        "service": 0.01 + 0.01, "admission": 0.01})
    assert span_run.subtract([(0, 10)], [(1, 2), (3, 4), (9, 12)]) == \
        [(0, 1), (2, 3), (4, 9)]


def test_span_run_places_each_k1_launch_among_its_querys_spans():
    spans = program_spans()
    device = [("fused_dense_kernel", 10.525, 10.53),   # in a's batchExec
              ("fused_dense_kernel", 10.565, 10.57),   # in a's wait
              ("fused_dense_kernel", 10.595, 10.60),   # after a's service
              ("elementwise", 10.52, 10.53)]           # no K1
    got = span_run.k1_placement(spans, device, 10.0, 12.0)
    assert {k: v for k, v in got.items() if k != "example"} == {
        "inside_batchExec": 1, "after_batchExec_before_wait_end": 1,
        "other": 0, "ambiguous": 1}


def test_span_run_rehearses_its_windows_on_the_cpu():
    """A window with the port's tracing off reads no span metric, one with
    it on reads all five; on the CPU no window has a device trace."""
    from conftest import TINY, TINY_LOAD

    cell = bench.Cell("uber_trips.dash", scale=TINY["uber_trips"],
                      traffic=TINY_LOAD)
    rows = span_run.run(cell, 2 ** 31 + 29, 1.5, "01", True, device="cpu",
                        log=lambda s: None)
    assert [r["mode"] for r in rows] == ["0", "1", "P"]
    for r in rows:
        assert r["failed"] == 0 and r["query_p95_ms"] > 0
        assert isinstance(r["batch_exec_ms"], float)
        assert r["idle_in_query_pct"] is None and "idle_split" not in r
        for m in SPAN_METRICS:
            if r["mode"] == "0":
                assert r[m] is None
            else:
                assert isinstance(r[m], float) and r[m] >= 0, (m, r[m])
    assert "spans" not in rows[0] and rows[1]["spans"] > 0
    assert rows[1]["per_query"]["service"]["n"] == 1
