"""The port's daemon: build_server, restart and recovery, the command
line, the configuration, and its HTTP server under concurrent clients.

All of it on the CPU (`device="cpu"`); tests/test_torch_server.py holds
the server's answers against the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from aresdb_tpu.common.config import AresServerConfig as JaxConfig
from aresdb_tpu_torch.cmd import aresd
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.config import AresServerConfig
from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert
from aresdb_tpu_torch.utils import clock

ROOT = Path(__file__).resolve().parent.parent
NOW = 1_600_000_000
DAY = 86400
TRIPS = {
    "name": "aresd_trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 4096, "recordRetentionInDays": 0}}
CITIES = {
    "name": "aresd_cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "population", "type": "Uint32"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 1024}}


def _q(measure, dims=(), filters=(), **extra):
    return {"table": "aresd_trips", "now": NOW,
            "measures": [{"sqlExpression": measure,
                          "rowFilters": list(filters)}],
            "dimensions": [dict(d) if isinstance(d, dict)
                           else {"sqlExpression": d} for d in dims],
            **extra}


COUNT = _q("count(*)")
# (route, body): one of each query class the server answers
MIXED = [
    ("aql", {"queries": [_q("sum(fare)", [{"sqlExpression": "request_at",
                                           "timeBucketizer": "hour"},
                                          "city_id"],
                            ["status='completed'"])]}),
    ("aql", {"queries": [_q("sum(fare)", ["id % 997"])]}),
    ("aql", {"queries": [_q("count(*)", ["c.population"], joins=[
        {"table": "aresd_cities", "alias": "c",
         "conditions": ["c.id = city_id"]}])]}),
    ("aql", {"queries": [_q("countdistincthll(id)", ["city_id"])]}),
    ("aql", {"queries": [{"table": "aresd_trips", "now": NOW,
                          "measures": [{"sqlExpression": "1"}],
                          "dimensions": [{"sqlExpression": "fare"},
                                         {"sqlExpression": "city_id"}],
                          "rowFilters": ["status='rejected'"],
                          "limit": 20}]}),
    ("sql", {"queries": ["SELECT count(*) FROM aresd_trips WHERE fare > 25 "
                         f"AND aql_now(request_at, {NOW})"]}),
]


def _config(root, **kw) -> AresServerConfig:
    return AresServerConfig.load(None, {"root_path": str(root), "port": 0,
                                        "scheduler_off": True, **kw})


def _call(port, route, body=None, method="POST"):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{route}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        out = r.read()
    return json.loads(out) if out[:1] in (b"{", b"[") else out


def _load(port, n_rows: int, seed: int = 0) -> None:
    """The tables, the enum cases and n_rows trips over the two days before
    NOW, in two upserts, over HTTP."""
    rng = np.random.RandomState(seed)
    _call(port, "schema/tables", TRIPS)
    _call(port, "schema/tables", CITIES)
    _call(port, "schema/tables/aresd_trips/columns/status/enum-cases",
          {"enumCases": ["completed", "canceled", "rejected"]})
    half = n_rows // 2
    for lo, hi in ((0, half), (half, n_rows)):
        n = hi - lo
        _call(port, "data/aresd_trips/0", build_columnar_upsert(
            [(0, mdt.Uint32, (NOW - 1 - rng.randint(0, 2 * DAY, n))
              .astype(np.uint32), None, 0),
             (1, mdt.Uint32, np.arange(lo, hi, dtype=np.uint32), None, 0),
             (2, mdt.Uint16, rng.randint(0, 50, n).astype(np.uint16), None,
              0),
             (3, mdt.SmallEnum, rng.randint(0, 3, n).astype(np.uint8), None,
              0),
             (4, mdt.Float32, (rng.rand(n) * 50).astype(np.float32),
              rng.rand(n) > 0.05, 0)], n))
    _call(port, "data/aresd_cities/0", build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(50, dtype=np.uint16), None, 0),
         (1, mdt.Uint32, np.arange(50, dtype=np.uint32) * 1000, None, 0)],
        50))


def _shutdown(server, memstore, scheduler) -> None:
    server.stop()
    scheduler.stop()
    memstore.host_memory_manager.stop()
    memstore.redolog_master.stop_all()


@pytest.fixture
def frozen_clock():
    clock.set_current_time(NOW)
    yield
    clock.reset_clock()


def test_build_server_ingests_answers_and_recovers(tmp_path, frozen_clock):
    """A daemon over a root: ingest and query over HTTP, archive the first
    day; then stopped, and a new one over the same root recovers the
    archive and the redo log and answers the same."""
    cfg = _config(tmp_path)
    server, ms, sched = aresd.build_server(cfg, device="cpu")
    port = server.start_background()
    try:
        assert _call(port, "health", method="GET") == b"OK"
        _load(port, 3000)
        assert _call(port, "query/aql", {"queries": [COUNT]})[
            "results"] == [{"": 3000.0}]
        job = _call(port, "dbg/aresd_trips/0/archiving")
        assert job["result"]["rowsArchived"] > 1000
        before = [_call(port, f"query/{r}", b) for r, b in MIXED]
    finally:
        _shutdown(server, ms, sched)
    server, ms, sched = aresd.build_server(cfg, device="cpu")
    port = server.start_background()
    try:
        assert server.ctx.device.type == "cpu"
        shard = _call(port, "dbg/aresd_trips/0", method="GET")
        assert len(shard["archiveStore"]["batches"]) == 2
        assert _call(port, "query/aql", {"queries": [COUNT]})[
            "results"] == [{"": 3000.0}]
        after = [_call(port, f"query/{r}", b) for r, b in MIXED]
        for x, y in zip(before, after):
            _same(x, y)
    finally:
        _shutdown(server, ms, sched)


def _same(a, b):
    """Equal JSON, float sums within 2^-17 relative (a recovered store
    may add its rows in another order)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=2.0 ** -17)
    else:
        assert a == b


def _serving_port(proc, prefix: str) -> int:
    """The port a daemon's start-up line on stderr names."""
    line = proc.stderr.readline()
    assert line.startswith(prefix), line
    return int(line.split(" on :")[1].split()[0])


def _until(fn, what: str, timeout: float = 60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_main_runs_a_datanode_with_a_controller(tmp_path):
    """The three daemons as a user starts them: `cmd.controller --port 0`,
    `cmd.aresd --controller ... --device cpu` (main -> run_datanode) and
    `cmd.broker --port 0`. The datanode registers with the controller,
    takes the shards the placement gives it, answers /health and the
    bootstrap retry, and the broker answers /health and a count over both
    shards; the controller, as the JAX package's, has no /health."""
    procs = []

    def start(module, *args):
        proc = subprocess.Popen(
            [sys.executable, "-m", f"aresdb_tpu_torch.cmd.{module}", *args],
            cwd=ROOT, stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc

    try:
        cport = _serving_port(start("controller", "--port", "0",
                                    "--root-path", str(tmp_path / "ctrl")),
                              "ares-controller serving on :")
        assert _call(cport, "leader", method="GET") == {"mode": "single",
                                                        "isLeader": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            _call(cport, "health", method="GET")
        assert e.value.code == 404
        _call(cport, "namespaces", {"namespace": "ns"})
        _call(cport, "schema/ns/tables", TRIPS)
        _call(cport, "schema/ns/tables/aresd_trips/columns/status/"
                     "enum-cases", {"enumCases": ["completed"]})
        node = start("aresd", "--controller", f"localhost:{cport}",
                     "--namespace", "ns", "--instance", "dnx", "--port", "0",
                     "--device", "cpu", "--root-path", str(tmp_path / "dn"),
                     "--scheduler-off")
        nport = _serving_port(node, "aresd datanode 'dnx' serving on :")
        _until(lambda: "dnx" in _call(cport, "membership/ns/instances",
                                      method="GET"), "the registration")
        _call(cport, "placement/ns/datanode",
              {"numShards": 2, "replicaFactor": 1, "instances": ["dnx"]})
        _until(lambda: all(set(sd["instances"].values()) == {"Available"}
                           for sd in _call(cport, "placement/ns/datanode",
                                           method="GET")["shards"]),
               "the shards to turn Available")
        for shard, ids in ((0, np.arange(0, 30)), (1, np.arange(30, 50))):
            n = len(ids)
            _call(nport, f"data/aresd_trips/{shard}", build_columnar_upsert(
                [(0, mdt.Uint32, np.full(n, NOW - 60, np.uint32), None, 0),
                 (1, mdt.Uint32, ids.astype(np.uint32), None, 0),
                 (2, mdt.Uint16, np.zeros(n, np.uint16), None, 0),
                 (3, mdt.SmallEnum, np.zeros(n, np.uint8), None, 0),
                 (4, mdt.Float32, np.ones(n, np.float32), None, 0)], n))
        with urllib.request.urlopen(f"http://127.0.0.1:{nport}/health",
                                    timeout=30) as r:
            assert r.read() == b"OK"
        assert _call(nport, "dbg/bootstrap/retry") == {"retried": []}
        bport = _serving_port(start("broker", "--port", "0", "--controller",
                                    f"localhost:{cport}", "--namespace",
                                    "ns"), "ares-broker serving on :")
        with urllib.request.urlopen(f"http://127.0.0.1:{bport}/health",
                                    timeout=30) as r:
            assert r.read() == b"OK"
        count = {"queries": [_q("count(*)")]}
        assert _until(lambda: "errors" not in _call(bport, "query/aql",
                                                    count),
                      "the broker's topology")
        assert _call(bport, "query/aql", count) == {"results": [{"": 50.0}]}
        assert all(p.poll() is None for p in procs)
    finally:
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=30)
            proc.stderr.close()


def test_the_module_starts_and_serves_health(tmp_path):
    """python -m aresdb_tpu_torch.cmd.aresd --device cpu --port 0: it
    prints the port it bound and answers /health; importing it loaded
    neither tornado, requests, yaml nor jax."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "aresdb_tpu_torch.cmd.aresd", "--device",
         "cpu", "--port", "0", "--root-path", str(tmp_path),
         "--scheduler-off"], cwd=ROOT, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith("aresd serving on :"), line
        port = int(line.split(":")[1].split()[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            assert r.read() == b"OK"
        devices = _call(port, "dbg/devices", method="GET")
        assert devices == {"devices": [{"id": 0, "platform": "cpu",
                                        "kind": "cpu"}]}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
    code = ("import sys, aresdb_tpu_torch.cmd.aresd, "
            "aresdb_tpu_torch.api.server; "
            "print(sorted(m for m in ('tornado', 'requests', 'yaml', 'jax',"
            " 'aresdb_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


@pytest.mark.parametrize("source", ["defaults", "overrides", "yaml"])
def test_config_load_equals_the_jax_packages(tmp_path, source):
    overrides = {}
    path = None
    if source != "defaults":
        overrides = {"port": 0, "root_path": str(tmp_path),
                     "scheduler_off": True, "query.query_timeout": 5,
                     "cluster.namespace": "ns"}
    if source == "yaml":
        path = tmp_path / "ares.yaml"
        path.write_text(
            "port: 9999\nroot_path: r\nquery:\n"
            "  device_memory_utilization: 0.5\n"
            "  device_choosing_timeout: 7\n  query_timeout: 3\n"
            "  timezone_table:\n    table_name: tz\n"
            "redo_log:\n  disk:\n    enabled: false\n"
            "http:\n  max_connections: 5\n")
        overrides = {"port": 0}
    got = AresServerConfig.load(path and str(path), overrides)
    want = JaxConfig.load(path and str(path), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if source == "yaml":
        assert got.query.timezone_table.table_name == "tz"
        assert got.port == 0 and got.http.max_connections == 5


@pytest.fixture
def daemon(tmp_path, frozen_clock):
    server, ms, sched = aresd.build_server(_config(tmp_path), device="cpu")
    port = server.start_background()
    yield port
    _shutdown(server, ms, sched)


def test_concurrent_clients_get_their_serial_answers(daemon):
    """8 client threads x 20 mixed requests (dense, keyed, join, HLL,
    listing, SQL), with a short switch interval: every answer equals the
    same request's serial answer."""
    _load(daemon, 2000)
    serial = [_call(daemon, f"query/{r}", b) for r, b in MIXED]
    errors = []

    def client(i):
        try:
            for j in range(20):
                k = (i + j) % len(MIXED)
                route, body = MIXED[k]
                got = _call(daemon, f"query/{route}", body)
                if got != serial[k]:
                    errors.append((i, j, k))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    stats = _call(daemon, "dbg/device", method="GET")
    assert stats["inUseBytes"] == 0 and stats["running"] == 0


def test_count_stays_whole_while_archiving(daemon):
    """count(*) asked again and again while the archiving job runs on
    another thread always answers every row: the executor snapshots the
    live batches first, then reads one archive version."""
    n = 40_000
    _load(daemon, n)
    job = {}
    counts = []
    started = threading.Event()

    def archive():
        started.set()
        job.update(_call(daemon, "dbg/aresd_trips/0/archiving"))

    t = threading.Thread(target=archive)
    t.start()
    started.wait(timeout=10)
    during = 0
    while t.is_alive() or during == 0:
        counts.append(_call(daemon, "query/aql", {"queries": [COUNT]})[
            "results"][0][""])
        during += t.is_alive()
        if not t.is_alive() and len(counts) > 200:
            break
    t.join(timeout=120)
    assert not t.is_alive()
    assert job["result"]["rowsArchived"] > n // 4
    for _ in range(3):
        counts.append(_call(daemon, "query/aql", {"queries": [COUNT]})[
            "results"][0][""])
    assert set(counts) == {float(n)}, sorted(set(counts))
    assert during >= 1


def _status(port, route, body=None):
    """(status, JSON body) of one POST, errors included."""
    try:
        return 200, _call(port, route, {} if body is None else body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profiler_traces_into_the_directory_given(daemon, tmp_path):
    """/dbg/profiler/start and stop drive torch.profiler on one thread of
    the server's: stop writes a Chrome trace into start's directory;
    starting twice, or stopping with no trace running, is a 400."""
    d = tmp_path / "trace"
    assert _status(daemon, "dbg/profiler/stop")[0] == 400
    assert _status(daemon, "dbg/profiler/start", {"dir": str(d)}) == (
        200, {"message": f"tracing to {d}"})
    status, body = _status(daemon, "dbg/profiler/start", {"dir": str(d)})
    assert status == 400 and "already been started" in body["message"]
    _call(daemon, "query/aql", {"queries": [COUNT]})
    assert _status(daemon, "dbg/profiler/stop") == (
        200, {"message": "trace stopped"})
    (trace,) = d.glob("trace-*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    assert _status(daemon, "dbg/profiler/stop") == (
        400, {"message": "No profile started"})
