"""The port's HTTP server against the JAX package's, request by request.

Both servers run in this process over a MemStore each, in a temporary
root of its own, each with a Scheduler that is not started (jobs run only
through /dbg), and both packages' clocks frozen at NOW. One scripted list
of requests (CASES) is replayed against both with urllib; the upserts are
the same bytes. Every request must give the same status code; a JSON body
the same JSON, counts exactly and float sums within 2^-17 relative; any
other body the same bytes (the HLL frames, the redo-log stream, tornado's
error pages). The fields left out, because they depend on the environment
and not on the server, are named by each case's `drop`:
  /dbg/devices      the devices
  verbose contexts  all but batches, rows_scanned and memoryRequired (stage
                    timings, and counters only one executor keeps)
  /dbg/jobs         lastRun and lastDuration
  /metrics          values, and series not tagged with this file's tables
  /dbg/device-cache values (cache bytes, hits and misses of the process)
  /dbg/device       budgetBytes (16 GiB on the port's CPU, the JAX
                    backend's limit on its own)
  /swagger.json     the two summaries that name the JAX or torch runtime,
                    and the port's own /dbg/trace
  /dbg              the page (its labels name the runtime)
The tables are named srvd_* so that no other test file's table of one
name shares a JAX kernel with them (ROADMAP section 3).
"""

from __future__ import annotations

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from aresdb_tpu.api.server import ApiServer as JaxApiServer
from aresdb_tpu.diskstore.local_diskstore import \
    LocalDiskStore as JaxDiskStore
from aresdb_tpu.memstore.memstore import MemStore as JaxMemStore
from aresdb_tpu.memstore.scheduler import Scheduler as JaxScheduler
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JaxMetaStore
from aresdb_tpu.utils import clock as jax_clock
from aresdb_tpu_torch.api.server import ApiServer
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.memstore.scheduler import Scheduler
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.utils import clock

NOW = 1_600_000_000
DAY = 86400
N_ROWS = 400
N_CITIES = 30
STATUSES = ["completed", "canceled", "rejected"]
TRIPS = {
    "name": "srvd_trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": 128, "recordRetentionInDays": 0}}
CITIES = {
    "name": "srvd_cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "population", "type": "Uint32"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 1024}}
RTOL = 2.0 ** -17
TABLES = ("srvd_trips", "srvd_cities")


def _rows():
    """The trips over the two days before NOW (the archiving cutoff, NOW
    less the default delay of a day, falls in the middle), 5% null fares,
    and the cities' populations."""
    rng = np.random.RandomState(11)
    n = N_ROWS
    return {"request_at": (NOW - 1 - rng.randint(0, 2 * DAY, n))
            .astype(np.uint32),
            "id": np.arange(1, n + 1, dtype=np.uint32),
            "city_id": rng.randint(0, N_CITIES, n).astype(np.uint16),
            "status": rng.randint(0, 3, n).astype(np.uint8),
            "fare": (rng.rand(n) * 50).astype(np.float32),
            "fare_valid": rng.rand(n) > 0.05,
            "population": ((np.arange(N_CITIES) + 1) * 1000)
            .astype(np.uint32)}


def _upserts():
    d = _rows()
    half = N_ROWS // 2
    out = []
    for sl in (slice(0, half), slice(half, N_ROWS)):
        n = sl.stop - sl.start
        out.append(build_columnar_upsert(
            [(0, mdt.Uint32, d["request_at"][sl], None, 0),
             (1, mdt.Uint32, d["id"][sl], None, 0),
             (2, mdt.Uint16, d["city_id"][sl], None, 0),
             (3, mdt.SmallEnum, d["status"][sl], None, 0),
             (4, mdt.Float32, d["fare"][sl], d["fare_valid"][sl], 0)],
            n, arrival_time=NOW))
    cities = build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(N_CITIES, dtype=np.uint16), None, 0),
         (1, mdt.Uint32, d["population"], None, 0)], N_CITIES,
        arrival_time=NOW)
    return out, cities


def _q(measure, dims=(), filters=(), **extra):
    q = {"table": "srvd_trips", "now": NOW,
         "measures": [{"sqlExpression": measure,
                       "rowFilters": list(filters)}],
         "dimensions": [dict(d) if isinstance(d, dict)
                        else {"sqlExpression": d} for d in dims]}
    q.update(extra)
    return q


def _aql(*queries, **extra):
    return {"queries": list(queries), **extra}


HOUR_CITY = _q("sum(fare)", [{"sqlExpression": "request_at",
                              "timeBucketizer": "hour"}, "city_id"],
               ["status='completed'"])
AVG_STATUS = _q("avg(fare)", ["status"])
HLL_ID = _q("countdistincthll(id)")
HLL_CITY = _q("countdistincthll(id)", ["city_id"])
JOIN_COUNT = _q("count(*)", filters=["c.population > 15000"],
                joins=[{"table": "srvd_cities", "alias": "c",
                        "conditions": ["c.id = city_id"]}])
LISTING = {"table": "srvd_trips", "now": NOW,
           "measures": [{"sqlExpression": "1"}],
           "dimensions": [{"sqlExpression": "fare"},
                          {"sqlExpression": "city_id"}],
           "rowFilters": ["status='rejected'"], "limit": 50}
NO_DIMS = _q("sum(fare)", filters=["status='completed'"])
COUNT_CITY = _q("count(*)", ["city_id"])
BUCKET = _q("sum(fare)", [{"sqlExpression": "fare",
                           "numericBucketizer": {"bucketWidth": 5.0}}])
CASE_IN = _q("sum(case when status='completed' then fare else 0 end)",
             ["city_id"], ["status in ('completed', 'canceled')"])
MONTH = _q("sum(fare)", [{"sqlExpression": "request_at",
                          "timeBucketizer": "month"}, "city_id"])
MOD_GROUPS = _q("sum(fare)", ["id % 200"])
COUNT = _q("count(*)")
SQL_COUNT = ("SELECT count(*) FROM srvd_trips WHERE fare > 25 AND "
             f"aql_now(request_at, {NOW})")
SQL_SUM = f"SELECT sum(fare) FROM srvd_trips WHERE aql_now(request_at, {NOW})"
HLL_ACCEPT = {"Accept": "application/hll"}
FIRST_LIVE = -2147483648
FIRST_DAY = (NOW - 2 * DAY) // DAY


def _drop_context(body):
    """Keep of each verbose context only batches, rows_scanned and
    memoryRequired."""
    keep = ("batches", "rows_scanned", "memoryRequired")
    body["context"] = [None if c is None else {k: c.get(k) for k in keep}
                       for c in body["context"]]
    return body


def _drop_job_times(body):
    for status in body.values():
        status.pop("lastRun")
        status.pop("lastDuration")
    return body


def _metric_keys(body):
    return {kind: sorted(k for k in series if any(
        f"table={t}" in k for t in TABLES)) for kind, series in body.items()}


def _keys(body):
    return sorted(body)


def _drop_budget(body):
    body.pop("budgetBytes")
    return body


def _drop_runtime_labels(body):
    body["paths"]["/dbg/devices"]["get"].pop("summary")
    body["paths"]["/dbg/profiler/{action}"]["post"].pop("summary")
    body["paths"].pop("/dbg/trace/{action}", None)
    return body


def _drop_session(body):
    body.pop("sessionId")
    return body


def _first_upsert_rows(body):
    """The redo log's first upsert batch as the port's server lists it:
    the first 100 of upsert 1's rows, nulls as None. The JAX server
    answers 500 (its handler calls a `read_value` that its upsert-batch
    columns lack; ROADMAP section 3)."""
    d = _rows()
    want = [[int(d["request_at"][r]), int(d["id"][r]), int(d["city_id"][r]),
             int(d["status"][r]),
             float(d["fare"][r]) if d["fare_valid"][r] else None]
            for r in range(100)]
    assert body == {"numRows": N_ROWS // 2, "columns": [0, 1, 2, 3, 4],
                    "rows": want}


def _case(name, method, path, body=None, headers=None, drop=None,
          capture=None, compare=True, reference_fault=None, port_only=None):
    """One scripted request. body: a dict or list (sent as JSON), bytes or
    None. drop: body -> body with the environment's fields left out.
    capture: body -> {name: value}, formatted into this server's later
    paths. compare: False compares the status and Content-Type only.
    reference_fault: a check of the port's JSON answer where the JAX
    server answers 500 (a fault of the reference). port_only: the port's
    status on a route of its own, which the JAX server answers 404."""
    return {"name": name, "method": method, "path": path, "body": body,
            "headers": headers or {}, "drop": drop, "capture": capture,
            "compare": compare, "reference_fault": reference_fault,
            "port_only": port_only}


def _cases(upserts, cities):
    post, get = "POST", "GET"
    qjson = json.dumps(_aql(HOUR_CITY))
    return [
        _case("create trips", post, "/schema/tables", TRIPS),
        _case("create cities", post, "/schema/tables", CITIES),
        _case("create a table twice", post, "/schema/tables", CITIES),
        _case("enum cases", post,
              "/schema/tables/srvd_trips/columns/status/enum-cases",
              {"enumCases": STATUSES}),
        _case("upsert 1", post, "/data/srvd_trips/0", upserts[0]),
        _case("upsert 2", post, "/data/srvd_trips/0", upserts[1]),
        _case("upsert cities", post, "/data/srvd_cities/0", cities),
        _case("list tables", get, "/schema/tables"),
        _case("get table", get, "/schema/tables/srvd_trips"),
        _case("health", get, "/health"),
        _case("health head", "HEAD", "/health"),
        _case("aql post", post, "/query/aql", _aql(HOUR_CITY)),
        _case("aql get q", get,
              "/query/aql?q=" + urllib.request.quote(qjson)),
        _case("aql dataonly", post, "/query/aql?dataonly=1",
              _aql(AVG_STATUS)),
        _case("aql verbose", post, "/query/aql?verbose=1",
              _aql(AVG_STATUS, COUNT_CITY), drop=_drop_context),
        _case("aql device and timeout", post,
              "/query/aql?device=3&timeout=30", _aql(COUNT_CITY)),
        _case("aql device not numeric", post, "/query/aql?device=x",
              _aql(COUNT_CITY)),
        _case("hll frame overall", post, "/query/aql", _aql(HLL_ID),
              HLL_ACCEPT),
        _case("hll frame by city", post, "/query/aql", _aql(HLL_CITY),
              HLL_ACCEPT),
        _case("hll json by city", post, "/query/aql", _aql(HLL_CITY)),
        _case("join count", post, "/query/aql", _aql(JOIN_COUNT)),
        _case("listing", post, "/query/aql", _aql(LISTING)),
        _case("dense shapes", post, "/query/aql",
              _aql(NO_DIMS, BUCKET, CASE_IN, MONTH)),
        _case("sort path", post, "/query/aql", _aql(MOD_GROUPS)),
        _case("unknown column", post, "/query/aql",
              _aql(_q("sum(no_such_col)"))),
        _case("sql", post, "/query/sql", {"queries": [SQL_COUNT]}),
        _case("sql verbose", post, "/query/sql?verbose=1",
              {"queries": [SQL_SUM]}, drop=_drop_context),
        _case("add column", post, "/schema/tables/srvd_trips/columns",
              {"column": {"name": "tip", "type": "Float32"}}),
        _case("add a column twice", post,
              "/schema/tables/srvd_trips/columns",
              {"column": {"name": "tip", "type": "Float32"}}),
        _case("update column", "PUT",
              "/schema/tables/srvd_trips/columns/tip",
              {"preloadingDays": 3, "priority": 7}),
        _case("delete column", "DELETE",
              "/schema/tables/srvd_trips/columns/tip"),
        _case("delete the key column", "DELETE",
              "/schema/tables/srvd_trips/columns/id"),
        _case("table config", "PUT", "/schema/tables/srvd_cities",
              {"batchSize": 2048}),
        _case("table after changes", get, "/schema/tables/srvd_trips"),
        _case("enum get", get,
              "/schema/tables/srvd_trips/columns/status/enum-cases"),
        _case("enum extend", post,
              "/schema/tables/srvd_trips/columns/status/enum-cases",
              {"enumCases": ["unknown"]}),
        _case("shards", get, "/dbg/shards"),
        _case("shard", get, "/dbg/srvd_trips/0"),
        _case("live batch", get, f"/dbg/srvd_trips/0/batches/{FIRST_LIVE}"),
        _case("live vector party", get,
              f"/dbg/srvd_trips/0/batches/{FIRST_LIVE}/vector-parties/"
              "fare?offset=1&rows=5"),
        _case("primary key", get, "/dbg/srvd_trips/0/primary-keys?key=5"),
        _case("primary key absent", get,
              "/dbg/srvd_trips/0/primary-keys?key=999999"),
        _case("primary key arity", get,
              "/dbg/srvd_trips/0/primary-keys?key=1,2"),
        _case("primary key no table", get, "/dbg/missing/0/primary-keys"
                                           "?key=1"),
        _case("archive", post, "/dbg/srvd_trips/0/archiving"),
        _case("jobs", get, "/dbg/jobs", drop=_drop_job_times),
        _case("jobs archiving", get, "/dbg/jobs/archiving",
              drop=_drop_job_times),
        _case("shard archived", get, "/dbg/srvd_trips/0"),
        _case("archive batch", get, f"/dbg/srvd_trips/0/batches/{FIRST_DAY}"),
        _case("archive vector party", get,
              f"/dbg/srvd_trips/0/batches/{FIRST_DAY}/vector-parties/"
              "city_id?rows=7"),
        _case("no archive batch", get, "/dbg/srvd_trips/0/batches/999"),
        _case("queries after archiving", post, "/query/aql",
              _aql(HOUR_CITY, COUNT_CITY, MOD_GROUPS, COUNT, JOIN_COUNT)),
        _case("hll frame after archiving", post, "/query/aql",
              _aql(HLL_CITY), HLL_ACCEPT),
        _case("sql after archiving", post, "/query/sql",
              {"queries": [SQL_COUNT, SQL_SUM]}),
        _case("backfill queue", get, "/dbg/srvd_trips/0/backfill-queue/0"),
        _case("backfill manager", get,
              "/dbg/srvd_trips/0/backfill-manager/upsertbatches/0"),
        _case("redologs", get, "/dbg/srvd_trips/0/redologs",
              capture=lambda b: {"log": b[0]}),
        _case("redolog batches", get, "/dbg/srvd_trips/0/redologs/{log}"),
        _case("redolog batch", get,
              "/dbg/srvd_trips/0/redologs/{log}/upsertbatches/0",
              reference_fault=_first_upsert_rows),
        _case("redolog stream", get,
              "/peer/srvd_trips/0/redolog/{log}?offset=10"),
        _case("host memory", get, "/dbg/host-memory"),
        _case("device", get, "/dbg/device", drop=_drop_budget),
        _case("device cache", get, "/dbg/device-cache", drop=_keys),
        _case("devices", get, "/dbg/devices", compare=False),
        _case("metrics", get, "/metrics", drop=_metric_keys),
        _case("swagger", get, "/swagger.json", drop=_drop_runtime_labels),
        _case("debug page", get, "/dbg", compare=False),
        _case("peer metadata", get, "/peer/srvd_trips/0/metadata",
              capture=lambda b: {"day": next(iter(b["batches"])),
                                 "vs": "/".join(map(str, next(iter(
                                     b["batches"].values()))[:2]))}),
        _case("peer archive column", get,
              "/peer/srvd_trips/0/archive/{day}/{vs}/4"),
        _case("snapshot cities", post, "/dbg/srvd_cities/0/snapshot"),
        _case("peer cities metadata", get, "/peer/srvd_cities/0/metadata",
              capture=lambda b: {"snap": "/".join(
                  map(str, b["snapshotProgress"][:2] + [
                      next(iter(b["snapshotBatches"]))]))}),
        _case("peer snapshot column", get,
              "/peer/srvd_cities/0/snapshot/{snap}/1"),
        _case("peer session", post, "/peer/srvd_trips/0/session",
              drop=_drop_session,
              capture=lambda b: {"session": b["sessionId"]}),
        _case("peer session keepalive", "PUT",
              "/peer/session/{session}/keepalive"),
        _case("peer session metadata", get,
              "/peer/srvd_trips/0/metadata?session={session}"),
        _case("peer session close", "DELETE", "/peer/session/{session}"),
        _case("peer session expired", "PUT",
              "/peer/session/{session}/keepalive"),
        _case("bootstrap retry", post, "/dbg/bootstrap/retry"),
        _case("profiler stop idle", post, "/dbg/profiler/stop"),
        _case("trace stop idle", post, "/dbg/trace/stop", port_only=400),
        _case("drain off", post, "/health/off"),
        _case("drained health", get, "/health"),
        _case("drain on", post, "/health/on"),
        _case("drain bad switch", post, "/health/maybe"),
        _case("health again", get, "/health"),
        _case("bad upsert", post, "/data/nope/0", b"garbage"),
        _case("upsert unknown table", post, "/data/missing/0", cities),
        _case("bad json", post, "/query/aql", b"{not json"),
        _case("bad q", get, "/query/aql?q=%7Bnot%20json"),
        _case("missing table", get, "/schema/tables/missing"),
        _case("no route", get, "/no/such/route"),
        _case("method not allowed", "PUT", "/health"),
        _case("delete table", "DELETE", "/schema/tables/srvd_cities"),
        _case("tables after delete", get, "/schema/tables"),
    ]


def _send(port, case, captured):
    """(status, Content-Type, body) of one case on the server at port."""
    body = case["body"]
    headers = dict(case["headers"])
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    elif body is not None:
        headers["Content-Type"] = "application/octet-stream"
    path = case["path"].format(**captured)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers,
                                 method=case["method"])
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _start(pkg_root, jax: bool):
    if jax:
        ms = JaxMemStore(JaxMetaStore(pkg_root), JaxDiskStore(pkg_root))
        ms.fetch_schema()
        srv = JaxApiServer(ms, JaxScheduler(ms), port=0)
    else:
        ms = MemStore(DiskMetaStore(pkg_root), LocalDiskStore(pkg_root))
        ms.fetch_schema()
        srv = ApiServer(ms, Scheduler(ms), port=0, device="cpu")
    return srv, srv.start_background(), ms


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """{case name: (JAX server's answer, port's answer)}, each answer
    (status, Content-Type, body bytes)."""
    upserts, cities = _upserts()
    cases = _cases(upserts, cities)
    jax_clock.set_current_time(NOW)
    clock.set_current_time(NOW)
    servers = []
    try:
        for jax in (True, False):
            root = str(tmp_path_factory.mktemp("jax" if jax else "port"))
            servers.append(_start(root, jax))
        answers = {}
        captured = ({}, {})
        for case in cases:
            pair = tuple(_send(port, case, seen) for (_, port, _), seen
                         in zip(servers, captured))
            answers[case["name"]] = (case, pair)
            for (status, _, body), seen in zip(pair, captured):
                if case["capture"] is not None and status == 200:
                    seen.update(case["capture"](json.loads(body)))
        yield answers
    finally:
        for srv, _, ms in servers:
            srv.stop()
            ms.host_memory_manager.stop()
            ms.redolog_master.stop_all()
        jax_clock.reset_clock()
        clock.reset_clock()


def _close(a, b, where):
    """a and b equal as JSON: numbers within RTOL, the rest exactly."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            where
        if not (math.isnan(a) and math.isnan(b)):
            assert a == b or abs(a - b) <= RTOL * max(abs(a), abs(b)), \
                (where, a, b)
    else:
        assert a == b, (where, a, b)


CASE_NAMES = [c["name"] for c in _cases([b""] * 2, b"")]


def test_the_script_covers_every_route():
    """Each route of the port's server is hit by at least one case."""
    import re

    from aresdb_tpu_torch.api.server import ROUTES

    fill = {"log": 1, "day": 1, "vs": "1/0", "snap": "1/0/1", "session": "ab"}
    paths = [c["path"].split("?")[0].format(**fill)
             for c in _cases([b""] * 2, b"")]
    missed = [p for p, _ in ROUTES
              if not any(re.fullmatch(p, path) for path in paths)]
    assert missed == []


@pytest.mark.parametrize("name", CASE_NAMES)
def test_request_answers_alike(replay, name):
    case, ((jstatus, jtype, jbody), (status, ctype, body)) = replay[name]
    if case["port_only"] is not None:
        assert (jstatus, status) == (404, case["port_only"]), name
        return
    if case["reference_fault"] is not None:
        assert jstatus == 500 and status == 200, (jstatus, status)
        case["reference_fault"](json.loads(body))
        return
    assert status == jstatus, (name, jbody[:300], body[:300])
    assert ctype == jtype, name
    if not case["compare"]:
        return
    if ctype == "application/json":
        want, got = json.loads(jbody), json.loads(body)
        if case["drop"] is not None:
            want, got = case["drop"](want), case["drop"](got)
        _close(got, want, name)
    else:
        assert body == jbody, (name, jbody[:300], body[:300])
