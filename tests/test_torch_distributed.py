"""The port's cluster against the JAX package's, request by request.

Each cluster runs in this process, as tests/test_distributed.py runs the
JAX one: a controller, two datanodes (dn0, dn1) over MemStores of their
own, 4 shards at replica factor 1, and a broker over a DynamicTopology
with a controller-synced schema view. The port's datanodes run on the
CPU. Both packages' clocks are frozen at NOW, and each datanode's
scheduler is paused, so that jobs run only through /dbg. The same
upsert bytes go into both: the battery's trips rows of chip_smoke.py, one
contiguous quarter a shard, each to its shard's owner, and the cities to
the owner of shard 0, the shard a joined table is read from.

One scripted list of requests (CASES) is replayed against both
controllers and brokers with urllib. Every request must give the same
status code; a JSON body the same JSON, counts exactly and float sums
within 2^-17 relative; any other body the same bytes (the HLL frames,
tornado's error pages). Left out, because they depend on the environment:
  membership  the ports, heartbeat ages and heartbeat row counts
  verbose     each datanode's stage stats but batches, rows_scanned and
              memoryRequired, and the order the datanodes answered in
  errors      the host:port in a message
The listing (B6) concatenates each node's rows up to its limit, so it is
compared as a multiset of rows, each one a rejected trip. B5, the join to
cities, fails on the node that lacks shard 0 of cities, and the broker
then marks that node unhealthy (a difference of the reference cluster
from one node, ROADMAP section 3), as it marks every node that answers
an error, an unknown column's too: B5 runs last in each battery, and a
count after it and after the unknown column shows the mark. The brokers
keep a mark for UNHEALTHY_TTL, far longer than the test, so that the
count after a failure sees it on both clusters however slow the host;
the test then clears every mark with `mark_healthy`.

Then the clock moves 14 hours, each owner archives its shards through
/dbg, and the broker battery runs again; then a third node, dn2, replaces
dn1 through /placement/{ns}/datanode/replace, bootstraps dn1's shards
from it (archive batches and redo logs), and the battery runs again: each
answer equal to the JAX cluster's and to the one before the migration.
Last, the port's broker retries a node that refuses connections and
marks it unhealthy. The tables are named dist_* so that no other test
file's table of one name shares a JAX kernel with them (ROADMAP
section 3).
"""

from __future__ import annotations

import json
import math
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as CS
from aresdb_tpu.broker.server import BrokerServer as JaxBroker
from aresdb_tpu.broker.validator import BrokerSchemaView as JaxSchemaView
from aresdb_tpu.cluster.topology import DynamicTopology as JaxTopology
from aresdb_tpu.cluster.topology import \
    HealthTrackingTopology as JaxHealth
from aresdb_tpu.controller.server import ControllerServer as JaxController
from aresdb_tpu.controller.state import ControllerState as JaxState
from aresdb_tpu.datanode.datanode import DataNode as JaxDataNode
from aresdb_tpu.diskstore.local_diskstore import LocalDiskStore as JaxDisk
from aresdb_tpu.memstore.memstore import MemStore as JaxMemStore
from aresdb_tpu.memstore.scheduler import Scheduler as JaxScheduler
from aresdb_tpu.metastore.disk_metastore import DiskMetaStore as JaxMeta
from aresdb_tpu.utils import clock as jax_clock
from aresdb_tpu.utils import metrics as jax_metrics
from aresdb_tpu_torch.broker.executor import RETRIES, BrokerError
from aresdb_tpu_torch.broker.executor import BrokerExecutor
from aresdb_tpu_torch.broker.server import BrokerServer
from aresdb_tpu_torch.broker.validator import BrokerSchemaView
from aresdb_tpu_torch.cluster.topology import (SHARD_AVAILABLE,
                                               DynamicTopology,
                                               HealthTrackingTopology,
                                               HostInstance, StaticTopology,
                                               TopologyView)
from aresdb_tpu_torch.common import data_types as mdt
from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert
from aresdb_tpu_torch.controller.server import ControllerServer
from aresdb_tpu_torch.controller.state import ControllerState
from aresdb_tpu_torch.datanode.datanode import DataNode
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.memstore.scheduler import Scheduler
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.utils import clock
from aresdb_tpu_torch.utils.http_client import Session

NS = "dist"
CTL = "dist_ctl"          # a namespace of the controller's routes alone
NOW = CS.SERVER_NOW
N_ROWS = 400
N_SHARDS = 4
RTOL = 2.0 ** -17
# the brokers keep an unhealthy mark this many seconds (the default is
# 30): no mark expires within the test, which clears them itself once
# the count after a failure has shown them (`settle`)
UNHEALTHY_TTL = 3600.0
TRIPS = dict(CS.SERVER_TRIPS_JSON, name="dist_trips",
             config={"batchSize": 64, "recordRetentionInDays": 0})
CITIES = dict(CS.CITIES_SCHEMA_JSON, name="dist_cities")
SIDES = {
    "jax": SimpleNamespace(
        Controller=JaxController, State=JaxState, DataNode=JaxDataNode,
        MemStore=JaxMemStore, Meta=JaxMeta, Disk=JaxDisk,
        Scheduler=JaxScheduler, Broker=JaxBroker, Topology=JaxTopology,
        SchemaView=JaxSchemaView, Health=JaxHealth, device={}),
    "port": SimpleNamespace(
        Controller=ControllerServer, State=ControllerState,
        DataNode=DataNode, MemStore=MemStore, Meta=DiskMetaStore,
        Disk=LocalDiskStore, Scheduler=Scheduler, Broker=BrokerServer,
        Topology=DynamicTopology, SchemaView=BrokerSchemaView,
        Health=HealthTrackingTopology, device={"device": "cpu"}),
}


def _renamed(q):
    """A battery query (or SQL statement) over the dist_* tables."""
    if isinstance(q, str):
        return q.replace("FROM trips", "FROM dist_trips")
    return json.loads(json.dumps(q).replace('"trips"', '"dist_trips"')
                      .replace('"cities"', '"dist_cities"'))


SHAPES = {name: (route, _renamed(q))
          for name, (route, q) in CS.server_queries().items()}
SQL_NOW = f"aql_now(request_at, {NOW})"
# more of the shapes as SQL, beside the battery's B7 and B9
SQL_SHAPES = {
    "B2 sql": f"SELECT status, avg(fare) FROM dist_trips WHERE {SQL_NOW} "
              "GROUP BY status",
    "B8 sql": "SELECT sum(fare) FROM dist_trips WHERE status = 'completed' "
              f"AND {SQL_NOW}",
    "B10 sql": f"SELECT city_id, count(*) FROM dist_trips WHERE {SQL_NOW} "
               "GROUP BY city_id",
}


def _q(measure, dims=(), **extra):
    return {"table": "dist_trips", "now": NOW,
            "measures": [{"sqlExpression": measure}],
            "dimensions": [{"sqlExpression": d} for d in dims], **extra}


HLL = {"Accept": "application/hll"}


def _case(name, target, method, path, body=None, headers=None, drop=None,
          compare="json", settle=False):
    """One scripted request to the controller or the broker (`target`).
    body: a dict or list (sent as JSON), bytes or None. drop: body ->
    body with the environment's fields left out. compare: "json",
    "bytes" or "listing" (rows as a multiset). settle: clear the
    brokers' unhealthy marks after it."""
    return {"name": name, "target": target, "method": method, "path": path,
            "body": body, "headers": headers or {}, "drop": drop,
            "compare": compare, "settle": settle}


def _drop_ports(body):
    for v in body.values():
        for k in ("port", "lastHeartbeatAgoSec", "rows"):
            v.pop(k, None)
    return body


def _drop_stats(body):
    keep = ("batches", "rows_scanned", "memoryRequired")
    for per_query in body.get("context") or []:
        for entry in per_query or []:
            stats = entry.get("stats")
            if stats is not None:
                entry["stats"] = {k: stats.get(k) for k in keep}
        per_query.sort(key=lambda entry: entry["host"])
    return body


def _broker_battery(stage, extras=()):
    """The broker's requests: the 14 shapes through their routes, more of
    them as SQL, HLL as frames, a verbose count, `extras`; B5 last, then a
    count. A node that lacks shard 0 of the joined table fails B5, and the
    broker marks it unhealthy (ROADMAP section 3): the count after it
    shows that."""
    out = []
    for name, (route, q) in SHAPES.items():
        if name == "B5":
            continue
        out.append(_case(f"{name}{stage}", "broker", "POST", f"/query/{route}",
                         {"queries": [q]},
                         compare="listing" if name == "B6" else "json"))
    for name, stmt in SQL_SHAPES.items():
        out.append(_case(f"{name}{stage}", "broker", "POST", "/query/sql",
                         {"queries": [stmt]}))
    for name in ("B3", "B4"):
        out.append(_case(f"{name} frame{stage}", "broker", "POST",
                         "/query/aql", {"queries": [SHAPES[name][1]]}, HLL,
                         compare="bytes"))
    out.append(_case(f"verbose count{stage}", "broker", "POST", "/query/aql",
                     {"verbose": True, "queries": [_q("count(*)")]},
                     drop=_drop_stats))
    out += list(extras)
    out.append(_case(f"B5{stage}", "broker", "POST", "/query/aql",
                     {"queries": [SHAPES["B5"][1]]}))
    out.append(_case(f"after B5{stage}", "broker", "POST", "/query/aql",
                     {"queries": [_q("count(*)")]}, settle=True))
    return out


STAGES = ("", " archived", " migrated")


def _cases():
    post, get, put, delete = "POST", "GET", "PUT", "DELETE"
    job = {"name": "etl1", "table": "dist_trips", "topic": "trips-events"}
    ctl = {
        "setup": [
            _case("create namespace", "ctrl", post, "/namespaces",
                  {"namespace": NS}),
            _case("create ctl namespace", "ctrl", post, "/namespaces",
                  {"namespace": CTL}),
            _case("namespace twice", "ctrl", post, "/namespaces",
                  {"namespace": NS}),
            _case("namespace bad json", "ctrl", post, "/namespaces",
                  b"{not json", compare="bytes"),
            _case("namespaces", "ctrl", get, "/namespaces"),
            _case("create trips", "ctrl", post, f"/schema/{NS}/tables",
                  TRIPS),
            _case("create cities", "ctrl", post, f"/schema/{NS}/tables",
                  CITIES),
            _case("create ctl table", "ctrl", post, f"/schema/{CTL}/tables",
                  dict(CITIES, name="ctl_cities")),
            _case("table twice", "ctrl", post, f"/schema/{NS}/tables",
                  CITIES),
            _case("table bad column type", "ctrl", post,
                  f"/schema/{CTL}/tables",
                  dict(CITIES, name="bad", columns=[
                      {"name": "id", "type": "NoSuchType"}])),
            _case("table unknown namespace", "ctrl", post,
                  "/schema/nope/tables", CITIES),
            _case("enum cases", "ctrl", post,
                  f"/schema/{NS}/tables/dist_trips/columns/status/"
                  "enum-cases", {"enumCases": CS.STATUSES}),
            _case("enum cases again", "ctrl", post,
                  f"/schema/{NS}/tables/dist_trips/columns/status/"
                  "enum-cases", {"enumCases": ["rejected", "unknown"]}),
            _case("enum get", "ctrl", get,
                  f"/schema/{NS}/tables/dist_trips/columns/status/"
                  "enum-cases"),
            _case("schema tables", "ctrl", get, f"/schema/{NS}/tables"),
            _case("schema hash", "ctrl", get, f"/schema/{NS}/hash"),
            _case("schema hash unknown namespace", "ctrl", get,
                  "/schema/nope/hash"),
            _case("table get", "ctrl", get,
                  f"/schema/{NS}/tables/dist_trips"),
            _case("table get unknown", "ctrl", get,
                  f"/schema/{NS}/tables/nope"),
            _case("table put mismatch", "ctrl", put,
                  f"/schema/{CTL}/tables/other",
                  dict(CITIES, name="ctl_cities")),
            _case("table put", "ctrl", put,
                  f"/schema/{CTL}/tables/ctl_cities",
                  dict(CITIES, name="ctl_cities",
                       config={"batchSize": 2048})),
            _case("table put unknown", "ctrl", put,
                  f"/schema/{CTL}/tables/nope", dict(CITIES, name="nope")),
            _case("table delete", "ctrl", delete,
                  f"/schema/{CTL}/tables/ctl_cities"),
            _case("table delete unknown", "ctrl", delete,
                  f"/schema/{CTL}/tables/ctl_cities"),
            _case("no route", "ctrl", get, "/no/such/route",
                  compare="bytes"),
            _case("method not allowed", "ctrl", put, "/namespaces",
                  compare="bytes"),
            _case("leader", "ctrl", get, "/leader"),
            _case("ui", "ctrl", get, "/ui/", compare="bytes"),
        ],
        "placement": [
            _case("placement", "ctrl", post, f"/placement/{NS}/datanode",
                  {"numShards": N_SHARDS, "replicaFactor": 1,
                   "instances": ["dn0", "dn1"]}),
            _case("placement twice", "ctrl", post,
                  f"/placement/{NS}/datanode",
                  {"numShards": N_SHARDS, "replicaFactor": 1,
                   "instances": ["dn0", "dn1"]}),
            _case("placement no body", "ctrl", post,
                  f"/placement/{NS}/datanode"),
        ],
        "placed": [
            _case("placement get", "ctrl", get, f"/placement/{NS}/datanode"),
            _case("placement kinds", "ctrl", get, f"/placements/{NS}"),
            _case("placement unknown kind", "ctrl", get,
                  f"/placement/{NS}/broker"),
            _case("membership", "ctrl", get,
                  f"/membership/{NS}/instances", drop=_drop_ports),
            _case("membership all", "ctrl", get,
                  f"/membership/{NS}/instances?all=1", drop=_drop_ports),
            _case("membership unknown namespace", "ctrl", get,
                  "/membership/nope/instances"),
            _case("join a", "ctrl", post, f"/membership/{CTL}/instances",
                  {"name": "a", "host": "h", "port": 1}),
            _case("join b", "ctrl", post, f"/membership/{CTL}/instances",
                  {"name": "b", "host": "h", "port": 2}),
            _case("join c", "ctrl", post, f"/membership/{CTL}/instances",
                  {"name": "c", "host": "h", "port": 3}),
            _case("join no port", "ctrl", post,
                  f"/membership/{CTL}/instances", {"name": "x", "host": "h"},
                  compare="bytes"),
            _case("ctl placement", "ctrl", post, f"/placement/{CTL}/datanode",
                  {"numShards": 4, "replicaFactor": 1,
                   "instances": ["a"]}),
            _case("ctl available a", "ctrl", post,
                  f"/placement/{CTL}/datanode/a/available", {}),
            _case("heartbeat a", "ctrl", put,
                  f"/membership/{CTL}/instances/a",
                  {"shardRows": {"0": 1_000_000, "1": 1000, "2": 1000,
                                 "3": 1000}}),
            _case("heartbeat b", "ctrl", put,
                  f"/membership/{CTL}/instances/b", {"shardRows": {}}),
            _case("heartbeat no body", "ctrl", put,
                  f"/membership/{CTL}/instances/c"),
            _case("heartbeat unknown", "ctrl", put,
                  f"/membership/{CTL}/instances/zz", {}),
            _case("leave c", "ctrl", delete,
                  f"/membership/{CTL}/instances/c"),
            _case("rebalance", "ctrl", post,
                  f"/placement/{CTL}/datanode/rebalance", {}),
            _case("ctl placement after rebalance", "ctrl", get,
                  f"/placement/{CTL}/datanode"),
            _case("ctl available all", "ctrl", post,
                  f"/placement/{CTL}/datanode/b/available", {}),
            _case("ctl replace", "ctrl", post,
                  f"/placement/{CTL}/datanode/replace",
                  {"leaving": "a", "joining": "b"}),
            _case("ctl placement replacing", "ctrl", get,
                  f"/placement/{CTL}/datanode"),
            _case("rebalance unknown kind", "ctrl", post,
                  f"/placement/{CTL}/broker/rebalance", {}),
            _case("available unknown kind", "ctrl", post,
                  f"/placement/{CTL}/broker/a/available", {"shardId": 1}),
            _case("jobs post", "ctrl", post, f"/config/{NS}/jobs", job),
            _case("jobs assignment post", "ctrl", post,
                  f"/assignment/{NS}/jobs",
                  dict(job, name="etl2", cluster="k1",
                       config={"partitions": 4})),
            _case("jobs get", "ctrl", get, f"/config/{NS}/jobs"),
            _case("job get", "ctrl", get, f"/config/{NS}/jobs/etl1"),
            _case("job put", "ctrl", put, f"/config/{NS}/jobs/etl1",
                  {"table": "dist_trips", "topic": "trips-v2"}),
            _case("job get after put", "ctrl", get,
                  f"/config/{NS}/jobs/etl1"),
            _case("job missing", "ctrl", get, f"/config/{NS}/jobs/none"),
            _case("jobs unknown namespace", "ctrl", get,
                  "/config/nope/jobs"),
            _case("assignment s1", "ctrl", get,
                  f"/assignment/{NS}/subscribers/s1"),
            _case("assignment s2", "ctrl", get,
                  f"/assignment/{NS}/subscribers/s2"),
            _case("assignment unknown namespace", "ctrl", get,
                  "/assignment/nope/subscribers/s1"),
            _case("job delete", "ctrl", delete, f"/config/{NS}/jobs/etl1"),
            _case("job gone", "ctrl", get, f"/config/{NS}/jobs/etl1"),
        ],
        "replace": [
            _case("replace dn1", "ctrl", post,
                  f"/placement/{NS}/datanode/replace",
                  {"leaving": "dn1", "joining": "dn2"}),
        ],
        "replaced": [
            _case("placement after replace", "ctrl", get,
                  f"/placement/{NS}/datanode"),
        ],
    }
    extras = [
        _case("avg fare", "broker", "POST", "/query/aql",
              {"queries": [_q("avg(fare)")]}),
        _case("min and max", "broker", "POST", "/query/aql",
              {"queries": [_q("min(fare)", ["city_id"]),
                           _q("max(fare)", ["status"])]}),
        _case("composite", "broker", "POST", "/query/aql",
              {"queries": [{**_q("count(*)", ["status"]), "measures": [
                  {"sqlExpression": "count(*)", "alias": "n"},
                  {"sqlExpression": "sum(fare)", "alias": "s"},
                  {"sqlExpression": "s / n", "alias": "mean"}]}]}),
        _case("frame of a count", "broker", "POST", "/query/aql",
              {"queries": [_q("count(*)"), SHAPES["B3"][1]]}, HLL,
              compare="bytes"),
        _case("unknown table", "broker", "POST", "/query/aql",
              {"queries": [dict(_q("count(*)"), table="nope")]}),
        _case("unknown join table", "broker", "POST", "/query/aql",
              {"queries": [_q("count(*)", joins=[{"table": "nope",
                                                  "alias": "n"}])]}),
        _case("two measures", "broker", "POST", "/query/aql",
              {"queries": [{**_q("count(*)"), "measures": [
                  {"sqlExpression": "count(*)"},
                  {"sqlExpression": "sum(fare)"}]}]}),
        _case("no measures", "broker", "POST", "/query/aql",
              {"queries": [{**_q("count(*)"), "measures": []}]}),
        _case("measure parse failure", "broker", "POST", "/query/aql",
              {"queries": [_q("foo(")]}),
        _case("non-aggregate measure", "broker", "POST", "/query/aql",
              {"queries": [_q("1 = 2")]}),
        _case("aggregate arity", "broker", "POST", "/query/aql",
              {"queries": [_q("sum(fare, id)")]}),
        _case("no table", "broker", "POST", "/query/aql",
              {"queries": [dict(_q("count(*)"), table="")]}),
        _case("unknown column", "broker", "POST", "/query/aql",
              {"queries": [_q("sum(no_such_col)")]}),
        _case("after unknown column", "broker", "POST", "/query/aql",
              {"queries": [_q("count(*)")]}, settle=True),
        _case("sql parse error", "broker", "POST", "/query/sql",
              {"queries": ["SELEC nothing", "SELECT count(*) FROM "
                           f"dist_trips WHERE {SQL_NOW}"]}),
        _case("bad json", "broker", "POST", "/query/aql", b"{not json",
              compare="bytes"),
        _case("sql bad json", "broker", "POST", "/query/sql", b"{not json",
              compare="bytes"),
        _case("broker health", "broker", "GET", "/health", compare="bytes"),
        _case("broker health head", "broker", "HEAD", "/health",
              compare="bytes"),
        _case("broker get aql", "broker", "GET", "/query/aql",
              compare="bytes"),
        _case("broker no route", "broker", "GET", "/no/such/route",
              compare="bytes"),
    ]
    broker = {stage: _broker_battery(stage, extras if stage == "" else ())
              for stage in STAGES}
    return ctl, broker


def _send(port, case):
    """(status, Content-Type, body) of one case on the server at port."""
    body = case["body"]
    headers = dict(case["headers"])
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{case['path']}",
                                 data=body, headers=headers,
                                 method=case["method"])
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class Cluster:
    """One package's controller, datanodes and broker in this process."""

    def __init__(self, side: str, root):
        self.m = SIDES[side]
        self.root = root
        self.ctrl = self.m.Controller(self.m.State())
        self.cport = self.ctrl.start_background()
        self.caddr = f"localhost:{self.cport}"
        self.nodes = {}
        self.broker = self.topology = self.schema_view = None
        self.http = Session()

    def add_node(self, name: str):
        root = str(self.root / name)
        ms = self.m.MemStore(self.m.Meta(root), self.m.Disk(root))
        node = self.m.DataNode(ms, self.m.Scheduler(ms),
                               controller_address=self.caddr, namespace=NS,
                               instance_name=name, heartbeat_seconds=0.5,
                               poll_seconds=0.2, **self.m.device)
        node.open()
        node.serve()
        node.scheduler.disable()   # jobs run through /dbg alone
        self.nodes[name] = node
        return node

    def placement(self) -> dict:
        return self.http.get(f"http://{self.caddr}/placement/{NS}/"
                             "datanode").json()

    def settled(self, owners) -> bool:
        """Every shard Available on exactly the instances given."""
        shards = self.placement()["shards"]
        return all(set(sd["instances"]) <= set(owners)
                   and set(sd["instances"].values()) == {SHARD_AVAILABLE}
                   for sd in shards)

    def owner(self, shard: int):
        (name,) = [n for sd in self.placement()["shards"]
                   if sd["shardId"] == shard for n in sd["instances"]]
        return self.nodes[name]

    def post_node(self, node, path, body):
        r = self.http.post(f"http://localhost:{node.port}{path}",
                           data=body, timeout=60)
        return r.status_code, r.json()

    def start_broker(self):
        self.topology = self.m.Topology(self.caddr, NS, poll_seconds=0.2)
        self.topology.start()
        self.schema_view = self.m.SchemaView(self.caddr, NS,
                                             poll_seconds=0.2)
        self.schema_view.start()
        self.health = self.m.Health(self.topology,
                                    unhealthy_ttl_seconds=UNHEALTHY_TTL)
        self.broker = self.m.Broker(self.health, port=0,
                                    schema_view=self.schema_view)
        self.bport = self.broker.start_background()

    def close(self):
        if self.broker is not None:
            self.broker.stop()
            self.schema_view.stop()
            self.topology.stop()
        for node in self.nodes.values():
            node.close()
            node.memstore.host_memory_manager.stop()
            node.memstore.redolog_master.stop_all()
        self.ctrl.stop()


def _upserts():
    data = CS.server_rows(N_ROWS, 0)
    q = N_ROWS // N_SHARDS
    trips = [CS.server_upsert(data, s * q, (s + 1) * q)
             for s in range(N_SHARDS)]
    cities = build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(CS.N_CITIES, dtype=np.uint16), None, 0),
         (1, mdt.Uint32, (np.arange(CS.N_CITIES, dtype=np.uint32) + 1)
          * 1000, None, 0)], CS.N_CITIES)
    return data, trips, cities


@pytest.fixture(scope="module", autouse=True)
def jax_metrics_restored():
    """The JAX package's metrics are one registry a process, and its
    cluster's peer bootstraps here leave a rate gauge of 0 for a shard
    with nothing to copy: put the registry back as it was, so that a later
    test in the process reads only what it reported itself."""
    reg = jax_metrics.root()
    with reg.lock:
        saved = [dict(reg.counters), dict(reg.gauges),
                 {k: list(v) for k, v in reg.timers.items()}]
    yield
    with reg.lock:
        for kept, now in zip(saved, (reg.counters, reg.gauges, reg.timers)):
            now.clear()
            now.update(kept)


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """{case name: (case, (JAX cluster's answer, port's answer))}, each
    answer (status, Content-Type, body bytes); and the side steps'
    answers under `steps`."""
    ctl, broker = _cases()
    _, trips, cities = _upserts()
    jax_clock.set_current_time(NOW)
    clock.set_current_time(NOW)
    clusters = []
    answers, steps = {}, {}

    def run(cases):
        for case in cases:
            pair = tuple(_send(c.cport if case["target"] == "ctrl"
                               else c.bport, case) for c in clusters)
            answers[case["name"]] = (case, pair)
            if case["settle"]:
                for c in clusters:
                    for name in c.nodes:
                        c.health.mark_healthy(name)

    def both(name, fn):
        steps[name] = tuple(fn(c) for c in clusters)

    try:
        for side in ("jax", "port"):
            clusters.append(Cluster(side, tmp_path_factory.mktemp(side)))
        run(ctl["setup"])
        for c in clusters:
            for name in ("dn0", "dn1"):
                c.add_node(name)
        run(ctl["placement"])
        for c in clusters:
            _wait(lambda: c.settled({"dn0", "dn1"}), "the first placement")
        both("upsert trips", lambda c: [
            c.post_node(c.owner(s), f"/data/dist_trips/{s}", trips[s])
            for s in range(N_SHARDS)])
        both("upsert cities", lambda c: c.post_node(
            c.owner(0), "/data/dist_cities/0", cities))
        for c in clusters:
            c.start_broker()
        run(broker[""])
        run(ctl["placed"])

        jax_clock.set_current_time(NOW + 14 * 3600)
        clock.set_current_time(NOW + 14 * 3600)
        both("archive", lambda c: [
            c.post_node(c.owner(s), f"/dbg/dist_trips/{s}/archiving", b"{}")
            for s in range(N_SHARDS)])
        run(broker[" archived"])

        for c in clusters:
            c.add_node("dn2")
        run(ctl["replace"])
        for c in clusters:
            _wait(lambda: c.settled({"dn0", "dn2"})
                  and c.nodes["dn1"].owned_shards == set(),
                  "dn2 to take over dn1's shards")
            c.topology.refresh()
        both("dn2 shards", lambda c: sorted(c.nodes["dn2"].owned_shards))
        run(ctl["replaced"])
        run(broker[" migrated"])
        yield answers, steps
    finally:
        for c in clusters:
            c.close()
        jax_clock.reset_clock()
        clock.reset_clock()


_HOST_PORT = re.compile(r"(localhost|127\.0\.0\.1):\d+")


def _close(a, b, where):
    """a and b equal as JSON: numbers within RTOL, strings with their
    host:port left out, the rest exactly."""
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
    elif isinstance(a, str) and isinstance(b, str):
        assert _HOST_PORT.sub("HOST", a) == _HOST_PORT.sub("HOST", b), where
    else:
        assert a == b, (where, a, b)


def _listing_rows(body):
    (result,) = body["results"]
    return result["headers"], Counter(map(tuple, result["matrixData"]))


CTL_CASES, BROKER_CASES = _cases()
CASE_NAMES = [c["name"] for cases in list(CTL_CASES.values())
              + list(BROKER_CASES.values()) for c in cases]


def test_the_script_covers_every_route():
    from aresdb_tpu_torch.broker.server import ROUTES as BROKER_ROUTES
    from aresdb_tpu_torch.controller.server import ROUTES as CTL_ROUTES

    for routes, target in ((CTL_ROUTES, "ctrl"), (BROKER_ROUTES, "broker")):
        paths = [c["path"].split("?")[0]
                 for cases in list(CTL_CASES.values())
                 + list(BROKER_CASES.values())
                 for c in cases if c["target"] == target]
        missed = [p for p, _ in routes
                  if not any(re.fullmatch(p, path) for path in paths)]
        assert missed == [], target


@pytest.mark.parametrize("name", CASE_NAMES)
def test_request_answers_alike(replay, name):
    answers, _ = replay
    case, ((jstatus, jtype, jbody), (status, ctype, body)) = answers[name]
    assert status == jstatus, (name, jbody[:300], body[:300])
    assert ctype == jtype, name
    if case["compare"] == "bytes":
        assert body == jbody, (name, jbody[:300], body[:300])
    elif case["compare"] == "listing" and status == 200:
        assert _listing_rows(json.loads(body)) == \
            _listing_rows(json.loads(jbody)), name
    elif case["compare"] == "json" and ctype == "application/json":
        want, got = json.loads(jbody), json.loads(body)
        if case["drop"] is not None:
            want, got = case["drop"](want), case["drop"](got)
        _close(got, want, name)


@pytest.mark.parametrize("step", ("upsert trips", "upsert cities", "archive",
                                  "dn2 shards"))
def test_side_steps_answer_alike(replay, step):
    _, steps = replay
    want, got = steps[step]
    _close(got, want, step)
    if step == "archive":
        archived = sum(r["result"]["rowsArchived"] for _, r in got)
        assert 0 < archived < N_ROWS   # about half the rows archive
    if step == "dn2 shards":
        assert got == [1, 3]


@pytest.mark.parametrize("name", [n for n in SHAPES] + list(SQL_SHAPES)
                         + ["B3 frame", "B4 frame"])
def test_the_cluster_answers_alike_after_archiving_and_migration(replay,
                                                                 name):
    """Each shape's answer before archiving, after it, and after dn2
    bootstrapped dn1's shards: one answer (on the port's cluster)."""
    answers, _ = replay
    first, archived, migrated = (answers[name + stage][1][1]
                                 for stage in STAGES)
    assert archived[0] == migrated[0] == first[0] == 200
    if name.endswith("frame"):
        assert archived[2] == migrated[2] == first[2]
    elif name == "B6":
        assert _listing_rows(json.loads(archived[2])) == \
            _listing_rows(json.loads(migrated[2]))
    else:
        for later in (archived, migrated):
            _close(json.loads(later[2]), json.loads(first[2]), name)


def test_the_listing_rows_are_rejected_trips(replay):
    from aresdb_tpu_torch.query.postprocess import format_float32

    data, _, _ = _upserts()
    answers, _ = replay
    rejected = {(format_float32(f) if v else "NULL", str(c))
                for f, v, c, s in zip(data["fare"].tolist(),
                                      data["fare_valid"].tolist(),
                                      data["city_id"].tolist(),
                                      data["status"].tolist()) if s == 2}
    for stage in STAGES:
        headers, rows = _listing_rows(json.loads(
            answers["B6" + stage][1][1][2]))
        assert headers == ["fare", "city_id"]
        assert sum(rows.values()) == 50
        assert set(rows) <= rejected


class _Flaky(threading.Thread):
    """A datanode stand-in: answers 500 to its first `failures` queries,
    then a result."""

    def __init__(self, failures: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self
        self.calls = 0

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                self.rfile.read(int(self.headers["Content-Length"]))
                outer.calls += 1
                ok = outer.calls > failures
                out = json.dumps({"results": [{"x": 1.0}]}).encode() \
                    if ok else b"boom"
                self.send_response(200 if ok else 500)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        super().__init__(target=self.server.serve_forever, daemon=True)
        self.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("failures", (0, 1, RETRIES))
def test_a_failed_scan_is_retried_and_marks_the_node(failures):
    """BlockingScanNode (test_distributed.py's retry case) over the port's
    HTTP client: a node that answers 500 is retried up to RETRIES times
    and marked unhealthy; one that recovers within them is healthy."""
    node = _Flaky(failures)
    try:
        host = HostInstance("n1", "127.0.0.1", node.server.server_address[1])
        topo = HealthTrackingTopology(StaticTopology(TopologyView(
            num_shards=1, shards={0: [(host, SHARD_AVAILABLE)]})))
        ex = BrokerExecutor(topo)
        q = {"table": "t", "dimensions": [{"sqlExpression": "a"}],
             "measures": [{"sqlExpression": "count(*)"}]}
        if failures < RETRIES:
            assert ex.execute(q) == {"x": 1.0}
            assert topo.is_healthy("n1")
            assert node.calls == failures + 1
        else:
            with pytest.raises(BrokerError, match="failed after"):
                ex.execute(q)
            assert node.calls == RETRIES
            assert not topo.is_healthy("n1")
        ex.pool.shutdown()
    finally:
        node.close()


def test_a_node_that_refuses_connections_is_marked_unhealthy():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    host = HostInstance("gone", "127.0.0.1", port)
    topo = HealthTrackingTopology(StaticTopology(TopologyView(
        num_shards=1, shards={0: [(host, SHARD_AVAILABLE)]})))
    ex = BrokerExecutor(topo)
    with pytest.raises(BrokerError, match="failed after 3 tries"):
        ex.execute({"table": "t", "measures": [{"sqlExpression": "count(*)"}]})
    assert not topo.is_healthy("gone")
    # the broker's next scatter finds no healthy host for the shard
    with pytest.raises(BrokerError, match="no available host"):
        ex.execute({"table": "t", "measures": [{"sqlExpression": "count(*)"}]})
    ex.pool.shutdown()


def test_a_join_fails_on_a_node_without_shard_0_of_its_table(replay):
    """The reference cluster's difference from one node (ROADMAP section
    3): dn1 holds no shard 0 of dist_cities, so B5 fails there after
    RETRIES tries, and the broker marks dn1 unhealthy: the count after it
    finds no host for dn1's shards. The port answers alike."""
    answers, _ = replay
    for stage in STAGES:
        for side in answers["B5" + stage][1]:
            (error,) = json.loads(side[2])["errors"]
            assert "failed after 3 tries" in error
            assert "no shard 0 for table 'dist_cities'" in error
        for side in answers["after B5" + stage][1]:
            assert json.loads(side[2])["errors"] == [
                "no available host for shard 1"]
    # a query error on every node marks both: the next query finds none
    for side in answers["after unknown column"][1]:
        assert json.loads(side[2])["errors"] == [
            "no available host for shard 0"]
