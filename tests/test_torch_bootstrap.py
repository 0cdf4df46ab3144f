"""A datanode that replaces another keeps every row of the shards it takes.

Each case runs one package's cluster in this process, as
chip_smoke.phase_cluster runs the port's: a controller, dn0 and dn1 over
MemStores of their own (4 shards at replica factor 1), the battery's
trips rows of chip_smoke.py one contiguous quarter a shard, the clock
moved 14 hours and every shard archived through /dbg at a cutoff that
splits an hour (02:26:40 UTC), so that each shard holds archived rows and
live ones; then dn0's and dn1's schedulers run again, a broker starts, and
dn2 replaces dn1 by peer bootstrap. dn2's scheduler runs as
`DataNode.serve` starts it; in the smoke dn2 is a process of its own whose
clock is the wall's, and here its jobs get the wall's time too.

Before the replace, each of dn1's shards is counted on dn1 (a count with
`shards: [sid]` sent to dn1 directly) below and above the cutoff; after
it, the same counts on dn2 must be equal, and the broker's B1 (sum(fare)
by hour and city) must equal the numpy oracle (chip_smoke.check_server).

Faults are injected through monkeypatch and a session wrapper handed to
dn2, never through a knob of the program:
- a scheduler tick that lands on a shard between its listing in the store
  and the end of its recovery (`_recover_shard` wrapped); in the JAX
  package, and in the port before the repair, the job publishes a cutoff
  past the shard's live rows and hides them (ROADMAP section 3);
- a peer copy that fails on every attempt: the redo-log fetch, a 410 at
  the second metadata fetch, a 503 on an archive file after the first.
  The port keeps such a shard Initializing on dn2, with no file or
  metastore entry of the copy left, while the Leaving dn1 serves it, and
  takes it over once the fault is lifted; the JAX package starts the
  shard empty and marks it Available, and its answer is short;
- an attempt that fails after its archive copy, with the source
  archiving again before the next attempt.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import requests

import chip_smoke as CS
from aresdb_tpu.broker.server import BrokerServer as JaxBroker
from aresdb_tpu.cluster.failover import FailoverSession as JaxFailover
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
from aresdb_tpu_torch.broker.server import BrokerServer
from aresdb_tpu_torch.cluster.failover import FailoverSession
from aresdb_tpu_torch.cluster.topology import (DynamicTopology,
                                               HealthTrackingTopology)
from aresdb_tpu_torch.cmd import aresd
from aresdb_tpu_torch.common.config import AresServerConfig
from aresdb_tpu_torch.controller.server import ControllerServer
from aresdb_tpu_torch.controller.state import ControllerState
from aresdb_tpu_torch.datanode.datanode import DataNode
from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.memstore.memstore import MemStore
from aresdb_tpu_torch.memstore.scheduler import Scheduler
from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
from aresdb_tpu_torch.utils import clock, http_client

NS = "boot"
TABLE = "boot_trips"
NOW = CS.SERVER_NOW
LATER = NOW + 14 * 3600
CUTOFF = LATER - 86400        # 2020-09-13 02:26:40 UTC
N_ROWS = 2048
N_SHARDS = 4
QUARTER = N_ROWS // N_SHARDS
TRIPS = dict(CS.SERVER_TRIPS_JSON, name=TABLE,
             config={"batchSize": 128, "recordRetentionInDays": 0})
B1 = json.loads(json.dumps(CS.server_queries()["B1"][1])
                .replace('"trips"', f'"{TABLE}"'))
SIDES = {
    "jax": SimpleNamespace(
        Controller=JaxController, State=JaxState, DataNode=JaxDataNode,
        MemStore=JaxMemStore, Meta=JaxMeta, Disk=JaxDisk,
        Scheduler=JaxScheduler, Broker=JaxBroker, Topology=JaxTopology,
        Health=JaxHealth, Failover=JaxFailover, Session=requests.Session,
        clock=jax_clock, device={}),
    "port": SimpleNamespace(
        Controller=ControllerServer, State=ControllerState,
        DataNode=DataNode, MemStore=MemStore, Meta=DiskMetaStore,
        Disk=LocalDiskStore, Scheduler=Scheduler, Broker=BrokerServer,
        Topology=DynamicTopology, Health=HealthTrackingTopology,
        Failover=FailoverSession, Session=http_client.Session, clock=clock,
        device={"device": "cpu"}),
}


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _response(side: str, url: str, status: int, text: str):
    """A canned HTTP answer in the side's client type."""
    body = json.dumps({"error": text}).encode()
    if side == "port":
        return http_client.Response(url, status, text,
                                    {"Content-Type": "application/json"},
                                    body)
    r = requests.models.Response()
    r.status_code, r.url, r.reason, r._content = status, url, text, body
    r.headers["Content-Type"] = "application/json"
    return r


class Fault:
    """What dn2's session does to the peer copy of the shards in `shards`:
    `inject(method, url, session_id)` returns None (send the request), an
    exception to raise, or (status, text) to answer instead. `active`
    False lifts it; `hits` counts the requests it changed."""

    def __init__(self, shards, inject):
        self.shards, self.inject = set(shards), inject
        self.active, self.hits = True, 0

    def __call__(self, method, url):
        if not self.active or "/peer/" not in url:
            return None
        part = url.split("/peer/", 1)[1].split("?")[0].split("/")
        if part[0] != TABLE or int(part[1]) not in self.shards:
            return None
        sid = url.split("session=", 1)[1].split("&")[0] \
            if "session=" in url else None
        out = self.inject(method, "/".join(part[2:]), sid)
        self.hits += out is not None
        return out


def _session(side: str, caddr: str, fault: Fault):
    m = SIDES[side]

    class Faulty(m.Session):
        def request(self, method, url, *args, **kw):
            out = fault(method, url)
            if isinstance(out, Exception):
                raise out
            if out is not None:
                return _response(side, url, *out)
            return super().request(method, url, *args, **kw)

    return m.Failover([caddr], session=Faulty())


class Cluster:
    """One package's controller, datanodes and broker in this process, the
    trips ingested and archived at CUTOFF."""

    def __init__(self, side: str, root, data):
        self.side, self.m, self.root, self.data = side, SIDES[side], root, \
            data
        self.m.clock.set_current_time(NOW)
        self.http = http_client.Session()
        self.ctrl = self.m.Controller(self.m.State())
        self.cport = self.ctrl.start_background()
        self.caddr = f"localhost:{self.cport}"
        self.nodes, self.broker = {}, None
        self.call("POST", f"{self.ctl}/namespaces", {"namespace": NS})
        self.call("POST", f"{self.ctl}/schema/{NS}/tables", TRIPS)
        self.call("POST", f"{self.ctl}/schema/{NS}/tables/{TABLE}/columns/"
                  "status/enum-cases", {"enumCases": CS.STATUSES})
        for name in ("dn0", "dn1"):
            self.add_node(name)
        self.call("POST", f"{self.ctl}/placement/{NS}/datanode",
                  {"numShards": N_SHARDS, "replicaFactor": 1,
                   "instances": ["dn0", "dn1"]})
        _wait(lambda: self.settled({"dn0", "dn1"}), "the first placement")
        for sid in range(N_SHARDS):
            r = self.http.post(
                f"http://localhost:{self.owner(sid).port}/data/{TABLE}/"
                f"{sid}", data=CS.server_upsert(data, sid * QUARTER,
                                                (sid + 1) * QUARTER),
                timeout=60)
            assert r.status_code == 200, r.text
        # as phase_cluster: the schedulers paused while the clock jumps
        # and every owner archives, then running again
        for node in self.nodes.values():
            node.scheduler.disable()
        self.m.clock.set_current_time(LATER)
        for sid in range(N_SHARDS):
            self.archive(sid)
        for node in self.nodes.values():
            node.scheduler.enable()
        self.dn1_shards = sorted(self.nodes["dn1"].owned_shards)
        assert len(self.dn1_shards) == 2
        self.before = {sid: self.counts(self.nodes["dn1"], sid)
                       for sid in self.dn1_shards}
        self.topology = self.m.Topology(self.caddr, NS, poll_seconds=0.2)
        self.topology.start()
        # a failed scan marks its node for longer than the test runs
        self.broker = self.m.Broker(
            self.m.Health(self.topology, unhealthy_ttl_seconds=3600.0),
            port=0)
        self.bport = self.broker.start_background()

    @property
    def ctl(self) -> str:
        return f"http://{self.caddr}"

    def call(self, method, url, body=None):
        r = self.http.request(method, url, json=body, timeout=60)
        assert r.status_code == 200, (url, r.status_code, r.text)
        return r.json()

    def add_node(self, name: str, session=None):
        root = str(self.root / name)
        ms = self.m.MemStore(self.m.Meta(root), self.m.Disk(root))
        node = self.m.DataNode(ms, self.m.Scheduler(ms),
                               controller_address=self.caddr, namespace=NS,
                               instance_name=name, heartbeat_seconds=0.5,
                               poll_seconds=0.1, session=session,
                               **self.m.device)
        node.BOOTSTRAP_BACKOFF_S = 0.01
        node.open()
        node.serve()
        self.nodes[name] = node
        return node

    def archive(self, sid: int, node=None) -> None:
        port = (node or self.owner(sid)).port
        body = self.call("POST", f"http://localhost:{port}/dbg/{TABLE}/{sid}"
                         "/archiving", {})
        assert body["result"] is not None, body

    def placement(self) -> dict:
        return {sd["shardId"]: sd["instances"] for sd in self.call(
            "GET", f"{self.ctl}/placement/{NS}/datanode")["shards"]}

    def settled(self, owners) -> bool:
        return all(set(inst) <= set(owners)
                   and set(inst.values()) == {"Available"}
                   for inst in self.placement().values())

    def owner(self, sid: int):
        (name,) = self.placement()[sid]
        return self.nodes[name]

    def counts(self, node, sid: int) -> tuple:
        """(rows below CUTOFF, rows at or above it) of one shard on one
        node."""
        q = {"table": TABLE, "shards": [sid], "now": NOW,
             "measures": [{"sqlExpression": "count(*)"}],
             "dimensions": [{"sqlExpression": f"request_at >= {CUTOFF}"}]}
        body = self.call("POST", f"http://localhost:{node.port}/query/aql",
                         {"queries": [q]})
        assert "errors" not in body, body
        return tuple(int(body["results"][0].get(k, 0)) for k in ("0", "1"))

    def oracle_counts(self, sid: int) -> tuple:
        t = self.data["request_at"][sid * QUARTER:(sid + 1) * QUARTER]
        return int((t < CUTOFF).sum()), int((t >= CUTOFF).sum())

    def b1(self) -> dict:
        self.topology.refresh()
        body = self.call("POST", f"http://localhost:{self.bport}/query/aql",
                         {"queries": [B1]})
        assert "errors" not in body, body
        return body["results"][0]

    def replace(self, dn2) -> None:
        self.call("POST", f"{self.ctl}/placement/{NS}/datanode/replace",
                  {"leaving": "dn1", "joining": "dn2"})

    def taken_over(self) -> bool:
        return self.settled({"dn0", "dn2"}) and \
            not self.nodes["dn1"].owned_shards

    def close(self):
        if self.broker is not None:
            self.broker.stop()
            self.topology.stop()
        for node in self.nodes.values():
            node.close()
            node.memstore.host_memory_manager.stop()
            node.memstore.redolog_master.stop_all()
        self.ctrl.stop()
        self.m.clock.reset_clock()


@pytest.fixture
def cluster(tmp_path):
    made = []

    def make(side: str, seed: int = 0):
        made.append(Cluster(side, tmp_path / f"{side}{len(made)}",
                            CS.server_rows(N_ROWS, seed)))
        return made[-1]

    yield make
    for c in made:
        c.close()


def _wall_clock_jobs(node) -> None:
    """The node's scheduler ticks at the wall's time, as a datanode in a
    process of its own does when its clock is not frozen."""
    run = type(node.scheduler).run_due_jobs
    node.scheduler.run_due_jobs = \
        lambda now=None: run(node.scheduler, int(time.time()))


def _assert_whole(c: Cluster, dn2) -> None:
    """dn2 holds dn1's shards whole, and the broker answers B1 as the
    numpy oracle."""
    assert sorted(dn2.owned_shards) == c.dn1_shards
    for sid in c.dn1_shards:
        assert c.before[sid] == c.oracle_counts(sid)
        assert c.counts(dn2, sid) == c.before[sid], sid
    CS.check_server("B1", c.b1(), c.data)


def _short(c: Cluster) -> float:
    """How far the broker's B1 total falls below the oracle's (it must
    differ from the oracle)."""
    got = c.b1()
    with pytest.raises(AssertionError):
        CS.check_server("B1", got, c.data)
    d = c.data
    want = float(d["fare"][(d["status"] == 0) & d["fare_valid"]]
                 .astype(np.float64).sum())
    total = sum(v for by_city in got.values() for v in by_city.values())
    return want - total


@pytest.mark.parametrize("run", range(3))
def test_a_replacement_keeps_every_row(cluster, run):
    """The replacement as the smoke makes it, a few times over."""
    c = cluster("port", seed=run)
    CS.check_server("B1", c.b1(), c.data)
    dn2 = c.add_node("dn2")
    _wall_clock_jobs(dn2)
    c.replace(dn2)
    _wait(c.taken_over, "dn2 to take over dn1's shards")
    _assert_whole(c, dn2)


def _tick_during_recovery(node):
    """Run the node's due jobs, at the wall's time, as each shard's
    recovery starts: a scheduler tick that lands after the shard is
    listed in the store and before it is replayed."""
    real = node.memstore._recover_shard
    ran = []

    def recover(shard):
        ran.append(node.scheduler.run_due_jobs(now=int(time.time())))
        real(shard)

    node.memstore._recover_shard = recover
    return ran


@pytest.mark.parametrize("side", ["port", "jax"])
def test_a_scheduler_tick_during_recovery_hides_no_row(cluster, side):
    """The port skips the job on a shard under recovery (its bootstrap
    token is held) and keeps every row; the JAX package's job archives
    the empty shard at the wall's cutoff, and the replayed live rows land
    behind it: its answer is short by dn1's live rows."""
    c = cluster(side)
    dn2 = c.add_node("dn2")
    dn2.scheduler.disable()
    ran = _tick_during_recovery(dn2)
    c.replace(dn2)
    _wait(c.taken_over, "dn2 to take over dn1's shards")
    assert ran
    if side == "jax":
        live = sum(c.before[s][1] for s in c.dn1_shards)
        assert any(c.counts(dn2, s)[1] < c.before[s][1]
                   for s in c.dn1_shards), live
        assert _short(c) > 0
        return
    _assert_whole(c, dn2)


def _redolog_fails(method, what, sid):
    if what.startswith("redolog/"):
        return ConnectionError("injected: redo-log fetch")
    return None


class _PerSession:
    """Answers `status` to a request of a peer-copy session past the
    first `kind` request of that session."""

    def __init__(self, kind: str, status: int):
        self.kind, self.status, self.seen = kind, status, {}

    def __call__(self, method, what, sid):
        if sid is None or not what.startswith(self.kind):
            return None
        n = self.seen[sid] = self.seen.get(sid, 0) + 1
        return (self.status, "injected") if n > 1 else None


FAULTS = {   # name: (inject, whether the JAX package answers short)
    "redolog fetch": (lambda: _redolog_fails, True),
    "410 at the delta metadata": (lambda: _PerSession("metadata", 410),
                                  False),
    "503 on an archive file": (lambda: _PerSession("archive/", 503), True),
}


def _no_local_copy(c: Cluster, dn2, sid: int) -> bool:
    ms = dn2.memstore
    return (sid not in dn2.owned_shards
            and (TABLE, sid) not in ms.list_shards()
            and not os.path.exists(ms.diskstore._shard_dir(TABLE, sid))
            and not os.path.exists(ms.metastore._shard_dir(TABLE, sid)))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("side", ["port", "jax"])
def test_a_failed_peer_copy_leaves_the_shard_with_its_source(cluster, side,
                                                             fault):
    """Every attempt of the copy of dn1's first shard fails. The port
    keeps it Initializing on dn2 with nothing of the copy left, dn1 keeps
    serving it, and the broker's answer stays whole; once the fault is
    lifted, a later placement pass copies it. The JAX package starts it
    empty, marks it Available, and answers short."""
    c = cluster(side)
    sid = c.dn1_shards[0]
    inject, short_in_jax = FAULTS[fault]
    f = Fault([sid], inject())
    dn2 = c.add_node("dn2", session=_session(side, c.caddr, f))
    dn2.scheduler.disable()
    done = []
    real = dn2._add_shard

    def add_shard(shard_id):
        real(shard_id)
        done.append((shard_id, shard_id in dn2.owned_shards))

    dn2._add_shard = add_shard
    c.replace(dn2)
    if side == "jax":
        # every attempt failed, and the shard is Available all the same
        _wait(c.taken_over, "dn2 to take over dn1's shards")
        assert f.hits >= dn2.BOOTSTRAP_RETRIES
        if short_in_jax:
            assert _short(c) > 0
        else:
            # the copy lacks its cutoff, so that the shard replays every
            # row of its redo logs as live: whole by chance
            assert dn2.memstore.metastore.get_archiving_cutoff(TABLE,
                                                               sid) == 0
            CS.check_server("B1", c.b1(), c.data)
        return
    _wait(lambda: (sid, False) in done, "a failed copy of the shard")
    assert f.hits >= dn2.BOOTSTRAP_RETRIES
    with dn2._add_lock:     # no placement pass while the state is read
        assert _no_local_copy(c, dn2, sid)
        assert c.placement()[sid] == {"dn1": "Leaving",
                                      "dn2": "Initializing"}
        assert sid in c.nodes["dn1"].owned_shards
        CS.check_server("B1", c.b1(), c.data)
    f.active = False
    _wait(c.taken_over, "dn2 to take the shard over once the fault is "
          "lifted")
    _assert_whole(c, dn2)


def test_an_attempt_that_fails_after_its_archive_copy(cluster):
    """The first attempt copies the archive and fails at the redo logs;
    dn1 archives the shard again (4 hours later) before the second
    attempt opens its session. The second attempt's copy is whole."""
    c = cluster("port")
    sid = c.dn1_shards[0]
    steps = []

    def inject(method, what, session_id):
        if what.startswith("redolog/") and not steps:
            steps.append("failed")
            return ConnectionError("injected: redo-log fetch")
        if what == "session" and steps == ["failed"]:
            steps.append("archived")
            clock.set_current_time(LATER + 4 * 3600)
            c.archive(sid, c.nodes["dn1"])
        return None

    f = Fault([sid], inject)
    dn2 = c.add_node("dn2", session=_session("port", c.caddr, f))
    dn2.scheduler.disable()
    c.replace(dn2)
    _wait(c.taken_over, "dn2 to take over dn1's shards")
    assert steps == ["failed", "archived"]
    # dn2 holds the second copy alone: the source's batch versions at
    # its new cutoff, one metastore line and one directory each
    meta, disk = dn2.memstore.metastore, dn2.memstore.diskstore
    cutoff = meta.get_archiving_cutoff(TABLE, sid)
    assert cutoff == LATER + 4 * 3600 - 86400
    versions = meta.get_archive_batches(TABLE, sid)
    assert versions == c.nodes["dn1"].memstore.metastore \
        .get_archive_batches(TABLE, sid, cutoff)
    lines = os.path.join(meta._shard_dir(TABLE, sid), "batches")
    for name in os.listdir(lines):
        with open(os.path.join(lines, name)) as fh:
            assert len(fh.read().split()) == 1, name
    assert len(os.listdir(disk.archive_batch_root(TABLE, sid))) == \
        len(versions)
    _assert_whole(c, dn2)


@pytest.mark.parametrize("off", [True, False])
def test_scheduler_off_leaves_a_datanode_scheduler_paused(tmp_path, off):
    """`aresd --controller ... --scheduler-off` starts no job on the
    datanode (DataNode.serve would otherwise run its scheduler)."""
    ctrl = ControllerServer(ControllerState())
    cport = ctrl.start_background()
    overrides = {"port": 0, "root_path": str(tmp_path / "dn"),
                 "cluster.enable": True, "cluster.distributed": True,
                 "cluster.controller_address": f"localhost:{cport}",
                 "cluster.namespace": NS, "cluster.instance_name": "dnx"}
    if off:
        overrides["scheduler_off"] = True
    http_client.Session().post(f"http://localhost:{cport}/namespaces",
                               json={"namespace": NS}, timeout=10)
    node = aresd.start_datanode(AresServerConfig.load(None, overrides),
                                device="cpu")
    try:
        assert node.scheduler.enabled.is_set() is not off
        assert (node.scheduler._thread is None) is off
    finally:
        node.close()
        node.memstore.host_memory_manager.stop()
        node.memstore.redolog_master.stop_all()
        ctrl.stop()
