"""The port's cluster modules, case by case against the JAX package's.

The broker's merge lattice (the cases of test_broker_merge.py) and its
fail-fast validator (those of test_broker_validator.py), the coordination
KV stores and the leader election (test_election.py,
test_etcd_kvstore.py's contract against its fake etcd gateway), the HA
controllers with their failover session, the broker's shard assignment,
the controller's skew-aware rebalance and the consistent-hash ring: the
port's answer must equal the JAX package's on the same inputs.

Two controller-failover faults the port repairs and the JAX package keeps
(ROADMAP section 3): a promoted controller lists no live instance until
each one's next heartbeat, and a leader that lost its lease still takes a
write and its snapshot erases its successor's. Their tests run the same
scenario through both packages' controllers and hold each to its own
answer.
"""

from __future__ import annotations

import json
import time

import pytest

from aresdb_tpu.broker import executor as jax_executor
from aresdb_tpu.broker import validator as jax_validator
from aresdb_tpu.cluster import topology as jax_topology
from aresdb_tpu.controller import state as jax_state
from aresdb_tpu.controller.server import \
    ControllerServer as JaxControllerServer
from aresdb_tpu.utils import consistent_hashing as jax_hashing
from aresdb_tpu_torch.broker import executor as X
from aresdb_tpu_torch.broker import validator as V
from aresdb_tpu_torch.cluster import topology as T
from aresdb_tpu_torch.cluster.etcd_kvstore import EtcdKVStore
from aresdb_tpu_torch.cluster.failover import FailoverSession, parse_addresses
from aresdb_tpu_torch.cluster.kvstore import FileKVStore, MemoryKVStore
from aresdb_tpu_torch.controller import state as S
from aresdb_tpu_torch.controller.election import LEASE_KEY, LeaderElector
from aresdb_tpu_torch.controller.server import ControllerServer
from aresdb_tpu_torch.utils import consistent_hashing as H
from aresdb_tpu_torch.utils.http_client import Session
from tests.test_broker_merge import CASES as MERGE_CASES
from tests.test_etcd_kvstore import fake_etcd  # noqa: F401 — a fixture

TTL = 0.6


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- the broker's merge lattice ---------------------------------------------

@pytest.mark.parametrize("agg,lhs,rhs,expected", MERGE_CASES)
def test_merge_lattice_equals_the_jax_packages(agg, lhs, rhs, expected):
    for parts in ([lhs, rhs], [lhs, {}, rhs]):
        got = X.merge_results(agg, parts)
        assert got == expected == jax_executor.merge_results(agg, parts)


def test_avg_is_refused_at_the_merge_layer():
    with pytest.raises(X.BrokerError):
        X.merge_results("avg", [{"a": 1.0}, {"a": 2.0}])


# -- the broker's validator -------------------------------------------------

TABLES = {"table1": {"name": "table1"}, "cities": {"name": "cities"}}


def _vq(**kw):
    q = {"table": "table1",
         "measures": [{"sqlExpression": "count(*)"}],
         "dimensions": [{"sqlExpression": "c1"}]}
    q.update(kw)
    return q


# (name, query, tables, hll_binary): the cases of test_broker_validator.py
VALIDATION_CASES = [
    ("happy path", _vq(), TABLES, False),
    ("unknown main table", _vq(table="tableNonExist"), TABLES, False),
    ("unknown join table", _vq(joins=[{"table": "foreignTableNonExist"}]),
     TABLES, False),
    ("known join table", _vq(joins=[{"table": "cities", "alias": "c"}]),
     TABLES, False),
    ("no schema view", _vq(table="whatever"), None, False),
    ("no table", _vq(table=""), TABLES, False),
    ("two measures", _vq(measures=[{"sqlExpression": "count(*)"},
                                   {"sqlExpression": "sum(fare)"}]),
     TABLES, False),
    ("no measures", _vq(measures=[]), TABLES, False),
    ("measure parse failure", _vq(measures=[{"sqlExpression": "foo("}]),
     TABLES, False),
    ("comparison measure", _vq(measures=[{"sqlExpression": "1 = 2"}]),
     TABLES, False),
    ("bare column measure", _vq(measures=[{"sqlExpression": "foo"}]),
     TABLES, False),
    ("non-aggregate literal", _vq(measures=[{"sqlExpression": "1"}]),
     TABLES, False),
    ("aggregate arity", _vq(measures=[{"sqlExpression": "sum(f1, f2)"}]),
     TABLES, False),
    ("hll binary needs hll", _vq(), TABLES, True),
    ("hll binary countdistincthll",
     _vq(measures=[{"sqlExpression": "countdistincthll(id)"}]), TABLES, True),
    ("hll binary hll", _vq(measures=[{"sqlExpression": "hll(id_hll)"}]),
     TABLES, True),
    ("hll binary non-aggregate", _vq(measures=[{"sqlExpression": "1"}]),
     TABLES, True),
]


def _verdict(module, q, tables, hll_binary):
    try:
        module.validate_query(q, tables, hll_binary=hll_binary)
    except module.BrokerValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name,q,tables,hll_binary", VALIDATION_CASES,
                         ids=[c[0] for c in VALIDATION_CASES])
def test_validator_equals_the_jax_packages(name, q, tables, hll_binary):
    want = _verdict(jax_validator, q, tables, hll_binary)
    assert _verdict(V, q, tables, hll_binary) == want
    if name in ("happy path", "known join table", "no schema view",
                "non-aggregate literal", "hll binary countdistincthll",
                "hll binary hll"):
        assert want is None
    else:
        assert want is not None


# -- KV stores and the election ---------------------------------------------

def _kv(kind, tmp_path, endpoint):
    return {"memory": lambda: MemoryKVStore(),
            "file": lambda: FileKVStore(str(tmp_path)),
            "etcd-fake": lambda: EtcdKVStore(endpoint)}[kind]()


KV_KINDS = ("memory", "file", "etcd-fake")


@pytest.mark.parametrize("kind", KV_KINDS)
def test_kvstore_contract(kind, tmp_path, fake_etcd):  # noqa: F811
    """test_etcd_kvstore.py's shared contract, on each port backend (the
    etcd adapter over the port's HTTP client)."""
    kv = _kv(kind, tmp_path, fake_etcd)
    assert kv.get("k") is None
    assert kv.cas("k", None, "v1")        # create-if-absent
    assert not kv.cas("k", None, "v2")    # exists now
    assert not kv.cas("k", "wrong", "v2")
    assert kv.cas("k", "v1", "v2")
    assert kv.get("k") == "v2"
    kv.put("k", "v3")
    assert kv.get("k") == "v3"
    kv.delete("k")
    assert kv.get("k") is None
    assert kv.cas("k", None, "v4")        # delete resets create-if-absent
    assert kv.get("k") == "v4"
    kv.delete("k")
    kv.put("/ares/leader/lease", '{"name": "ünïcode"}')
    assert kv.get("/ares/leader/lease") == '{"name": "ünïcode"}'
    kv.delete("/ares/leader/lease")


@pytest.mark.parametrize("kind", KV_KINDS)
def test_election_fails_over_with_a_fencing_epoch(kind, tmp_path,
                                                  fake_etcd):  # noqa: F811
    """One leader among two; a resign hands over to the other with a
    larger epoch (test_election.py, test_etcd_kvstore.py)."""
    kv = _kv(kind, tmp_path, fake_etcd)
    a = LeaderElector(name="a", address="localhost:1", ttl=TTL, kv=kv)
    b = LeaderElector(name="b", address="localhost:2", ttl=TTL, kv=kv)
    a.start()
    b.start()
    try:
        assert wait_for(lambda: a.is_leader or b.is_leader)
        time.sleep(TTL)
        assert sum([a.is_leader, b.is_leader]) == 1
        leader, other = (a, b) if a.is_leader else (b, a)
        epoch0 = leader.epoch
        leader.stop()
        assert wait_for(lambda: other.is_leader, timeout=TTL * 6)
        assert other.epoch > epoch0
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("case", ("crash", "callbacks", "stale leader"))
def test_election_on_the_shared_directory(case, tmp_path):
    root = str(tmp_path)
    if case == "crash":
        a = LeaderElector(root, "a", "localhost:1", ttl=TTL)
        b = LeaderElector(root, "b", "localhost:2", ttl=TTL)
        a.start()
        assert wait_for(lambda: a.is_leader)
        a._stop.set()       # dies without resigning: the lease expires
        a._thread.join()
        b.start()
        assert wait_for(lambda: b.is_leader, timeout=TTL * 6)
        b.stop()
    elif case == "callbacks":
        events = []
        a = LeaderElector(root, "a", "localhost:1", ttl=TTL,
                          on_elected=lambda: events.append("up"),
                          on_revoked=lambda: events.append("down"))
        a.start()
        assert wait_for(lambda: events == ["up"])
        a.stop()
        assert events == ["up", "down"]
    else:
        e = LeaderElector(root, "a", "localhost:1", ttl=TTL)
        e.start()
        try:
            assert wait_for(lambda: e.is_leader)
            lease = json.loads(e.kv.get(LEASE_KEY))
            lease["expires"] = time.time() - 1
            e.kv.put(LEASE_KEY, json.dumps(lease))
            e._renew()
            assert not e.is_leader
        finally:
            e.stop()


@pytest.fixture
def ha_pair(tmp_path):
    servers = []
    for name in ("c1", "c2"):
        s = ControllerServer(S.ControllerState(str(tmp_path)),
                             instance_name=name, elect=True, lease_ttl=TTL)
        s.start_background()
        servers.append(s)
    assert wait_for(lambda: sum(s.elector.is_leader for s in servers) == 1)
    yield servers
    for s in servers:
        s.stop()


def _leader(servers, is_leader=True):
    return next(s for s in servers if s.elector.is_leader == is_leader)


def test_follower_answers_503_with_the_leaders_address(ha_pair):
    lead, foll = _leader(ha_pair), _leader(ha_pair, False)
    s = Session()
    r = s.post(f"http://localhost:{foll.port}/namespaces",
               json={"namespace": "ns1"})
    assert r.status_code == 503
    assert r.json() == {"message": "not leader",
                        "leader": f"localhost:{lead.port}"}
    r = s.get(f"http://localhost:{foll.port}/leader")
    assert r.status_code == 200 and r.json()["isLeader"] is False
    assert s.get(f"http://localhost:{foll.port}/ui").status_code == 200


def test_failover_session_follows_the_leader(ha_pair):
    lead, foll = _leader(ha_pair), _leader(ha_pair, False)
    fs = FailoverSession([f"localhost:{foll.port}",
                          f"localhost:{lead.port}"])
    base = f"http://localhost:{foll.port}"
    assert fs.post(f"{base}/namespaces",
                   json={"namespace": "ns1"}).status_code == 200
    assert fs.post(f"{base}/schema/ns1/tables", json={
        "name": "trips",
        "columns": [{"name": "request_at", "type": "Uint32"},
                    {"name": "id", "type": "Uint32"}],
        "primaryKeyColumns": [1], "isFactTable": True,
        "config": {"batchSize": 64}}).status_code == 200
    # a URL outside the controller list passes through untouched
    solo = FailoverSession([f"localhost:{lead.port}"])
    assert solo.get(f"{base}/leader").json()["name"] == foll.elector.name
    lead.stop()
    assert wait_for(lambda: foll.elector.is_leader, timeout=TTL * 8)
    r = fs.get(f"{base}/schema/ns1/tables")
    assert r.status_code == 200
    assert [t["name"] for t in r.json()] == ["trips"]
    assert parse_addresses("a:1, b:2 ,c:3") == ["a:1", "b:2", "c:3"]


# -- the two failover faults --------------------------------------------------

def _paused_leader(pkg, root):
    """Two controllers of `pkg` ("jax" or "torch") on one root, the
    namespace prod and the instance dn0 taken by the leader; then the
    leader's elector stopped without resigning (a pause) and the other
    promoted. Returns (old leader, new leader, session); the caller stops
    both servers."""
    server, state = ((JaxControllerServer, jax_state.ControllerState)
                     if pkg == "jax" else (ControllerServer,
                                           S.ControllerState))
    servers = [server(state(root), instance_name=name, elect=True,
                      lease_ttl=TTL) for name in ("c1", "c2")]
    for srv in servers:
        srv.start_background()
    s = Session()
    assert wait_for(lambda: sum(x.elector.is_leader for x in servers) == 1)
    old = _leader(servers)
    new = _leader(servers, False)
    base = f"http://localhost:{old.port}"
    assert s.post(f"{base}/namespaces",
                  json={"namespace": "prod"}).status_code == 200
    assert s.post(f"{base}/membership/prod/instances", json={
        "name": "dn0", "host": "localhost", "port": 1}).status_code == 200
    assert s.get(f"{base}/membership/prod/instances").json() == {
        "dn0": {"host": "localhost", "port": 1}}
    old.elector._stop.set()
    old.elector._thread.join()
    assert wait_for(lambda: new.elector.is_leader, timeout=TTL * 8)
    return old, new, s


def _stop_all(*servers):
    for srv in servers:
        srv.stop()


@pytest.mark.parametrize("pkg", ("jax", "torch"))
def test_a_promoted_controller_lists_the_live_instances(pkg, tmp_path):
    """The leader pauses and the other controller is promoted: the JAX
    package's lists no instance until each one's next heartbeat (its
    reload rebuilds every instance with no heartbeat), the port's lists
    dn0, alive for a heartbeat timeout from the promotion."""
    old, new, s = _paused_leader(pkg, str(tmp_path))
    try:
        got = s.get(f"http://localhost:{new.port}/membership/prod/instances")
        assert got.status_code == 200
        want = {} if pkg == "jax" else {
            "dn0": {"host": "localhost", "port": 1}}
        assert got.json() == want
    finally:
        _stop_all(old, new)


@pytest.mark.parametrize("pause", ("before the request",
                                   "between the check and the write"))
@pytest.mark.parametrize("pkg", ("jax", "torch"))
def test_a_stale_leader_cannot_overwrite_its_successor(pkg, pause, tmp_path):
    """After the promotion the new leader takes table t_new, then the old
    one is asked for t_stale. The JAX package's old leader still reads as
    leader and takes it, and its snapshot erases t_new. The port's answers
    503 with the new leader's address: its lease lapsed by its own clock
    (a pause before the request), or, where the request passed that check
    (a pause between the check and the write), the lease's fence refuses
    the snapshot; state.json keeps t_new."""
    old, new, s = _paused_leader(pkg, str(tmp_path))
    try:
        if pause != "before the request" and pkg == "torch":
            old.elector._valid_until = time.monotonic() + 60
            assert old.elector.is_leader
        table = {"columns": [{"name": "id", "type": "Uint32"}],
                 "primaryKeyColumns": [0], "isFactTable": False,
                 "config": {"batchSize": 64}}
        assert s.post(f"http://localhost:{new.port}/schema/prod/tables",
                      json=dict(table, name="t_new")).status_code == 200
        r = s.post(f"http://localhost:{old.port}/schema/prod/tables",
                   json=dict(table, name="t_stale"))
        with open(tmp_path / "state.json") as f:
            on_disk = sorted(json.load(f)["prod"]["tables"])
        if pkg == "jax":
            assert r.status_code == 200
            assert on_disk == ["t_stale"]
        else:
            assert r.status_code == 503
            assert r.json() == {"message": "not leader",
                                "leader": f"localhost:{new.port}"}
            assert on_disk == ["t_new"]
    finally:
        _stop_all(old, new)


# -- placement ---------------------------------------------------------------

def _views(mod):
    h1, h2, h3 = (mod.HostInstance(n, f"h{i}", i)
                  for i, n in enumerate("abc"))
    av, init, leave = (mod.SHARD_AVAILABLE, mod.SHARD_INITIALIZING,
                       mod.SHARD_LEAVING)
    return {
        "balanced": mod.TopologyView(4, {
            0: [(h1, av), (h2, av)], 1: [(h1, av), (h2, av)],
            2: [(h1, av)], 3: [(h2, av)]}),
        "one host": mod.TopologyView(3, {s: [(h1, av)] for s in range(3)}),
        "replacing": mod.TopologyView(4, {
            0: [(h1, leave), (h3, init)], 1: [(h2, av)],
            2: [(h1, leave), (h3, av)], 3: [(h2, av), (h3, av)]}),
        "missing": mod.TopologyView(2, {0: [(h1, av)], 1: [(h2, init)]}),
    }


@pytest.mark.parametrize("name", ("balanced", "one host", "replacing",
                                  "missing"))
def test_shard_assignment_equals_the_jax_packages(name):
    def run(executor, mod):
        try:
            out = executor.calculate_shard_assignment(_views(mod)[name])
        except executor.BrokerError as e:
            return str(e)
        return {k: (h.address, shards) for k, (h, shards) in out.items()}

    want = run(jax_executor, jax_topology)
    if name == "replacing":
        # the port routes a shard whose joiner is still Initializing to
        # its Leaving replica; the JAX package's broker refuses the query
        assert want == "no available host for shard 0"
        want = {"a": ("h0:0", [0]), "b": ("h1:1", [1, 3]),
                "c": ("h2:2", [2])}
    assert run(X, T) == want


# (name, initial owners, rows per instance's shards, joiners, replica
# factor): the skew-aware rebalance of test_distributed.py and its kin
REBALANCE_CASES = [
    ("one heavy shard", ["a"], {"a": {0: 1_000_000, 1: 1000, 2: 1000,
                                      3: 1000}, "b": {}}, ["b"], 1),
    ("sticky when balanced", ["a", "b"], {"a": {0: 5000, 2: 5000},
                                          "b": {1: 5000, 3: 5000}}, [], 1),
    ("two equal shards split", ["a"], {"a": {0: 10, 1: 10}}, ["b"], 1),
    ("replicated", ["a", "b"], {"a": {0: 7, 1: 3, 2: 9, 3: 1},
                                "b": {0: 7, 1: 3, 2: 9, 3: 1}}, ["c"], 2),
]


def _rebalance(mod, owners, rows, joiners, rf):
    st = mod.ControllerState()
    st.create_namespace("ns")
    for name in sorted(set(owners) | set(joiners) | set(rows)):
        st.join("ns", mod.Instance(name=name, host="h", port=1))
    st.init_placement("ns", "datanode", 4, rf, owners)
    for sa in st.get_placement("ns", "datanode").shards:
        for o in list(sa.instances):
            st.mark_available("ns", "datanode", o, sa.shard_id)
    for name, shard_rows in rows.items():
        st.heartbeat("ns", name, shard_rows)
    out = st.rebalance("ns", "datanode")
    p = st.get_placement("ns", "datanode")
    return out, [(sa.shard_id, dict(sa.instances)) for sa in p.shards]


@pytest.mark.parametrize("name,owners,rows,joiners,rf", REBALANCE_CASES,
                         ids=[c[0] for c in REBALANCE_CASES])
def test_rebalance_equals_the_jax_packages(name, owners, rows, joiners, rf):
    got = _rebalance(S, owners, rows, joiners, rf)
    assert got == _rebalance(jax_state, owners, rows, joiners, rf)
    if name == "sticky when balanced":
        assert got[0]["moves"] == 0
    else:
        assert got[0]["moves"] >= 1


def test_hash_ring_assigns_as_the_jax_packages():
    keys = [f"job{i}" for i in range(40)]
    for nodes in (["s1"], ["s1", "s2", "s3"], ["s2", "s3"]):
        ring, jring = H.HashRing(), jax_hashing.HashRing()
        for n in nodes:
            ring.add(n)
            jring.add(n)
        assert ring.assign(keys) == jring.assign(keys)
    ring.remove("s2")
    jring.remove("s2")
    assert ring.assign(keys) == jring.assign(keys) == {"s3": sorted(keys)}
