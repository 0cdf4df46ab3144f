"""The port's subscriber (`subscriber/subscriber.py`, `cmd/subscriber.py`)
against the JAX package's.

Transformations, `parse_message` and `shard_of` (on 10,000 random keys)
must give what the JAX package gives; `RetryFailureHandler` must sleep and
give up alike, and a poison batch must be abandoned alike. A
`StreamingProcessor` over a `FakeKafkaBroker` topic, and one over a
JSON-lines `FileConsumer`, feed each package's daemon (the port's on the
CPU) through its own `AresSink` and `Connector`: the daemons must answer
alike. `KafkaSink` must produce the same bytes. `SubscriberController`
must sync the same jobs from each package's controller, and
`cmd.subscriber.make_processor_factory` must build equal processors.
Starting `python -m aresdb_tpu_torch.cmd.subscriber` loads no torch.
"""

from __future__ import annotations

import datetime as _dt
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_daemons as D
from aresdb_tpu.client.connector import Connector as JaxConnector
from aresdb_tpu.client.query import QueryClient as JaxQueryClient
from aresdb_tpu.cmd import subscriber as jax_cmd
from aresdb_tpu.controller.server import ControllerServer as JaxController
from aresdb_tpu.controller.state import ControllerState as JaxState
from aresdb_tpu.redolog import kafka as jax_kafka
from aresdb_tpu.subscriber import subscriber as J
from aresdb_tpu_torch.client import Connector
from aresdb_tpu_torch.client.query import QueryClient
from aresdb_tpu_torch.cmd import subscriber as port_cmd
from aresdb_tpu_torch.common import upsert_batch as UB
from aresdb_tpu_torch.controller.server import ControllerServer
from aresdb_tpu_torch.controller.state import ControllerState
from aresdb_tpu_torch.redolog import kafka as port_kafka
from aresdb_tpu_torch.subscriber import subscriber as S
from aresdb_tpu_torch.utils.http_client import Session

ROOT = Path(__file__).resolve().parent.parent
NOW = 1_600_000_000
STATUSES = ["completed", "canceled", "rejected"]
TRIPS = {"name": "sub_trips",
         "columns": [{"name": "request_at", "type": "Uint32"},
                     {"name": "id", "type": "Uint32"},
                     {"name": "city_id", "type": "Uint16"},
                     {"name": "status", "type": "SmallEnum"},
                     {"name": "fare", "type": "Float32"},
                     {"name": "rider_hll", "type": "Uint32"}],
         "primaryKeyColumns": [1], "isFactTable": True,
         "config": {"batchSize": 256, "recordRetentionInDays": 0}}
COLUMNS = ["request_at", "id", "city_id", "status", "fare", "rider_hll"]
TRANSFORMS = {"request_at": {"type": "timestamp", "source": "t"},
              "id": {"source": "trip"},
              "status": {"source": "state", "default": "completed"},
              "rider_hll": {"type": "uuid_hll", "source": "rider"}}


def _rules(pkg):
    return pkg.JobRules(
        job="sub-job", table="sub_trips", columns=COLUMNS,
        sources={c: pkg.Transformation(**t) for c, t in TRANSFORMS.items()})


def _iso(t: int) -> str:
    return _dt.datetime.fromtimestamp(t, _dt.timezone.utc).isoformat()


def _events(seed: int, n: int) -> list:
    """JSON lines of n trip events from `seed`: the time as seconds,
    milliseconds, an ISO-8601 string or a numeric string; a few without a
    state (the default) or a fare; then updates of the first tenth of the
    trips; and malformed lines among them."""
    rng = np.random.RandomState(seed)
    out, docs = [], []
    for i in range(n):
        t = int(NOW - 1 - rng.randint(0, 20 * 3600))
        when = (t, t * 1000 + int(rng.randint(0, 1000)), _iso(t),
                str(t))[i % 4]
        doc = {"t": when, "trip": i + 1,
               "city_id": int(rng.randint(0, 30)),
               "rider": "%032x" % int(rng.randint(0, 2**62))}
        if rng.rand() > 0.05:
            doc["state"] = str(rng.choice(STATUSES))
        if rng.rand() > 0.05:
            doc["fare"] = float(np.float32(rng.rand() * 50))
        docs.append(doc)
        out.append(json.dumps(doc).encode())
        if i % 97 == 0:
            out.append(b'{"t": 1, "trip": ')
    for doc in docs[:n // 10]:
        out.append(json.dumps(dict(doc, state="rejected",
                                   fare=99.5)).encode())
    return out


def test_transformations_equal_the_jax_packages():
    rng = np.random.RandomState(0)
    docs = []
    for _ in range(500):
        t = int(NOW - rng.randint(0, 10**6))
        docs.append({"t": t})
        docs.append({"t": t * 1000 + int(rng.randint(0, 1000))})
        docs.append({"t": float(t) + 0.5})
        docs.append({"t": _iso(t)})
        docs.append({"t": _iso(t).replace("+00:00", "Z")})
        docs.append({"t": str(t)})
        docs.append({"u": "%08x-%04x-4%03x-8%03x-%012x" % (
            int(rng.randint(0, 2**31)), int(rng.randint(0, 2**16)),
            int(rng.randint(0, 2**12)), int(rng.randint(0, 2**12)),
            int(rng.randint(0, 2**40)))})
    kinds = [dict(type="timestamp", source="t"),
             dict(type="uuid_hll", source="u"),
             dict(type="", source="t"),
             dict(type="passthrough", source="u"),
             dict(type="timestamp", source="missing", default="1234"),
             dict(source="missing")]
    for kind in kinds:
        for doc in docs:
            if kind["source"] in doc or kind["source"] == "missing":
                want = J.apply_transformation(J.Transformation(**kind), doc)
                got = S.apply_transformation(S.Transformation(**kind), doc)
                assert got == want and type(got) is type(want), (kind, doc)


def test_an_unknown_transformation_is_refused_alike():
    doc = {"x": 1}
    with pytest.raises(ValueError) as want:
        J.apply_transformation(J.Transformation(type="nope", source="x"),
                               doc)
    with pytest.raises(ValueError) as got:
        S.apply_transformation(S.Transformation(type="nope", source="x"),
                               doc)
    assert str(got.value) == str(want.value)


def test_parse_message_equals_the_jax_packages():
    lines = _events(1, 2000) + [b"", b"\xff\xfe", b"[1, 2]", b"null"]
    jr, pr = _rules(J), _rules(S)
    n = 0
    for line in lines:
        try:
            want = J.parse_message(jr, line)
        except (AttributeError, TypeError) as e:
            # a JSON value that is no object: both fail alike
            with pytest.raises(type(e)):
                S.parse_message(pr, line)
            continue
        assert S.parse_message(pr, line) == want, line
        n += want is None
    assert n >= 20   # the malformed lines dropped


@pytest.mark.parametrize("num_shards", (1, 2, 4, 7, 16))
def test_shard_of_equals_the_jax_packages_on_10000_keys(num_shards):
    rng = np.random.RandomState(num_shards)
    ints = rng.randint(-2**62, 2**62, 10_000).tolist()
    strs = ["%x" % v for v in rng.randint(0, 2**40, 10_000).tolist()]
    for keys in ([[k] for k in ints], [[s] for s in strs],
                 [[k, s] for k, s in zip(ints, strs)]):
        want = [J.shard_of(k, num_shards) for k in keys]
        assert [S.shard_of(k, num_shards) for k in keys] == want
    if num_shards > 1:
        assert set(want) == set(range(num_shards))


@pytest.mark.parametrize("fail_times", (0, 2, 5, 100))
def test_retry_failure_handler_backs_off_and_gives_up_alike(fail_times):
    def run(pkg):
        sleeps, calls = [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] <= fail_times:
                raise RuntimeError("ares down")
            return 7

        h = pkg.RetryFailureHandler(init_interval=1.0, multiplier=1.5,
                                    max_elapsed=30.0, sleep=sleeps.append)
        return h.handle(flaky), sleeps, h.retries, h.batches_abandoned

    want = run(J)
    assert run(S) == want
    assert (want[0] is None) == (fail_times == 100)


def test_a_poison_batch_is_abandoned_alike():
    def run(pkg):
        msgs = [pkg.Message(key=b"", value=line, offset=i)
                for i, line in enumerate(_events(2, 30))]

        class Poison:
            calls = 0

            def save(self, rules, rows):
                Poison.calls += 1
                raise RuntimeError("always fails")

        consumer = pkg.ListConsumer(msgs)
        h = pkg.RetryFailureHandler(init_interval=1.0, multiplier=1.0,
                                    max_elapsed=2.0, sleep=lambda s: None)
        p = pkg.StreamingProcessor(_rules(pkg), consumer, Poison(),
                                   batch_size=10, flush_interval=0,
                                   failure_handler=h)
        written = [p.run_once() for _ in range(5)]
        return (written, p.messages_dropped, p.rows_written, Poison.calls,
                consumer.committed, h.batches_abandoned)

    want = run(J)
    assert run(S) == want
    assert want[1] > 0 and want[4]


class _Transport:
    def __init__(self):
        self.produced = []

    def produce(self, topic, partition, value):
        self.produced.append((topic, partition, value))
        return len(self.produced) - 1


class _Schema:
    def __init__(self, table_cls):
        self._table = table_cls.from_json(TRIPS)
        self._enums = {}

    def table(self, name):
        return self._table

    def enum_dict(self, table, column):
        return dict(self._enums.get(column, {}))

    def extend_enum(self, table, column, cases):
        d = self._enums.setdefault(column, {})
        return [d.setdefault(c, len(d)) for c in cases]


def test_kafka_sink_payloads_are_byte_equal(monkeypatch):
    from aresdb_tpu.common.schema import Table as JaxTable
    from aresdb_tpu_torch.common.schema import Table

    monkeypatch.setattr(UB.time, "time", lambda: NOW)
    produced = []
    for pkg, Conn, table_cls in ((J, JaxConnector, JaxTable),
                                 (S, Connector, Table)):
        conn = Conn.__new__(Conn)
        conn.host, conn.port, conn.session = "x", 0, None
        conn.schema = _Schema(table_cls)
        transport = _Transport()
        sink = pkg.KafkaSink(conn, transport, namespace="ns", num_shards=4,
                             pk_positions=[1])
        rules = _rules(pkg)
        rows = [r for r in (pkg.parse_message(rules, line)
                            for line in _events(3, 500)) if r is not None]
        assert sink.save(rules, rows) == len(rows)
        produced.append(transport.produced)
    want, got = produced
    assert got == want
    assert {p for _, p, _ in got} == {0, 1, 2, 3}
    assert got[0][0] == port_kafka.redolog_topic("ns", "sub_trips") \
        == jax_kafka.redolog_topic("ns", "sub_trips")


def test_kafka_consumer_is_gated_alike():
    with pytest.raises(RuntimeError, match="confluent-kafka") as want:
        J.KafkaConsumer(["b1"], "topic", "group")
    with pytest.raises(RuntimeError, match="confluent-kafka") as got:
        S.KafkaConsumer(["b1"], "topic", "group")
    assert str(got.value) == str(want.value)


QUERIES = {
    "count": {"measures": [{"sqlExpression": "count(*)"}]},
    "by status": {"measures": [{"sqlExpression": "sum(fare)"}],
                  "dimensions": [{"sqlExpression": "status"}]},
    "by city": {"measures": [{"sqlExpression": "count(*)"}],
                "dimensions": [{"sqlExpression": "city_id"}]},
    "riders": {"measures": [{"sqlExpression": "countdistincthll(id)"}]},
    "rejected fares": {"measures": [{"sqlExpression": "sum(fare)"}],
                       "rowFilters": ["status = 'rejected'"]},
}


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Each package's answers after two processors streamed into its
    daemon: a TransportConsumer over a FakeKafkaBroker topic (2 shards
    through the AresSink's routing) and a FileConsumer over a JSON-lines
    file (the same events again, updates last-write-wins)."""
    lines = _events(4, 1500)
    path = tmp_path_factory.mktemp("events") / "trips.jsonl"
    path.write_bytes(b"\n".join(lines) + b"\n")
    out = {}
    with D.daemons(tmp_path_factory, NOW) as ports:
        for side, port in ports.items():
            pkg, Conn, Client, kafka = (
                (J, JaxConnector, JaxQueryClient, jax_kafka)
                if side == "jax" else (S, Connector, QueryClient, port_kafka))
            conn = Conn("localhost", port)
            conn.create_table(TRIPS)
            broker = kafka.FakeKafkaBroker()
            for line in lines:
                broker.produce("trips-topic", 0, line)
            stats = []
            for consumer in (pkg.TransportConsumer(broker, "trips-topic"),
                             pkg.FileConsumer(str(path), topic="file")):
                sink = pkg.AresSink(conn, num_shards=1, pk_positions=[1])
                p = pkg.StreamingProcessor(_rules(pkg), consumer, sink,
                                           batch_size=400, flush_interval=0)
                while p.run_once():
                    pass
                consumer.close()
                stats.append((p.rows_written, p.messages_dropped,
                              getattr(consumer, "committed", None)))
            client = Client(f"localhost:{port}")
            answers = {k: client.query_aql([dict(q, table="sub_trips",
                                                 now=NOW)])
                       for k, q in QUERIES.items()}
            out[side] = (stats, answers)
    return out


def test_both_processors_stream_alike(streamed):
    assert streamed["port"][0] == streamed["jax"][0]
    (written, dropped, committed), _ = streamed["port"][0]
    assert dropped >= 15 and written > 1500
    assert committed == {0: written + dropped - 1}


@pytest.mark.parametrize("name", list(QUERIES))
def test_the_streamed_daemons_answer_alike(streamed, name):
    want, got = streamed["jax"][1][name], streamed["port"][1][name]
    D.close(got, want, name)
    assert "errors" not in got and got["results"][0]
    if name == "count":
        assert got["results"][0] == {"": 1500.0}


def _controller(side):
    if side == "jax":
        ctrl = JaxController(JaxState())
    else:
        ctrl = ControllerServer(ControllerState())
    return ctrl, ctrl.start_background()


JOBS = [{"name": f"job{i}", "table": "sub_trips", "topic": f"topic{i}",
         "config": {"source": {"type": "list"}, "columns": COLUMNS,
                    "transformations": TRANSFORMS, "batchSize": 50 + i,
                    "sink": {"host": "localhost", "port": 1,
                             "numShards": 2, "pkPositions": [1]}}}
        for i in range(5)]


def test_subscriber_controllers_sync_alike():
    """Two subscribers split five jobs by the controller's ring; a job
    deleted drops its processor at the next sync."""
    seen = {}
    for side, pkg in (("jax", J), ("port", S)):
        ctrl, port = _controller(side)
        http = Session()
        base = f"http://localhost:{port}"
        try:
            assert http.post(f"{base}/namespaces",
                             json={"namespace": "ns"}).status_code == 200
            for job in JOBS:
                assert http.post(f"{base}/config/ns/jobs",
                                 json=job).status_code == 200
            subs, syncs = [], []
            for name in ("sub1", "sub2"):
                made = []

                def make(job, made=made):
                    made.append(job)
                    return pkg.StreamingProcessor(
                        _rules(pkg), pkg.ListConsumer([]),
                        pkg.AresSink(None))

                sc = pkg.SubscriberController(f"localhost:{port}", "ns",
                                              name, make, poll_seconds=60)
                syncs.append(sc.sync_once())
                subs.append((sc, made))
            again = [sc.sync_once() for sc, _ in subs]
            http.delete(f"{base}/config/ns/jobs/{again[0][0]}")
            after = [sc.sync_once() for sc, _ in subs]
            seen[side] = (syncs, again, after,
                          [[j["name"] for j in made] for _, made in subs],
                          [sorted(sc.driver.processors) for sc, _ in subs])
            for sc, _ in subs:
                sc.stop()
        finally:
            ctrl.stop()
    assert seen["port"] == seen["jax"]
    syncs, again, after, made, running = seen["port"]
    assert sorted(again[0] + again[1]) == [j["name"] for j in JOBS]
    assert len(after[0]) + len(after[1]) == 4
    assert running == after


def _processor_fields(p):
    rules = p.rules
    return {"rules": (rules.job, rules.table, rules.columns,
                      {c: (t.type, t.source, t.default, t.context)
                       for c, t in rules.sources.items()},
                      rules.update_modes),
            "consumer": type(p.consumer).__name__,
            "sink": (type(p.sink).__name__, p.sink.num_shards,
                     p.sink.pk_positions, p.sink.connector.host,
                     p.sink.connector.port),
            "batch": (p.batch_size, p.flush_interval)}


@pytest.mark.parametrize("source", ["file", "list", "default sink"])
def test_make_processor_factory_builds_equal_processors(tmp_path, source):
    path = tmp_path / "e.jsonl"
    path.write_bytes(b"\n".join(_events(5, 10)))
    job = json.loads(json.dumps(JOBS[1]))
    if source == "file":
        job["config"]["source"] = {"type": "file", "path": str(path)}
    elif source == "default sink":
        del job["config"]["sink"]
    procs = [cmd.make_processor_factory("dhost", 4242)(job)
             for cmd in (jax_cmd, port_cmd)]
    want, got = (_processor_fields(p) for p in procs)
    assert got == want
    assert got["consumer"] == ("FileConsumer" if source == "file"
                               else "ListConsumer")
    if source == "file":
        assert [m.value for m in procs[1].consumer.poll(20, 0)] == \
            [m.value for m in procs[0].consumer.poll(20, 0)]
    for p in procs:
        p.consumer.close()


_NO_TORCH = """
import sys, threading, time
from aresdb_tpu_torch.cmd import subscriber
threading.Thread(target=subscriber.main, args=([
    "--controller", sys.argv[1], "--namespace", "ns", "--name", "s1",
    "--sink-host", "localhost", "--sink-port", "1"],), daemon=True).start()
deadline = time.time() + 60
while "aresdb_tpu_torch.subscriber.subscriber" not in sys.modules or \\
        not any(t.name.startswith("subscriber-job") for t in
                threading.enumerate()):
    assert time.time() < deadline, "no processor started"
    time.sleep(0.05)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("torch", "jax", "aresdb_tpu", "requests")]
print("loaded:", bad, flush=True)
"""


def test_the_subscriber_process_loads_no_torch():
    """`cmd.subscriber` as a process: it syncs a job from the port's
    controller and starts its processor, with no torch in the process."""
    ctrl, port = _controller("port")
    try:
        http = Session()
        http.post(f"http://localhost:{port}/namespaces",
                  json={"namespace": "ns"})
        http.post(f"http://localhost:{port}/config/ns/jobs", json=JOBS[0])
        out = subprocess.run([sys.executable, "-c", _NO_TORCH,
                              f"localhost:{port}"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
    finally:
        ctrl.stop()
    assert out.returncode == 0, out.stderr
    assert "loaded: []" in out.stdout, out.stdout
