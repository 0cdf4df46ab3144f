"""Subscriber: consume → decode → transform → batch → sink pipeline.

Reference: subscriber/ (Controller syncing job assignments
common/job/controller.go:107, Driver managing N StreamingProcessors
driver.go:110, processor pipeline streaming_processor.go:323, JSON decoder
common/message/json_decoder.go, transformation rules
common/rules/job_config.go:62, sinks common/sink/{ares_database,kafka}.go
with murmur-based shard routing sink.go:56).

Kafka gating: confluent-kafka is not available in this environment, so the
Consumer interface ships with a file/list-backed implementation for local
use and tests; KafkaConsumer raises a clear error until the client library
is installed. All pipeline logic is transport-agnostic.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from aresdb_tpu_torch.query import hll as H


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------

@dataclass
class Message:
    key: bytes
    value: bytes
    topic: str = ""
    partition: int = 0
    offset: int = 0


class Consumer:
    """Transport interface (reference: subscriber/common/consumer)."""

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        raise NotImplementedError

    def commit(self, offsets: Dict[int, int]) -> None:
        pass

    def close(self) -> None:
        pass


class ListConsumer(Consumer):
    """In-memory consumer for tests and bounded replays."""

    def __init__(self, messages: Iterable[Message]):
        self._messages = list(messages)
        self._pos = 0
        self.committed: Dict[int, int] = {}

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        out = self._messages[self._pos:self._pos + max_messages]
        self._pos += len(out)
        return out

    def commit(self, offsets: Dict[int, int]) -> None:
        self.committed.update(offsets)


class FileConsumer(Consumer):
    """JSON-lines file consumer (one message per line)."""

    def __init__(self, path: str, topic: str = ""):
        self._f = open(path, "rb")
        self.topic = topic
        self._offset = 0

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        out = []
        for _ in range(max_messages):
            line = self._f.readline()
            if not line:
                break
            out.append(Message(key=b"", value=line.strip(), topic=self.topic,
                               offset=self._offset))
            self._offset += 1
        return out

    def close(self) -> None:
        self._f.close()


class TransportConsumer(Consumer):
    """Kafka consumer logic over the injectable transport
    (`redolog/kafka.py`) — offset tracking, committed-offset resume,
    poll batching. Tests drive it with FakeKafkaBroker; production wraps
    ConfluentKafkaTransport (subscriber/common/consumer/kafka/kafka.go:66).
    """

    def __init__(self, transport, topic: str, partition: int = 0,
                 start_offset: int = 0):
        self.transport = transport
        self.topic = topic
        self.partition = partition
        self._pos = start_offset
        self.committed: Dict[int, int] = {}

    def poll(self, max_messages: int, timeout: float) -> List[Message]:
        msgs = self.transport.fetch(self.topic, self.partition, self._pos,
                                    max_messages=max_messages,
                                    timeout=timeout)
        out = [Message(key=b"", value=v, topic=self.topic,
                       partition=self.partition, offset=o)
               for o, v in msgs]
        if out:
            self._pos = out[-1].offset + 1
        return out

    def commit(self, offsets: Dict[int, int]) -> None:
        self.committed.update(offsets)


def KafkaConsumer(brokers: List[str], topic: str, group: str
                  ) -> TransportConsumer:
    """Real-client consumer: the same TransportConsumer logic over the
    confluent adapter (constructing it raises a clear error when the
    client library is absent, mirroring the sarama gate)."""
    from aresdb_tpu_torch.redolog.kafka import ConfluentKafkaTransport

    return TransportConsumer(ConfluentKafkaTransport(brokers), topic)


# ---------------------------------------------------------------------------
# rules / transformations (reference rules/job_config.go + transformations)
# ---------------------------------------------------------------------------

@dataclass
class Destination:
    table: str
    column: str
    update_mode: int = 0


@dataclass
class Transformation:
    type: str = ""                  # '', 'timestamp', 'uuid_hll', ...
    source: str = ""
    default: Optional[str] = None
    context: Dict[str, str] = field(default_factory=dict)


@dataclass
class JobRules:
    """Mapping of incoming JSON fields to one Ares table's columns."""

    job: str
    table: str
    columns: List[str]                      # ares column names, in order
    sources: Dict[str, Transformation]      # column -> transformation
    update_modes: Optional[List[int]] = None


def apply_transformation(t: Transformation, doc: Dict[str, Any]) -> Any:
    raw = doc.get(t.source or "", None)
    if raw is None and t.default is not None:
        raw = t.default
    if raw is None:
        return None
    kind = t.type
    if kind in ("", "passthrough"):
        return raw
    if kind == "timestamp":
        # seconds or millis or ISO8601 → unix seconds
        if isinstance(raw, (int, float)):
            v = int(raw)
            return v // 1000 if v > 99999999999 else v
        import datetime as _dt

        s = str(raw)
        try:
            return int(s)
        except ValueError:
            pass
        return int(_dt.datetime.fromisoformat(
            s.replace("Z", "+00:00")).timestamp())
    if kind == "uuid_hll":
        from aresdb_tpu_torch.common import data_types as dtm

        hi, lo = dtm.parse_uuid(raw)
        hashed = np.uint64(hi) ^ np.uint64(lo)
        return int(H.hll_value_from_hash(np.asarray([hashed], np.uint64))[0])
    raise ValueError(f"unknown transformation type {kind!r}")


def parse_message(rules: JobRules, payload: bytes) -> Optional[List[Any]]:
    """JSON message → row values in rules.columns order; None to drop."""
    try:
        doc = json.loads(payload)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    row = []
    for col in rules.columns:
        t = rules.sources.get(col, Transformation(source=col))
        row.append(apply_transformation(t, doc))
    return row


# ---------------------------------------------------------------------------
# sink (reference sink/ares_database.go + shard routing sink.go:56)
# ---------------------------------------------------------------------------

def shard_of(key_values: List[Any], num_shards: int) -> int:
    """murmur3 of the packed PK % num_shards (reference sink.go shardFn)."""
    if num_shards <= 1:
        return 0
    blob = b"".join(
        v.to_bytes(8, "little", signed=True) if isinstance(v, int)
        else str(v).encode() for v in key_values)
    h = H.murmur3_64(
        np.frombuffer(blob[:8].ljust(8, b"\0"), np.uint64), 8)[0]
    return int(h) % num_shards


class AresSink:
    """Writes batched rows through the client SDK."""

    def __init__(self, connector, num_shards: int = 1,
                 pk_positions: Optional[List[int]] = None):
        self.connector = connector
        self.num_shards = num_shards
        self.pk_positions = pk_positions or [0]

    def save(self, rules: JobRules, rows: List[List[Any]]) -> int:
        if not rows:
            return 0
        by_shard: Dict[int, List[List[Any]]] = {}
        for row in rows:
            sid = shard_of([row[i] for i in self.pk_positions],
                           self.num_shards)
            by_shard.setdefault(sid, []).append(row)
        total = 0
        for sid, shard_rows in by_shard.items():
            stats = self.connector.insert(
                rules.table, rules.columns, shard_rows,
                update_modes=rules.update_modes, shard_id=sid)
            total += stats.get("inserted", 0) + stats.get("updated", 0)
        return total


class KafkaSink:
    """Publishes upsert batches to the per-table redolog topic instead of
    posting over HTTP (reference subscriber/common/sink/kafka.go:46) —
    the datanode's KafkaRedoLogManager consumes them as its WAL.

    Batch bytes come from the same Connector.build_batch used for HTTP
    ingestion, so both sinks emit the identical wire format; partition =
    shard (sink.go Shard()).
    """

    def __init__(self, connector, transport, namespace: str = "",
                 num_shards: int = 1,
                 pk_positions: Optional[List[int]] = None):
        from aresdb_tpu_torch.redolog.kafka import redolog_topic as _topic

        self.connector = connector
        self.transport = transport
        self.namespace = namespace
        self.num_shards = num_shards
        self.pk_positions = pk_positions or [0]
        self._topic_fn = _topic

    def save(self, rules: JobRules, rows: List[List[Any]]) -> int:
        if not rows:
            return 0
        by_shard: Dict[int, List[List[Any]]] = {}
        for row in rows:
            sid = shard_of([row[i] for i in self.pk_positions],
                           self.num_shards)
            by_shard.setdefault(sid, []).append(row)
        topic = self._topic_fn(self.namespace, rules.table)
        total = 0
        for sid, shard_rows in by_shard.items():
            payload = self.connector.build_batch(
                rules.table, rules.columns, shard_rows,
                update_modes=rules.update_modes)
            self.transport.produce(topic, sid, payload)
            total += len(shard_rows)
        return total


# ---------------------------------------------------------------------------
# processor / driver (reference streaming_processor.go:323, driver.go:110)
# ---------------------------------------------------------------------------

class RetryFailureHandler:
    """Exponential-backoff retry for sink saves, then give up on the batch.

    Reference: subscriber/common/job/retry_failure_handler.go — constant
    or increasing interval (multiplier >= 1), capped total elapsed time
    (default 10 minutes); after the cap the batch is abandoned and the
    pipeline moves on. `sleep` is injectable for tests.
    """

    def __init__(self, init_interval: float = 5.0, multiplier: float = 1.5,
                 max_elapsed: float = 600.0, sleep: Callable = None):
        self.init_interval = init_interval
        self.multiplier = multiplier if multiplier >= 1 else 1.5
        self.max_elapsed = max_elapsed
        self.sleep = sleep or __import__("time").sleep
        self.retries = 0
        self.batches_abandoned = 0

    def handle(self, fn: Callable[[], int]) -> Optional[int]:
        """Run fn, retrying with backoff on exceptions; None = abandoned."""
        try:
            return fn()
        except Exception:
            pass
        interval = self.init_interval
        elapsed = 0.0
        while elapsed + interval <= self.max_elapsed:
            self.sleep(interval)
            elapsed += interval
            self.retries += 1
            try:
                return fn()
            except Exception:
                interval *= self.multiplier
        self.batches_abandoned += 1
        return None


class StreamingProcessor:
    def __init__(self, rules: JobRules, consumer: Consumer, sink: AresSink,
                 batch_size: int = 1000, flush_interval: float = 5.0,
                 failure_handler: Optional[RetryFailureHandler] = None):
        self.rules = rules
        self.consumer = consumer
        self.sink = sink
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.failure_handler = failure_handler
        self.rows_written = 0
        self.messages_dropped = 0
        self._stop = threading.Event()

    def run_once(self) -> int:
        """Consume one batch worth of messages; returns rows written."""
        msgs = self.consumer.poll(self.batch_size, self.flush_interval)
        if not msgs:
            return 0
        rows = []
        for m in msgs:
            row = parse_message(self.rules, m.value)
            if row is None:
                self.messages_dropped += 1
                continue
            rows.append(row)
        if self.failure_handler is not None:
            written = self.failure_handler.handle(
                lambda: self.sink.save(self.rules, rows))
            if written is None:
                # batch abandoned after exhausting retries (reference
                # HandleFailure: log + move on; offsets still commit so
                # the pipeline does not wedge on a poison batch)
                self.messages_dropped += len(rows)
                written = 0
        else:
            written = self.sink.save(self.rules, rows)
        self.rows_written += written
        self.consumer.commit({m.partition: m.offset for m in msgs})
        return written

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.run_once()
            except Exception:
                # transient consumer/sink failure without a handler:
                # back off rather than killing the job thread
                self._stop.wait(1.0)
                continue
            if n == 0:
                self._stop.wait(0.2)

    def stop(self) -> None:
        self._stop.set()


class Driver:
    """Runs one StreamingProcessor thread per assigned job."""

    def __init__(self):
        self.processors: Dict[str, StreamingProcessor] = {}
        self._threads: Dict[str, threading.Thread] = {}

    def add(self, name: str, processor: StreamingProcessor) -> None:
        self.processors[name] = processor
        t = threading.Thread(target=processor.run, daemon=True,
                             name=f"subscriber-{name}")
        self._threads[name] = t
        t.start()

    def remove(self, name: str) -> None:
        p = self.processors.pop(name, None)
        if p is not None:
            p.stop()
        t = self._threads.pop(name, None)
        if t is not None:
            t.join(timeout=5)

    def stop_all(self) -> None:
        for name in list(self.processors):
            self.remove(name)


class SubscriberController:
    """Syncs job assignments from the cluster controller.

    Reference: subscriber/common/job/controller.go:107 — polls the
    assignment endpoint (which doubles as the subscriber heartbeat) and
    reconciles the running processors.
    """

    def __init__(self, controller_address: str, namespace: str, name: str,
                 make_processor: Callable[[Dict[str, Any]], StreamingProcessor],
                 poll_seconds: float = 5.0, session=None):
        from aresdb_tpu_torch.cluster.failover import (
            FailoverSession, parse_addresses)

        addresses = parse_addresses(controller_address)
        self.base = f"http://{addresses[0]}"
        self.namespace = namespace
        self.name = name
        self.make_processor = make_processor
        self.driver = Driver()
        self.poll_seconds = poll_seconds
        self.session = session or FailoverSession(addresses)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sync_once(self) -> List[str]:
        r = self.session.get(
            f"{self.base}/assignment/{self.namespace}/subscribers/{self.name}",
            timeout=10)
        r.raise_for_status()
        jobs = {j["name"]: j for j in r.json()}
        for name in list(self.driver.processors):
            if name not in jobs:
                self.driver.remove(name)
        for name, job in jobs.items():
            if name not in self.driver.processors:
                self.driver.add(name, self.make_processor(job))
        return sorted(jobs)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.poll_seconds):
                try:
                    self.sync_once()
                except Exception:
                    pass

        self.sync_once()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="subscriber-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.driver.stop_all()
