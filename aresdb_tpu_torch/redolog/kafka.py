"""Kafka transport abstraction for redolog + subscriber paths.

The logic that the reference implements against sarama
(redolog/kafka_redolog_manager.go, subscriber/common/sink/kafka.go) lives
here against a minimal injectable transport, so the semantics are fully
testable with `FakeKafkaBroker` and a real client plugs in via one adapter
class (`ConfluentKafkaTransport`, gated on the library being installed).

Message model: a (topic, partition) is an append-only offset-indexed log —
exactly Kafka's contract and all the managers rely on.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


def redolog_topic(namespace: str, table: str) -> str:
    """Topic naming parity: subscriber/common/sink/kafka.go:173
    (`ares-redolog-{cluster}-{table}`)."""
    return f"ares-redolog-{namespace}-{table}"


class KafkaTransport:
    """Injectable transport: produce + fetch on (topic, partition) logs."""

    def produce(self, topic: str, partition: int, value: bytes) -> int:
        """Append; returns the assigned offset."""
        raise NotImplementedError

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 500, timeout: float = 0.0
              ) -> List[Tuple[int, bytes]]:
        """Messages from `offset` (inclusive); may return []. Blocks up to
        `timeout` seconds waiting for the first message."""
        raise NotImplementedError

    def high_watermark(self, topic: str, partition: int) -> int:
        """Offset one past the last produced message."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class FakeKafkaBroker(KafkaTransport):
    """In-memory broker for tests and single-process drives.

    Thread-safe; `fetch` can block on a Condition so consumer loops don't
    busy-poll. Messages are retained forever (tests assert checkpoint
    semantics, not broker GC).
    """

    def __init__(self):
        self._logs: Dict[Tuple[str, int], List[bytes]] = {}
        self._cond = threading.Condition()

    def _log(self, topic: str, partition: int) -> List[bytes]:
        return self._logs.setdefault((topic, partition), [])

    def produce(self, topic: str, partition: int, value: bytes) -> int:
        with self._cond:
            log = self._log(topic, partition)
            log.append(bytes(value))
            self._cond.notify_all()
            return len(log) - 1

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 500, timeout: float = 0.0
              ) -> List[Tuple[int, bytes]]:
        deadline = None
        with self._cond:
            log = self._log(topic, partition)
            if timeout > 0:
                import time as _t

                deadline = _t.monotonic() + timeout
                while len(log) <= offset:
                    remaining = deadline - _t.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            end = min(len(log), offset + max_messages)
            return [(i, log[i]) for i in range(offset, end)]

    def high_watermark(self, topic: str, partition: int) -> int:
        with self._cond:
            return len(self._log(topic, partition))


class ConfluentKafkaTransport(KafkaTransport):
    """Real-client adapter (confluent-kafka). Constructed lazily so the
    fake-backed logic carries all test coverage in environments without
    the library (reference gates the same way on sarama)."""

    def __init__(self, brokers: List[str]):
        try:
            import confluent_kafka
        except ImportError as e:
            raise RuntimeError(
                "Kafka transport requires the confluent-kafka package, "
                "which is not installed in this environment") from e
        self._kafka = confluent_kafka
        conf = {"bootstrap.servers": ",".join(brokers)}
        self._producer = confluent_kafka.Producer(conf)
        self._conf = conf
        self._consumers: Dict[Tuple[str, int], object] = {}

    def produce(self, topic: str, partition: int, value: bytes) -> int:
        holder: Dict[str, int] = {}

        def _cb(err, msg):
            if err is None:
                holder["offset"] = msg.offset()

        self._producer.produce(topic, value=value, partition=partition,
                               callback=_cb)
        self._producer.flush(30)
        return holder.get("offset", -1)

    def _consumer(self, topic: str, partition: int):
        key = (topic, partition)
        c = self._consumers.get(key)
        if c is None:
            c = self._kafka.Consumer({
                **self._conf,
                "group.id": f"aresdb-{topic}-{partition}",
                "enable.auto.commit": False,
            })
            self._consumers[key] = c
        return c

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 500, timeout: float = 0.0
              ) -> List[Tuple[int, bytes]]:
        c = self._consumer(topic, partition)
        c.assign([self._kafka.TopicPartition(topic, partition, offset)])
        out: List[Tuple[int, bytes]] = []
        msgs = c.consume(max_messages, timeout if timeout > 0 else 0.05)
        for m in msgs:
            if m.error() is None:
                out.append((m.offset(), m.value()))
        return out

    def high_watermark(self, topic: str, partition: int) -> int:
        c = self._consumer(topic, partition)
        _, hi = c.get_watermark_offsets(
            self._kafka.TopicPartition(topic, partition))
        return hi

    def close(self) -> None:
        for c in self._consumers.values():
            c.close()


def make_transport(brokers: Optional[List[str]] = None,
                   transport: Optional[KafkaTransport] = None
                   ) -> KafkaTransport:
    """transport injection point: tests pass a FakeKafkaBroker; production
    config passes broker addresses for the real client."""
    if transport is not None:
        return transport
    return ConfluentKafkaTransport(brokers or [])
