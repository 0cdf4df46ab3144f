"""Redolog manager master: file / kafka / composite backend factory.

Reference: redolog/redolog_manager_master.go:45 (NewRedologManagerMaster),
redolog/kafka_redolog_manager.go:29 (virtual 5000-batch "files" over
partition offsets, commit/checkpoint offsets in the metastore),
redolog/composite_redolog_manager.go:27 (kafka ingest + local file recovery).

The Kafka LOGIC is fully implemented against the injectable transport in
`redolog/kafka.py`; tests drive it with FakeKafkaBroker and a real client
plugs in through ConfluentKafkaTransport (the library itself is the only
gated piece, mirroring the reference's dependency on sarama).

Durability departure from the reference composite manager: consumed Kafka
batches are written through `save_upsert_batch` into the LOCAL file WAL
before application, so recovery is purely file-based and crash-safe even if
the broker GCs past data. The reference instead re-reads Kafka from the
last commit offset on restart (composite_redolog_manager.go:63).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, Optional, Tuple

from aresdb_tpu_torch.redolog.file_redolog import FileRedoLogManager
from aresdb_tpu_torch.redolog.kafka import KafkaTransport, redolog_topic

KAFKA_VIRTUAL_FILE_BATCHES = 5000  # reference: maxBatchesPerFile
KAFKA_COMMIT_INTERVAL = 100        # reference: commitInterval

log = logging.getLogger("aresdb.redolog")


class KafkaRedoLogManager:
    """Kafka-as-WAL: partition offsets grouped into virtual files of 5000
    batches (kafka_redolog_manager.go:29). The partition IS the redolog;
    appending locally is disabled (IsAppendEnabled → false) — data arrives
    by consuming the topic.
    """

    def __init__(self, table: str, shard: int, metastore,
                 transport: KafkaTransport, topic: Optional[str] = None,
                 namespace: str = ""):
        self.table = table
        self.shard = shard
        self.metastore = metastore
        self.transport = transport
        self.topic = topic or redolog_topic(namespace, table)
        # per-virtual-file metadata (kafka_redolog_manager.go:38-42)
        self.max_event_time_per_file = {}
        self.first_kafka_offset_per_file = {}
        self.size_per_file = {}
        self.total_size = 0
        self.batch_received = 0
        self.batch_recovered = 0
        self._lock = threading.RLock()
        self._replay_pos = 0   # next kafka offset to stream from
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- virtual file arithmetic --

    @staticmethod
    def offset_to_file(offset: int) -> int:
        return offset // KAFKA_VIRTUAL_FILE_BATCHES

    @staticmethod
    def offset_to_batch(offset: int) -> int:
        return offset % KAFKA_VIRTUAL_FILE_BATCHES

    @staticmethod
    def file_to_offset(redo_file: int, batch_offset: int) -> int:
        return redo_file * KAFKA_VIRTUAL_FILE_BATCHES + batch_offset

    # -- RedoLogManager interface --

    def append(self, batch_bytes: bytes, max_event_time: int = 0
               ) -> Tuple[int, int]:
        raise RuntimeError(
            "append is disabled on the kafka redolog manager: the topic is "
            "the WAL; produce to it instead (IsAppendEnabled=false, "
            "kafka_redolog_manager.go:95)")

    def _track(self, offset: int, size: int) -> None:
        fid = self.offset_to_file(offset)
        with self._lock:
            first = self.first_kafka_offset_per_file.get(fid)
            if first is None or first > offset:
                self.first_kafka_offset_per_file[fid] = offset
            self.size_per_file[fid] = self.size_per_file.get(fid, 0) + size
            self.total_size += size

    def iterate(self, checkpoint_file: int = 0, checkpoint_offset: int = 0
                ) -> Iterator[Tuple[int, int, bytes]]:
        """Recovery replay: [max(arg checkpoint, stored checkpoint offset),
        commit offset) — the same window the reference's Iterator covers
        with includeRecovery=true (getKafkaOffsets)."""
        start = max(self.file_to_offset(checkpoint_file, checkpoint_offset),
                    self.metastore.get_kafka_checkpoint_offset(
                        self.table, self.shard))
        commit = self.metastore.get_kafka_commit_offset(self.table,
                                                        self.shard)
        hi = self.transport.high_watermark(self.topic, self.shard)
        end = min(max(commit, start), hi)
        pos = start
        while pos < end:
            msgs = self.transport.fetch(self.topic, self.shard, pos,
                                        max_messages=min(500, end - pos))
            if not msgs:
                break
            past_end = False
            for offset, value in msgs:
                if offset >= end:
                    # retention/compaction skipped past the replay window:
                    # no message in [pos, end) remains — stop, or the
                    # unadvanced pos refetches the same window forever
                    past_end = True
                    break
                self._track(offset, len(value))
                self.batch_recovered += 1
                pos = offset + 1
                yield (self.offset_to_file(offset),
                       self.offset_to_batch(offset), value)
            if past_end:
                break
        self._replay_pos = max(pos, end)

    # -- streaming ingest (the ongoing half of the reference Iterator) --

    def start_streaming(self, shard) -> None:
        """Consume the topic from the commit offset and apply batches to
        the live store. Virtual (file, batch) ids flow into the normal
        checkpoint machinery; the commit offset advances every
        KAFKA_COMMIT_INTERVAL batches (addMessage commit cadence)."""
        from aresdb_tpu_torch.common.upsert_batch import UpsertBatch

        start = max(self._replay_pos,
                    self.metastore.get_kafka_commit_offset(
                        self.table, self.shard))

        def loop():
            pos = start
            since_commit = 0
            while not self._stop.is_set():
                msgs = self.transport.fetch(self.topic, self.shard, pos,
                                            timeout=0.2)
                for offset, value in msgs:
                    if self._stop.is_set():
                        return
                    fid = self.offset_to_file(offset)
                    foff = self.offset_to_batch(offset)
                    self._track(offset, len(value))
                    try:
                        batch = UpsertBatch(value)
                        with shard.writer_lock:
                            shard.apply_upsert_batch(
                                batch, recovery=False,
                                redo_file=fid, batch_offset=foff)
                            shard.live_store.advance_last_read_record()
                        et = shard._max_event_time(batch)
                        if et:
                            self.update_max_event_time(et, fid)
                    except Exception:  # noqa: BLE001 — poison message must
                        log.exception(   # not kill the consumer loop
                            "kafka batch apply failed %s/%s offset %d",
                            self.table, self.shard, offset)
                    self.batch_received += 1
                    since_commit += 1
                    pos = offset + 1
                    if since_commit >= KAFKA_COMMIT_INTERVAL:
                        self.metastore.update_kafka_commit_offset(
                            self.table, self.shard, pos)
                        since_commit = 0
            self.metastore.update_kafka_commit_offset(self.table,
                                                      self.shard, pos)

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"kafka-redolog-{self.table}-{self.shard}")
        self._thread.start()

    def update_max_event_time(self, event_time: int, redo_file: int) -> None:
        with self._lock:
            prev = self.max_event_time_per_file.get(redo_file, 0)
            if event_time > prev:
                self.max_event_time_per_file[redo_file] = event_time

    def checkpoint(self, cutoff: int, checkpoint_file: int,
                   checkpoint_offset: int) -> None:
        """Persist the first unpurgeable kafka offset and drop tracking of
        fully-covered virtual files (CheckpointRedolog,
        kafka_redolog_manager.go:115)."""
        with self._lock:
            first_fid = None
            first_offset = None
            for fid, max_et in self.max_event_time_per_file.items():
                purgeable = (max_et < cutoff and fid < checkpoint_file) or (
                    fid == checkpoint_file
                    and checkpoint_offset == KAFKA_VIRTUAL_FILE_BATCHES - 1
                    and max_et < cutoff)
                if not purgeable:
                    if first_fid is None or fid < first_fid:
                        first_fid = fid
                        first_offset = self.first_kafka_offset_per_file.get(
                            fid, self.file_to_offset(fid, 0))
            if first_fid is None:
                return
            self.metastore.update_kafka_checkpoint_offset(
                self.table, self.shard, first_offset)
            for fid in [f for f in self.max_event_time_per_file
                        if f < first_fid]:
                self.max_event_time_per_file.pop(fid, None)
                self.first_kafka_offset_per_file.pop(fid, None)
                self.total_size -= self.size_per_file.pop(fid, 0)

    def get_total_size(self) -> int:
        return self.total_size

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class CompositeRedoLogManager:
    """Kafka ingestion + local file durability/recovery (reference
    composite manager). HTTP-ingested batches append to the file WAL as
    usual; consumed Kafka batches are written through the same
    save_upsert_batch path (so they hit the file WAL too — see module
    docstring), and the kafka commit offset advances after the local
    append, making re-consumption after a crash idempotent via PK upserts.
    """

    def __init__(self, file_manager: FileRedoLogManager,
                 table: str, shard: int, metastore,
                 transport: KafkaTransport, topic: Optional[str] = None,
                 namespace: str = ""):
        self.file_manager = file_manager
        self.table = table
        self.shard = shard
        self.metastore = metastore
        self.transport = transport
        self.topic = topic or redolog_topic(namespace, table)
        self.batch_received = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # file-backed interface (recovery + HTTP ingest WAL)

    def append(self, batch_bytes: bytes, max_event_time: int = 0):
        return self.file_manager.append(batch_bytes, max_event_time)

    def iterate(self, checkpoint_file: int = 0, checkpoint_offset: int = 0):
        return self.file_manager.iterate(checkpoint_file, checkpoint_offset)

    def checkpoint(self, cutoff: int, checkpoint_file: int,
                   checkpoint_offset: int) -> None:
        self.file_manager.checkpoint(cutoff, checkpoint_file,
                                     checkpoint_offset)

    def update_max_event_time(self, event_time: int, redo_file: int) -> None:
        self.file_manager.update_max_event_time(event_time, redo_file)

    def get_total_size(self) -> int:
        return self.file_manager.get_total_size()

    # kafka ingest loop

    def start_streaming(self, shard) -> None:
        from aresdb_tpu_torch.common.upsert_batch import UpsertBatch

        start = self.metastore.get_kafka_commit_offset(self.table,
                                                       self.shard)

        def loop():
            pos = start
            since_commit = 0
            while not self._stop.is_set():
                msgs = self.transport.fetch(self.topic, self.shard, pos,
                                            timeout=0.2)
                for offset, value in msgs:
                    if self._stop.is_set():
                        return
                    try:
                        # write-through: WAL append + apply in one locked
                        # step (save_upsert_batch routes append to the
                        # file manager above)
                        shard.save_upsert_batch(UpsertBatch(value))
                    except Exception:  # noqa: BLE001 — poison message
                        log.exception(
                            "kafka batch apply failed %s/%s offset %d",
                            self.table, self.shard, offset)
                    self.batch_received += 1
                    since_commit += 1
                    pos = offset + 1
                    if since_commit >= KAFKA_COMMIT_INTERVAL:
                        self.metastore.update_kafka_commit_offset(
                            self.table, self.shard, pos)
                        since_commit = 0
            self.metastore.update_kafka_commit_offset(self.table,
                                                      self.shard, pos)

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"kafka-composite-{self.table}-{self.shard}")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.file_manager.close()


class RedoLogManagerMaster:
    """Per-(table, shard) manager factory (reference master :45).

    Mode matrix (redolog_manager_master.go NewRedologManager):
      disk only            → FileRedoLogManager
      disk + kafka         → CompositeRedoLogManager
      kafka only           → KafkaRedoLogManager (topic is the WAL)
    """

    def __init__(self, diskstore, metastore, redo_log_config=None,
                 transport: Optional[KafkaTransport] = None,
                 namespace: str = ""):
        self.diskstore = diskstore
        self.metastore = metastore
        self.config = redo_log_config
        self.transport = transport
        self.namespace = namespace
        self.managers = {}

    def _kafka_transport(self) -> KafkaTransport:
        if self.transport is None:
            from aresdb_tpu_torch.redolog.kafka import make_transport

            self.transport = make_transport(
                getattr(self.config, "kafka_brokers", []))
        return self.transport

    def new_redolog_manager(self, table: str, shard: int, table_config):
        key = (table, shard)
        if key in self.managers:
            return self.managers[key]
        cfg = self.config
        kafka_on = cfg is not None and getattr(cfg, "kafka_enabled", False)
        disk_on = cfg is None or getattr(cfg, "disk_enabled", True)
        if disk_on:
            file_mgr = FileRedoLogManager(
                table, shard, self.diskstore,
                rotation_interval=table_config.redo_log_rotation_interval,
                max_redolog_size=table_config.max_redo_log_file_size)
            if kafka_on:
                mgr = CompositeRedoLogManager(
                    file_mgr, table, shard, self.metastore,
                    self._kafka_transport(), namespace=self.namespace)
            else:
                mgr = file_mgr
        elif kafka_on:
            mgr = KafkaRedoLogManager(
                table, shard, self.metastore, self._kafka_transport(),
                namespace=self.namespace)
        else:
            raise ValueError("redolog config enables neither disk nor kafka")
        self.managers[key] = mgr
        return mgr

    def stop(self, table: str, shard: int) -> None:
        mgr = self.managers.pop((table, shard), None)
        if mgr is not None:
            mgr.close()

    def stop_all(self) -> None:
        for key in list(self.managers):
            self.stop(*key)
