"""File-based write-ahead redo log.

Reference: redolog/file_redolog_manager.go. File format kept compatible:
each .redolog file starts with the uint32 magic 0xADDAFEED, followed by
length-prefixed upsert batches ([uint32 size][batch bytes]); corrupt tails
are truncated on replay (file_redolog_manager.go:261-265).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Optional, Tuple

from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
from aresdb_tpu_torch.utils import clock

UPSERT_HEADER = 0xADDAFEED


class FileRedoLogManager:
    def __init__(self, table: str, shard: int, diskstore: LocalDiskStore,
                 rotation_interval: int = 10800,
                 max_redolog_size: int = 1 << 30):
        self.table = table
        self.shard = shard
        self.diskstore = diskstore
        self.rotation_interval = rotation_interval
        self.max_redolog_size = max_redolog_size
        self.current_file: Optional[int] = None  # creation time
        self.current_size = 0
        self._fh = None
        # creation time -> max event time seen, for checkpoint purging
        self.max_event_time_per_file: Dict[int, int] = {}
        self.batch_count_per_file: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # append path
    # ------------------------------------------------------------------

    def _rotate_if_needed(self) -> None:
        now = clock.now_unix()
        needs_new = (
            self.current_file is None
            or self.current_size >= self.max_redolog_size
            or now >= self.current_file + self.rotation_interval
        )
        if needs_new:
            if self._fh is not None:
                self._fh.close()
            creation = now
            # avoid collision with an existing file in the same second
            existing = set(self.diskstore.list_logs(self.table, self.shard))
            while creation in existing:
                creation += 1
            self.current_file = creation
            self._fh = self.diskstore.open_log_for_append(
                self.table, self.shard, creation)
            self._fh.write(struct.pack("<I", UPSERT_HEADER))
            self._fh.flush()
            self.current_size = 4
            self.batch_count_per_file[creation] = 0

    def append(self, batch_bytes: bytes, max_event_time: int = 0
               ) -> Tuple[int, int]:
        """Append a serialized upsert batch; returns (redo_file, offset).

        offset is the batch ordinal within the file (matching the reference's
        batch-offset semantics used in checkpoints, not a byte offset).
        """
        self._rotate_if_needed()
        self._fh.write(struct.pack("<I", len(batch_bytes)))
        self._fh.write(batch_bytes)
        self._fh.flush()
        self.current_size += 4 + len(batch_bytes)
        f = self.current_file
        offset = self.batch_count_per_file[f]
        self.batch_count_per_file[f] = offset + 1
        if max_event_time:
            prev = self.max_event_time_per_file.get(f, 0)
            self.max_event_time_per_file[f] = max(prev, max_event_time)
        from aresdb_tpu_torch.utils import metrics as M

        rep = M.root().scoped(table=self.table, shard=str(self.shard))
        rep.gauge(M.CURRENT_REDOLOG_CREATION_TIME, f)
        rep.gauge(M.CURRENT_REDOLOG_SIZE, self.current_size)
        rep.gauge(M.NUMBER_OF_REDOLOGS, len(self.batch_count_per_file))
        return f, offset

    def update_max_event_time(self, event_time: int, redo_file: int) -> None:
        prev = self.max_event_time_per_file.get(redo_file, 0)
        self.max_event_time_per_file[redo_file] = max(prev, event_time)

    # ------------------------------------------------------------------
    # replay path
    # ------------------------------------------------------------------

    def iterate(self, checkpoint_file: int = 0, checkpoint_offset: int = 0
                ) -> Iterator[Tuple[int, int, bytes]]:
        """Yield (redo_file, batch_offset, batch_bytes) after the checkpoint.

        Batches at (file < checkpoint_file) or (== file, offset < checkpoint
        offset) are skipped — they're covered by archive/snapshot data.
        Corrupt tails are truncated (reference behavior).
        """
        for creation in self.diskstore.list_logs(self.table, self.shard):
            if creation < checkpoint_file:
                continue
            count = 0
            with self.diskstore.open_log_for_read(self.table, self.shard,
                                                  creation) as f:
                head = f.read(4)
                if len(head) < 4 or struct.unpack("<I", head)[0] != UPSERT_HEADER:
                    # corrupt file header: truncate everything
                    self.diskstore.truncate_log(self.table, self.shard,
                                                creation, 0)
                    continue
                pos = 4
                while True:
                    size_raw = f.read(4)
                    if len(size_raw) == 0:
                        break
                    if len(size_raw) < 4:
                        self.diskstore.truncate_log(self.table, self.shard,
                                                    creation, pos)
                        break
                    (size,) = struct.unpack("<I", size_raw)
                    payload = f.read(size)
                    if len(payload) < size:
                        self.diskstore.truncate_log(self.table, self.shard,
                                                    creation, pos)
                        break
                    pos += 4 + size
                    offset = count
                    count += 1
                    if creation == checkpoint_file and offset < checkpoint_offset:
                        continue
                    yield creation, offset, payload
            self.batch_count_per_file[creation] = count

    # ------------------------------------------------------------------
    # checkpointing (reference: CheckpointRedolog redolog_manager.go:44)
    # ------------------------------------------------------------------

    def checkpoint(self, cutoff: int, checkpoint_file: int,
                   checkpoint_offset: int) -> None:
        """Purge redo files fully covered by the archiving cutoff and the
        backfill checkpoint (reference getRedoLogFilesToPurge
        file_redolog_manager.go:347): every batch has event time < cutoff
        AND the file is either older than the checkpointed file or IS the
        checkpointed file with every batch checkpointed (batch count ==
        offset + 1). The current ingestion file is never purged."""
        for creation in self.diskstore.list_logs(self.table, self.shard):
            if self.current_file is not None and creation >= self.current_file:
                continue
            max_et = self.max_event_time_per_file.get(creation)
            if max_et is None:
                continue
            fully_checkpointed = (
                creation == checkpoint_file
                and self.batch_count_per_file.get(creation)
                == checkpoint_offset + 1)
            if max_et < cutoff and (creation < checkpoint_file
                                    or fully_checkpointed):
                self.diskstore.delete_log(self.table, self.shard, creation)
                self.max_event_time_per_file.pop(creation, None)
                self.batch_count_per_file.pop(creation, None)
        from aresdb_tpu_torch.utils import metrics as M

        rep = M.root().scoped(table=self.table, shard=str(self.shard))
        rep.gauge(M.NUMBER_OF_REDOLOGS, len(self.batch_count_per_file))
        rep.gauge(M.SIZE_OF_REDOLOGS, self.get_total_size())

    def get_total_size(self) -> int:
        return self.current_size

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
