"""Disk-backed metastore: schemas, enums, watermarks, batch versions.

Reference: metastore/disk_metastore.go (file-per-concern json/text layout
under {root}/metastore) and metastore/common/types.go MetaStore interface.

Layout:
    {root}/metastore/{table}/schema              (json Table)
    {root}/metastore/{table}/enums/{column}      (cases joined by "\\0\\n",
        byte-compatible with the reference's EnumDelimiter
        metastore/common/data_type.go:19 / disk_metastore.go:1169,1193)
    {root}/metastore/{table}/shards/{shard}/version         (archiving cutoff)
    {root}/metastore/{table}/shards/{shard}/redolog-offset  (checkpointed redo)
    {root}/metastore/{table}/shards/{shard}/snapshot        (snapshot progress)
    {root}/metastore/{table}/shards/{shard}/backfill-offset (backfill progress)
    {root}/metastore/{table}/shards/{shard}/batches/{batchID} (version list)
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from aresdb_tpu_torch.common.schema import Table

# Reference metastore/common/data_type.go:19 — enum cases are joined with
# a NUL+newline delimiter so cases may contain spaces, commas, etc.
ENUM_DELIMITER = "\u0000\n"


class DiskMetaStore:
    def __init__(self, root_path: str):
        self.root = os.path.join(root_path, "metastore")
        os.makedirs(self.root, exist_ok=True)
        self.lock = threading.RLock()
        self._schema_watchers: List[Callable[[Table], None]] = []
        self._enum_watchers: List[Callable[[str, str, List[str]], None]] = []

    # ------------------------------------------------------------------
    # schema
    # ------------------------------------------------------------------

    def _table_dir(self, table: str) -> str:
        return os.path.join(self.root, table)

    def _shard_dir(self, table: str, shard: int) -> str:
        return os.path.join(self._table_dir(table), "shards", str(shard))

    def list_tables(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            t for t in os.listdir(self.root)
            if os.path.exists(os.path.join(self.root, t, "schema")))

    def create_table(self, table: Table) -> None:
        from aresdb_tpu_torch.metastore.validator import validate_table

        with self.lock:
            validate_table(table)
            d = self._table_dir(table.name)
            if os.path.exists(os.path.join(d, "schema")):
                raise ValueError(f"table {table.name!r} already exists")
            os.makedirs(d, exist_ok=True)
            self._write(os.path.join(d, "schema"),
                        json.dumps(table.to_json()).encode())
            # seed default enum cases into the enum files so file ranks
            # and runtime dicts agree (reference disk_metastore.go:490)
            for col in table.columns:
                if (not col.deleted and col.is_enum_column()
                        and col.default_value is not None):
                    self.extend_enum_cases(table.name, col.name,
                                           [col.default_value])
            for w in self._schema_watchers:
                w(table)

    def update_table(self, table: Table) -> None:
        from aresdb_tpu_torch.metastore.validator import validate_table

        with self.lock:
            d = self._table_dir(table.name)
            if not os.path.exists(os.path.join(d, "schema")):
                raise KeyError(f"table {table.name!r} does not exist")
            old = self.get_table(table.name)
            validate_table(table, old=old)
            self._write(os.path.join(d, "schema"),
                        json.dumps(table.to_json()).encode())
            # newly added enum columns with defaults seed their enum file
            # (reference disk_metastore.go:557,1044 AddColumn)
            old_names = {c.name for c in old.columns}
            for col in table.columns:
                if (not col.deleted and col.is_enum_column()
                        and col.default_value is not None
                        and col.name not in old_names):
                    self.extend_enum_cases(table.name, col.name,
                                           [col.default_value])
            for w in self._schema_watchers:
                w(table)

    def get_table(self, name: str) -> Table:
        p = os.path.join(self._table_dir(name), "schema")
        if not os.path.exists(p):
            raise KeyError(f"table {name!r} does not exist")
        with open(p) as f:
            return Table.from_json(json.load(f))

    def delete_table(self, name: str) -> None:
        import shutil
        with self.lock:
            shutil.rmtree(self._table_dir(name), ignore_errors=True)

    def delete_table_shard(self, table: str, shard: int) -> None:
        """Drop a shard's watermarks and batch versions, its schema kept
        (a failed peer copy's entries, datanode/datanode.py)."""
        import shutil
        with self.lock:
            shutil.rmtree(self._shard_dir(table, shard), ignore_errors=True)

    def watch_schema(self, callback: Callable[[Table], None]) -> None:
        self._schema_watchers.append(callback)

    # ------------------------------------------------------------------
    # enums (append-only log per column)
    # ------------------------------------------------------------------

    def extend_enum_cases(self, table: str, column: str,
                          cases: List[str]) -> List[int]:
        """Rank for each requested case, appending only genuinely new ones
        (reference ExtendEnumDict, metastore/disk_metastore.go: dedup
        against the existing file, enum-cardinality overflow check,
        watchers see only the new cases)."""
        with self.lock:
            existing = self.get_enum_cases(table, column)
            index = {c: i for i, c in enumerate(existing)}
            ranks: List[int] = []
            new: List[str] = []
            for c in cases:
                rank = index.get(c)
                if rank is None:
                    rank = len(index)
                    index[c] = rank
                    new.append(c)
                ranks.append(rank)
            if new:
                limit = self._enum_cardinality(table, column)
                if limit and len(index) > limit:
                    raise ValueError(
                        f"enum cardinality overflow for {table}.{column}: "
                        f"{len(index)} > {limit}")
                d = os.path.join(self._table_dir(table), "enums")
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, column), "a",
                          encoding="utf-8") as f:
                    for c in new:
                        f.write(c + ENUM_DELIMITER)
                for w in self._enum_watchers:
                    w(table, column, new)
            return ranks

    def _enum_cardinality(self, table: str, column: str) -> int:
        """256 for SmallEnum, 65536 for BigEnum, 0 (no limit) if the
        schema is unavailable (reference common.EnumCardinality)."""
        try:
            t = self.get_table(table)
        except Exception:
            return 0
        for col in t.columns:
            if col.name == column:
                from aresdb_tpu_torch.common import data_types as dt

                if col.data_type == dt.SmallEnum:
                    return 256
                if col.data_type == dt.BigEnum:
                    return 65536
        return 0

    def get_enum_cases(self, table: str, column: str) -> List[str]:
        p = os.path.join(self._table_dir(table), "enums", column)
        if not os.path.exists(p):
            return []
        with open(p, encoding="utf-8") as f:
            data = f.read()
        if not data:
            return []
        if data.endswith(ENUM_DELIMITER):
            data = data[: -len(ENUM_DELIMITER)]
        return data.split(ENUM_DELIMITER)

    def watch_enums(self, callback: Callable[[str, str, List[str]], None]) -> None:
        self._enum_watchers.append(callback)

    # ------------------------------------------------------------------
    # per-shard watermarks
    # ------------------------------------------------------------------

    def update_archiving_cutoff(self, table: str, shard: int, cutoff: int) -> None:
        self._write_shard(table, shard, "version", str(cutoff).encode())

    def get_archiving_cutoff(self, table: str, shard: int) -> int:
        return int(self._read_shard(table, shard, "version", b"0"))

    def update_redolog_checkpoint(self, table: str, shard: int,
                                  redo_file: int, offset: int) -> None:
        self._write_shard(table, shard, "redolog-offset",
                          f"{redo_file},{offset}".encode())

    def get_redolog_checkpoint(self, table: str, shard: int) -> Tuple[int, int]:
        raw = self._read_shard(table, shard, "redolog-offset", b"0,0").decode()
        rf, off = raw.split(",")
        return int(rf), int(off)

    def update_backfill_progress(self, table: str, shard: int,
                                 redo_file: int, offset: int) -> None:
        self._write_shard(table, shard, "backfill-offset",
                          f"{redo_file},{offset}".encode())

    def get_backfill_progress(self, table: str, shard: int) -> Tuple[int, int]:
        raw = self._read_shard(table, shard, "backfill-offset", b"0,0").decode()
        rf, off = raw.split(",")
        return int(rf), int(off)

    def update_kafka_commit_offset(self, table: str, shard: int,
                                   offset: int) -> None:
        """Last consumed kafka offset (reference metastore
        UpdateRedoLogCommitOffset, metastore/common/types.go:80)."""
        self._write_shard(table, shard, "kafka-commit-offset",
                          str(offset).encode())

    def get_kafka_commit_offset(self, table: str, shard: int) -> int:
        return int(self._read_shard(table, shard, "kafka-commit-offset",
                                    b"0"))

    def update_kafka_checkpoint_offset(self, table: str, shard: int,
                                       offset: int) -> None:
        """First kafka offset NOT yet covered by archive/backfill progress
        (UpdateRedoLogCheckpointOffset, types.go:86)."""
        self._write_shard(table, shard, "kafka-checkpoint-offset",
                          str(offset).encode())

    def get_kafka_checkpoint_offset(self, table: str, shard: int) -> int:
        return int(self._read_shard(table, shard, "kafka-checkpoint-offset",
                                    b"0"))

    def update_snapshot_progress(self, table: str, shard: int, redo_file: int,
                                 offset: int, batch_id: int, index: int) -> None:
        self._write_shard(table, shard, "snapshot",
                          f"{redo_file},{offset},{batch_id},{index}".encode())

    def get_snapshot_progress(self, table: str, shard: int
                              ) -> Tuple[int, int, int, int]:
        raw = self._read_shard(table, shard, "snapshot", b"0,0,0,0").decode()
        rf, off, bid, idx = raw.split(",")
        return int(rf), int(off), int(bid), int(idx)

    # ------------------------------------------------------------------
    # archive batch versions
    # ------------------------------------------------------------------

    def add_archive_batch_version(self, table: str, shard: int, batch_id: int,
                                  version: int, seq: int, size: int) -> None:
        """Append a batch-version line in the reference's on-disk format:
        'version,size' or 'version-seqNum,size' (metastore/disk_metastore.go
        AddArchiveBatchVersion; asserted byte-exact by
        disk_metastore_test.go:611-626)."""
        d = os.path.join(self._shard_dir(table, shard), "batches")
        os.makedirs(d, exist_ok=True)
        ver = f"{version}-{seq}" if seq else str(version)
        with self.lock:
            with open(os.path.join(d, str(batch_id)), "a") as f:
                f.write(f"{ver},{size}\n")

    def get_archive_batches(self, table: str, shard: int,
                            cutoff: Optional[int] = None
                            ) -> Dict[int, Tuple[int, int, int]]:
        """Latest (version, seq, size) per batch id, restricted to versions
        <= cutoff when given (reference: disk_metastore GetArchiveBatches)."""
        d = os.path.join(self._shard_dir(table, shard), "batches")
        if not os.path.isdir(d):
            return {}
        out: Dict[int, Tuple[int, int, int]] = {}
        for name in os.listdir(d):
            try:
                bid = int(name)
            except ValueError:
                continue
            best: Optional[Tuple[int, int, int]] = None
            with open(os.path.join(d, name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split(",")
                    if len(parts) == 3:
                        # legacy round-1/2 format 'version,seq,size'
                        ver, seq, size = (int(x) for x in parts)
                    else:
                        vs, size_s = parts
                        ver_s, _, seq_s = vs.partition("-")
                        ver, seq, size = int(ver_s), int(seq_s or 0), int(size_s)
                    if cutoff is not None and ver > cutoff:
                        continue
                    if best is None or (ver, seq) > (best[0], best[1]):
                        best = (ver, seq, size)
            if best is not None:
                out[bid] = best
        return out

    def purge_archive_batches(self, table: str, shard: int,
                              batch_id_cutoff: int) -> List[int]:
        """Remove metadata for batches older than cutoff; returns purged ids."""
        d = os.path.join(self._shard_dir(table, shard), "batches")
        if not os.path.isdir(d):
            return []
        purged = []
        for name in os.listdir(d):
            try:
                bid = int(name)
            except ValueError:
                continue
            if bid < batch_id_cutoff:
                os.remove(os.path.join(d, name))
                purged.append(bid)
        return sorted(purged)

    # ------------------------------------------------------------------
    # io helpers
    # ------------------------------------------------------------------

    def _write_shard(self, table: str, shard: int, name: str, data: bytes) -> None:
        d = self._shard_dir(table, shard)
        os.makedirs(d, exist_ok=True)
        self._write(os.path.join(d, name), data)

    def _read_shard(self, table: str, shard: int, name: str,
                    default: bytes) -> bytes:
        p = os.path.join(self._shard_dir(table, shard), name)
        if not os.path.exists(p):
            return default
        with open(p, "rb") as f:
            return f.read()

    @staticmethod
    def _write(path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
