"""Local filesystem disk store.

Reference: diskstore/diskstore.go:24 (interface), local_diskstore.go,
diskstore_util.go. Directory layout matches the reference:

    {root}/data/{table}_{shard}/redologs/{creation_time}.redolog
    {root}/data/{table}_{shard}/snapshots/{redo}_{offset}/{batchID}/{col}.data
    {root}/data/{table}_{shard}/archiving_batches/{date}_{version}[-{seq}]/{col}.data

Archive batch directories use the reference's "2006-01-02" DATE string of
the day batch (diskstore/local_diskstore.go:46 timeFormatForBatchID), e.g.
2017-07-19_1499971253, not the raw days-since-epoch integer.
"""

from __future__ import annotations

import datetime as _dt
import os
import re
import shutil
from typing import BinaryIO, List, Optional, Tuple

_EPOCH = _dt.date(1970, 1, 1)


def _batch_id_str(batch_id: int) -> str:
    return (_EPOCH + _dt.timedelta(days=batch_id)).strftime("%Y-%m-%d")


def _parse_batch_dir(name: str) -> Optional[Tuple[int, int, int]]:
    """'2017-07-19_1499971253[-seq]' -> (days, version, seq); also accepts
    a legacy integer batch id."""
    m = re.match(r"^(\d{4}-\d{2}-\d{2}|-?\d+)_(\d+)(?:-(\d+))?$", name)
    if not m:
        return None
    bid = m.group(1)
    if "-" in bid and not bid.lstrip("-").isdigit():
        days = (_dt.date.fromisoformat(bid) - _EPOCH).days
    else:
        days = int(bid)
    return days, int(m.group(2)), int(m.group(3) or 0)


class LocalDiskStore:
    def __init__(self, root_path: str):
        self.root = root_path

    # ------------------------------------------------------------------
    # path helpers
    # ------------------------------------------------------------------

    def _shard_dir(self, table: str, shard: int) -> str:
        return os.path.join(self.root, "data", f"{table}_{shard}")

    def redolog_dir(self, table: str, shard: int) -> str:
        return os.path.join(self._shard_dir(table, shard), "redologs")

    def redolog_path(self, table: str, shard: int, creation_time: int) -> str:
        return os.path.join(self.redolog_dir(table, shard), f"{creation_time}.redolog")

    def snapshot_dir(self, table: str, shard: int) -> str:
        return os.path.join(self._shard_dir(table, shard), "snapshots")

    def snapshot_batch_dir(self, table: str, shard: int, redo_file: int,
                           offset: int, batch_id: int) -> str:
        return os.path.join(self.snapshot_dir(table, shard),
                            f"{redo_file}_{offset}", str(batch_id))

    def archive_batch_root(self, table: str, shard: int) -> str:
        return os.path.join(self._shard_dir(table, shard), "archiving_batches")

    def archive_batch_dir(self, table: str, shard: int, batch_id: int,
                          version: int, seq: int = 0) -> str:
        bid = _batch_id_str(batch_id)
        name = f"{bid}_{version}" if seq == 0 else f"{bid}_{version}-{seq}"
        return os.path.join(self.archive_batch_root(table, shard), name)

    # ------------------------------------------------------------------
    # redologs
    # ------------------------------------------------------------------

    def list_logs(self, table: str, shard: int) -> List[int]:
        d = self.redolog_dir(table, shard)
        if not os.path.isdir(d):
            return []
        out = []
        for f in os.listdir(d):
            m = re.match(r"^(\d+)\.redolog$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def open_log_for_append(self, table: str, shard: int,
                            creation_time: int) -> BinaryIO:
        p = self.redolog_path(table, shard, creation_time)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return open(p, "ab")

    def open_log_for_read(self, table: str, shard: int,
                          creation_time: int) -> BinaryIO:
        return open(self.redolog_path(table, shard, creation_time), "rb")

    def delete_log(self, table: str, shard: int, creation_time: int) -> None:
        try:
            os.remove(self.redolog_path(table, shard, creation_time))
        except FileNotFoundError:
            pass

    def truncate_log(self, table: str, shard: int, creation_time: int,
                     offset: int) -> None:
        p = self.redolog_path(table, shard, creation_time)
        with open(p, "r+b") as f:
            f.truncate(offset)

    # ------------------------------------------------------------------
    # snapshots (dimension tables)
    # ------------------------------------------------------------------

    def write_snapshot_column(self, table: str, shard: int, redo_file: int,
                              offset: int, batch_id: int, column_id: int,
                              data: bytes) -> None:
        d = self.snapshot_batch_dir(table, shard, redo_file, offset, batch_id)
        os.makedirs(d, exist_ok=True)
        _atomic_write(os.path.join(d, f"{column_id}.data"), data)

    def read_snapshot_column(self, table: str, shard: int, redo_file: int,
                             offset: int, batch_id: int,
                             column_id: int) -> Optional[bytes]:
        p = os.path.join(
            self.snapshot_batch_dir(table, shard, redo_file, offset, batch_id),
            f"{column_id}.data")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def list_snapshot_batches(self, table: str, shard: int, redo_file: int,
                              offset: int) -> List[int]:
        d = os.path.join(self.snapshot_dir(table, shard), f"{redo_file}_{offset}")
        if not os.path.isdir(d):
            return []
        return sorted(int(b) for b in os.listdir(d) if re.match(r"^-?\d+$", b))

    def list_snapshot_batch_columns(self, table: str, shard: int,
                                    redo_file: int, offset: int,
                                    batch_id: int) -> List[int]:
        d = self.snapshot_batch_dir(table, shard, redo_file, offset, batch_id)
        if not os.path.isdir(d):
            return []
        return sorted(int(f[:-5]) for f in os.listdir(d) if f.endswith(".data"))

    def delete_snapshot(self, table: str, shard: int,
                        latest_redo_file: int, latest_offset: int) -> None:
        """Delete snapshots older than the given watermark."""
        d = self.snapshot_dir(table, shard)
        if not os.path.isdir(d):
            return
        for name in os.listdir(d):
            m = re.match(r"^(\d+)_(\d+)$", name)
            if not m:
                continue
            rf, off = int(m.group(1)), int(m.group(2))
            if (rf, off) < (latest_redo_file, latest_offset):
                shutil.rmtree(os.path.join(d, name), ignore_errors=True)

    # ------------------------------------------------------------------
    # archive batches
    # ------------------------------------------------------------------

    def write_archive_column(self, table: str, shard: int, batch_id: int,
                             version: int, seq: int, column_id: int,
                             data: bytes) -> None:
        d = self.archive_batch_dir(table, shard, batch_id, version, seq)
        os.makedirs(d, exist_ok=True)
        _atomic_write(os.path.join(d, f"{column_id}.data"), data)

    def read_archive_column(self, table: str, shard: int, batch_id: int,
                            version: int, seq: int,
                            column_id: int) -> Optional[bytes]:
        p = os.path.join(self.archive_batch_dir(table, shard, batch_id, version, seq),
                         f"{column_id}.data")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def list_archive_batch_columns(self, table: str, shard: int, batch_id: int,
                                   version: int, seq: int) -> List[int]:
        d = self.archive_batch_dir(table, shard, batch_id, version, seq)
        if not os.path.isdir(d):
            return []
        return sorted(int(f[:-5]) for f in os.listdir(d) if f.endswith(".data"))

    def list_archive_batch_dirs(self, table: str, shard: int
                                ) -> List[Tuple[int, int, int]]:
        """Returns sorted (batch_id, version, seq) of existing batch dirs."""
        d = self.archive_batch_root(table, shard)
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            parsed = _parse_batch_dir(name)
            if parsed is not None:
                out.append(parsed)
        return sorted(out)

    def delete_archive_batch_versions(self, table: str, shard: int,
                                      batch_id: int, keep_version: int,
                                      keep_seq: int) -> None:
        """Remove all versions of a batch except the given one."""
        for bid, ver, seq in self.list_archive_batch_dirs(table, shard):
            if bid == batch_id and (ver, seq) != (keep_version, keep_seq):
                shutil.rmtree(
                    self.archive_batch_dir(table, shard, bid, ver, seq),
                    ignore_errors=True)

    def delete_archive_batch(self, table: str, shard: int, batch_id: int) -> None:
        for bid, ver, seq in self.list_archive_batch_dirs(table, shard):
            if bid == batch_id:
                shutil.rmtree(
                    self.archive_batch_dir(table, shard, bid, ver, seq),
                    ignore_errors=True)

    def delete_column(self, table: str, shard: int, column_id: int) -> None:
        """Remove a deleted column's files from all archive batches."""
        for bid, ver, seq in self.list_archive_batch_dirs(table, shard):
            p = os.path.join(
                self.archive_batch_dir(table, shard, bid, ver, seq),
                f"{column_id}.data")
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def delete_table_shard(self, table: str, shard: int) -> None:
        shutil.rmtree(self._shard_dir(table, shard), ignore_errors=True)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
