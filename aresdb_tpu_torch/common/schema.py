"""Table schema model + runtime schema with enum dictionaries.

Capability parity with the reference schema model
(reference: metastore/common/model.go:28-150 Table/Column/TableConfig and
memstore/common/schema.go TableSchema). JSON field names match the reference
so schema documents interoperate.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from aresdb_tpu_torch.common import data_types as dt

DEFAULT_BATCH_SIZE = 2097152


@dataclass
class ColumnConfig:
    preloading_days: int = 0
    priority: int = 0

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.preloading_days:
            out["preloadingDays"] = self.preloading_days
        if self.priority:
            out["priority"] = self.priority
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ColumnConfig":
        return cls(
            preloading_days=d.get("preloadingDays", 0),
            priority=d.get("priority", 0),
        )


@dataclass
class HLLConfig:
    is_hll_column: bool = False


@dataclass
class Column:
    name: str
    type: str  # type name string ('Uint32', ...)
    deleted: bool = False
    default_value: Optional[str] = None
    case_insensitive: bool = False
    disable_auto_expand: bool = False
    config: ColumnConfig = field(default_factory=ColumnConfig)
    hll_config: HLLConfig = field(default_factory=HLLConfig)

    @property
    def data_type(self) -> int:
        return dt.data_type_from_string(self.type)

    def is_enum_column(self) -> bool:
        return self.base_type_name in ("SmallEnum", "BigEnum")

    @property
    def base_type_name(self) -> str:
        """Type name with any array suffix stripped ('SmallEnum[]' /
        'ArraySmallEnum' → 'SmallEnum')."""
        t = self.type
        if t.endswith("[]"):
            return t[:-2]
        if t.startswith("Array"):
            return t[len("Array"):]
        return t

    @property
    def is_array(self) -> bool:
        return self.type.endswith("[]") or self.type.startswith("Array")

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "type": self.type}
        if self.deleted:
            out["deleted"] = True
        if self.default_value is not None:
            out["defaultValue"] = self.default_value
        if self.case_insensitive:
            out["caseInsensitive"] = True
        if self.disable_auto_expand:
            out["disableAutoExpand"] = True
        cfg = self.config.to_json()
        if cfg:
            out["config"] = cfg
        if self.hll_config.is_hll_column:
            out["hllConfig"] = {"isHLLColumn": True}
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Column":
        return cls(
            name=d["name"],
            type=d["type"],
            deleted=d.get("deleted", False),
            default_value=d.get("defaultValue"),
            case_insensitive=d.get("caseInsensitive", False),
            disable_auto_expand=d.get("disableAutoExpand", False),
            config=ColumnConfig.from_json(d.get("config", {})),
            hll_config=HLLConfig(
                is_hll_column=d.get("hllConfig", {}).get("isHLLColumn", False)
            ),
        )


@dataclass
class TableConfig:
    initial_primary_key_num_buckets: int = 0
    batch_size: int = DEFAULT_BATCH_SIZE
    redo_log_rotation_interval: int = 10800
    max_redo_log_file_size: int = 1 << 30
    archiving_delay_minutes: int = 1440
    archiving_interval_minutes: int = 180
    backfill_interval_minutes: int = 60
    backfill_max_buffer_size: int = 4 << 30
    backfill_threshold_in_bytes: int = 2 << 30
    backfill_store_batch_size: int = 20000
    record_retention_in_days: int = 90
    snapshot_threshold: int = 6291456
    snapshot_interval_minutes: int = 360
    allow_missing_event_time: bool = False

    _JSON_FIELDS = {
        "initial_primary_key_num_buckets": "initPrimaryKeyNumBuckets",
        "batch_size": "batchSize",
        "redo_log_rotation_interval": "redoLogRotationInterval",
        "max_redo_log_file_size": "maxRedoLogFileSize",
        "archiving_delay_minutes": "archivingDelayMinutes",
        "archiving_interval_minutes": "archivingIntervalMinutes",
        "backfill_interval_minutes": "backfillIntervalMinutes",
        "backfill_max_buffer_size": "backfillMaxBufferSize",
        "backfill_threshold_in_bytes": "backfillThresholdInBytes",
        "backfill_store_batch_size": "backfillStoreBatchSize",
        "record_retention_in_days": "recordRetentionInDays",
        "snapshot_threshold": "snapshotThreshold",
        "snapshot_interval_minutes": "snapshotIntervalMinutes",
        "allow_missing_event_time": "allowMissingEventTime",
    }

    def to_json(self) -> Dict[str, Any]:
        return {j: getattr(self, a) for a, j in self._JSON_FIELDS.items()}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TableConfig":
        cfg = cls()
        for attr, jname in cls._JSON_FIELDS.items():
            if jname in d:
                setattr(cfg, attr, d[jname])
        return cfg


@dataclass
class Table:
    """Logical table definition (reference: metastore/common/model.go:128)."""

    name: str
    columns: List[Column]
    primary_key_columns: List[int]
    is_fact_table: bool = False
    config: TableConfig = field(default_factory=TableConfig)
    archiving_sort_columns: List[int] = field(default_factory=list)
    incarnation: int = 0
    version: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "columns": [c.to_json() for c in self.columns],
            "primaryKeyColumns": self.primary_key_columns,
            "isFactTable": self.is_fact_table,
            "config": self.config.to_json(),
            "archivingSortColumns": self.archiving_sort_columns,
            "incarnation": self.incarnation,
            "version": self.version,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Table":
        return cls(
            name=d["name"],
            columns=[Column.from_json(c) for c in d["columns"]],
            primary_key_columns=list(d.get("primaryKeyColumns", [])),
            is_fact_table=d.get("isFactTable", False),
            config=TableConfig.from_json(d.get("config", {})),
            archiving_sort_columns=list(d.get("archivingSortColumns", [])),
            incarnation=d.get("incarnation", 0),
            version=d.get("version", 0),
        )

    @classmethod
    def from_json_str(cls, s: str) -> "Table":
        return cls.from_json(json.loads(s))

    def validate(self) -> None:
        """Schema sanity checks (reference: metastore/validator.go)."""
        if not self.name:
            raise ValueError("table name must not be empty")
        if not self.columns:
            raise ValueError("table must have at least one column")
        names = set()
        for c in self.columns:
            dt.data_type_from_string(c.type)  # raises on bad type
            if not c.deleted:
                if c.name in names:
                    raise ValueError(f"duplicate column name {c.name!r}")
                names.add(c.name)
        if not self.primary_key_columns:
            raise ValueError("table must have primary key columns")
        for ci in self.primary_key_columns:
            if ci < 0 or ci >= len(self.columns):
                raise ValueError(f"primary key column id {ci} out of range")
            if self.columns[ci].deleted:
                raise ValueError(f"primary key column {ci} is deleted")
            if dt.is_array_type(self.columns[ci].data_type):
                raise ValueError("array column cannot be primary key")
        if self.is_fact_table:
            # column 0 is the designated event-time column for fact tables
            if self.columns[0].data_type != dt.Uint32:
                raise ValueError(
                    "fact table's first column must be the Uint32 event time"
                )
        for ci in self.archiving_sort_columns:
            if ci < 0 or ci >= len(self.columns):
                raise ValueError(f"sort column id {ci} out of range")


class EnumDict:
    """Bidirectional enum string<->rank dictionary for one enum column."""

    def __init__(self, case_insensitive: bool = False):
        self.case_insensitive = case_insensitive
        self.str_to_rank: Dict[str, int] = {}
        self.rank_to_str: List[str] = []

    def get_or_add(self, value: str) -> int:
        key = value.lower() if self.case_insensitive else value
        rank = self.str_to_rank.get(key)
        if rank is None:
            rank = len(self.rank_to_str)
            self.str_to_rank[key] = rank
            self.rank_to_str.append(value)
        return rank

    def get(self, value: str) -> Optional[int]:
        key = value.lower() if self.case_insensitive else value
        return self.str_to_rank.get(key)

    def extend(self, values: List[str]) -> None:
        for v in values:
            self.get_or_add(v)

    def __len__(self) -> int:
        return len(self.rank_to_str)


class TableSchema:
    """Runtime table schema: table def + enum dictionaries + fast lookups.

    Reference: memstore/common/schema.go TableSchema.
    """

    def __init__(self, table: Table):
        self.lock = threading.RLock()
        self.table = table
        self.enum_dicts: Dict[str, EnumDict] = {}
        self.column_ids: Dict[str, int] = {}
        self._rebuild()

    def _rebuild(self) -> None:
        self.column_ids = {
            c.name: i for i, c in enumerate(self.table.columns) if not c.deleted
        }
        for c in self.table.columns:
            if c.deleted:
                continue
            if c.is_enum_column() and c.name not in self.enum_dicts:
                ed = EnumDict(case_insensitive=c.case_insensitive)
                if c.default_value is not None:
                    ed.get_or_add(c.default_value)
                self.enum_dicts[c.name] = ed

    def set_table(self, table: Table) -> None:
        with self.lock:
            self.table = table
            self._rebuild()

    @property
    def value_type_by_column(self) -> List[int]:
        return [c.data_type for c in self.table.columns]

    def get_column_deletable(self, column_id: int) -> bool:
        c = self.table.columns[column_id]
        return not (
            column_id in self.table.primary_key_columns
            or (self.table.is_fact_table and column_id == 0)
        ) and not c.deleted

    def column_id(self, name: str) -> int:
        try:
            return self.column_ids[name]
        except KeyError:
            raise KeyError(
                f"unknown column {name!r} in table {self.table.name!r}"
            ) from None

    def column(self, name: str) -> Column:
        return self.table.columns[self.column_id(name)]

    def translate_enum(self, column_name: str, value: str) -> Optional[int]:
        """String -> enum rank, or None if not in dictionary."""
        ed = self.enum_dicts.get(column_name)
        if ed is None:
            return None
        return ed.get(value)

    def extend_enum(self, column_name: str, values: List[str]) -> List[int]:
        col = self.column(column_name)
        ed = self.enum_dicts[column_name]
        with self.lock:
            if col.disable_auto_expand:
                out = []
                for v in values:
                    rank = ed.get(v)
                    if rank is None:
                        # unknown values map to default (rank of default value
                        # or 0), matching reference connector behavior
                        rank = 0 if len(ed) else ed.get_or_add(v)
                    out.append(rank)
                return out
            return [ed.get_or_add(v) for v in values]

    def enum_reverse_dict(self, column_name: str) -> List[str]:
        ed = self.enum_dicts.get(column_name)
        return list(ed.rank_to_str) if ed else []

    @property
    def primary_key_bytes(self) -> int:
        return sum(
            dt.data_type_bytes(self.table.columns[ci].data_type)
            for ci in self.table.primary_key_columns
        )
