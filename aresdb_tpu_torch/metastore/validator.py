"""Table schema validator — creation and safe-evolution rules.

Reference: metastore/validator.go:27 (tableSchemaValidatorImpl). Used by
both the single-node metastore (table CRUD) and the cluster controller
(schema endpoint), so a schema rejected on one path is rejected on all.
"""

from __future__ import annotations

from typing import Optional

from aresdb_tpu_torch.common import data_types as dt
from aresdb_tpu_torch.common.schema import Table

# fast-HLL aggregation input types (validator.go validateColumnHLLConfig)
_HLL_OK_TYPES = ("Uint32", "Int32", "Int64", "UUID")


def validate_table(new: Table, old: Optional[Table] = None) -> None:
    """Raise ValueError on an invalid schema or an illegal update."""
    _validate_individual(new)
    if old is not None:
        _validate_update(new, old)


def _validate_individual(table: Table) -> None:
    if not table.name:
        raise ValueError("table name must not be empty")
    if not table.columns:
        raise ValueError("table must have at least one column")

    names = set()
    non_deleted = 0
    for cid, c in enumerate(table.columns):
        if not c.deleted:
            non_deleted += 1
        # duplicate names are rejected even against deleted columns —
        # column ids are never reused (validator.go colNameDedup)
        if c.name in names:
            raise ValueError(f"duplicate column name {c.name!r}")
        names.add(c.name)

        dtype = dt.data_type_from_string(c.type)  # raises on bad type

        if table.is_fact_table and cid == 0:
            if dtype != dt.Uint32:
                raise ValueError(
                    "fact table's first column must be the Uint32 event time")
            if c.hll_config.is_hll_column:
                raise ValueError("time column does not allow hll config")
            if c.default_value is not None:
                raise ValueError("time column does not allow default value")

        if c.hll_config.is_hll_column:
            if c.base_type_name not in _HLL_OK_TYPES or c.is_array:
                raise ValueError(
                    f"data type {c.type} not allowed for fast hll "
                    f"aggregation, valid options: {list(_HLL_OK_TYPES)}")
            if c.default_value is not None:
                raise ValueError("hll column does not allow default value")

        if c.default_value is not None and not c.is_enum_column():
            # enum defaults are strings by construction; everything else
            # must parse for its type (validator.go ValidateDefaultValue)
            try:
                dt.parse_value(c.default_value, dtype)
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"invalid default value {c.default_value!r} for type "
                    f"{c.type}: {e}") from e

    if non_deleted == 0:
        raise ValueError("all columns are deleted")

    if not table.primary_key_columns:
        raise ValueError("table must have primary key columns")
    seen = set()
    for ci in table.primary_key_columns:
        if ci < 0 or ci >= len(table.columns):
            raise ValueError(f"primary key column id {ci} out of range")
        if table.columns[ci].deleted:
            raise ValueError(f"primary key column {ci} is deleted")
        if ci in seen:
            raise ValueError(f"duplicate primary key column {ci}")
        if dt.is_array_type(table.columns[ci].data_type):
            raise ValueError("array column cannot be primary key")
        seen.add(ci)

    if table.config.batch_size <= 0:
        raise ValueError("batchSize must be positive")

    if table.is_fact_table:
        seen = set()
        for ci in table.archiving_sort_columns:
            if ci < 0 or ci >= len(table.columns):
                raise ValueError(f"sort column id {ci} out of range")
            if table.columns[ci].deleted:
                raise ValueError(f"sort column {ci} is deleted")
            if ci in seen:
                raise ValueError(f"duplicate sort column {ci}")
            if dt.is_array_type(table.columns[ci].data_type):
                raise ValueError("array column cannot be a sort column")
            seen.add(ci)
    elif table.archiving_sort_columns:
        raise ValueError("dimension tables have no archiving sort columns")


def _validate_update(new: Table, old: Table) -> None:
    if new.name != old.name:
        raise ValueError("cannot rename a table")
    if new.is_fact_table != old.is_fact_table:
        raise ValueError("cannot change table type")
    if len(new.columns) < len(old.columns):
        # even with deletion/recreation, column ids are never reused
        raise ValueError("cannot remove columns (mark deleted instead)")
    if old.is_fact_table and old.config.allow_missing_event_time \
            and not new.config.allow_missing_event_time:
        raise ValueError("allowMissingEventTime cannot change from true "
                         "to false")

    for i, oc in enumerate(old.columns):
        nc = new.columns[i]
        if oc.deleted and not nc.deleted:
            raise ValueError(
                f"cannot reuse deleted column id {i} ({oc.name!r})")
        # column definitions are immutable, even for deleted columns
        if (nc.name != oc.name or nc.type != oc.type
                or nc.default_value != oc.default_value
                or nc.case_insensitive != oc.case_insensitive
                or nc.disable_auto_expand != oc.disable_auto_expand
                or nc.hll_config.is_hll_column != oc.hll_config.is_hll_column):
            raise ValueError(f"cannot mutate column {i} ({oc.name!r})")

    if new.primary_key_columns != old.primary_key_columns:
        raise ValueError("cannot change primary key columns")

    # sort columns are append-only: the old list must be a prefix
    o_sort = old.archiving_sort_columns
    n_sort = new.archiving_sort_columns
    if len(n_sort) < len(o_sort) or n_sort[:len(o_sort)] != o_sort:
        raise ValueError("sort columns may only be appended to")
    for ci in n_sort[len(o_sort):]:
        if ci >= len(new.columns) or new.columns[ci].deleted:
            raise ValueError(f"new sort column {ci} invalid")
