"""AQL query model (JSON-compatible with the reference).

Reference: query/common/aql.go — field names in to/from_json match the
reference exactly so existing AQL documents run unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NumericBucketizerDef:
    bucket_width: float = 0.0
    log_base: float = 0.0
    manual_partitions: List[float] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "NumericBucketizerDef":
        d = d or {}
        return cls(
            bucket_width=d.get("bucketWidth", 0.0),
            log_base=d.get("logBase", 0.0),
            manual_partitions=list(d.get("manualPartitions", [])),
        )

    @property
    def empty(self) -> bool:
        return (not self.bucket_width and not self.log_base
                and not self.manual_partitions)


@dataclass
class Dimension:
    expr: str = ""
    alias: str = ""
    time_bucketizer: str = ""
    time_unit: str = ""
    numeric_bucketizer: NumericBucketizerDef = field(
        default_factory=NumericBucketizerDef)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Dimension":
        return cls(
            expr=d.get("sqlExpression", ""),
            alias=d.get("alias", ""),
            time_bucketizer=d.get("timeBucketizer", ""),
            time_unit=d.get("timeUnit", ""),
            numeric_bucketizer=NumericBucketizerDef.from_json(
                d.get("numericBucketizer")),
        )

    @property
    def is_time_dimension(self) -> bool:
        return bool(self.time_bucketizer or self.time_unit)


@dataclass
class Measure:
    expr: str
    alias: str = ""
    filters: List[str] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Measure":
        return cls(
            expr=d.get("sqlExpression", ""),
            alias=d.get("alias", ""),
            filters=list(d.get("rowFilters", [])),
        )


@dataclass
class Join:
    table: str
    alias: str = ""
    conditions: List[str] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Join":
        return cls(
            table=d.get("table", ""),
            alias=d.get("alias", ""),
            conditions=list(d.get("conditions", [])),
        )


@dataclass
class TimeFilter:
    column: str = ""
    from_: str = ""
    to: str = ""

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "TimeFilter":
        d = d or {}
        return cls(
            column=d.get("column", ""),
            from_=d.get("from", ""),
            to=d.get("to", ""),
        )

    @property
    def empty(self) -> bool:
        return not self.from_ and not self.to


@dataclass
class SortField:
    name: str
    order: str = "asc"

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SortField":
        return cls(name=d.get("name", ""), order=d.get("order", "asc"))


@dataclass
class AQLQuery:
    table: str
    measures: List[Measure]
    shards: List[int] = field(default_factory=list)
    joins: List[Join] = field(default_factory=list)
    dimensions: List[Dimension] = field(default_factory=list)
    filters: List[str] = field(default_factory=list)
    time_filter: TimeFilter = field(default_factory=TimeFilter)
    supporting_dimensions: List[Dimension] = field(default_factory=list)
    supporting_measures: List[Measure] = field(default_factory=list)
    timezone: str = ""
    now: int = 0
    limit: int = 0
    sorts: List[SortField] = field(default_factory=list)
    sql_query: str = ""

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "AQLQuery":
        return cls(
            table=d.get("table", ""),
            shards=list(d.get("shards", [])),
            joins=[Join.from_json(j) for j in d.get("joins", [])],
            dimensions=[Dimension.from_json(x) for x in d.get("dimensions", [])],
            measures=[Measure.from_json(m) for m in d.get("measures", [])],
            filters=list(d.get("rowFilters", [])),
            time_filter=TimeFilter.from_json(d.get("timeFilter")),
            supporting_dimensions=[Dimension.from_json(x)
                                   for x in d.get("supportingDimensions", [])],
            supporting_measures=[Measure.from_json(m)
                                 for m in d.get("supportingMeasures", [])],
            timezone=d.get("timezone", ""),
            now=d.get("now", 0),
            limit=d.get("limit", 0),
            sorts=[SortField.from_json(s) for s in d.get("sorts", [])],
            sql_query=d.get("sql", ""),
        )

    def to_json(self) -> Dict[str, Any]:
        """Inverse of from_json (modulo empty-field omission)."""
        out: Dict[str, Any] = {
            "table": self.table,
            "measures": [
                {"sqlExpression": m.expr, "alias": m.alias,
                 "rowFilters": m.filters} for m in self.measures
            ],
            "dimensions": [],
            "rowFilters": self.filters,
            "joins": [{"table": j.table, "alias": j.alias,
                       "conditions": j.conditions} for j in self.joins],
        }
        for d in self.dimensions:
            dd: Dict[str, Any] = {"sqlExpression": d.expr, "alias": d.alias,
                                  "timeBucketizer": d.time_bucketizer,
                                  "timeUnit": d.time_unit}
            nb = d.numeric_bucketizer
            if not nb.empty:
                dd["numericBucketizer"] = {
                    "bucketWidth": nb.bucket_width, "logBase": nb.log_base,
                    "manualPartitions": nb.manual_partitions}
            out["dimensions"].append(dd)
        if not self.time_filter.empty:
            out["timeFilter"] = {"column": self.time_filter.column,
                                 "from": self.time_filter.from_,
                                 "to": self.time_filter.to}
        if self.supporting_measures:
            out["supportingMeasures"] = [
                {"sqlExpression": m.expr, "alias": m.alias,
                 "rowFilters": m.filters} for m in self.supporting_measures]
        if self.shards:
            out["shards"] = self.shards
        if self.timezone:
            out["timezone"] = self.timezone
        if self.now:
            out["now"] = self.now
        if self.limit:
            out["limit"] = self.limit
        if self.sorts:
            out["sorts"] = [{"name": s.name, "order": s.order}
                            for s in self.sorts]
        if self.sql_query:
            out["sql"] = self.sql_query
        return out


@dataclass
class AQLRequest:
    queries: List[AQLQuery]

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "AQLRequest":
        return cls(queries=[AQLQuery.from_json(q) for q in d.get("queries", [])])
