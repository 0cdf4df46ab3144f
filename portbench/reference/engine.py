"""A plain numpy group-by over generated rows, the reference of every
query file's `spec`, and the comparison that judges an answer by it.

A spec: {"measure": "count" | "sum" | "avg", "column": <measured column>,
"range": {"from_s": <seconds before now>, "to_s": ...}, {"from_days": k}
(from the midnight k days before now's day, as AQL's "k days ago" is,
to now) or {"from": day, "to": day}, "filters": [{"column": c,
"equals": value}], "dims": [{"column": c} | {"column": c, "time":
"hour" | "day" | "year"} | {"column": c, "width": w}]}. Rows count
where from <= time < to and every filter holds; a sum or an average
is over the rows whose measured value is not null. An answer is
{(formatted dim values...): value} for every group that holds a row,
with the keys formatted as the daemon's JSON gives them.
"""

from __future__ import annotations

import calendar
import math
import time

import numpy as np

from portbench import wire

DAY = 86400


def day_seconds(day: str) -> int:
    """Unix seconds of a 'YYYY-MM-DD' midnight, UTC."""
    return calendar.timegm(time.strptime(day, "%Y-%m-%d"))


def time_range(spec: dict, now: int) -> tuple:
    r = spec["range"]
    if "from" in r:
        return day_seconds(r["from"]), day_seconds(r["to"])
    if "from_days" in r:
        return (now // DAY - r["from_days"]) * DAY, now
    return now - r["from_s"], now - r["to_s"]


def bf16(values: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    u = np.ascontiguousarray(values, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def _year_starts(lo: int, hi: int) -> np.ndarray:
    y0 = time.gmtime(lo).tm_year
    y1 = time.gmtime(max(lo, hi - 1)).tm_year
    return np.array([calendar.timegm((y, 1, 1, 0, 0, 0))
                     for y in range(y0, y1 + 2)], np.int64)


def _dim_codes(dim: dict, table, sel: np.ndarray, lo: int, hi: int):
    """(integer code of each selected row, code -> formatted key)."""
    col = dim["column"]
    v = table.columns[col][sel]
    if "time" in dim:
        t = v.astype(np.int64)
        kind = dim["time"]
        if kind == "hour":
            code = t // 3600
            return code, lambda c: time.strftime("%Y-%m-%d %H:00",
                                                 time.gmtime(c * 3600))
        if kind == "day":
            code = t // DAY
            return code, lambda c: time.strftime("%Y-%m-%d",
                                                 time.gmtime(c * DAY))
        if kind == "year":
            starts = _year_starts(lo, hi)
            code = np.searchsorted(starts, t, side="right") - 1
            return code, lambda c: str(int(starts[c]))
        raise ValueError(f"unknown time bucket {kind!r}")
    if "width" in dim:
        w = dim["width"]
        code = np.floor(v.astype(np.float64) / w).astype(np.int64)
        return code, lambda c: str(int(c * w)) if float(w).is_integer() \
            else repr(c * w)
    names = table.enums.get(col)
    code = v.astype(np.int64)
    if names is not None:
        return code, lambda c: names[c]
    return code, lambda c: str(int(c))


def selection(spec: dict, table, now: int) -> np.ndarray:
    """The boolean mask of the rows the query reads."""
    lo, hi = time_range(spec, now)
    t = table.columns[table.time_column]
    sel = (t >= lo) & (t < hi)
    for f in spec.get("filters", ()):
        col = f["column"]
        want = f["equals"]
        names = table.enums.get(col)
        if names is not None:
            want = names.index(want)
        sel &= table.columns[col] == want
    return sel


def answer(spec: dict, table, now: int, values_bf16: bool = False) -> dict:
    """{(formatted dim values...): measure} of every group that holds a
    row. values_bf16: the measured values rounded to bfloat16 first (the
    control)."""
    lo, hi = time_range(spec, now)
    idx = np.flatnonzero(selection(spec, table, now))
    if not len(idx):
        return {}
    key = np.zeros(len(idx), np.int64)
    fmts, bases, radix = [], [], []
    for dim in spec["dims"]:
        code, fmt = _dim_codes(dim, table, idx, lo, hi)
        base = int(code.min())
        span = int(code.max()) - base + 1
        key = key * span + (code - base)
        fmts.append(fmt)
        bases.append(base)
        radix.append(span)
    size = int(np.prod(radix)) if radix else 1
    rows = np.bincount(key, minlength=size)
    measure = spec["measure"]
    if measure == "count":
        vals = rows.astype(np.float64)
    else:
        v = table.columns[spec["column"]][idx]
        if values_bf16:
            v = bf16(v)
        v = v.astype(np.float64)
        valid = table.valid.get(spec["column"])
        w = np.ones(len(idx), bool) if valid is None else valid[idx]
        sums = np.bincount(key[w], v[w], minlength=size)
        if measure == "sum":
            vals = sums
        elif measure == "avg":
            n = np.bincount(key[w], minlength=size)
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = sums / n
        else:
            raise ValueError(f"unknown measure {measure!r}")
    out = {}
    for k in np.flatnonzero(rows).tolist():
        parts, rest = [], k
        for span in reversed(radix):
            parts.append(rest % span)
            rest //= span
        parts.reverse()
        out[tuple(fmt(base + c) for fmt, base, c
                  in zip(fmts, bases, parts))] = float(vals[k])
    return out


def flatten(result, prefix=()) -> dict:
    """{(key, key, ...): value} of a nested answer of the daemon."""
    if not isinstance(result, dict):
        return {prefix: result}
    out = {}
    for k, v in result.items():
        out.update(flatten(v, prefix + (k,)))
    return out


def compare(spec: dict, got: dict, want: dict) -> dict:
    """The numbers one answer gives against the reference's: how many
    groups lie in one of the two and not the other, how many counts
    differ, and the largest relative error of a sum or an average (0 for
    counts; infinite where the reference's is 0 and the answer's not)."""
    got = flatten(got)
    shared = set(got) & set(want)
    out = {"group_mismatch": len(set(got) ^ set(want)),
           "count_mismatch": 0, "sum_rel_err": 0.0}
    for k in shared:
        g, w = got[k], want[k]
        if not isinstance(g, (int, float)) or isinstance(g, bool):
            out["group_mismatch"] += 1
        elif spec["measure"] == "count":
            out["count_mismatch"] += int(g != w)
        elif g != w:
            err = abs(g - w) / abs(w) if w != 0 else math.inf
            out["sum_rel_err"] = max(out["sum_rel_err"], err)
    return out


class Rows:
    """A table's generated rows: columns[name] (n,) arrays (a UUID column
    (n, 2) uint64), valid[name] the validity of a nullable column, enums
    [name] the cases of an enum column by rank."""

    def __init__(self, columns: dict, valid: dict, enums: dict,
                 time_column: str):
        self.columns = columns
        self.valid = valid
        self.enums = enums
        self.time_column = time_column

    def __len__(self) -> int:
        return len(self.columns[self.time_column])


class Deployment:
    """A configuration's rows as set-up loads them: `now` (the queries'
    now), `cutoff` (the Archiver's) and the rows archived under it."""

    def __init__(self, cfg: dict, rows: Rows, now: int, cutoff: int):
        self.cfg = cfg
        self.rows = rows
        self.now = now
        self.cutoff = cutoff
        self.n_archived = int(np.count_nonzero(
            rows.columns[rows.time_column] < cutoff))

    def upserts(self, lo: int = 0, hi: int = None):
        """The wire bytes of rows [lo, hi) in upserts of `upsert_rows`."""
        hi = len(self.rows) if hi is None else hi
        step = self.cfg["upsert_rows"]
        for off in range(lo, hi, step):
            yield encode(self.cfg, self.rows, np.arange(off, min(off + step,
                                                                  hi)))


def encode(cfg: dict, rows: Rows, index: np.ndarray) -> bytes:
    """The upsert of rows[index], every column of the configuration's
    table in its order, by the frozen encoder."""
    cols = []
    for cid, col in enumerate(cfg["table"]["columns"]):
        name = col["name"]
        valid = rows.valid.get(name)
        cols.append((cid, wire.TYPE_CODES[col["type"]],
                     rows.columns[name][index],
                     None if valid is None else valid[index], 0))
    return wire.encode(cols, len(index))


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for (seed, stream...): any whole number as a
    seed, negative or past 64 bits included."""
    words = []
    s = int(seed)
    words.append(1 if s < 0 else 0)
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return np.random.default_rng(np.random.SeedSequence(words + list(stream)))
