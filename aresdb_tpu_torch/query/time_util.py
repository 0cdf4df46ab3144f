"""Calendar/time utilities: timezone parsing, time filters, bucketizers.

Reference: query/common/time_filter.go (ParseTimeFilter/applyTimeOffset),
query/common/time_bucketizer.go (ParseRegularTimeBucketizer),
query/time_bucketizer.go (irregular + recurring bucketizers),
query/common/dimval.go (formatTimeDimension).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Optional, Tuple

try:
    from zoneinfo import ZoneInfo
except ImportError:  # pragma: no cover
    ZoneInfo = None

SECONDS_PER_MINUTE = 60
SECONDS_PER_HOUR = 3600
SECONDS_PER_DAY = 86400
SECONDS_PER_4DAY = 4 * SECONDS_PER_DAY
SECONDS_PER_WEEK = 7 * SECONDS_PER_DAY

_TIME_UNIT_MAP = {
    "year": "y",
    "quarter": "q",
    "month": "M",
    "week": "w",
    "day": "d",
    "hour": "h",
    "quarter-hour": "15m",
    "minute": "m",
    "second": "s",
}

_BUCKET_NORMALIZED = {
    "minutes": "m", "minute": "m", "day": "d", "hours": "h", "hour": "h",
}
_BUCKET_UNIT_SECONDS = {"m": 60, "h": 3600, "d": 86400}

# irregular calendar bucketizers (reference query/time_bucketizer.go:38-41)
IRREGULAR_BUCKETIZERS = {"month", "quarter", "year", "week"}

# regular recurring "x of y" (reference query/time_bucketizer.go:53-56)
RECURRING_BUCKETIZERS = {
    "time of day": (1, SECONDS_PER_DAY),
    "hour of day": (SECONDS_PER_HOUR, SECONDS_PER_DAY),
    "hour of week": (SECONDS_PER_HOUR, SECONDS_PER_WEEK),
    "day of week": (SECONDS_PER_DAY, SECONDS_PER_WEEK),
}

# irregular recurring calendar extracts (reference :61-64)
RECURRING_CALENDAR_BUCKETIZERS = {
    "day of month", "day of year", "month of year", "quarter of year",
}

_ALLOWED_MINUTES_OF_DAY = {2, 3, 4, 5, 6, 10, 15, 20, 30}


class TimeError(ValueError):
    pass


def parse_timezone(tz: str) -> _dt.tzinfo:
    """Parse '-8:00', 'GMT', 'America/Los_Angeles' (ParseTimezone)."""
    if not tz:
        return _dt.timezone.utc
    parts = tz.split(":")
    try:
        hours = int(parts[0])
        minutes = int(parts[1]) if len(parts) > 1 else 0
        if hours < 0:
            minutes = -minutes
        return _dt.timezone(_dt.timedelta(hours=hours, minutes=minutes), tz)
    except ValueError:
        pass
    if ZoneInfo is None:
        raise TimeError(f"cannot load timezone {tz!r}")
    try:
        return ZoneInfo(tz)
    except Exception as e:
        raise TimeError(f"unknown timezone {tz!r}") from e


def tz_offset_at(tz: _dt.tzinfo, ts: int) -> int:
    """UTC offset (seconds) of tz at unix second ts."""
    return int(_dt.datetime.fromtimestamp(ts, tz).utcoffset().total_seconds())


def dst_switch_ts(tz: _dt.tzinfo, from_ts: int, to_ts: int) -> Tuple[int, int, int]:
    """(from_offset, to_offset, switch_ts) for the range [from_ts, to_ts).

    switch_ts is 0 when the offset is constant over the range; otherwise the
    first second at which the new offset applies (found by bisection).
    Mirrors the reference's TimeDimensionMeta{FromOffset,ToOffset,DSTSwitchTs}.
    """
    fo = tz_offset_at(tz, from_ts)
    to = tz_offset_at(tz, to_ts)
    if fo == to:
        return fo, to, 0
    lo, hi = from_ts, to_ts
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if tz_offset_at(tz, mid) == fo:
            lo = mid
        else:
            hi = mid
    return fo, to, hi


def _adjust_midnight(t: _dt.datetime) -> _dt.datetime:
    """DST midnight anomalies (reference adjustMidnight, ABSOLUTE adds):
    a constructed midnight that normalized to 23:00 (DST starts at
    midnight, e.g. America/Sao_Paulo) moves forward one hour; one that
    normalized to 01:00 moves back unless that crosses the day."""
    if t.hour == 23:
        return _abs_add(t, 3600)
    if t.hour == 1:
        t2 = _abs_add(t, -3600)
        if t2.day == t.day:
            return t2
    return t


def _midnight(t: _dt.datetime) -> _dt.datetime:
    """Resolve a constructed wall midnight like Go time.Date +
    adjustMidnight (gap times take the post-transition offset, then the
    23:00/01:00 anomalies are repaired)."""
    return _adjust_midnight(_resolve_wall(t))


def _mk(t: _dt.datetime, year, month, day, hour=0, minute=0) -> _dt.datetime:
    return _dt.datetime(year, month, day, hour, minute, tzinfo=t.tzinfo)


def _resolve_wall(t: _dt.datetime) -> _dt.datetime:
    """Pin a local wall time to one instant, matching Go time.Date:
    ambiguous (fall-back) times take the FIRST occurrence; nonexistent
    (spring-forward) times take the post-transition offset (reference
    time_filter_test.go '2016-03-13 02' / '2015-11-01 01' cases)."""
    ts = t.replace(fold=0).timestamp()
    back = _dt.datetime.fromtimestamp(ts, t.tzinfo)
    if (back.year, back.month, back.day, back.hour, back.minute) != \
            (t.year, t.month, t.day, t.hour, t.minute):
        ts = t.replace(fold=1).timestamp()
        back = _dt.datetime.fromtimestamp(ts, t.tzinfo)
    return back


def _abs_add(t: _dt.datetime, seconds: int) -> _dt.datetime:
    """Absolute-duration add (Go time.Add) — aware-datetime + timedelta in
    python is WALL arithmetic, which diverges across DST transitions."""
    return _dt.datetime.fromtimestamp(t.timestamp() + seconds, t.tzinfo)


def _wall_days(t: _dt.datetime, n: int) -> _dt.datetime:
    """Go AddDate(0, 0, n): calendar day arithmetic on the wall clock,
    preserving the time-of-day fields; the result is an UNRESOLVED wall
    time (callers pass it through _midnight/_resolve_wall)."""
    d = _dt.datetime(t.year, t.month, t.day) + _dt.timedelta(days=n)
    return _dt.datetime(d.year, d.month, d.day, t.hour, t.minute,
                        tzinfo=t.tzinfo)


def apply_time_offset(base: _dt.datetime, amount: int, unit: str
                      ) -> Tuple[_dt.datetime, _dt.datetime]:
    """Start/end of the calendar `unit` `amount` units from base."""
    month_start = _midnight(_mk(base, base.year, base.month, 1))
    day_start = _midnight(_mk(base, base.year, base.month, base.day))

    def add_months(t: _dt.datetime, n: int) -> _dt.datetime:
        y = t.year + (t.month - 1 + n) // 12
        m = (t.month - 1 + n) % 12 + 1
        return _mk(t, y, m, t.day, t.hour, t.minute)

    if unit == "y":
        start = _midnight(_mk(base, base.year + amount, 1, 1))
        end = _midnight(_mk(base, base.year + amount + 1, 1, 1))
    elif unit == "q":
        # month offset to quarter start: Go's (1-int(month))%3 keeps the
        # dividend's sign, i.e. -((month-1) mod 3)
        go_off = -((base.month - 1) % 3)
        start = _midnight(add_months(month_start, go_off + 3 * amount))
        end = _midnight(add_months(start, 3))
    elif unit == "M":
        start = _midnight(add_months(month_start, amount))
        end = _midnight(add_months(start, 1))
    elif unit == "w":
        # Go: dayStart.AddDate(0,0,(-weekday-6)%7+7*amount); week starts Monday
        wd = (base.weekday() + 1) % 7  # Go Weekday: Sunday=0
        go_mod = -((wd + 6) % 7)
        start = _midnight(_wall_days(day_start, go_mod + 7 * amount))
        end = _midnight(_wall_days(start, 7))
    elif unit == "d":
        start = _midnight(_wall_days(day_start, amount))
        end = _midnight(_wall_days(start, 1))
    elif unit == "h":
        # sub-day units: wall truncation, then ABSOLUTE adds (Go time.Add)
        b = _resolve_wall(_mk(base, base.year, base.month, base.day,
                              base.hour))
        start = _abs_add(b, 3600 * amount)
        end = _abs_add(start, 3600)
    elif unit == "15m":
        b = _resolve_wall(_mk(base, base.year, base.month, base.day,
                              base.hour, base.minute - base.minute % 15))
        start = _abs_add(b, 900 * amount)
        end = _abs_add(start, 900)
    elif unit == "m":
        b = _resolve_wall(_mk(base, base.year, base.month, base.day,
                              base.hour, base.minute))
        start = _abs_add(b, 60 * amount)
        end = _abs_add(start, 60)
    else:
        raise TimeError(f"Unknown time filter unit: {unit}")
    return start, end


def _parse_absolute_time(date_expr: str, time_expr: str, tz: _dt.tzinfo
                         ) -> Tuple[_dt.datetime, _dt.datetime, str]:
    year, quarter, hour, minute = 0, 0, 0, 0
    month, day = 1, 1
    segments = date_expr.split("-")
    if len(segments) > 3:
        raise TimeError(f"Unknown time expression: {date_expr} {time_expr}")
    year = int(segments[0])
    unit = "y"
    if len(segments) >= 2:
        if segments[1].startswith("Q"):
            quarter = int(segments[1][1:])
            if len(segments) == 3:
                raise TimeError(f"Unknown time expression: {date_expr} {time_expr}")
            month = 1 + (quarter - 1) * 3
            unit = "q"
        else:
            month = int(segments[1])
            unit = "M"
    if len(segments) == 3:
        day = int(segments[2])
        unit = "d"
    elif time_expr:
        raise TimeError(f"Unknown time expression: {date_expr} {time_expr}")
    if time_expr:
        tsegs = time_expr.split(":")
        if len(tsegs) > 2:
            raise TimeError(f"Unknown time expression: {date_expr} {time_expr}")
        hour = int(tsegs[0])
        unit = "h"
        if len(tsegs) == 2:
            minute = int(tsegs[1])
            unit = "m"
            if minute % 15 == 0:
                unit = "15m"
    t = _dt.datetime(year, month, day, hour, minute, tzinfo=tz)
    if hour == 0:
        t = _midnight(t)
    start, end = apply_time_offset(t, 0, unit)
    return start, end, unit


def parse_time_filter_expression(expression: str, now: _dt.datetime
                                 ) -> Tuple[_dt.datetime, _dt.datetime, str]:
    """(start, end, unit) of the calendar unit in `expression`.

    Reference: parseTimeFilterExpression (query/common/time_filter.go:241).
    """
    if expression == "now":
        return now, now, "s"
    if expression == "today":
        expression = "this day"
    elif expression == "yesterday":
        expression = "last day"

    segments = expression.split(" ")
    if segments[0] == "this":
        if len(segments) != 2:
            raise TimeError(f"Unknown time filter expression: {expression}")
        unit = _TIME_UNIT_MAP.get(segments[1])
        if not unit:
            raise TimeError(f"Unknown time filter unit: {segments[1]}")
        s, e = apply_time_offset(now, 0, unit)
        return s, e, unit
    if segments[0] == "last":
        if len(segments) != 2:
            raise TimeError(f"Unknown time filter expression: {expression}")
        unit = _TIME_UNIT_MAP.get(segments[1])
        if not unit:
            raise TimeError(f"Unknown time filter unit: {segments[1]}")
        s, e = apply_time_offset(now, -1, unit)
        return s, e, unit
    if segments[-1] == "ago":
        if len(segments) != 3:
            raise TimeError(f"Unknown time filter expression: {expression}")
        try:
            amount = int(segments[0])
        except ValueError as e:
            raise TimeError(
                f"Unknown time filter expression: {expression}") from e
        unit = _TIME_UNIT_MAP.get(segments[1].rstrip("s"))
        if not unit:
            raise TimeError(f"Unknown time filter unit: {segments[1]}")
        s, e = apply_time_offset(now, -amount, unit)
        return s, e, unit
    if len(segments) == 1:
        # "+3d" style offsets
        try:
            amount = int(expression[:-1])
            unit = expression[-1:]
            s, e = apply_time_offset(now, amount, unit)
            return s, e, unit
        except (ValueError, TimeError):
            pass
        # raw unix timestamp
        try:
            seconds = int(segments[0])
            if seconds > 99999999999:
                seconds //= 1000
            if seconds > 9999999:
                t = _dt.datetime.fromtimestamp(seconds, now.tzinfo)
                if seconds % 60 == 0:
                    return t, t, "m"
                return t, t, "s"
        except ValueError:
            pass
    date_expr = segments[0]
    time_expr = segments[1] if len(segments) == 2 else ""
    if len(segments) > 2:
        raise TimeError(f"Unknown time filter expression: {expression}")
    try:
        return _parse_absolute_time(date_expr, time_expr, now.tzinfo)
    except TimeError:
        raise
    except ValueError as e:   # int() on non-numeric segments etc.
        raise TimeError(
            f"Unknown time filter expression: {expression}") from e


@dataclass
class AlignedTime:
    ts: int  # unix seconds
    unit: str


def parse_time_filter(from_expr: str, to_expr: str, tz: Optional[_dt.tzinfo],
                      now_ts: int) -> Tuple[Optional[AlignedTime], Optional[AlignedTime]]:
    """Resolve from/to expressions to [from_ts, to_ts) unix seconds."""
    tz = tz or _dt.timezone.utc
    now = _dt.datetime.fromtimestamp(now_ts, tz)
    from_t = to_t = None
    if from_expr:
        s, _, unit = parse_time_filter_expression(from_expr, now)
        from_t = AlignedTime(int(s.timestamp()), unit)
    if to_expr:
        _, e, unit = parse_time_filter_expression(to_expr, now)
        to_t = AlignedTime(int(e.timestamp()), unit)
    elif from_t is not None:
        to_t = AlignedTime(now_ts, "s")
    return from_t, to_t


def parse_regular_time_bucketizer(s: str) -> Tuple[int, str]:
    """'3m' / '4 hours' / 'quarter-hour' -> (size, unit)."""
    if s == "quarter-hour":
        s = "15m"
    s = s.lower()
    segments = s.split(" ", 1)
    if len(segments) == 2:
        unit = _BUCKET_NORMALIZED.get(segments[1])
        if not unit:
            raise TimeError(f"failed to parse time bucketizer: {s}")
        size = _parse_bucket_size(segments[0], unit, s)
        return size, unit
    t = _BUCKET_NORMALIZED.get(s, s)
    unit = t[-1:]
    if unit not in _BUCKET_UNIT_SECONDS:
        raise TimeError(f"failed to parse time bucketizer: {s}")
    if len(t) > 1:
        return _parse_bucket_size(t[:-1], unit, s), unit
    return 1, unit


def _parse_bucket_size(num: str, unit: str, orig: str) -> int:
    try:
        size = int(num)
    except ValueError:
        raise TimeError(f"failed to parse time bucketizer: {orig}") from None
    # valid sub-bucket sizes (reference parseSize): must divide parent unit
    if unit == "m" and size in (2, 3, 4, 5, 6, 10, 12, 15, 20, 30, 1):
        return size
    if unit == "h" and size in (1, 2, 3, 4, 6, 8, 12):
        return size
    if unit == "d" and size >= 1:
        return size
    raise TimeError(f"failed to parse time bucketizer: {orig}")


def bucketizer_seconds(size: int, unit: str) -> int:
    return size * _BUCKET_UNIT_SECONDS[unit]


def parse_minutes_of_day(s: str) -> Optional[int]:
    """'15 minutes of day' -> 900 (bucket width seconds), None if not that form."""
    if not s.endswith("minutes of day"):
        return None
    parts = s.split(" ")
    if len(parts) != 4:
        raise TimeError(f"Must put number before minutes of day: got {s}")
    n = int(parts[0])
    if n not in _ALLOWED_MINUTES_OF_DAY:
        raise TimeError(
            "Only {2,3,4,5,6,10,15,20,30} minutes of day are allowed: got " + s)
    return n * 60


# ---------------------------------------------------------------------------
# Time dimension formatting (reference query/common/dimval.go:146-210)
# ---------------------------------------------------------------------------

_WEEKDAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]


def _utc(ts: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(int(ts), _dt.timezone.utc)


def adjust_offset(from_offset: int, to_offset: int, switch_ts: int, val: int) -> int:
    """Mirror utils.AdjustOffset for timeUnit outputs."""
    if switch_ts and val >= switch_ts:
        return val + to_offset
    return val + from_offset


def format_time_dimension(val: int, time_bucketizer: str, time_unit: str = "",
                          from_offset: int = 0, to_offset: int = 0,
                          switch_ts: int = 0) -> str:
    if time_unit:
        v = adjust_offset(from_offset, to_offset, switch_ts, val)
        if time_unit == "day":
            v //= SECONDS_PER_DAY
        elif time_unit == "hour":
            v //= SECONDS_PER_HOUR
        elif time_unit == "minute":
            v //= SECONDS_PER_MINUTE
        elif time_unit == "millisecond":
            v *= 1000
        return str(v)

    tb = time_bucketizer
    if tb == "time of day":
        return _utc(val).strftime("%H:%M")
    if tb == "hour of day":
        return _utc(val - val % 3600).strftime("%H:%M")
    if tb == "hour of week":
        t = _utc(val + SECONDS_PER_4DAY)
        return f"{_WEEKDAYS[t.weekday()]} {t.strftime('%H:%M')}"
    if tb == "day of week":
        t = _utc(((val + 4) % 7) * SECONDS_PER_DAY)
        return _WEEKDAYS[t.weekday()]
    try:
        size, unit = parse_regular_time_bucketizer(tb)
    except TimeError:
        return str(val)
    if unit == "m":
        return _utc(val).strftime("%Y-%m-%d %H:%M")
    if unit == "h":
        return _utc(val - val % 3600).strftime("%Y-%m-%d %H:00")
    return _utc(val - val % 86400).strftime("%Y-%m-%d")
