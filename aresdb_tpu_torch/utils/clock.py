"""Injectable clock (reference: utils/time.go SetCurrentTime / utils.Now).

Tests pin time to get deterministic archiving cutoffs and time filters, like
the reference integration test's utils.SetCurrentTime(1560049867).
"""

from __future__ import annotations

import time as _time
from typing import Optional

_frozen: Optional[float] = None


def now() -> float:
    """Current unix time in seconds (float)."""
    return _frozen if _frozen is not None else _time.time()


def now_unix() -> int:
    return int(now())


def set_current_time(ts: Optional[float]) -> None:
    """Freeze the clock at ts; pass None to unfreeze."""
    global _frozen
    _frozen = ts


def reset_clock() -> None:
    set_current_time(None)
