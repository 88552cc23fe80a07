"""Progress callbacks and cooperative cancellation (port of
videovanish_tpu/core/prog.py).

Every stage takes `prog(pct, status, **kw)`; a job polls `is_canceled()`
between stages or chunks and stops with CancelledError.
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol


class ProgressFn(Protocol):
    def __call__(self, pct: float, status: str = "", **kw) -> None: ...


def null_prog(pct: float, status: str = "", **kw) -> None:
    return None


def scale_prog(prog: Optional[Callable], lo: float, hi: float,
               prefix: str = "") -> Callable:
    """Map a sub-stage's 0-100 progress into [lo, hi] of the caller's."""
    if prog is None:
        return null_prog

    def scaled(pct: float, status: str = "", **kw) -> None:
        p = lo + (hi - lo) * (max(0.0, min(100.0, float(pct))) / 100.0)
        prog(p, (prefix + status) if prefix else status, **kw)

    return scaled


class CancelledError(RuntimeError):
    """Raised when a job finds its cancel flag set between stages."""


def check_cancel(is_canceled: Optional[Callable[[], bool]]) -> None:
    if is_canceled is not None and is_canceled():
        raise CancelledError("job canceled")
