"""What the per-layer metrics read of the program's own record of an
``embed()`` call: ``info["spans"]``, a list of [name, parent_index,
start_ns, end_ns] on ``time.time_ns()`` (the clock the profiler stamps
the trace with; the root span's parent is -1), and ``info["counters"]``,
the process's counters' increments over the call.  A program that keeps
no such record reads as nothing: each helper returns None there."""

from __future__ import annotations

from typing import Callable, Iterable, Optional


def spans_of(info: Optional[dict]) -> Optional[list]:
    if not info or not info.get("spans"):
        return None
    return info["spans"]


def named(info: Optional[dict], names: Iterable[str] = (),
          prefix: Optional[str] = None) -> Optional[list]:
    """The call's spans named one of ``names`` or starting with
    ``prefix``; None where the call has no spans."""
    sp = spans_of(info)
    if sp is None:
        return None
    names = set(names)
    return [s for s in sp if s[0] in names
            or (prefix is not None and s[0].startswith(prefix))]


def seconds(info: Optional[dict], names: Iterable[str] = (),
            prefix: Optional[str] = None) -> Optional[float]:
    """Summed seconds of those spans; None where the call has none."""
    sp = named(info, names, prefix)
    if not sp:
        return None
    return sum(e - s for _, _, s, e in sp) * 1e-9


def window_mean(run, read: Callable[[dict], Optional[float]]
                ) -> Optional[float]:
    """The mean of ``read(info)`` over the window's embeds that give a
    value; None where none does."""
    vals = [v for v in (read(i) for i in run.infos) if v is not None]
    return sum(vals) / len(vals) if vals else None


def union(intervals: Iterable[tuple]) -> list:
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    out = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
