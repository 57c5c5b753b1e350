"""Share of the traced embed's device-idle time in which no span below
the root ``embed`` was open, over all its idle time, in %: the idle time
that no program phase accounts for.  ``pipeline``, the span that frames
the call's phases for ``info["total_time"]``, names no phase and does
not count as one."""

from portbench import spans

#: spans that frame the call's phases and name none
FRAMES = ("pipeline",)


def read(run):
    sp = spans.spans_of(run.traced_info)
    if run.trace is None or sp is None:
        return None
    gaps = run.trace.gaps()
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    inner = spans.union((s, e) for name, parent, s, e in sp
                        if parent != -1 and name not in FRAMES)
    return 100.0 * (idle - spans.overlap_ns(gaps, inner)) / idle
