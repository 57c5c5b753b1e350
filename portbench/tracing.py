"""A ``torch.profiler`` capture of one call, reduced to what the
per-layer metrics read: the device's activity intervals by name, the
union of them (busy seconds), the traced window's length, and the host
operation that was running in each idle gap.

The events are read from the profiler's raw results, not from its
per-event Python objects, so that a call with a million launches can be
reduced in seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

#: names longer than this are cut in the breakdown
NAME_CHARS = 160
#: the host span that bounds the traced window
WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    """Device intervals (name, start ns, end ns), host operations
    (name, start ns, end ns), the traced window's bounds on the
    profiler's clock and its length in seconds."""

    device: list
    host: list
    window_s: float
    t0_ns: int
    t1_ns: int

    def seconds_of(self, *parts: str) -> float:
        """Device seconds of the activities whose name holds any of
        ``parts``."""
        return sum(e - s for name, s, e in self.device
                   if any(p in name for p in parts)) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which some device activity ran, inside the window."""
        busy, end = 0, self.t0_ns
        for s, e in sorted((max(s, self.t0_ns), min(e, self.t1_ns))
                              for _, s, e in self.device):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy * 1e-9

    def gaps(self) -> list:
        """Idle intervals (start ns, end ns) of the device in the window."""
        out, end = [], self.t0_ns
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                out.append((end, min(s, self.t1_ns)))
            end = max(end, e)
        if end < self.t1_ns:
            out.append((end, self.t1_ns))
        return [(s, e) for s, e in out if e > s]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the innermost host operation running at
        their middle."""
        by_name: dict = {}
        for name, s, e in self.device:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            inner = None
            for name, hs, he in self.host:
                if hs <= mid <= he and (inner is None or hs >= inner[1]):
                    inner = (name, hs)
            label = inner[0][:NAME_CHARS] if inner else "host, no operation"
            named.append([label, (e - s) * 1e-9])
        return {"device_ops": [[k, v * 1e-9] for k, v in ops],
                "idle_gaps": named}


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def capture(fn: Callable[[], object]) -> tuple[object, Trace]:
    """Run ``fn()`` under the profiler (the card's activity and the
    host's operations); returns its result and the trace."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    with torch.profiler.record_function(WINDOW):
        out = fn()
        torch.cuda.synchronize()
    prof.stop()
    device, hosts, bounds = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        on_card = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name == WINDOW:
            # the span's copy on the card's timeline is no activity
            if not on_card:
                bounds = (s, e)
        elif on_card:
            device.append((name, s, e))
        else:
            hosts.append((name, s, e))
    if bounds is None:
        raise RuntimeError("the profiler recorded no window span")
    return out, Trace(device=device, host=hosts,
                      window_s=(bounds[1] - bounds[0]) * 1e-9,
                      t0_ns=bounds[0], t1_ns=bounds[1])


def device_summary(trace: Optional[Trace]) -> dict:
    if trace is None:
        return {}
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s}
