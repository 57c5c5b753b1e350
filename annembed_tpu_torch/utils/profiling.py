"""Spans, counters and optional device traces.

The reference instruments every phase with cpu_time::ProcessTime +
SystemTime pairs (embedder.rs:871-884).  Here:

* spans: ``span(name)`` records a name, the span it opened inside, a
  start and an end, all on ``time.time_ns()``.  That is the clock
  ``torch.profiler`` stamps its host events with and converts the card's
  activities to, so a span lies directly on a profiler trace.  Tensors
  appended to the yielded ``Span`` are waited for
  (``torch.cuda.synchronize`` of their devices) before it ends, so that
  its time covers their device work and not only its enqueue.  Spans are
  kept in memory while a call is open on the thread (``record_call``,
  which ``api.embed`` opens around itself); every span of a call belongs
  to that call's sequence number, and the call hands them out as
  ``[name, parent_index, start_ns, end_ns]`` (the root's parent -1).
  Nothing is put on the profiler's timeline: a ``record_function``
  range would be copied onto the card's, and read there as busy time.
* ``PhaseTimer``: named spans whose seconds it sums in ``timings``
  (name -> s), the view the graph builds and the embedder report.
* counters: ``count(name, k)`` adds to one registry per process (the
  kernels' launches, the IVF plan's candidate pairs); ``counters()``
  reads it, and a call hands out the increments over it.
* ``device_trace``: a ``torch.profiler`` capture written as a Chrome
  trace (the JAX package's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

#: the calls' sequence numbers, one count per process
_SEQ = itertools.count(1)
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


class _Open(threading.local):
    """The call open on this thread, if any."""

    call: Optional["Call"] = None


_OPEN = _Open()


class Call:
    """One recorded call: its sequence number ``seq``, its ``spans``
    ([name, parent_index, start_ns, end_ns], in the order they opened)
    and, once it has ended, its ``counters`` (each registry counter's
    increment over the call, where it moved)."""

    def __init__(self) -> None:
        self.seq = next(_SEQ)
        self.spans: List[list] = []
        self.counters: Dict[str, int] = {}
        self._stack: List[int] = []
        self._counts0 = counters()


class Span(list):
    """The tensors a span waits for before it ends (append them), and
    once it has ended its ``start_ns`` and ``end_ns``."""

    start_ns = 0
    end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@contextlib.contextmanager
def span(name: str):
    """Time the block as the span ``name``, kept if a call is open on
    this thread; yields a ``Span``."""
    call = _OPEN.call
    rec = None
    if call is not None:
        parent = call._stack[-1] if call._stack else -1
        rec = [name, parent, 0, 0]
        call._stack.append(len(call.spans))
        call.spans.append(rec)
    out = Span()
    out.start_ns = time.time_ns()
    if rec is not None:
        rec[2] = out.start_ns
    try:
        yield out
    finally:
        for dev in {t.device for t in out if isinstance(t, torch.Tensor)
                    and t.is_cuda}:
            torch.cuda.synchronize(dev)
        out.end_ns = time.time_ns()
        if rec is not None:
            rec[3] = out.end_ns
            call._stack.pop()


@contextlib.contextmanager
def record_call(name: str):
    """Open a call on this thread with the root span ``name`` around the
    block; yields the ``Call``, whose spans and counters are complete
    when the block has ended.  A call opened inside another keeps its
    own spans."""
    call, outer = Call(), _OPEN.call
    _OPEN.call = call
    try:
        with span(name):
            yield call
    finally:
        _OPEN.call = outer
        now = counters()
        call.counters = {k: v - call._counts0.get(k, 0)
                         for k, v in now.items()
                         if v != call._counts0.get(k, 0)}


class PhaseTimer:
    """Named spans; ``timings`` maps name -> the seconds of its spans."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase as the span ``name``.  Tensors appended to the
        yielded list are waited for before its clock stops."""
        with span(name) as out:
            yield out
        self.timings[name] = self.timings.get(name, 0.0) + out.seconds
        logger.info("phase %s: %.3fs", name, out.seconds)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the process's counter ``name``."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(k)


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``, the prefix cut."""
    with _COUNTS_LOCK:
        return {k[len(prefix):]: v for k, v in _COUNTS.items()
                if k.startswith(prefix)}


def reset_counters(prefix: str) -> None:
    """Set the counters whose names start with ``prefix`` to 0."""
    with _COUNTS_LOCK:
        for k in _COUNTS:
            if k.startswith(prefix):
                _COUNTS[k] = 0


@contextlib.contextmanager
def device_trace(logdir: Optional[str], name: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's when CUDA is available) into ``<logdir>/<name>.json``, a
    Chrome trace (open in chrome://tracing or Perfetto); no-op if
    ``logdir`` is empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"{name}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
