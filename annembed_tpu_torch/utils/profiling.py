"""Phase timing and optional device traces.

The reference instruments every phase with cpu_time::ProcessTime +
SystemTime pairs (embedder.rs:871-884).  Here: wall timers that end in a
``torch.cuda.synchronize()`` when any tensor handed to the phase lives on
a CUDA device, so a phase's time covers its device work, not only its
enqueue; and ``device_trace``, a ``torch.profiler`` capture written as a
Chrome trace (the JAX package's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


class PhaseTimer:
    """Collects named phase wall times; ``timings`` maps name -> s."""

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase.  Tensors appended to the yielded list are
        waited for before the clock stops."""
        t0 = time.perf_counter()
        out: list = []
        try:
            yield out
        finally:
            for dev in {t.device for t in out if isinstance(t, torch.Tensor)
                        and t.is_cuda}:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            logger.info("phase %s: %.3fs", name, dt)


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
