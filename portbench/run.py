"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the program
(``annembed_tpu_torch``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, last, ``compared``: each number the check compared,
with its limit.  The same numbers are the last lines of standard error.
Without the CUDA cards the cell asks for, or if a forbidden module was
loaded on any rank, it prints no result and exits 1.  A cell on more
than one card runs on a mesh (``mesh.py``), this process its rank 0.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_START = _T0 - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import annembed_tpu_torch  # noqa: F401  (the program under test)
    import torch
    from portbench import harness
    root = Path.cwd()
    bench = harness.load_json(root / "BENCHMARK.json")
    chips = harness.by_name(bench["workloads"], args.workload,
                            "workload")["chips"]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{count}", file=sys.stderr)
        return 1
    try:
        out = harness.run_cell(root, args.workload, args.seed, args.seconds,
                               bool(args.trace), _START)
        found = harness.forbidden_modules()
        if found:
            raise harness.ForbiddenModules(f"rank 0: {found}")
    except harness.ForbiddenModules as e:
        print(f"portbench: forbidden modules loaded: {e}", file=sys.stderr)
        return 1
    for k, (v, lim) in out["compared"].items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
