#!/usr/bin/env python3
"""Time variants of the dense sweep kernel source on the card.

    python3 tools/torch_sweep_variants.py [--variants base runtime]

Each variant is ``csrc/dense_sweep.cu``, as it is or patched (below),
built by nvcc with the package's flags into ``build/sweep_variants/``,
all builds started together, and bound with ``ops.dense_sweep._bind``.
On phase 3b's inputs (chip_smoke.py) each variant is timed with CUDA
events, in turns (every variant once, then in reverse, twice; the mean
of the four readings and their spread): at 11M rows the attraction
alone, the kicks alone and the persistent launch over one large-step
segment (13 sweeps); at 440,000 rows the persistent launch over one
first-step segment (325 sweeps); on the bench's graph over 200 sweeps
at n_neg 20 and 10 (its first two schedule phases).  Each variant's
persistent result is held bit-equal to the first variant's; each
build's nvcc seconds (all started together) are reported.  Prints the
card's name and power limit and one JSON line; writes it to
build/sweep_variants/times.json.

Variants:
  base     the source as it is;
  runtime  every kernel on its runtime-bound loops over the edges and
           the kicks (the compile-time kg and n_neg instances left out
           of the dispatch; d still a compile-time 2 or 3).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from annembed_tpu_torch.ops import _build  # noqa: E402
from annembed_tpu_torch.ops import dense_sweep as ds  # noqa: E402

OUT = ROOT / "build" / "sweep_variants"

# the runtime variant: the dispatch's compile-time lines (d 2 with kg 3)
# dropped, so every shape takes the runtime-bound instance of its d
FIXED = re.compile(r"^.*_launch<2, 3\b.*\n", re.M)
VARIANTS = ("base", "runtime")


def patched(name: str) -> str:
    src = (_build.CSRC / "dense_sweep.cu").read_text()
    if name == "runtime":
        src, dropped = FIXED.subn("", src)
        if dropped != 3:
            raise SystemExit(f"runtime variant: {dropped} compile-time "
                             "dispatch lines, not 3")
    return src


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(patched(name))
        cmd = [_build.find_nvcc(), *_build.nvcc_flags("dense_sweep"), "-o",
               str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    logs, seconds = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name}:\n{err}")
        logs[name], seconds[name] = err, time.perf_counter() - t0
    import ctypes
    return {name: ds._bind(ctypes.CDLL(str(OUT / f"{name}.so")))
            for name in names}, logs, seconds


def persistent_fn(inp, steps):
    plan = cs.sweep_plan(inp, steps)
    work = torch.empty_like(inp["y"])
    knobs = dict(neg_weight=inp["neg_weight"],
                 neighbor_exclusion=inp.get("exclusion", True))

    def run():
        work.copy_(inp["y"])
        return ds.dense_sweeps(work, None, inp["edges"], inp["scale"], *plan,
                               inp["b"], inp["n_neg"], inp["idx_full"],
                               **knobs)
    return run


def halves(inp):
    edges, y = inp["edges"][0], inp["y"]
    a = ds.dense_attraction_rows(y, y, 0, edges, inp["scale"], inp["gamma"],
                                 inp["b"])
    return (lambda: ds.dense_attraction_rows(y, y, 0, edges, inp["scale"],
                                             inp["gamma"], inp["b"]),
            lambda: ds.dense_kick_rows(y, a, 0, inp["offset"],
                                       inp["idx_full"], inp["scale"],
                                       inp["gamma"], inp["b"], inp["n_neg"],
                                       neg_weight=inp["neg_weight"],
                                       flat=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from annembed_tpu_torch.optim.dense import _segment_cap
    kernels, logs, build_s = build(args.variants)
    cases = []
    inp = cs.sweep_inputs(cs.SWEEP_LARGE_ROWS)
    att, kick = halves(inp)
    cases += [("11m_attraction", att, 1, 10), ("11m_kicks", kick, 1, 10),
              ("11m_persistent", persistent_fn(
                  inp, _segment_cap(cs.SWEEP_LARGE_ROWS, 2)),
               _segment_cap(cs.SWEEP_LARGE_ROWS, 2), 3)]
    first = cs.sweep_inputs(cs.SWEEP_FIRST_ROWS)
    steps = _segment_cap(cs.SWEEP_FIRST_ROWS, 2)
    cases.append(("440k_persistent", persistent_fn(first, steps), steps, 3))
    bench = cs.bench_sweep_inputs()
    cases.append(("bench_persistent", persistent_fn(bench, 200), 200, 3))
    # the bench's second schedule phase (n_sub 30) kicks n_neg 10 times
    cases.append(("bench_n_neg_10_persistent",
                  persistent_fn(dict(bench, n_neg=10), 200), 200, 3))
    results = {name: {} for name in args.variants}
    ref = {}
    for order in (args.variants, args.variants[::-1]) * 2:
        for name in order:
            ds._kernels = lambda k=kernels[name]: k
            for case, fn, steps, reps in cases:
                ms = cs.cuda_ms(fn, reps) / steps
                results[name].setdefault(case, []).append(ms)
                if case.endswith("persistent"):
                    got = fn().clone()
                    same = torch.equal(ref.setdefault(case, got), got)
                    results[name].setdefault("bit_equal", True)
                    results[name]["bit_equal"] &= same
    # each case's mean and the spread of its four readings
    table = {name: {case: (dict(mean=sum(v) / len(v), min=min(v),
                                max=max(v)) if isinstance(v, list) else v)
                    for case, v in r.items()} for name, r in results.items()}
    for name in args.variants:
        regs = [line.strip() for line in logs[name].splitlines()
                if "registers" in line]
        table[name]["ptxas"] = regs
        table[name]["nvcc_s"] = build_s[name]
        print(name, json.dumps({k: v for k, v in table[name].items()
                                if k != "ptxas"}), flush=True)
    out = {"device": smi, "ms_a_sweep": table}
    (OUT / "times.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if all(t["bit_equal"] for t in table.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
