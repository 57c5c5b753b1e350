#!/usr/bin/env python3
"""The stale gather at 11M rows on the card: seconds a sweep of both
optimize steps and conservation at each ``--gather-reuse`` S, then the
Higgs harness at its own defaults, and its resume from the caches.

    python3 tools/torch_gather_reuse_sweep.py [--n 11000000] \\
        [--reuse 1 8 12 1] [--no-defaults]

Runs ``python -m annembed_tpu_torch.examples.higgs`` in subprocesses on
one set of ``--n`` synthetic Higgs rows (seed 7, z-scored; one
``--data-cache``) and one projection (``--graph-cache``: the first run
builds and saves it, the others load it):

1. at chip_smoke's main-path point (batch 40, n_sub 60, flat; quality
   nbng 50 at fraction 0.005, no compat radius), once per S in
   ``--reuse`` (in that order, so S = 1 twice brackets the others);
2. at the harness's defaults (batch 60, n_sub 120, schedule 40x60,
   20x120; quality nbng 100, compat 250, fraction min(1, 200k/n)) with
   S = 12, the form of the JAX package's artifacts/higgs11m_r5*.json,
   with an ``--embed-cache``; then the same command again, which loads
   the projection and the embedding and runs only the quality tail.

Prints the card's name and power limit, one line a run (ms a sweep of
each step, frac_without_match, the checkpoint seconds, peak host and
device memory), then one JSON line with all of it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MAIN_POINT = ["--batch", "40", "--n-sub", "60", "--schedule", "none",
              "--quality", "--quality-nbng", "50", "--quality-fraction",
              "0.005", "--quality-radius-compat", "0"]


def harness(args):
    """One harness run: (its JSON record, its ``port:`` line, wall s)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "annembed_tpu_torch.examples.higgs",
         "--out", "none", "--json", "--device", "cuda", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"harness {args} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    port = next(json.loads(line[len("port: "):]) for line in
                proc.stderr.splitlines() if line.startswith("port: "))
    return json.loads(proc.stdout.strip().splitlines()[-1]), port, wall


def summary(tag, rec, port, wall):
    out = {"run": tag, "process_s": wall, "wall_s": rec["wall_s"],
           "graph_build_s": rec["graph_build_time"],
           "checkpoints": port.get("checkpoints", {}),
           "peak_host_rss_gib": port["peak_host_rss_gib"],
           "peak_device_gib": port.get("peak_device_gib")}
    if "first_step" in rec:
        f = rec["first_step"]
        out.update(first_sweeps=f["sweeps"],
                   first_optimize_s=f["optimize_time"],
                   first_ms_per_sweep=1e3 * f["optimize_time"] / f["sweeps"],
                   large_sweeps=rec["sweeps"],
                   large_optimize_s=rec["optimize_time"],
                   large_ms_per_sweep=1e3 * rec["optimize_time"]
                   / rec["sweeps"],
                   gather_reuse=(f.get("gather_reuse", 1),
                                 rec.get("gather_reuse", 1)))
    q = rec.get("quality", {})
    out.update({k: q[k] for k in ("frac_without_match", "mean_nb_matched",
                                  "compat_frac_without_match") if k in q})
    out["recall"] = rec.get("recall@6")
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=11_000_000)
    ap.add_argument("--reuse", type=int, nargs="+", default=[1, 8, 12, 1])
    ap.add_argument("--no-defaults", action="store_true",
                    help="skip the harness's default-knob run and resume")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        caches = ["--synthetic", str(args.n), "--data-cache",
                  f"{tmp}/x.npy", "--graph-cache", f"{tmp}/proj.npz"]
        for s in args.reuse:
            runs.append(summary(f"main point S={s}", *harness(
                caches + MAIN_POINT + ["--gather-reuse", str(s)])))
        if not args.no_defaults:
            cmd = caches + ["--gather-reuse", "12", "--quality",
                            "--embed-cache", f"{tmp}/emb.npz"]
            first = harness(cmd)
            runs.append(summary("defaults S=12", *first))
            again = harness(cmd)
            runs.append(summary("defaults S=12, resumed", *again))
            print("defaults record: " + json.dumps(first[0]), flush=True)
            print("resumed record: " + json.dumps(again[0]), flush=True)
    print(json.dumps({"device": smi, "n": args.n, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
