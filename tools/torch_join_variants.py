#!/usr/bin/env python3
"""Time variants of the IVF join kernel source on the card.

    python3 tools/torch_join_variants.py [--variants base wide_tile ...]

Each variant is ``csrc/ivf_join.cu``, as it is or with lines of its
dispatch dropped (below), built by nvcc with the package's flags into
``build/join_variants/``, all builds started together, and bound with
``ops.ivf_join._bind``.  On the join inputs of chip_smoke.py's phases
3c and 4 (``knn.ivf.sorted_join_inputs``: the 11M Higgs rows' large-graph
join in bf16 at k 12, nprobe 24; the first 1M rows in f32 at the parts'
nprobe 32, and their first 16 and 8 columns; the 300,000 x 3 quality
join at k 51; the parts' 1M x 2 clustered cloud through the grid
quantizer at k 10) each variant is
timed with CUDA events, in turns (every variant once, then in reverse,
twice; the mean of the four readings and their spread), and its result
held bit-equal to the first variant's.  Prints each build's ptxas
report, the card's name and power limit and one JSON line; writes it to
build/join_variants/times.json.

Variants:
  base       the source as it is;
  wide_tile  every d <= 32 on the 32-column tile (the 4-, 8- and
             16-column instances dropped).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from annembed_tpu_torch.ops import _build  # noqa: E402
from annembed_tpu_torch.ops import ivf_join as ij  # noqa: E402

OUT = ROOT / "build" / "join_variants"
DROP = {
    "base": [],
    "wide_tile": [r"^  if \(d <= (4|8|16)\) return .*\n"],
}
DROPPED = {"base": 0, "wide_tile": 3}


def patched(name: str) -> str:
    src = (_build.CSRC / "ivf_join.cu").read_text()
    dropped = 0
    for pattern in DROP[name]:
        src, count = re.subn(pattern, "", src, flags=re.M)
        dropped += count
    if dropped != DROPPED[name]:
        raise SystemExit(f"{name}: {dropped} dispatch lines dropped, not "
                         f"{DROPPED[name]}")
    return src


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(patched(name))
        cmd = [_build.find_nvcc(), *_build.nvcc_flags("ivf_join"), "-o",
               str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    joins, seconds = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name}:\n{err}")
        seconds[name] = time.perf_counter() - t0
        regs = sorted(set(re.findall(r"Used (\d+) registers", err)), key=int)
        print(f"build {name}: {seconds[name]:.2f} s, registers {regs}",
              flush=True)
        launch, max_k = ij._bind(ctypes.CDLL(str(OUT / f"{name}.so")))
        joins[name] = (launch, max_k)
    return joins, seconds


def shapes(x):
    """name -> (inputs, dtype) at the path's shapes."""
    from annembed_tpu_torch.knn.ivf import sorted_join_inputs as plan
    out = {"higgs_11m_bf16": (plan(x, 12, nprobe=24), "bfloat16")}
    for d in (28, 16, 8):
        out[f"slice_1m_x{d}_f32"] = (
            plan(x[:1_000_000, :d].contiguous(), 12, nprobe=32), "float32")
    out["quality_300k_x3_k51"] = (
        plan(x[:300_000, :3].contiguous(), 51, nprobe=32), "float32")
    rng = np.random.default_rng(cs.SEED)
    centers = rng.normal(0, 5, (8, 2))
    cloud = torch.from_numpy(
        (centers[rng.integers(0, 8, 1_000_000)]
         + rng.normal(0, 0.8, (1_000_000, 2))).astype(np.float32)).cuda()
    out["grid_1m_x2_k10"] = (plan(cloud, 10, quantizer="grid"), "float32")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(DROP))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    disable_tf32()
    joins, seconds = build(args.variants)
    x = torch.from_numpy(zscore(synthetic_higgs(cs.N_ROWS,
                                                seed=cs.SEED))).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    record = {"nvcc_s": seconds, "shapes": {}}
    for shape, (inp, dtype) in shapes(x).items():
        runs = {name: (lambda j=j: ij._join(*j, stream, **inp, dtype=dtype))
                for name, j in joins.items()}
        first = None
        for name, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            if first is None:
                first = out
            elif not (torch.equal(out[0], first[0])
                      and torch.equal(out[1], first[1])):
                raise SystemExit(f"{name} differs from {args.variants[0]} "
                                 f"at {shape}")
        del first, out
        order = list(runs)
        readings = {name: [] for name in order}
        for turn in (order, order[::-1], order, order[::-1]):
            for name in turn:
                readings[name].append(cs.cuda_ms(runs[name], 1))
        record["shapes"][shape] = {
            name: dict(ms=float(np.mean(r)), spread=float(np.ptp(r)),
                       readings=r) for name, r in readings.items()}
        print(shape, json.dumps({n: round(v["ms"], 4) for n, v in
                                 record["shapes"][shape].items()}),
              flush=True)
        del inp
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    record["card"] = smi
    print(smi)
    print(json.dumps(record))
    (OUT / "times.json").write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
