#!/usr/bin/env python3
"""Where the IVF + NN-descent graph build of annembed_tpu_torch spends the
card's time: device-busy share and kernel time by name (``torch.profiler``).

    python3 tools/torch_profile_graph_build.py [--n 11000000]

Builds the graph of ``--n`` Higgs-shaped rows (``synthetic_higgs``, seed
7, z-scored) at the Higgs knobs of examples/higgs.py (nbng 6, nprobe 24,
bf16 panels, 4 NN-descent rounds at rho 0.5) once without the profiler,
then again with the IVF join and the refinement each under a profiler
trace of its own.  Prints, per trace, its wall seconds (the clock
stops before the profiler collects its events), the sum of its kernels'
device time, their ratio (the busy share), the device time by kind of
kernel (``torch.topk``, sorts, matrix products, indexing, the rest) and
the kernels that took most of it; then one JSON line with all of it.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from annembed_tpu_torch.device import disable_tf32  # noqa: E402
from annembed_tpu_torch.io.synthetic import (synthetic_higgs,  # noqa: E402
                                             zscore)
from annembed_tpu_torch.knn.ivf import knn_graph_ivf  # noqa: E402
from annembed_tpu_torch.knn.nndescent import nndescent_refine  # noqa: E402
from annembed_tpu_torch.utils.profiling import PhaseTimer  # noqa: E402

KNBN, BUILD_K, NPROBE, ROUNDS, RHO, DTYPE = 6, 12, 24, 4, 0.5, "bfloat16"


#: kernel kinds by a substring of the kernel's name, first match wins
KINDS = (("topk", ("topk", "TopK")), ("sort", ("Sort", "sort")),
         ("matmul", ("gemm", "cutlass", "xmma")),
         ("index / gather", ("index", "gather", "scatter")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise, reductions, copies"


def profiled(fn, top: int):
    """Run ``fn`` under the profiler: (result, wall s, device s, device s
    by kind, rows of (kernel name, device s, calls))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    kinds: dict = {}
    for key, sec, _ in rows:
        kinds[kind_of(key)] = kinds.get(kind_of(key), 0.0) + sec
    return out, wall, sum(r[1] for r in rows), kinds, rows[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=11_000_000)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    disable_tf32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    x = torch.from_numpy(zscore(synthetic_higgs(args.n, seed=7))).to(dev)

    def join(timer=None):
        return knn_graph_ivf(x, BUILD_K, nprobe=NPROBE, dtype=DTYPE,
                             timer=timer)

    def refine(idx, dist, timer=None):
        return nndescent_refine(x, idx, dist, n_rounds=ROUNDS, dtype=DTYPE,
                                rho=RHO, timer=timer)

    plain = PhaseTimer()
    idx, dist = join(plain)
    refine(idx, dist, plain)
    print(f"plain build, n={args.n}: {json.dumps(plain.timings)}", flush=True)
    del idx, dist

    record = {"device": smi, "n": args.n, "plain_s": plain.timings}
    traced = PhaseTimer()
    (idx, dist), *trace = profiled(lambda: join(traced), args.top)
    traces = [("ivf (quantize + join)", *trace)]
    _, *trace = profiled(lambda: refine(idx, dist, traced), args.top)
    traces.append(("nndescent (rounds + rerank)", *trace))
    record["traced_s"] = traced.timings
    for name, wall, busy, kinds, rows in traces:
        print(f"{name}: wall {wall:.2f} s, kernels {busy:.2f} s, busy share "
              f"{busy / wall:.3f}; by kind (s) "
              f"{json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
        for key, sec, count in rows:
            print(f"  {sec:8.3f} s {count:8d} x  {key[:110]}")
        record[name] = {"wall_s": wall, "device_s": busy,
                        "busy_share": busy / wall, "by_kind_s": kinds,
                        "kernels": [(k[:110], s, c) for k, s, c in rows]}
    wall = sum(s[1] for s in traces)
    busy = sum(s[2] for s in traces)
    print(f"build: wall {wall:.2f} s, kernels {busy:.2f} s, busy share "
          f"{busy / wall:.3f}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
