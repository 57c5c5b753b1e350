#!/usr/bin/env python3
"""The dense optimizer's first-step sweeps on one card against the same
sweeps under a mesh of one rank (NCCL), in one process.

    python3 tools/torch_profile_mesh_sweep.py [--rows 440000]

On ``synthetic_higgs`` rows (seed 7, z-scored; 440,000 is the first
step's graph at chip_smoke's 11M point) it builds the graph at the
Higgs knobs, then times ``run_dense_optimization`` and
``sharded_dense_optimize`` (4 batches of 60 sweeps, hubness weights)
twice each, and profiles one run of each with ``torch.profiler``: the
top kernels, the host's and the card's self time.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _rank(mesh, path):
    import annembed_tpu_torch as at
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.graph.proba import to_proba_edges
    from annembed_tpu_torch.optim.dense import run_dense_optimization
    from annembed_tpu_torch.optim.embedder import hubness_sampling_weights
    from annembed_tpu_torch.parallel.launch import load_rows
    from annembed_tpu_torch.parallel.sharded import sharded_dense_optimize
    from torch.profiler import ProfilerActivity, profile
    disable_tf32()
    dev = mesh.device
    x = torch.from_numpy(np.ascontiguousarray(load_rows(path))).to(dev)
    g = at.build_kgraph(x, 6, params=at.KnnParams(
        knbn=6, nprobe=24, dtype="bfloat16", refine_rounds=4,
        nndescent_rho=0.5))
    npar = to_proba_edges(g, 0.75)
    hub = hubness_sampling_weights(g)
    y0 = torch.rand((x.shape[0], 2), device=dev) * 10 - 5
    p = at.EmbedderParams(nb_grad_batch=5, grad_step=1.0)

    def run(name):
        if name == "single":
            return run_dense_optimization(y0, g, npar, p, n_sub=p.n_sub,
                                          neg_weights=hub)
        return sharded_dense_optimize(y0, g, npar, p, mesh, neg_weights=hub)

    for name in ("single", "mesh", "single", "mesh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = run(name)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / info["sweeps"]
        print(f"{name}: {x.shape[0]} rows, {info['sweeps']} sweeps, "
              f"{ms:.3f} ms a sweep", flush=True)
    for name in ("single", "mesh"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(name)
            torch.cuda.synchronize()
        # the table ends with the host's and the card's self totals
        print(name, prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=12), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=440_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_mesh_sweep: no CUDA device", file=sys.stderr)
        return 1
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    from annembed_tpu_torch.parallel.launch import run_on_ranks, save_rows
    with tempfile.TemporaryDirectory() as tmp:
        path = save_rows(zscore(synthetic_higgs(args.rows, seed=7)), tmp)
        run_on_ranks(_rank, 1, (path,), device="cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
