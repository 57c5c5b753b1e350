#!/usr/bin/env python3
"""The IVF join kernel on a mesh of NVIDIA cards: every rank joins every
W-th virtual row and the shares are summed.

    python3 tools/torch_ivf_join_mesh.py [--rows 11000000] [--meshes 1 2 4]

The large graph of chip_smoke.py's phase 4 (``synthetic_higgs`` rows,
seed 7, z-scored; knbn 6, nprobe 24, bf16, 4 NN-descent rounds at rho
0.5) built on one card by ``build_kgraph``, then by
``sharded_build_kgraph`` on W ranks of the package's launcher (one card
each) for each W of ``--meshes`` that the host has cards for.  Per W:
the build's phases (quantize, join, NN-descent rounds, rerank) on rank
0, every rank's launches of each join kernel (the tensor-core one at
these shapes), and every rank's graph
against the one card's (bit-equal, rows that differ, the share of equal
ids on the columns outside near-ties).  One JSON line per W on stdout,
then the card's name and power limit.  Needs CUDA; builds every kernel
source first (chip_smoke.KERNEL_SOURCES); exits non-zero when a rank did
not launch the tensor-core kernel or its graph differs from the one
card's outside near-ties.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KNN = dict(knbn=6, nprobe=24, dtype="bfloat16", refine_rounds=4,
           nndescent_rho=0.5)
MIN_AGREE = 0.999


def _build(x, mesh=None):
    """The graph of ``x`` at KNN, its phases (s) and each join kernel's
    launches (``ops.ivf_join.launch_counts``)."""
    import annembed_tpu_torch as at
    from annembed_tpu_torch.knn.api import build_kgraph
    from annembed_tpu_torch.ops import ivf_join as ij
    from annembed_tpu_torch.parallel.sharded_knn import sharded_build_kgraph
    from annembed_tpu_torch.utils.profiling import PhaseTimer
    timer = PhaseTimer()
    ij.reset_launch_counts()
    t0 = time.perf_counter()
    if mesh is None:
        g = build_kgraph(x, KNN["knbn"], params=at.KnnParams(**KNN),
                         timer=timer)
    else:
        g = sharded_build_kgraph(x, KNN["knbn"], mesh,
                                 params=at.KnnParams(**KNN), timer=timer)
    torch.cuda.synchronize()
    phases = dict(timer.timings, wall=time.perf_counter() - t0)
    return g.indices.cpu(), g.dists.cpu(), phases, ij.launch_counts()


def _rank(mesh, rows_path):
    from annembed_tpu_torch.parallel.launch import load_rows
    x = torch.from_numpy(load_rows(rows_path)).to(mesh.device)
    idx, dist, phases, joins = _build(x, mesh)
    return dict(rank=mesh.rank, idx=idx, dist=dist, phases=phases,
                joins=joins)


def main() -> int:
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    from annembed_tpu_torch.ops import _build as build
    from annembed_tpu_torch.parallel.launch import run_on_ranks, save_rows
    from chip_smoke import KERNEL_SOURCES, graph_agreement
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=11_000_000)
    ap.add_argument("--meshes", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    build.build_libraries(KERNEL_SOURCES)
    x_np = zscore(synthetic_higgs(args.rows, seed=7))
    ok = True
    with tempfile.TemporaryDirectory(prefix="join_mesh_") as tmp:
        rows_path = save_rows(x_np, tmp)
        x = torch.from_numpy(x_np).cuda()
        del x_np
        ref_i, ref_d, phases, joins = _build(x)
        del x
        torch.cuda.empty_cache()
        print(json.dumps(dict(w=0, rows=args.rows, phases=phases,
                              joins=[joins])), flush=True)
        ok &= joins["tc"] >= 1
        for w in args.meshes:
            if w > torch.cuda.device_count():
                continue
            ranks = run_on_ranks(_rank, w, (rows_path,), device="cuda")
            checks = []
            for r in ranks:
                agree, rows, d_rel = graph_agreement(r["idx"], r["dist"],
                                                     ref_i, ref_d)
                bits = (torch.equal(r["idx"], ref_i)
                        and torch.equal(r["dist"], ref_d))
                checks.append(dict(bit_equal=bits, rows_differing=rows,
                                   clear_columns_equal=agree,
                                   max_rel_dist_err=d_rel))
                ok &= agree >= MIN_AGREE and r["joins"]["tc"] >= 1
            print(json.dumps(dict(w=w, rows=args.rows,
                                  phases=ranks[0]["phases"],
                                  joins=[r["joins"] for r in ranks],
                                  against_one_card=checks)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
