#!/usr/bin/env python3
"""Strong scaling of the port's sharded path on NVIDIA cards.

    python3 tools/torch_scaling_sharded.py [--rows 11000000] [--meshes 1 2 4]

``embed(x, layer=1)`` on ``synthetic_higgs`` rows (seed 7, z-scored) at
chip_smoke.py's main operating point (nbng 6, hierarchy fraction 0.04,
scale 0.75, batch 40, grad_factor 5, hubness weighting, nprobe 24, bf16
panels, 4 NN-descent rounds at rho 0.5, sampled quality at fraction
0.005) with ``mesh=make_mesh(W)`` on W ranks of the package's launcher,
one card each, for each W of ``--meshes`` that the host has cards for.
Per W it reports the graph build, its IVF join, the first and the large
step, milliseconds a large-step sweep, the total, each rank's peak
memory, the all-gather of the (n, 2) embedding's row blocks as the
sharded sweep issues it (mean of 50 after 5 warm-ups, CUDA events), and
each rank's launches of the top-1 kernel and of the dense sweep kernel
pair; it checks that every rank holds the same embedding and counts the
rows of the large graph that differ from the first mesh size's.
Every kernel source is built (``_build.build_libraries``) before the
first W, so no W's time holds nvcc.  One JSON line per W on stdout, then
the card's name and power limit.  Needs CUDA.
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

EMBED = dict(dim=2, nbng=6, layer=1, hierarchy_fraction=0.04, scale=0.75,
             seed=7, batch=40, return_graph=True, with_quality=True,
             quality_fraction=0.005, quality_nbng=50)
KNN = dict(knbn=6, nprobe=24, dtype="bfloat16", refine_rounds=4,
           nndescent_rho=0.5)
GATHER_REPS = 50


def _gather_ms(mesh, n: int, dim: int = 2) -> float:
    """Milliseconds of one all-gather of this rank's (n / W, dim) block
    into the (n, dim) embedding, as the sharded sweep does it."""
    rows = torch.randn(n // mesh.size, dim, device=mesh.device)

    def gather():
        return mesh.all_gather_rows(rows)

    for _ in range(5):
        gather()
    torch.cuda.synchronize(mesh.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GATHER_REPS):
        gather()
    end.record()
    torch.cuda.synchronize(mesh.device)
    return start.elapsed_time(end) / GATHER_REPS


def _rank(mesh, rows_path: str):
    import annembed_tpu_torch as at
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    from chip_smoke import dense_launches, rank_checksum, reset_launches
    from annembed_tpu_torch.parallel.launch import load_rows
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    y, info = at.embed(load_rows(rows_path), knn_params=at.KnnParams(**KNN),
                       params=at.EmbedderParams(grad_factor=5,
                                                hubness_weighting=True),
                       mesh=mesh, **EMBED)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    g = info.pop("kgraph")
    mine = torch.tensor([rank_checksum(torch.from_numpy(y).to(dev))],
                        device=dev)
    sums = mesh.all_gather_rows(mine).tolist()
    out = dict(rank=mesh.rank, wall=wall, peak_gib=peak,
               launches=top1_launch_count(), dense=dense_launches(),
               checksums=sums,
               gather_ms=_gather_ms(mesh, y.shape[0]))
    if mesh.rank == 0:
        out.update(info=info, graph=(g.indices.cpu(), g.dists.cpu()))
    return out


def _record(w, ranks, n):
    r0 = ranks[0]
    info = r0["info"]
    first = info["first_step"]
    phases = info["graph_build_phases"]
    return {
        "W": w, "rows": n, "graph_build_s": info["graph_build_time"],
        "ivf_join_s": phases.get("large_graph/ivf_join"),
        "large_graph_s": phases.get("large_graph"),
        "projection_s": phases.get("projection"),
        "first_step_s": first["init_time"] + first["optimize_time"],
        "first_sweeps": first["sweeps"],
        "large_step_s": info["optimize_time"],
        "large_sweeps": info["sweeps"],
        "ms_per_large_sweep": 1e3 * info["optimize_time"] / info["sweeps"],
        "ms_per_first_sweep": 1e3 * first["optimize_time"] / first["sweeps"],
        "ms_per_all_gather": [r["gather_ms"] for r in ranks],
        "total_s": info["total_time"],
        "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
        "launches_by_rank": [r["launches"] for r in ranks],
        "dense_launches_by_rank": [r["dense"] for r in ranks],
        "frac_without_match": info["quality"]["frac_without_match"],
        "ranks_bit_equal": all(r["checksums"] == r0["checksums"]
                               and len(set(r["checksums"])) == 1
                               for r in ranks),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=11_000_000)
    p.add_argument("--meshes", type=int, nargs="+", default=[1, 2, 4])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_scaling_sharded: no CUDA device", file=sys.stderr)
        return 1
    from annembed_tpu_torch.io.synthetic import synthetic_higgs, zscore
    from annembed_tpu_torch.ops import _build
    from annembed_tpu_torch.parallel.launch import run_on_ranks, save_rows
    from chip_smoke import KERNEL_SOURCES
    meshes = [w for w in args.meshes if w <= torch.cuda.device_count()]
    # every kernel built before the first W is timed (its ranks load the
    # libraries; nvcc is not in W = 1's first step)
    _build.build_libraries(KERNEL_SOURCES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    records, ref = [], None
    with tempfile.TemporaryDirectory(prefix="scaling_") as tmp:
        t0 = time.perf_counter()
        x = zscore(synthetic_higgs(args.rows, seed=7))
        rows_path = save_rows(x, tmp)
        del x
        print(f"data: {args.rows} rows in {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
        for w in meshes:
            t0 = time.perf_counter()
            ranks = run_on_ranks(_rank, w, (rows_path,), device="cuda")
            rec = _record(w, ranks, args.rows)
            rec["process_s"] = time.perf_counter() - t0
            gi, gd = ranks[0]["graph"]
            if ref is None:
                ref = (gi, gd, w)
            same = gi == ref[0]
            rec["graph_rows_differing_from_W%d" % ref[2]] = int(
                (~same).any(1).sum())
            rec["graph_equal_to_W%d" % ref[2]] = bool(
                torch.equal(gi, ref[0]) and torch.equal(gd, ref[1]))
            rec["device"] = smi
            records.append(rec)
            print(json.dumps(rec), flush=True)
    print(smi)
    bad = [r["W"] for r in records
           if not r["ranks_bit_equal"] or min(r["launches_by_rank"]) < 1
           or min(r["dense_launches_by_rank"]) < 1]
    if bad:
        print(f"ranks disagree or never launched a kernel at W={bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
