#!/usr/bin/env python3
"""Time the dense sweep's per-sweep pair of one tree's package on the
card: half of an A/B of two trees' wrappers and kernels.

    python3 tools/torch_sweep_pair_ab.py [--root DIR] [--tag NAME]

Imports ``annembed_tpu_torch`` from DIR (default: this checkout; for
another commit, an unpacked ``git archive`` under build/), builds its
sweep kernels, and times with CUDA events after a warm-up, on synthetic
tables of phase 4's ranges (seeded, the same in every tree), ms a
sweep:

  pair_440k, pair_bench  the pair's two wrappers over 200 whole-array
      sweeps of 440,000 rows (d 2, kg 3, k 6, n_neg 5, hubness
      weights) and of 70,000 (n_neg 20, no exclusion, no weights);
  pair_block  the same on a node block of 256 of the 440,000 rows: the
      wrappers' host cost, the kernels being tiny;
  blocks_440k  ``dense_optimize`` with n_blocks 2 over 400 sweeps (the
      pair in every tree);
  whole_440k  ``dense_optimize`` with n_blocks 1 over 400 sweeps (the
      pair before the persistent launch, the persistent launch after);
  mesh_first_step  phase 15's sharded first-step segment at W = 1 (one
      NCCL rank, 100 sweeps of 440,000 rows, both all-gathers a sweep);
  mesh_all_gather  that segment's all-gather of the 440,000 rows alone,
      ms a call;

plus the device time of pair_440k's kernels a sweep from torch.profiler.
Prints the card's name and power limit and one JSON line with the tag.
Run it on two trees in turns in one call (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tables(n, k=6, seed=0, hub=True):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo

    idx = torch.randint(0, n, (n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    w = u((n, k), 0.05, 1.0)
    w_rev = torch.where(u((n, k), 0.0, 1.0) < 0.5, u((n, k), 0.05, 1.0),
                        torch.zeros((), device="cuda"))
    scale = u((n,), 0.5, 2.0)
    return dict(y=3.0 * torch.randn((n, 2), generator=g, device="cuda"),
                idx=idx, w=w, m=2.0 * w, w_rev=w_rev, m_rev=2.0 * w_rev,
                scale=scale, nw=u((n,), 0.25, 4.0) if hub else None)


def group_args(ds, t, c, lo, rows, kg=3):
    """The attraction's edge arguments of rows [lo, lo + rows) of group
    c, in the tree's API: packed records, or the six (kg, rows) tables."""
    sl = slice(c * kg, (c + 1) * kg)
    if hasattr(ds, "pack_groups"):
        e = ds.pack_groups(t["idx"], t["w"], t["m"], t["w_rev"], t["m_rev"],
                           t["scale"], t["idx"].shape[1] // kg)
        return (e[c, lo:lo + rows],)
    cols = [t[key][lo:lo + rows, sl].T.contiguous()
            for key in ("idx", "w", "m", "w_rev", "m_rev")]
    sj = t["scale"][t["idx"][lo:lo + rows, sl].long()].T.contiguous()
    return (*cols, sj)


def pair_fn(ds, t, n_neg, exclusion, lo=0, rows=None, sweeps=200):
    y = t["y"]
    n = y.shape[0]
    rows = n - lo if rows is None else rows
    groups = [group_args(ds, t, c, lo, rows) for c in range(2)]
    ids = t["idx"][lo:lo + rows].T.contiguous()
    gen = torch.Generator().manual_seed(1)
    offs = torch.randint(0, n, (sweeps,), generator=gen).tolist()

    def run():
        for s in range(sweeps):
            a = ds.dense_attraction_rows(y, y, lo, *groups[s % 2], t["scale"],
                                         0.5, 1.0)
            ds.dense_kick_rows(y, a, lo, offs[s], ids, t["scale"], 0.5, 1.0,
                               n_neg, neg_weight=t["nw"],
                               neighbor_exclusion=exclusion,
                               flat=rows == n, out=y[lo:lo + rows])
    return run, sweeps


def optimize_fn(dense, t, n_blocks, n_sub=20, batches=20):
    args = (t["y"], t["idx"], t["w"], t["m"], t["w_rev"], t["m_rev"],
            t["scale"], t["nw"])

    def run():
        dense.dense_optimize(*args, grad_step_init=2.0, b=1.0, n_sub=n_sub,
                             n_neg=5, nb_grad_batch=batches + 1, n_groups=2,
                             batch0=0, batch1=batches, n_blocks=n_blocks,
                             generator=torch.Generator().manual_seed(2))
    return run, n_sub * batches


def mesh_fn(sharded, t, sweeps=100):
    """Phase 15's first-step segment on one rank."""
    mesh = sharded.Mesh(rank=0, size=1, device=torch.device("cuda"))
    seg = sharded.make_sharded_dense_segment(
        mesh, b=1.0, n_sub=sweeps, n_neg=5, nb_grad_batch=41, n_groups=2,
        grad_step_init=2.0, f_min=1e-3, mask_p=1.0, seg_steps=sweeps)
    raw = (t["idx"], t["w"], t["m"], t["w_rev"], t["m_rev"], t["scale"],
           t["nw"])
    gen = torch.Generator().manual_seed(3)
    offs = torch.randint(0, t["y"].shape[0], (sweeps,), generator=gen)
    offs = offs.tolist()
    if hasattr(sharded, "segment_tables"):
        tab = sharded.segment_tables(*raw, 2)
        return (lambda: seg(t["y"], tab, offs, 0, 0)), sweeps
    return (lambda: seg(t["y"], *raw, offs, 0, 0)), sweeps


def gather_fn(sharded, t, calls=100):
    """The mesh's all-gather of a 440,000-row block on one rank, as the
    sharded segment calls it twice a sweep."""
    mesh = sharded.Mesh(rank=0, size=1, device=torch.device("cuda"))
    rows = t["y"].clone()

    def run():
        for _ in range(calls):
            mesh.all_gather_rows(rows)
    return run, calls


def device_ms(fn):
    """Device time of the kernels of one call of ``fn`` (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if "dense" in evt.key or "kernel" in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch.distributed as dist
    from annembed_tpu_torch.ops import dense_sweep as ds
    from annembed_tpu_torch.optim import dense
    from annembed_tpu_torch.parallel import sharded
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    ds._kernels()
    build_s = time.perf_counter() - t0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    out = dict(tag=args.tag or str(args.root), device=smi,
               kernels_build_s=build_s)
    big = tables(440_000)
    bench = tables(70_000, seed=1, hub=False)
    cases = {
        "pair_440k": pair_fn(ds, big, 5, True),
        "pair_bench": pair_fn(ds, bench, 20, False),
        "pair_block": pair_fn(ds, big, 5, True, lo=200_001, rows=256),
        "blocks_440k": optimize_fn(dense, big, 2),
        "whole_440k": optimize_fn(dense, big, 1),
        "mesh_first_step": mesh_fn(sharded, big),
        "mesh_all_gather": gather_fn(sharded, big),
    }
    for name, (fn, sweeps) in cases.items():
        out[name] = [cuda_ms(fn, 2) / sweeps for _ in range(3)]
    out["pair_440k_device_ms"] = device_ms(cases["pair_440k"][0]) / 200
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
