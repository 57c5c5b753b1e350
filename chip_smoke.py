#!/usr/bin/env python3
"""Smoke run of annembed_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero; with no
CUDA device it exits 1 before printing any result):

1. the device, its name and power limit;
2. the CUDA kernel built from this checkout's sources, with ptxas's
   report (registers, shared memory, spills);
3. the kernel against its plain PyTorch twin at the hierarchical path's
   shapes (1M x 40k x 28 on the Higgs rows, 70k x 3.5k x 784 on the
   bench's rows, 11M x 440k x 28 checked on a query sample, a ragged
   77 x 131 x 5), timed in turns with its yardstick (``torch.cdist`` +
   ``min``) and beside its bound;
4. ``embed(x, layer=1)`` on 1,000,000 x 28 Higgs-shaped rows (the
   reference's Higgs operating point: nbng 6, hierarchy fraction 0.04,
   scale 0.75, batch 40, grad_factor 5, hubness weighting);
5. the bench workload (``annembed_tpu_torch.bench``: bench.py's one-step
   path at 70,000 x 784, blobs and manifold rows), held to recall and to
   the JAX package's conservation on the same workload;
6. ``dmap_embed`` at 70,000 x 784;
7. the CLI end to end (``embed --quality`` and ``dmapembed``) on a
   20,000 x 784 csv;
8. ``embed(distance=...)`` under the four non-L2 metrics on 20,000 x 784
   rows, each graph held against the CPU search on a row sample.

Before each path the kernel launch counts are set to 0 and read after it.
The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_ROWS = 1_000_000
SEED = 7
KNN_K = 6
FRACTION = 0.04
# The expansion (|q|^2 + |c|^2) - 2 q.c rounds at the scale of
# |q|^2 + |c|^2, not of d^2, so both tolerances are relative to that
# scale: indices must agree wherever the twin's best and second-best d^2
# are further apart than TIE_REL of it, and the squared distances must
# agree to D2_REL of it.  (A self-match has d^2 = 0 up to that noise, so
# its distance sqrt(noise) can differ by ~1e-2 between two summation
# orders; a tolerance on the distance itself cannot hold there.)
TIE_REL = 1e-5
D2_REL = 1e-5
MIN_RECALL = 0.99
MIN_PURITY = 0.9
ROOT = Path(__file__).resolve().parent
# phase 3: the kernel's other shapes on the path (bench rows at the
# default hierarchy fraction; the reference's HIGGS projection, checked
# on a query sample); the H100 SXM data sheet's peaks for its bounds
BENCH_FRACTION = 0.05
HIGGS_N, HIGGS_M, HIGGS_D, HIGGS_SAMPLE = 11_000_000, 440_000, 28, 65_536
H100_BYTES_PER_S, H100_TF32_FLOPS, H100_F32_FLOPS = 3.35e12, 495e12, 67e12

# phase 5: the JAX package (annembed_tpu) on the CPU backend, the same
# workload with the same exact f32 graph (PERF.md section 6)
JAX_NO_MATCH = 57_647
JAX_MANIFOLD_MEAN_MATCHED = 5.175777602183751
NO_MATCH_REL = 0.05
MANIFOLD_MATCHED_ABS = 0.15
BENCH_MIN_RECALL = 0.999
# phase 7: the CLI's csv; phase 8: the non-L2 graphs
CLI_ROWS = 20_000
METRIC_ROWS, METRIC_D, METRIC_SAMPLE = 20_000, 784, 200
METRIC_TIE_REL, METRIC_D_REL, METRIC_MIN_AGREE = 1e-5, 1e-4, 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def twin_top2(q, c):
    """Best and second-best d^2 per query from the twin's expansion, and
    the expansion's scale |q|^2 + |c_best|^2."""
    from annembed_tpu_torch.knn.distances import (corpus_sqnorm, l2_expansion,
                                                  panel_rows)
    c_sq = corpus_sqnorm(c)
    br = panel_rows(c.shape[0], q.shape[0])
    vals, scale = [], []
    for r0 in range(0, q.shape[0], br):
        qb = q[r0:r0 + br]
        v, i = torch.topk(l2_expansion(qb, c, c_sq), 2, dim=1, largest=False)
        vals.append(v)
        scale.append(torch.square(qb).sum(1) + c_sq[i[:, 0]])
    return torch.cat(vals), torch.cat(scale)


def library_top1(q, c):
    """The yardstick: ``torch.cdist`` (matmul form, full f32) and a row
    ``min`` over the twin's query chunks.  Timed only; the port never
    calls it."""
    from annembed_tpu_torch.knn.distances import panel_rows
    br = panel_rows(c.shape[0], q.shape[0])
    for r0 in range(0, q.shape[0], br):
        torch.cdist(q[r0:r0 + br], c,
                    compute_mode="use_mm_for_euclid_dist").min(dim=1)


def top1_bounds(nq, m, d):
    """Least time (ms) an H100 SXM could take for the top-1 search: the
    larger of its bytes (inputs read once, outputs written once) at
    3.35 TB/s and its f32-accurate tensor-core work (three TF32 products,
    6 nq m d flop) at 495 TFLOP/s; beside it the f32 CUDA-core bound
    (2 nq m d flop at 67 TFLOP/s)."""
    bytes_ms = 4.0 * ((nq + m) * d + 2 * nq) / H100_BYTES_PER_S * 1e3
    tf32x3_ms = 6.0 * nq * m * d / H100_TF32_FLOPS * 1e3
    f32_ms = 2.0 * nq * m * d / H100_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, tf32x3_ms),
                bound_by="operations" if tf32x3_ms >= bytes_ms else "bytes",
                bound_f32_ms=max(bytes_ms, f32_ms))


def check_kernel(name, q, c, reps, sample=None):
    """Kernel against twin on the same CUDA tensors, then timed in turns
    with its yardstick (library, kernel, kernel, library) and the twin.
    With ``sample``, the twin is held against the kernel on that many
    random query rows, and only the kernel is timed at full size."""
    from annembed_tpu_torch.ops.top1 import top1_l2, top1_l2_reference
    nq, d = q.shape
    m = c.shape[0]
    ki, kd = top1_l2(q, c)
    torch.cuda.synchronize()
    qc = q
    if sample is not None:
        gen = torch.Generator(device=q.device).manual_seed(SEED)
        rows = torch.sort(torch.randperm(nq, generator=gen,
                                         device=q.device)[:sample]).values
        qc, ki, kd = q[rows].contiguous(), ki[rows], kd[rows]
    ri, rd = top1_l2_reference(qc, c)
    top2, scale = twin_top2(qc, c)
    gap = (top2[:, 1] - top2[:, 0]) > TIE_REL * scale
    bad_idx = int(((ki != ri) & gap).sum())
    d2_err = (kd.square() - rd.square()).abs()
    bad_d2 = int((d2_err > D2_REL * scale).sum())
    max_err = float((kd - rd).abs().max())
    max_rel = float((d2_err / scale).max())
    near_ties = int((~gap).sum())
    del ki, kd, ri, rd, top2, scale, d2_err, gap
    kernel = lambda: top1_l2(q, c)  # noqa: E731
    if sample is None:
        lib_a = cuda_ms(lambda: library_top1(q, c), reps)
        ms_a = cuda_ms(kernel, reps)
        ms_b = cuda_ms(kernel, reps)
        lib_b = cuda_ms(lambda: library_top1(q, c), reps)
        ms, library_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
        turns = (f"turns lib {lib_a:.4f} kernel {ms_a:.4f} {ms_b:.4f} "
                 f"lib {lib_b:.4f}")
        twin_ms = cuda_ms(lambda: top1_l2_reference(q, c), reps)
        sample_twin_ms = None
    else:
        ms, library_ms, twin_ms, turns = cuda_ms(kernel, reps), None, None, ""
        sample_twin_ms = cuda_ms(lambda: top1_l2_reference(qc, c), 3)
    b = top1_bounds(nq, m, d)
    out = dict(shape=name, nq=nq, m=m, d=d, ms=ms, bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], bound_f32_ms=b["bound_f32_ms"],
               share_of_bound=b["bound_ms"] / ms, library_ms=library_ms,
               twin_ms=twin_ms, sample_twin_ms=sample_twin_ms,
               checked_rows=qc.shape[0], idx_mismatch_outside_ties=bad_idx,
               near_ties_skipped=near_ties, d2_out_of_tol=bad_d2,
               max_rel_d2_err=max_rel, max_abs_err=max_err)
    log(f"kernel {name}: nq={nq} m={m} d={d} checked_rows={qc.shape[0]} "
        f"idx_mismatch_outside_ties={bad_idx} near_ties_skipped={near_ties} "
        f"d2_out_of_tol={bad_d2} max_rel_d2_err={max_rel:.3e} "
        f"max_abs_dist_err={max_err:.3e} ms={ms:.4f} "
        f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}; f32 CUDA cores "
        f"{b['bound_f32_ms']:.4f}) share={b['bound_ms'] / ms:.4f} "
        f"library_ms={library_ms} twin_ms={twin_ms} "
        f"sample_twin_ms={sample_twin_ms} {turns}")
    if bad_idx or bad_d2:
        raise AssertionError(f"top1_l2 kernel disagrees with its twin at "
                             f"{name}: {bad_idx} index mismatches, {bad_d2} "
                             "squared distances out of tolerance")
    return out


def phase_bench():
    """Phase 5: bench.py's one-step workload at 70,000 x 784."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.ops.top1 import top1_l2
    top1_l2.launches = 0
    rec, t, y, tm = bench.run(bench.N, "cuda")
    log(f"bench: phases (s) {json.dumps(t)}; manifold row {json.dumps(tm)}; "
        f"top1_l2 launches={top1_l2.launches}")
    log(json.dumps(rec))
    y = y.cpu().numpy()
    if y.shape != (bench.N, 2) or not np.isfinite(y).all():
        raise AssertionError(f"bench embedding {y.shape} or non-finite")
    if rec["recall"] < BENCH_MIN_RECALL:
        raise AssertionError(f"bench recall {rec['recall']} < "
                             f"{BENCH_MIN_RECALL}")
    rel = abs(rec["no_match"] - JAX_NO_MATCH) / JAX_NO_MATCH
    if rel > NO_MATCH_REL:
        raise AssertionError(f"blobs no_match {rec['no_match']} vs JAX "
                             f"{JAX_NO_MATCH}: {rel:.4f} > {NO_MATCH_REL}")
    diff = abs(rec["manifold_mean_matched"] - JAX_MANIFOLD_MEAN_MATCHED)
    if diff > MANIFOLD_MATCHED_ABS:
        raise AssertionError(
            f"manifold mean_matched {rec['manifold_mean_matched']} vs JAX "
            f"{JAX_MANIFOLD_MEAN_MATCHED}: {diff:.4f} > "
            f"{MANIFOLD_MATCHED_ABS}")
    log(f"bench: no_match {rec['no_match']} vs JAX {JAX_NO_MATCH} "
        f"({rel:.4f} relative); manifold mean_matched "
        f"{rec['manifold_mean_matched']:.4f} vs JAX "
        f"{JAX_MANIFOLD_MEAN_MATCHED:.4f} ({diff:.4f})")


def phase_dmap(at):
    """Phase 6: ``dmap_embed`` at 70,000 x 784, layer 0."""
    from annembed_tpu_torch.bench import D, N
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.ops.top1 import top1_l2
    x = synthetic_blobs(N, D, 42)
    top1_l2.launches = 0
    t0 = time.perf_counter()
    y, info = at.dmap_embed(x, dim=2, device="cuda")
    wall = time.perf_counter() - t0
    log(f"dmap_embed: n={N} d={D} wall={wall:.2f} s info={json.dumps(info)} "
        f"top1_l2 launches={top1_l2.launches}")
    if y.shape != (N, 2) or not np.isfinite(y).all():
        raise AssertionError(f"dmap_embed output {y.shape} or non-finite")


def _run_cli(args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "annembed_tpu_torch.cli",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def _csv_rows(path: Path) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


def phase_cli():
    """Phase 7: the CLI on a 20,000 x 784 csv with a '#' header."""
    from annembed_tpu_torch.io.synthetic import synthetic_clustered_manifold
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src = d / "manifold.csv"
        np.savetxt(src, synthetic_clustered_manifold(CLI_ROWS, 784), fmt="%d",
                   delimiter=",", header="synthetic clustered manifold")
        out, wall = _run_cli(["embed", "--csv", str(src), "--nbng", "6",
                              "--quality", "--outfile",
                              str(d / "embedded.csv"), "--device", "cuda"])
        log(f"cli embed: wall={wall:.2f} s {json.dumps(out)}")
        if "quality" not in out or out["n"] != CLI_ROWS:
            raise AssertionError(f"cli embed printed {sorted(out)}")
        for name in ("embedded.csv", "first_dist.csv",
                     "continuity_ratio.csv"):
            rows = _csv_rows(d / name)
            if rows != CLI_ROWS:
                raise AssertionError(f"{name}: {rows} rows, not {CLI_ROWS}")
        out, wall = _run_cli(["dmapembed", "--csv", str(src), "--outfile",
                              str(d / "dmap.csv"), "--device", "cuda"])
        log(f"cli dmapembed: wall={wall:.2f} s {json.dumps(out)}")
        rows = _csv_rows(d / "dmap.csv")
        if out["n"] != CLI_ROWS or rows != CLI_ROWS:
            raise AssertionError(f"cli dmapembed: n={out['n']}, {rows} rows")


def _clear_ties(dist: np.ndarray) -> np.ndarray:
    """Columns whose distance is further than METRIC_TIE_REL (relative)
    from both row neighbours' distances."""
    scale = np.maximum(np.abs(dist), 1e-6)
    gap = np.full(dist.shape, np.inf)
    step = np.diff(dist, axis=1)
    gap[:, 1:] = step / scale[:, 1:]
    gap[:, :-1] = np.minimum(gap[:, :-1], step / scale[:, :-1])
    return gap > METRIC_TIE_REL


def phase_metrics(at):
    """Phase 8: ``embed(distance=...)`` under each non-L2 metric on
    20,000 x 784 blobs (the bench's width; probability rows for Jeffreys
    and Jensen-Shannon), its graph held against the CPU search of the
    same rows on a sample."""
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.knn.brute import knn_search_brute
    from annembed_tpu_torch.ops.top1 import top1_l2
    x = synthetic_blobs(METRIC_ROWS, METRIC_D, 5).astype(np.float32)
    prob = x / x.sum(1, keepdims=True)
    sample = np.sort(np.random.default_rng(0).choice(
        METRIC_ROWS, METRIC_SAMPLE, replace=False))
    for metric in ("DistL1", "DistCosine", "DistJeffreys",
                   "DistJensenShannon"):
        data = prob if metric in ("DistJeffreys", "DistJensenShannon") else x
        top1_l2.launches = 0
        t0 = time.perf_counter()
        y, info = at.embed(data, dim=2, nbng=KNN_K, distance=metric,
                           return_graph=True, device="cuda")
        wall = time.perf_counter() - t0
        g = info["kgraph"]
        gi = g.indices.cpu().numpy()[sample]
        gd = g.dists.cpu().numpy()[sample]
        host = torch.from_numpy(data)
        t0 = time.perf_counter()
        ci, cd = knn_search_brute(host[sample], host, KNN_K + 2,
                                  distance=metric)
        cpu_s = time.perf_counter() - t0
        ci, cd = ci.numpy(), cd.numpy()
        keep = ci != sample[:, None]
        ci = np.stack([r[m][:KNN_K] for r, m in zip(ci, keep)])
        cd = np.stack([r[m][:KNN_K] for r, m in zip(cd, keep)])
        clear = _clear_ties(cd)
        agree = float((gi[clear] == ci[clear]).mean())
        d_err = np.abs(gd - cd) / np.maximum(np.abs(cd), 1e-6)
        bad_d = int((np.abs(gd - cd) > METRIC_D_REL * np.abs(cd) + 1e-6)
                    .sum())
        log(f"metric {metric}: n={METRIC_ROWS} d={METRIC_D} k={KNN_K} "
            f"graph {info['graph_build_time']:.2f} s, embed wall "
            f"{wall:.2f} s; {METRIC_SAMPLE} rows vs CPU ({cpu_s:.2f} s): "
            f"id agreement {agree:.5f} outside {int((~clear).sum())} "
            f"near-tie columns, max rel dist err {float(d_err.max()):.3e}, "
            f"{bad_d} dists out of tol; top1_l2 launches={top1_l2.launches}")
        if y.shape != (METRIC_ROWS, 2) or not np.isfinite(y).all():
            raise AssertionError(f"{metric}: embedding {y.shape} or "
                                 "non-finite")
        if agree < METRIC_MIN_AGREE or bad_d:
            raise AssertionError(f"{metric}: CUDA graph disagrees with the "
                                 "CPU search")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # phase 1: device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: {kind} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)

    import annembed_tpu_torch as at
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.io.synthetic import (label_purity,
                                                 synthetic_blobs,
                                                 synthetic_higgs, zscore)
    from annembed_tpu_torch.knn.api import sampled_exact_recall
    from annembed_tpu_torch.knn.hierarchy import draw_sample_ids
    from annembed_tpu_torch.ops import _build
    from annembed_tpu_torch.ops.top1 import top1_l2
    disable_tf32()

    # phase 2: build the kernel from this checkout's sources
    t0 = time.perf_counter()
    _build.load_library("top1_l2")
    log(f"build: top1_l2.cu -> {_build.library_path('top1_l2')} in "
        f"{time.perf_counter() - t0:.2f} s; ptxas:\n"
        f"{_build.build_log('top1_l2').strip()}")

    # phase 3: kernel against twin and library at the path's shapes
    t0 = time.perf_counter()
    x_np, labels = synthetic_higgs(N_ROWS, seed=SEED, return_labels=True)
    x = torch.from_numpy(zscore(x_np)).to(dev)
    m = max(KNN_K + 1, int(round(N_ROWS * FRACTION)))
    sample = draw_sample_ids(N_ROWS, m, torch.Generator().manual_seed(SEED))
    xs = x[sample.to(dev)].contiguous()
    shapes = [check_kernel("slice", x, xs, reps=3)]
    xb = torch.from_numpy(synthetic_blobs(bench.N, bench.D, 42)
                          .astype(np.float32)).to(dev)
    mb = max(KNN_K + 1, int(round(bench.N * BENCH_FRACTION)))
    sb = draw_sample_ids(bench.N, mb, torch.Generator().manual_seed(SEED))
    shapes.append(check_kernel("bench_rows", xb, xb[sb.to(dev)].contiguous(),
                               reps=10))
    del xb
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qh = torch.randn(HIGGS_N, HIGGS_D, generator=gen, device=dev)
    ch = torch.randn(HIGGS_M, HIGGS_D, generator=gen, device=dev)
    shapes.append(check_kernel("higgs_11m", qh, ch, reps=1,
                               sample=HIGGS_SAMPLE))
    del qh, ch
    gen = torch.Generator().manual_seed(0)
    shapes.append(check_kernel(
        "ragged", torch.randn(77, 5, generator=gen).to(dev),
        torch.randn(131, 5, generator=gen).to(dev), reps=5))
    log(f"phase 3: {time.perf_counter() - t0:.2f} s")

    # phase 4: the main path, counting kernel launches from zero
    torch.cuda.reset_peak_memory_stats()
    top1_l2.launches = 0
    t0 = time.perf_counter()
    y, info = at.embed(
        x.cpu().numpy(), dim=2, nbng=KNN_K, layer=1,
        hierarchy_fraction=FRACTION, scale=0.75, batch=40,
        knn_params=at.KnnParams(knbn=KNN_K, brute_force_limit=1_000_000),
        params=at.EmbedderParams(grad_factor=5, hubness_weighting=True),
        seed=SEED, return_graph=True, device="cuda")
    wall = time.perf_counter() - t0
    launches = top1_l2.launches
    first = info["first_step"]
    phases = info["graph_build_phases"]
    log(f"main path: n={N_ROWS} wall={wall:.2f} s "
        f"graph_build={info['graph_build_time']:.2f} s "
        f"(small={phases['small_graph']:.2f} large={phases['large_graph']:.2f}"
        f" projection={phases['projection']:.4f}) "
        f"first_init={first['init_time']:.2f} s "
        f"first_optimize={first['optimize_time']:.2f} s "
        f"large_optimize={info['optimize_time']:.2f} s "
        f"total={info['total_time']:.2f} s "
        f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main path: first step ce {first['initial_ce']:.6g} -> "
        f"{first['final_ce']:.6g} ({first['sweeps']} sweeps); large step ce "
        f"{info['initial_ce']:.6g} -> {info['final_ce']:.6g} "
        f"({info['sweeps']} sweeps); top1_l2 launches={launches}")
    recall = sampled_exact_recall(x, info["kgraph"], sample=2000)
    purity = label_purity(torch.from_numpy(y).to(dev), labels, k=KNN_K)
    # the CE values are reported, not held to a direction: at this
    # operating point the JAX package itself ends the large step above
    # its initial CE on Higgs-shaped data (20k and 30k rows, CPU), and the
    # first step too at 20k, so the output is held to the graph's recall
    # and the embedding's cluster purity instead
    log(f"main path: recall@{KNN_K}={recall:.4f} "
        f"embedded {KNN_K}-NN label purity={purity:.4f}")
    if y.shape != (N_ROWS, 2) or not np.isfinite(y).all():
        raise AssertionError(f"embedding shape {y.shape} or non-finite")
    if launches < 1:
        raise AssertionError("the main path never launched top1_l2")
    if recall < MIN_RECALL:
        raise AssertionError(f"recall@{KNN_K} {recall} < {MIN_RECALL}")
    if purity < MIN_PURITY:
        raise AssertionError(f"label purity {purity} < {MIN_PURITY}")

    phase_bench()
    phase_dmap(at)
    phase_cli()
    phase_metrics(at)

    # the top-level numbers are those of the main path's shape (phase 4's
    # projection, 1M x 40k x 28); every shape of phase 3 is in "shapes"
    main_shape = shapes[0]
    log(json.dumps({"kernels": [{
        "name": "top1_l2", "route": "cuda",
        "source": "annembed_tpu_torch/csrc/top1_l2.cu",
        "replaces": "annembed_tpu/ops/top1.py:24",
        "launches": launches, "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["twin_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shapes": [dict(s, launches=launches if s is main_shape else None)
                   for s in shapes]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
