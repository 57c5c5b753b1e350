#!/usr/bin/env python3
"""Smoke run of annembed_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero; with no
CUDA device it exits 1 before printing any result):

1. the device, its name and power limit;
2. the CUDA kernel built from this checkout's sources, with ptxas's
   report (registers, shared memory, spills);
3. the kernel against its plain PyTorch twin at the hierarchical path's
   shapes, every query row (11M x 440k x 28 on the Higgs rows, the twin
   and ``torch.cdist`` + ``min`` timed once at that size; 200k x 8k x 28,
   the exact path's projection; 1M x 40k x 28; 70k x 3.5k x 784 on the
   bench's rows; a ragged 77 x 131 x 5), timed in turns with its
   yardstick and beside its bound;
4. the main path: ``embed(x, layer=1)`` on 11,000,000 x 28 Higgs-shaped
   rows (the reference's Higgs operating point: nbng 6, hierarchy
   fraction 0.04, scale 0.75, batch 40, grad_factor 5, hubness weighting;
   nprobe 24, bf16 panels, 4 NN-descent rounds at rho 0.5), both graphs
   through the IVF + NN-descent build, with a sampled quality estimate
   whose radius search goes through the certified grid (2,000 of its
   rows held bit-equal to the brute search on the card); then phases 13
   and 14 on its embedding and graph; then the same path on 200,000
   rows, whose graphs are exact;
   then the parts of the build against exact search: the IVF +
   NN-descent graph of 1,000,000 rows in f32 and in bf16, the grid
   quantizer on a 1,000,000 x 2 cloud, and the full-fraction quality
   estimate of a 3-D embedding of 300,000 rows (its radius through the
   IVF rebuild) against the same estimate with the exact search;
5. the bench workload (``annembed_tpu_torch.bench``: bench.py's one-step
   path at 70,000 x 784, blobs and manifold rows), held to recall and to
   the JAX package's conservation on the same workload;
6. ``dmap_embed`` at 70,000 x 784;
7. the CLI end to end (``embed --quality --stats --cluster`` and
   ``dmapembed``) on a 20,000 x 784 csv;
8. ``embed(distance=...)`` under the four non-L2 metrics on 20,000 x 784
   rows, each graph held against the CPU search on a row sample;
9. the sampling path: ``embed(optimizer="sampling", cluster=1000)`` on the
   bench's 70,000 x 784 blobs and manifold rows (the reference's negative-
   sampling SGD, ~8,000 steps of 10,000 edges, then quality and HDBSCAN*),
   held to the JAX package's conservation and cluster count on the same
   call, with the alias and MST backends native;
10. the estimators on the blobs rows: the ``--stats`` numbers of a 20-NN
   graph held to the JAX package's, the Carre du champ covariances of a
   few hundred points (symmetric, PSD) and ``psd_dist_pairs`` on 1,000
   pairs;
11. the Higgs harness (``python -m annembed_tpu_torch.examples.higgs``)
   on the same 11,000,000 x 28 rows at phase 4's operating point with the
   stale gather (``--gather-reuse 12``), its data, projection and
   embedding cached: recall, label purity, both steps at S = 12, and
   frac_without_match near phase 4's S = 1 reading; then the same command
   again, which must load both caches, launch no kernel and give the
   same quality fields; then once more from the caches at the harness's
   own quality defaults (nbng 100, compat 250, 200,000 queries), its
   radius through the grid, 2,000 rows held bit-equal to brute;
12. ``embed`` on the bench's 70,000 x 784 blobs rows with each dense knob
   (node blocks, the row-major scatter path, stacked kicks, the stale
   gather), each held to the JAX package's no_match of the same call; a
   ``trace_dir`` capture holding the card's kernels; the rows through
   gzip IDX files and back; ``extract_neighbourhood`` on the card against
   the CPU;
13. the full-fraction quality estimate of phase 4's 11M embedding at nbng
   50 (every row a query of the certified grid, only the radius column
   kept): 2,000 rows' radii bit-equal to brute, frac_without_match
   within +-0.005 of phase 4's sampled reading, its seconds and peak
   memory;
14. the functions that complete the ported modules: ``kgraph_stats``
   and ``proba_telemetry`` of phase 4's 11M graph against the same calls
   on its CPU copy; on the bench's 70,000 x 784 blobs rows the adaptive
   SVD of the diffusion operator (rank discovered, leading singular
   values against ``randomized_svd_op`` at that rank, sigma_1 against
   the power iteration) and ``get_dmap_embedding``.

Before each path the kernel launch counts are set to 0 and read after it.
The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_ROWS = 11_000_000
SEED = 7
KNN_K = 6
FRACTION = 0.04
# the hierarchical path's operating point (examples/higgs.py); the exact
# phase runs it with fewer batches on rows the brute build takes
HIGGS_EMBED = dict(dim=2, nbng=KNN_K, layer=1, hierarchy_fraction=FRACTION,
                   scale=0.75, seed=SEED, return_graph=True, device="cuda")
HIGGS_KNN = dict(knbn=KNN_K, nprobe=24, dtype="bfloat16", refine_rounds=4,
                 nndescent_rho=0.5)
MAIN_BATCHES, EXACT_BATCHES = 40, 10
EXACT_ROWS, SLICE_ROWS = 200_000, 1_000_000
QUALITY_FRACTION, QUALITY_NBNG = 0.005, 50
# recall@6 on 2,000 rows against exact search: the 11M graph at the Higgs
# knobs, the 1M graphs at the default knobs, the grid quantizer's graph
MIN_RECALL_IVF, MIN_RECALL_PARTS, MIN_RECALL_GRID = 0.90, 0.95, 0.97
PARTS_ROWS, GRID_K, QUALITY_ROWS, QUALITY_NO_MATCH_REL = (
    1_000_000, 10, 300_000, 0.05)
# The expansion (|q|^2 + |c|^2) - 2 q.c rounds at the scale of
# |q|^2 + |c|^2, not of d^2, so both tolerances are relative to that
# scale: indices must agree wherever the twin's best and second-best d^2
# are further apart than TIE_REL of it, and the squared distances must
# agree to D2_REL of it.  (A self-match has d^2 = 0 up to that noise, so
# its distance sqrt(noise) can differ by ~1e-2 between two summation
# orders; a tolerance on the distance itself cannot hold there.)
TIE_REL = 1e-5
D2_REL = 1e-5
MIN_RECALL = 0.99                # exact graphs
MIN_PURITY = 0.9
ROOT = Path(__file__).resolve().parent
# phase 3: the kernel's other shapes on the path (bench rows at the
# default hierarchy fraction); the H100 SXM data sheet's peaks for the
# bounds
BENCH_FRACTION = 0.05
H100_BYTES_PER_S, H100_TF32_FLOPS, H100_F32_FLOPS = 3.35e12, 495e12, 67e12

# phase 5: the JAX package (annembed_tpu) on the CPU backend, the same
# workload with the same exact f32 graph, the mean of seeds 0 / 1 / 2
# (blobs no_match 57,647 / 57,436 / 57,335; manifold mean_matched
# 5.17578 / 5.17503 / 5.17645; PERF.md section 6):
#   python -m tests.test_torch_bench_reference --n 70000 --seeds 0 1 2
# The margins are 2.5-3x the larger of the seeds' spread (+0.30% /
# -0.24%; +-0.0007) and the H100's over PRs 2-5 (57,183-57,717, -0.50% /
# +0.43%; 5.1574-5.1807, -0.018 / +0.005).  The sampling optimizer's
# 54,936-55,212 (-3.9% to -4.4%) and 4.828-4.863 on the same rows fail
# both.
JAX_NO_MATCH = 57_473
JAX_MANIFOLD_MEAN_MATCHED = 5.175751139402752
NO_MATCH_REL = 0.015
MANIFOLD_MATCHED_ABS = 0.05
BENCH_MIN_RECALL = 0.999
# phase 7: the CLI's csv; phase 8: the non-L2 graphs
CLI_ROWS = 20_000
METRIC_ROWS, METRIC_D, METRIC_SAMPLE = 20_000, 784, 200
METRIC_TIE_REL, METRIC_D_REL, METRIC_MIN_AGREE = 1e-5, 1e-4, 0.999
# phase 9: the JAX package on the CPU, embed(**bench.SAMPLING_EMBED) with
# the sampling optimizer, the mean of seeds 0 / 1 / 2 (blobs no_match
# 54,881 / 55,229 / 55,000; manifold mean_matched 4.8121 / 4.8610 /
# 4.8242; 10 clusters, no noise, in every run; PERF.md section 6):
#   python -m tests.test_torch_bench_reference --n 70000 \
#       --optimizer sampling --seeds 0 1 2
# The margins are 2.5-3x the larger of the seeds' spread (+-0.32%,
# +-0.025) and the H100's over four runs (54,936-55,212, at most +0.32%;
# 4.828-4.863, at most +0.031).  The dense optimizer's 57,451 (+4.4%)
# and 5.18 (+0.35) on the same rows fail both.
JAX_SAMPLING_NO_MATCH = 55_037
JAX_SAMPLING_MANIFOLD_MEAN_MATCHED = 4.832463128579099
JAX_SAMPLING_N_CLUSTERS = {"": 10, "manifold_": 10}
SAMPLING_NO_MATCH_REL, SAMPLING_MATCHED_ABS = 0.01, 0.08
SAMPLING_SEED, SAMPLING_BATCH, SAMPLING_STEPS_PER_BATCH = 0, 10_000, 420
# phase 10: the same command's --stats record of the blobs rows' 20-NN
# graph (Levina-Bickel mean and std, 2NN, hubness skew)
JAX_STATS_INTRINSIC_DIM = (18.427152633666992, 5.303670406341553)
JAX_STATS_INTRINSIC_DIM_2NN = 18.2176456451416
JAX_STATS_HUBNESS_SKEW = 2.449930191040039
STATS_REL = 1e-3
CDC_POINTS, CDC_PAIRS, CDC_SYM_REL, CDC_PSD_REL = 256, 1000, 1e-5, 1e-5
# phase 11: the Higgs harness at phase 4's operating point with the stale
# gather at S = 12, then again from its caches.  S = 12 costs
# conservation: its frac_without_match is held to phase 4's S = 1 reading
# plus HARNESS_FRAC_SHIFT, within HARNESS_FRAC_ABS.  On the H100 (PERF.md
# section 5) S = 12 read 0.97087 and 0.97238 against phase 4's 0.9474 and
# 0.9480 (+0.0235, +0.0244), and 0.9709 against 0.9462 / 0.9461 (+0.0247;
# tools/torch_gather_reuse_sweep.py): the shift is their mean, the margin
# 2.5x the spread of the S = 1 readings (0.9461-0.9480), so a stale path
# that reads fresh (+0) or wrong neighbours fails.
HARNESS_BASE = ["--synthetic", str(N_ROWS), "--batch", "40", "--n-sub", "60",
                "--schedule", "none", "--gather-reuse", "12", "--quality",
                "--json", "--out", "none", "--device", "cuda"]
HARNESS_ARGS = HARNESS_BASE + [
    "--quality-nbng", str(QUALITY_NBNG), "--quality-fraction",
    str(QUALITY_FRACTION), "--quality-radius-compat", "0"]
HARNESS_GATHER_REUSE = 12
HARNESS_FRAC_SHIFT, HARNESS_FRAC_ABS = 0.0242, 0.005
# phase 12: the JAX package on the CPU, embed(**bench.KNOB_EMBED) on the
# blobs rows with each of bench.DENSE_KNOBS, seed 0 (PERF.md section 6),
# held within phase 5's NO_MATCH_REL:
#   python -m tests.test_torch_bench_reference --n 70000 --optimizer knobs
JAX_KNOB_NO_MATCH = {"n_blocks": 63_099, "row_major": 60_031,
                     "parallel_kicks": 61_086, "gather_reuse": 63_661}
NEIGHBOURHOOD_K, NEIGHBOURHOOD_REL = 200, 1e-6
# phases 4, 11, 13: the quality radius through the certified grid; this
# many of the evaluated rows held bit-equal to knn_search_brute's columns
RADIUS_CHECK_ROWS = 2_000
# phase 13: the full fraction against phase 4's sampled reading of the
# same embedding: 5x the binomial sd of a 55,000-row sample at the
# readings' ~0.947 (0.00096), a fifth of the stale gather's +0.024
FULL_FRAC_ABS = 0.005
# phase 11's third run: the harness's quality defaults, its fraction
# min(1, 200,000 / n) and the embed's seed 0
HARNESS_TAIL_NBNG, HARNESS_TAIL_COMPAT = 100, 250
HARNESS_TAIL_FRACTION, HARNESS_SEED = min(1.0, 200_000 / N_ROWS), 0
# phase 14: the adaptive SVD of the bench blobs' diffusion operator at
# time ADAPTIVE_TIME (the Laplacian applied that many times): at time 1
# the one-pass adaptive finder cannot resolve the kernel's slow bulk
# (10,000 blobs rows on the CPU: rank runs to 128, leading values 36-40%
# low); at time 32 it found rank 16 and its 10 cluster modes within
# 2.3e-5 of randomized_svd_op (PERF.md section 6)
ADAPTIVE_TIME, ADAPTIVE_LEAD, ADAPTIVE_REL = 32, 10, 1e-3
STATS_CPU_REL = 1e-6


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


def cuda_once_ms(fn) -> float:
    """Milliseconds of one call of ``fn``, CUDA events, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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


def check_kernel(name, q, c, reps, once=False):
    """Kernel against twin on the same CUDA tensors, every query row, then
    timed in turns with its yardstick (library, kernel, kernel, library)
    and the twin.  Rows whose index differs from the twin's are looked up
    in the twin's two best d^2: a near-tie may go either way.  With
    ``once`` (the full-size projection) the twin's checking call is its
    one timed run and the library is timed once too, without a warm-up."""
    from annembed_tpu_torch.knn.distances import corpus_sqnorm
    from annembed_tpu_torch.ops.top1 import top1_l2, top1_l2_reference
    nq, d = q.shape
    m = c.shape[0]
    ki, kd = top1_l2(q, c)
    torch.cuda.synchronize()
    twin = {}
    twin_ms = cuda_once_ms(lambda: twin.update(out=top1_l2_reference(q, c)))
    ri, rd = twin.pop("out")
    scale = torch.square(q).sum(1) + corpus_sqnorm(c)[ri.long()]
    differ = torch.nonzero(ki != ri).squeeze(1)
    bad_idx = 0
    if differ.numel():
        top2, top2_scale = twin_top2(q[differ].contiguous(), c)
        bad_idx = int(((top2[:, 1] - top2[:, 0]) > TIE_REL * top2_scale).sum())
    near_ties = int(differ.numel()) - bad_idx
    d2_err = (kd.square() - rd.square()).abs()
    bad_d2 = int((d2_err > D2_REL * scale).sum())
    max_err = float((kd - rd).abs().max())
    max_rel = float((d2_err / scale).max())
    del ki, kd, ri, rd, scale, d2_err, differ
    kernel = lambda: top1_l2(q, c)  # noqa: E731
    if once:
        ms = cuda_ms(kernel, reps)
        library_ms = cuda_once_ms(lambda: library_top1(q, c))
        turns = "library and twin timed once each, no warm-up"
    else:
        lib_a = cuda_ms(lambda: library_top1(q, c), reps)
        ms_a = cuda_ms(kernel, reps)
        ms_b = cuda_ms(kernel, reps)
        lib_b = cuda_ms(lambda: library_top1(q, c), reps)
        ms, library_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
        turns = (f"turns lib {lib_a:.4f} kernel {ms_a:.4f} {ms_b:.4f} "
                 f"lib {lib_b:.4f}")
        twin_ms = cuda_ms(lambda: top1_l2_reference(q, c), reps)
    b = top1_bounds(nq, m, d)
    out = dict(shape=name, nq=nq, m=m, d=d, ms=ms, bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], bound_f32_ms=b["bound_f32_ms"],
               share_of_bound=b["bound_ms"] / ms, library_ms=library_ms,
               twin_ms=twin_ms, checked_rows=nq,
               idx_mismatch_outside_ties=bad_idx,
               idx_mismatch_in_near_ties=near_ties, d2_out_of_tol=bad_d2,
               max_rel_d2_err=max_rel, max_abs_err=max_err)
    log(f"kernel {name}: nq={nq} m={m} d={d} checked_rows={nq} "
        f"idx_mismatch_outside_ties={bad_idx} "
        f"idx_mismatch_in_near_ties={near_ties} "
        f"d2_out_of_tol={bad_d2} max_rel_d2_err={max_rel:.3e} "
        f"max_abs_dist_err={max_err:.3e} ms={ms:.4f} "
        f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}; f32 CUDA cores "
        f"{b['bound_f32_ms']:.4f}) share={b['bound_ms'] / ms:.4f} "
        f"library_ms={library_ms} twin_ms={twin_ms} {turns}")
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
    from annembed_tpu_torch.bench import MIN_CLUSTER_SIZE
    from annembed_tpu_torch.io.synthetic import synthetic_clustered_manifold
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src = d / "manifold.csv"
        np.savetxt(src, synthetic_clustered_manifold(CLI_ROWS, 784), fmt="%d",
                   delimiter=",", header="synthetic clustered manifold")
        out, wall = _run_cli(["embed", "--csv", str(src), "--nbng", "6",
                              "--quality", "--stats", "--cluster",
                              str(MIN_CLUSTER_SIZE), "--outfile",
                              str(d / "embedded.csv"), "--device", "cuda"])
        log(f"cli embed: wall={wall:.2f} s {json.dumps(out)}")
        keys = {"quality", "cluster", "intrinsic_dim", "intrinsic_dim_2nn",
                "hubness_skew", "hubness_hist"}
        if not keys <= set(out) or out["n"] != CLI_ROWS:
            raise AssertionError(f"cli embed printed {sorted(out)}")
        for name in ("embedded.csv", "first_dist.csv",
                     "continuity_ratio.csv", "clusters.csv"):
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


def phase_sampling(at):
    """Phase 9: ``embed(**bench.SAMPLING_EMBED)`` with the sampling
    optimizer on the bench's two 70,000 x 784 rows.  Returns the blobs
    rows on the card for phase 10."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io.synthetic import (synthetic_blobs,
                                                 synthetic_clustered_manifold)
    from annembed_tpu_torch.ops.top1 import top1_l2
    from annembed_tpu_torch.utils.native import BACKENDS
    rows = {"": synthetic_blobs(bench.N, bench.D, 42),
            "manifold_": synthetic_clustered_manifold(bench.N, bench.D)}
    for prefix, x in rows.items():
        tag = f"sampling {prefix or 'blobs_'}row"
        BACKENDS.clear()
        top1_l2.launches = 0
        t0 = time.perf_counter()
        y, info = at.embed(
            x, params=at.EmbedderParams(optimizer="sampling"),
            seed=SAMPLING_SEED, device="cuda",
            **bench.SAMPLING_EMBED)
        wall = time.perf_counter() - t0
        rec = bench.sampling_record(info, prefix)
        steps = info["steps_per_batch"] * (bench.SAMPLING_EMBED["batch"] - 1)
        c = info["cluster"]
        log(f"{tag}: n={bench.N} wall={wall:.2f} s "
            f"graph_build={info['graph_build_time']:.3f} s "
            f"init={info['init_time']:.3f} s "
            f"optimize={info['optimize_time']:.3f} s ({steps} steps of "
            f"{info['batch_size']} edges, {info['steps_per_batch']} a batch, "
            f"{steps / info['optimize_time']:.1f} steps/s) "
            f"total={info['total_time']:.3f} s; ce {info['initial_ce']:.6g} "
            f"-> {info['final_ce']:.6g}; hdbscan stages (s) "
            f"{json.dumps(c['timings'])}; top1_l2 launches="
            f"{top1_l2.launches}")
        log(f"{tag}: {json.dumps(rec)}; quality {json.dumps(info['quality'])}")
        log(f"{tag}: host backends {json.dumps(BACKENDS)}")
        if BACKENDS != dict.fromkeys(("alias", "mst", "linkage", "condense"),
                                     "native"):
            raise AssertionError(f"{tag}: a native backend did not run")
        if y.shape != (bench.N, 2) or not np.isfinite(y).all():
            raise AssertionError(f"{tag}: embedding {y.shape} or non-finite")
        if (info["batch_size"], info["steps_per_batch"]) != (
                SAMPLING_BATCH, SAMPLING_STEPS_PER_BATCH):
            raise AssertionError(f"{tag}: batch {info['batch_size']} x "
                                 f"{info['steps_per_batch']} steps a batch")
        want = JAX_SAMPLING_N_CLUSTERS[prefix]
        if c["n_clusters"] != want:
            raise AssertionError(f"{tag}: {c['n_clusters']} clusters, JAX "
                                 f"{want}")
        if prefix:
            diff = abs(rec["manifold_mean_matched"]
                       - JAX_SAMPLING_MANIFOLD_MEAN_MATCHED)
            log(f"{tag}: mean_matched {rec['manifold_mean_matched']:.4f} vs "
                f"JAX {JAX_SAMPLING_MANIFOLD_MEAN_MATCHED:.4f} ({diff:.4f}); "
                f"{c['n_clusters']} clusters as JAX")
            if diff > SAMPLING_MATCHED_ABS:
                raise AssertionError(f"{tag}: mean_matched off by {diff:.4f} "
                                     f"> {SAMPLING_MATCHED_ABS}")
        else:
            rel = abs(rec["no_match"] - JAX_SAMPLING_NO_MATCH) \
                / JAX_SAMPLING_NO_MATCH
            log(f"{tag}: no_match {rec['no_match']} vs JAX "
                f"{JAX_SAMPLING_NO_MATCH} ({rel:.4f} relative); "
                f"{c['n_clusters']} clusters as JAX")
            if rel > SAMPLING_NO_MATCH_REL:
                raise AssertionError(f"{tag}: no_match off by {rel:.4f} > "
                                     f"{SAMPLING_NO_MATCH_REL}")
    return torch.from_numpy(rows[""]).to("cuda", torch.float32)


def phase_estimators(at, x):
    """Phase 10: the ``--stats`` numbers of the blobs rows' 20-NN graph
    against the JAX package's, and the Carre du champ operator."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.estimators.cdc import (CarreDuChamp, CdcMat,
                                                   psd_dist_upper_bound)
    t0 = time.perf_counter()
    g = at.build_kgraph(x, bench.STATS_NBNG,
                        params=at.KnnParams(knbn=bench.KNBN))
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    hub = at.Hubness.new(g)
    got = {"intrinsic_dim": list(at.intrinsic_dim_levina_bickel(g)),
           "intrinsic_dim_2nn": at.intrinsic_dim_2nn(g),
           "hubness_skew": hub.get_standard3m(),
           "hubness_hist": hub.get_hubness_histogram()}
    t_stats = time.perf_counter() - t0
    want = {"intrinsic_dim_mean": JAX_STATS_INTRINSIC_DIM[0],
            "intrinsic_dim_std": JAX_STATS_INTRINSIC_DIM[1],
            "intrinsic_dim_2nn": JAX_STATS_INTRINSIC_DIM_2NN,
            "hubness_skew": JAX_STATS_HUBNESS_SKEW}
    have = {"intrinsic_dim_mean": got["intrinsic_dim"][0],
            "intrinsic_dim_std": got["intrinsic_dim"][1],
            "intrinsic_dim_2nn": got["intrinsic_dim_2nn"],
            "hubness_skew": got["hubness_skew"]}
    rel = {k: abs(have[k] - want[k]) / abs(want[k]) for k in want}
    log(f"stats: {x.shape[0]} x {x.shape[1]}, {bench.STATS_NBNG}-NN graph "
        f"{t_graph:.3f} s, estimators {t_stats:.3f} s: {json.dumps(got)}; "
        f"relative to JAX {json.dumps(rel)}")
    bad = {k: v for k, v in rel.items() if not v <= STATS_REL}
    if bad:
        raise AssertionError(f"stats off the JAX record by more than "
                             f"{STATS_REL}: {bad}")
    del g
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    cdc = CarreDuChamp(x)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    pts = torch.randperm(x.shape[0], generator=gen)[:CDC_POINTS]
    t0 = time.perf_counter()
    means, covs = cdc.get_cdc_batch(pts)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    a = torch.randint(0, x.shape[0], (CDC_PAIRS,), generator=gen)
    b = torch.randint(0, x.shape[0], (CDC_PAIRS,), generator=gen)
    t0 = time.perf_counter()
    dist = cdc.psd_dist_pairs(a, b)
    torch.cuda.synchronize()
    t_pairs = time.perf_counter() - t0
    scale = covs.abs().amax(dim=(1, 2))
    asym = float(((covs - covs.transpose(1, 2)).abs().amax(dim=(1, 2))
                  / scale).max())
    eig = torch.linalg.eigvalsh(covs.double())
    neg = float((-eig[:, 0] / eig[:, -1]).max())
    # the pairwise form against the bound between materialized matrices
    _, ca = cdc.get_cdc_batch(a[:8])
    _, cb = cdc.get_cdc_batch(b[:8])
    direct = torch.tensor([psd_dist_upper_bound(CdcMat(ca[i]), CdcMat(cb[i]))
                           for i in range(8)])
    pair_err = float(((dist[:8].cpu() - direct).abs()
                      / direct.clamp_min(1e-6)).max())
    log(f"cdc: {x.shape[0]} x {x.shape[1]}, kernel rows of at most "
        f"{cdc._max_row}: operator {t_build:.3f} s, get_cdc_batch of "
        f"{CDC_POINTS} points {t_batch:.3f} s, psd_dist_pairs of {CDC_PAIRS} "
        f"pairs {t_pairs:.3f} s; max asymmetry {asym:.3e}, most negative "
        f"eigenvalue / largest {neg:.3e}, pairwise vs materialized bound "
        f"{pair_err:.3e}; trace q0.5 "
        f"{float(covs.diagonal(dim1=1, dim2=2).sum(1).median()):.6g}, "
        f"distance q0.5 {float(dist.median()):.6g}")
    finite = all(bool(torch.isfinite(t).all()) for t in (means, covs, dist))
    if not finite or asym > CDC_SYM_REL or neg > CDC_PSD_REL \
            or pair_err > 1e-3:
        raise AssertionError("cdc: non-finite, asymmetric or not PSD, or "
                             "the pairwise distance disagrees")


def _hierarchical(at, x, labels, batches, knn, min_recall, tag, **extra):
    """``embed(x, layer=1)`` at the Higgs operating point on the rows of
    CUDA tensor ``x``, launch counts from zero, held to a finite (n, 2)
    output, one kernel launch at least, graph recall and label purity."""
    from annembed_tpu_torch.io.synthetic import label_purity
    from annembed_tpu_torch.knn.api import sampled_exact_recall
    from annembed_tpu_torch.ops.top1 import top1_l2
    n = x.shape[0]
    x_host = x.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    top1_l2.launches = 0
    t0 = time.perf_counter()
    y, info = at.embed(
        x_host, batch=batches, knn_params=at.KnnParams(**knn),
        params=at.EmbedderParams(grad_factor=5, hubness_weighting=True),
        **HIGGS_EMBED, **extra)
    wall = time.perf_counter() - t0
    launches = top1_l2.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    first = info["first_step"]
    # what is left of the total: edge probabilities, the jittered
    # initialization, the quality estimate and the readback
    rest = info["total_time"] - (info["graph_build_time"] + first["init_time"]
                                 + first["optimize_time"]
                                 + info["optimize_time"])
    log(f"{tag}: n={n} wall={wall:.2f} s "
        f"graph_build={info['graph_build_time']:.2f} s "
        f"first_init={first['init_time']:.2f} s "
        f"first_optimize={first['optimize_time']:.2f} s "
        f"large_optimize={info['optimize_time']:.2f} s rest={rest:.2f} s "
        f"total={info['total_time']:.2f} s peak_mem={peak:.2f} GiB")
    log(f"{tag}: graph build phases (s) "
        f"{json.dumps(info['graph_build_phases'])}")
    log(f"{tag}: first step ce {first['initial_ce']:.6g} -> "
        f"{first['final_ce']:.6g} ({first['sweeps']} sweeps); large step ce "
        f"{info['initial_ce']:.6g} -> {info['final_ce']:.6g} "
        f"({info['sweeps']} sweeps); top1_l2 launches={launches}")
    log(f"{tag}: projection distance quantiles "
        f"{json.dumps(info['projection_distance_quantiles'])}")
    if "quality" in info:
        log(f"{tag}: quality (fraction {QUALITY_FRACTION}, nbng "
            f"{QUALITY_NBNG}, not held) {json.dumps(info['quality'])}")
    recall = sampled_exact_recall(x, info["kgraph"], sample=2000)
    purity = label_purity(torch.from_numpy(y).to(x.device), labels, k=KNN_K)
    # the CE values are reported, not held to a direction: at this
    # operating point the JAX package itself ends the large step above
    # its initial CE on Higgs-shaped data (20k and 30k rows, CPU), and the
    # first step too at 20k, so the output is held to the graph's recall
    # and the embedding's cluster purity instead
    log(f"{tag}: recall@{KNN_K}={recall:.4f} "
        f"embedded {KNN_K}-NN label purity={purity:.4f}")
    if y.shape != (n, 2) or not np.isfinite(y).all():
        raise AssertionError(f"{tag}: embedding {y.shape} or non-finite")
    if launches < 1:
        raise AssertionError(f"{tag} never launched top1_l2")
    if recall < min_recall:
        raise AssertionError(f"{tag}: recall@{KNN_K} {recall} < {min_recall}")
    if purity < MIN_PURITY:
        raise AssertionError(f"{tag}: label purity {purity} < {MIN_PURITY}")
    return launches, info, y


def rows_bit_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape and the same f32 bits in every entry."""
    return got.shape == want.shape and bool(torch.equal(got, want))


def frac_within_band(full: float, sampled: float) -> bool:
    """Phase 13: the full fraction's frac_without_match against phase 4's
    sampled reading of the same embedding."""
    return abs(full - sampled) <= FULL_FRAC_ABS


def singular_values_agree(s, ref) -> float:
    """Largest relative difference of the leading ADAPTIVE_LEAD values."""
    s, ref = s[:ADAPTIVE_LEAD], ref[:ADAPTIVE_LEAD]
    return float(((s - ref).abs() / ref.abs().clamp_min(1e-30)).max())


def _spread(ids: torch.Tensor) -> torch.Tensor:
    """RADIUS_CHECK_ROWS positions spread evenly over ``ids``."""
    return torch.linspace(0, ids.shape[0] - 1, RADIUS_CHECK_ROWS,
                          device=ids.device).round().to(torch.int64)


def _radius_vs_brute(tag, y, rows, radius, k, cols):
    """The radius columns ``radius`` (r, len(cols)) of the evaluated rows
    ``rows`` against ``knn_search_brute``'s on the card, bit for bit.
    Returns the brute search's seconds."""
    from annembed_tpu_torch.knn.brute import knn_search_brute
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sd = knn_search_brute(y[rows], y, k=k)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    want = sd[:, list(cols)]
    equal = rows_bit_equal(radius, want)
    n_diff = int((radius != want).any(1).sum()) if radius.shape == \
        want.shape else rows.shape[0]
    log(f"{tag}: radius columns {list(cols)} of {rows.shape[0]} rows vs "
        f"knn_search_brute (k={k}, {brute_s:.3f} s, "
        f"{1e3 * brute_s / rows.shape[0]:.3f} ms a row): "
        f"{'bit-equal' if equal else f'{n_diff} rows differ'}")
    if not equal:
        raise AssertionError(f"{tag}: grid radius differs from brute on "
                             f"{n_diff} rows")
    return brute_s


def _log_search(tag, rec):
    per_row = 1e3 * rec["seconds"] / max(rec["queries"], 1)
    log(f"{tag}: radius search {json.dumps(rec)} ({per_row:.4f} ms a row)")
    if rec["route"] != "grid":
        raise AssertionError(f"{tag}: radius search took the "
                             f"{rec['route']} route, not the grid")


def phase_main_quality(at, y, graph, main_quality, search):
    """Phase 4's sampled quality estimate (``search``: its radius search
    record from the main path's run) again on the same embedding and
    graph: the same summary, and 2,000 of its rows' radii bit-equal to
    the brute search."""
    _log_search("main path quality", search)
    est = at.quality_estimate(graph, y, nbng=QUALITY_NBNG,
                              sample_fraction=QUALITY_FRACTION, seed=SEED)
    again = est.summary()
    rel = {k: abs(again[k] - v) / max(abs(v), 1e-30)
           for k, v in main_quality.items()}
    log(f"main path quality: the estimate again, largest relative "
        f"difference {max(rel.values()):.3e}")
    if again.keys() != main_quality.keys() or max(rel.values()) > 1e-6 or \
            again["nb_without_match"] != main_quality["nb_without_match"]:
        raise AssertionError("the quality estimate differs from the main "
                             "path's")
    ids = torch.from_numpy(est.sample_ids).to(y.device, torch.int64)
    pick = _spread(ids)
    _radius_vs_brute("main path quality", y, ids[pick],
                     est.radius[pick, None], QUALITY_NBNG + 1,
                     (QUALITY_NBNG,))


def phase_full_quality(at, y, graph, frac_sampled):
    """Phase 13: the full-fraction quality estimate of phase 4's 11M
    embedding at nbng 50, through the certified grid."""
    from annembed_tpu_torch.ops.top1 import top1_l2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    top1_l2.launches = 0
    t0 = time.perf_counter()
    est = at.quality_estimate(graph, y, nbng=QUALITY_NBNG,
                              radius_k=QUALITY_NBNG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    frac = est.frac_without_match
    log(f"full quality: n={N_ROWS} nbng={QUALITY_NBNG} wall={wall:.2f} s "
        f"peak_mem={peak:.2f} GiB top1_l2 launches={top1_l2.launches}; "
        f"{json.dumps(est.summary())}")
    _log_search("full quality", est.radius_search)
    log(f"full quality: frac_without_match {frac} vs phase 4's sampled "
        f"{frac_sampled} ({frac - frac_sampled:+.5f}, band "
        f"+-{FULL_FRAC_ABS})")
    if est.nb_sampled != N_ROWS or not bool(torch.isfinite(est.radius)
                                            .all()):
        raise AssertionError("full quality: not every row evaluated, or "
                             "a radius non-finite")
    ids = torch.arange(N_ROWS, device=y.device)
    pick = _spread(ids)
    brute_s = _radius_vs_brute("full quality", y, ids[pick],
                               est.radius[pick, None], QUALITY_NBNG + 1,
                               (QUALITY_NBNG,))
    search = est.radius_search
    fallback_s = search["n_fallback"] * brute_s / RADIUS_CHECK_ROWS
    log(f"full quality: the {search['n_fallback']} fallback rows at the "
        f"brute rate above take ~{fallback_s:.1f} s of the search's "
        f"{search['seconds']:.1f} s")
    if not frac_within_band(frac, frac_sampled):
        raise AssertionError(f"full quality: frac_without_match {frac} not "
                             f"within {FULL_FRAC_ABS} of the sampled "
                             f"{frac_sampled}")


def phase_a3_rest(at, graph):
    """Phase 14: the statistics of phase 4's 11M graph on the card
    against its CPU copy; the adaptive SVD, the power iteration and the
    legacy initialization on the bench's blobs rows."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.graph.kgraph import KGraph, kgraph_stats
    from annembed_tpu_torch.graph.proba import (NodeParams, proba_telemetry,
                                                to_proba_edges)
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.linalg.rsvd import (
        estimate_first_singular_value, randomized_svd_adaptive,
        randomized_svd_op)
    from annembed_tpu_torch.spectral.diffmaps import get_dmap_embedding
    nodes = to_proba_edges(graph, scale_rho=0.75)
    stats = {}
    for dev in ("cuda", "cpu"):
        g = KGraph(indices=graph.indices.to(dev), dists=graph.dists.to(dev))
        p = NodeParams(scale=nodes.scale.to(dev), probas=nodes.probas.to(dev))
        t0 = time.perf_counter()
        stats[dev] = {**kgraph_stats(g), **proba_telemetry(p)}
        log(f"graph stats ({dev}): {graph.indices.shape[0]} x "
            f"{graph.indices.shape[1]} in {time.perf_counter() - t0:.2f} s "
            f"{json.dumps(stats[dev])}")
        del g, p
    rel = {k: abs(v - stats["cpu"][k]) / max(abs(stats["cpu"][k]), 1e-30)
           for k, v in stats["cuda"].items()}
    worst = max(rel, key=rel.get)
    log(f"graph stats: card vs CPU, largest relative difference "
        f"{rel[worst]:.3e} ({worst})")
    if stats["cuda"].keys() != stats["cpu"].keys() or \
            rel[worst] > STATS_CPU_REL:
        raise AssertionError(f"graph stats on the card differ from the CPU "
                             f"copy's: {worst} {rel[worst]:.3e}")
    del nodes

    x = torch.from_numpy(synthetic_blobs(bench.N, bench.D, 42)
                         .astype(np.float32)).to("cuda")
    g = at.build_kgraph(x, bench.KNBN)
    lap = at.DiffusionMaps(at.DiffusionParams()).laplacian_from_kgraph(g)
    lap_mm = lap.matmat()

    def diffusion(v):
        for _ in range(ADAPTIVE_TIME):
            v = lap_mm(v)
        return v

    n = bench.N
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ad = randomized_svd_adaptive(diffusion, diffusion, (n, n))
    torch.cuda.synchronize()
    t_ad = time.perf_counter() - t0
    rank = int((ad.s > 0).sum())
    t0 = time.perf_counter()
    fixed = randomized_svd_op(diffusion, diffusion, (n, n), rank=rank)
    s1 = float(estimate_first_singular_value(diffusion, diffusion, n))
    torch.cuda.synchronize()
    t_fixed = time.perf_counter() - t0
    worst = singular_values_agree(ad.s, fixed.s)
    s1_rel = abs(s1 - float(fixed.s[0])) / float(fixed.s[0])
    log(f"adaptive svd: {n} x {n} diffusion operator at time "
        f"{ADAPTIVE_TIME}, rank {rank} discovered in {t_ad:.2f} s; leading "
        f"{ADAPTIVE_LEAD} values {ad.s[:ADAPTIVE_LEAD].tolist()} vs "
        f"randomized_svd_op at rank {rank} {fixed.s[:ADAPTIVE_LEAD].tolist()}"
        f": largest relative difference {worst:.3e}; power iteration sigma_1 "
        f"{s1} ({s1_rel:.3e}); fixed rank and power iteration {t_fixed:.2f} s")
    if worst > ADAPTIVE_REL or s1_rel > ADAPTIVE_REL:
        raise AssertionError(f"adaptive svd: {worst:.3e} or sigma_1 "
                             f"{s1_rel:.3e} > {ADAPTIVE_REL}")
    t0 = time.perf_counter()
    y = get_dmap_embedding(g, to_proba_edges(g).probas, 2)
    torch.cuda.synchronize()
    log(f"get_dmap_embedding: {tuple(y.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    if y.shape != (n, 2) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"get_dmap_embedding: {tuple(y.shape)} or "
                             "non-finite")


def phase_parts(at, x):
    """The parts of the IVF build against exact search on the card."""
    from annembed_tpu_torch.graph.kgraph import KGraph
    from annembed_tpu_torch.knn.api import build_kgraph, sampled_exact_recall
    from annembed_tpu_torch.knn.ivf import knn_graph_ivf
    from annembed_tpu_torch.utils.profiling import PhaseTimer
    dev = x.device
    xp = x[:PARTS_ROWS].contiguous()
    for dtype in ("float32", "bfloat16"):
        timer = PhaseTimer()
        t0 = time.perf_counter()
        g = build_kgraph(xp, KNN_K, params=at.KnnParams(knbn=KNN_K,
                                                        dtype=dtype),
                         timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recall = sampled_exact_recall(xp, g, sample=2000)
        log(f"parts: IVF + NN-descent graph, {PARTS_ROWS} x {x.shape[1]}, "
            f"{dtype}, default knobs: {wall:.2f} s "
            f"{json.dumps(timer.timings)} recall@{KNN_K}={recall:.4f}")
        if recall < MIN_RECALL_PARTS:
            raise AssertionError(f"IVF {dtype} recall {recall} < "
                                 f"{MIN_RECALL_PARTS}")
    del xp
    # the grid quantizer on a clustered 2-D cloud
    rng = np.random.default_rng(SEED)
    centers = rng.normal(0, 5, (8, 2))
    cloud = torch.from_numpy(
        (centers[rng.integers(0, 8, PARTS_ROWS)]
         + rng.normal(0, 0.8, (PARTS_ROWS, 2))).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    gi, gd = knn_graph_ivf(cloud, GRID_K, quantizer="grid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recall = sampled_exact_recall(cloud, KGraph(indices=gi, dists=gd),
                                  sample=2000)
    log(f"parts: grid quantizer, {PARTS_ROWS} x 2, k={GRID_K}: {wall:.2f} s "
        f"recall@{GRID_K}={recall:.4f}")
    if recall < MIN_RECALL_GRID or not torch.isfinite(gd).all():
        raise AssertionError(f"grid recall {recall} < {MIN_RECALL_GRID} or "
                             "non-finite distances")
    del cloud, gi, gd
    # the full-fraction quality estimate of a 3-D embedding above the
    # limit: its radius through the IVF rebuild, against the exact search
    y3, info = at.embed(x[:QUALITY_ROWS].cpu().numpy(), dim=3, nbng=KNN_K,
                        batch=5, seed=SEED, return_graph=True, device="cuda")
    y3 = torch.from_numpy(y3).to(dev)
    out = {}
    for name, limit in (("ivf", at.KnnParams().brute_force_limit),
                        ("exact", QUALITY_ROWS)):
        t0 = time.perf_counter()
        q = at.quality_estimate(
            info["kgraph"], y3, nbng=QUALITY_NBNG,
            knn_params=at.KnnParams(knbn=KNN_K, brute_force_limit=limit))
        torch.cuda.synchronize()
        out[name] = (q.nb_without_match, q.mean_nb_matched,
                     time.perf_counter() - t0)
    rel = abs(out["ivf"][0] - out["exact"][0]) / max(out["exact"][0], 1)
    log(f"parts: quality at full fraction, {QUALITY_ROWS} x 3, nbng "
        f"{QUALITY_NBNG}: IVF radius no_match {out['ivf'][0]} mean_matched "
        f"{out['ivf'][1]:.4f} in {out['ivf'][2]:.2f} s; exact radius no_match "
        f"{out['exact'][0]} mean_matched {out['exact'][1]:.4f} in "
        f"{out['exact'][2]:.2f} s; relative difference {rel:.4f}")
    if rel > QUALITY_NO_MATCH_REL:
        raise AssertionError(f"quality no_match through the IVF radius "
                             f"differs by {rel:.4f} > {QUALITY_NO_MATCH_REL}")


def _run_harness(args):
    """``python -m annembed_tpu_torch.examples.higgs`` with ``args``:
    (its result record, its ``port:`` record, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "annembed_tpu_torch.examples.higgs", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"harness exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    port = next(json.loads(line[len("port: "):]) for line in
                proc.stderr.splitlines() if line.startswith("port: "))
    return json.loads(proc.stdout.strip().splitlines()[-1]), port, wall


def _resumed(port, rec) -> bool:
    """Both caches loaded; no build, no optimize, no kernel."""
    return (set(port["checkpoints"]) == {"graph_load_s", "embedding_load_s"}
            and "first_step" not in rec and "optimize_time" not in rec
            and port["top1_l2_launches"] == 0)


def phase_harness_tail(y, rec, port):
    """Phase 11's third run: the quality tail alone at the harness's
    defaults, its radius search through the grid; 2,000 of its rows
    searched again by the grid and by brute on the loaded embedding."""
    from annembed_tpu_torch.estimators.quality import quality_sample_ids
    from annembed_tpu_torch.knn.radius import grid_radius_search
    search = port["quality_radius"]
    _log_search("harness tail", search)
    log(f"harness tail: wall {rec['wall_s']} s (PR 6: ~81 s of quality); "
        f"quality {json.dumps(rec['quality'])}")
    if not _resumed(port, rec):
        raise AssertionError("the harness tail did not resume from both "
                             "caches")
    ids = torch.from_numpy(quality_sample_ids(
        N_ROWS, HARNESS_TAIL_FRACTION, HARNESS_SEED)).to("cuda", torch.int64)
    if search["queries"] != ids.shape[0]:
        raise AssertionError(f"harness tail: {search['queries']} queries, "
                             f"not the {ids.shape[0]} of its sample")
    rows = ids[_spread(ids)]
    cols = (HARNESS_TAIL_NBNG, HARNESS_TAIL_COMPAT)
    sd, _ = grid_radius_search(y, rows, search["k"], keep_cols=cols)
    _radius_vs_brute("harness tail", y, rows, sd, search["k"], cols)


def phase_harness(labels, frac_s1):
    """Phase 11: the Higgs harness at full size with the stale gather,
    its caches written, then the same command again, which must load the
    projection and the embedding and run only the quality tail, then the
    tail at the harness's own quality defaults.  Returns the first run's
    top-1 launches."""
    from annembed_tpu_torch.io.checkpoint import load_embedding
    from annembed_tpu_torch.io.synthetic import label_purity
    with tempfile.TemporaryDirectory() as tmp:
        # the harness saves its projection right after the build, as
        # the JAX harness does (graph_cache_eager)
        caches = ["--data-cache", f"{tmp}/x.npy", "--graph-cache",
                  f"{tmp}/proj.npz", "--embed-cache", f"{tmp}/emb.npz"]
        runs = []
        for tag, args in (("harness", HARNESS_ARGS),
                          ("harness resumed", HARNESS_ARGS),
                          ("harness tail", HARNESS_BASE)):
            rec, port, wall = _run_harness(args + caches)
            runs.append((rec, port))
            log(f"{tag}: process {wall:.2f} s; port {json.dumps(port)}")
            log(f"{tag}: {json.dumps(rec)}")
        y = torch.from_numpy(load_embedding(f"{tmp}/emb.npz")).to("cuda")
    (rec, port), (again, port2), (tail, port3) = runs
    phase_harness_tail(y, tail, port3)
    first = rec["first_step"]
    frac = rec["quality"]["frac_without_match"]
    purity = label_purity(y, labels, k=KNN_K)
    log(f"harness: S={rec['gather_reuse']} large step "
        f"{1e3 * rec['optimize_time'] / rec['sweeps']:.3f} ms a sweep "
        f"({rec['sweeps']} sweeps), first step "
        f"{1e3 * first['optimize_time'] / first['sweeps']:.3f} ms "
        f"({first['sweeps']}); frac_without_match {frac} vs phase 4's "
        f"{frac_s1} at S=1; recall@{KNN_K} {rec[f'recall@{KNN_K}']}; "
        f"embedded {KNN_K}-NN label purity {purity:.4f}; resumed in "
        f"{again['wall_s']} s, launches {port2['top1_l2_launches']}")
    if y.shape != (N_ROWS, 2) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"harness embedding {tuple(y.shape)} or "
                             "non-finite")
    if port["top1_l2_launches"] < 1:
        raise AssertionError("the harness never launched top1_l2")
    if (rec["gather_reuse"], first["gather_reuse"]) != (
            HARNESS_GATHER_REUSE,) * 2:
        raise AssertionError("the harness's steps did not report "
                             f"gather_reuse {HARNESS_GATHER_REUSE}")
    if rec[f"recall@{KNN_K}"] < MIN_RECALL_IVF or purity < MIN_PURITY:
        raise AssertionError("harness recall or purity below its limit")
    if not _resumed(port2, again):
        raise AssertionError("the rerun did not resume from both caches")
    if again["quality"] != rec["quality"]:
        raise AssertionError("the resumed quality differs from the first "
                             "run's")
    if abs(frac - frac_s1 - HARNESS_FRAC_SHIFT) > HARNESS_FRAC_ABS:
        raise AssertionError(
            f"harness frac_without_match {frac} is not S=1's {frac_s1} + "
            f"{HARNESS_FRAC_SHIFT} +- {HARNESS_FRAC_ABS}")
    return port["top1_l2_launches"]


def phase_knobs_io(at):
    """Phase 12: ``embed(**bench.KNOB_EMBED)`` on the bench's blobs rows
    with each dense knob, held to the JAX package's no_match; a
    ``trace_dir`` capture; the rows through gzip IDX files and back; a
    neighbourhood's BSON from the card against the CPU's."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io import mnist_io, ripser
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.ops.top1 import top1_l2
    x = synthetic_blobs(bench.N, bench.D, 42).astype(np.float32)
    off = {}
    for knob, kw in bench.DENSE_KNOBS.items():
        top1_l2.launches = 0
        t0 = time.perf_counter()
        y, info = at.embed(x, params=at.EmbedderParams(**kw), device="cuda",
                           **bench.KNOB_EMBED)
        wall = time.perf_counter() - t0
        no_match = int(info["quality"]["nb_without_match"])
        want = JAX_KNOB_NO_MATCH[knob]
        rel = abs(no_match - want) / want
        log(f"knob {knob} {json.dumps(kw)}: wall {wall:.2f} s, optimize "
            f"{info['optimize_time']:.3f} s ({info['sweeps']} sweeps); "
            f"no_match {no_match} vs JAX {want} ({rel:.4f} relative); "
            f"mean_matched {info['quality']['mean_nb_matched']:.4f}")
        if y.shape != (bench.N, 2) or not np.isfinite(y).all():
            raise AssertionError(f"knob {knob}: {y.shape} or non-finite")
        if rel > NO_MATCH_REL:
            off[knob] = rel
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        # one batch of sweeps (60) keeps the trace to tens of MB
        t0 = time.perf_counter()
        at.embed(x, device="cuda", params=at.EmbedderParams(
            trace_dir=str(d / "trace")), **dict(bench.KNOB_EMBED, batch=2))
        wall = time.perf_counter() - t0
        path = d / "trace" / f"entropy_optimization_n{bench.N}.json"
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
        log(f"trace_dir: {path.name} {path.stat().st_size} bytes, "
            f"{len(events)} events, {len(kernels)} kernels, {busy_ms:.1f} "
            f"ms of kernels; embed wall {wall:.2f} s")
        if not kernels:
            raise AssertionError("the trace holds no kernel of the card")
        # the rows as MNIST's four gzip IDX files, read back
        imgs = x.astype(np.uint8).reshape(bench.N, 28, 28)
        labels = (np.arange(bench.N) % 10).astype(np.uint8)
        t0 = time.perf_counter()
        for stem, sl in (("train", slice(0, 60_000)),
                         ("t10k", slice(60_000, None))):
            with gzip.open(d / f"{stem}-images-idx3-ubyte.gz", "wb",
                           compresslevel=1) as f:
                f.write(struct.pack(">IIII", 2051, *imgs[sl].shape))
                f.write(imgs[sl].tobytes())
            with gzip.open(d / f"{stem}-labels-idx1-ubyte.gz", "wb",
                           compresslevel=1) as f:
                f.write(struct.pack(">II", 2049, len(labels[sl])))
                f.write(labels[sl].tobytes())
        back, back_labels = mnist_io.load_mnist_full(d)
        log(f"idx: {bench.N} x 784 through gzip IDX and back in "
            f"{time.perf_counter() - t0:.2f} s")
        if not (np.array_equal(back, x) and
                np.array_equal(back_labels, labels)):
            raise AssertionError("the IDX round trip changed the rows")
        # a neighbourhood's distance matrix, card against CPU
        limat = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            nb = ripser.extract_neighbourhood(
                x, x[0], NEIGHBOURHOOD_K, str(d / f"{device}.bson"),
                distance="DistL1", device=device)
            limat[device] = ripser.read_bson_limat(str(d / f"{device}.bson"))
            log(f"extract_neighbourhood ({device}): {nb} points, "
                f"{limat[device].size} values in "
                f"{time.perf_counter() - t0:.2f} s")
        err = np.abs(limat["cuda"] - limat["cpu"]) / np.maximum(
            np.abs(limat["cpu"]), 1.0)
        log(f"extract_neighbourhood: card vs CPU max rel err {err.max():.3e}")
        if limat["cuda"].shape != limat["cpu"].shape or \
                err.max() > NEIGHBOURHOOD_REL:
            raise AssertionError("the card's neighbourhood differs from the "
                                 "CPU's")
    if off:
        raise AssertionError(f"no_match off the JAX record by more than "
                             f"{NO_MATCH_REL}: {off}")


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
    t_start = time.perf_counter()

    import annembed_tpu_torch as at
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.device import disable_tf32
    from annembed_tpu_torch.io.synthetic import (synthetic_blobs,
                                                 synthetic_higgs, zscore)
    from annembed_tpu_torch.knn.hierarchy import draw_sample_ids
    from annembed_tpu_torch.ops import _build
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
    del x_np
    log(f"data: {N_ROWS} x {x.shape[1]} Higgs-shaped rows in "
        f"{time.perf_counter() - t0:.2f} s")

    def sampled(rows, fraction):
        n = rows.shape[0]
        m = max(KNN_K + 1, int(round(n * fraction)))
        ids = draw_sample_ids(n, m, torch.Generator().manual_seed(SEED))
        return rows[ids.to(dev)].contiguous()

    main_shape = check_kernel("higgs_11m", x, sampled(x, FRACTION), reps=1,
                              once=True)
    shapes = [main_shape]
    xs = x[:EXACT_ROWS].contiguous()
    shapes.append(check_kernel("exact_200k", xs, sampled(xs, FRACTION),
                               reps=10))
    xs = x[:SLICE_ROWS].contiguous()
    shapes.append(check_kernel("slice_1m", xs, sampled(xs, FRACTION), reps=3))
    del xs
    xb = torch.from_numpy(synthetic_blobs(bench.N, bench.D, 42)
                          .astype(np.float32)).to(dev)
    shapes.append(check_kernel("bench_rows", xb, sampled(xb, BENCH_FRACTION),
                               reps=10))
    del xb
    gen = torch.Generator().manual_seed(0)
    shapes.append(check_kernel(
        "ragged", torch.randn(77, 5, generator=gen).to(dev),
        torch.randn(131, 5, generator=gen).to(dev), reps=5))
    log(f"phase 3: {time.perf_counter() - t0:.2f} s")

    # phase 4: the main path at full size, then the exact hierarchical
    # path at a smaller depth, then the parts of the IVF build
    t0 = time.perf_counter()
    launches, main_info, y = _hierarchical(
        at, x, labels, MAIN_BATCHES, HIGGS_KNN, MIN_RECALL_IVF, "main path",
        with_quality=True, quality_fraction=QUALITY_FRACTION,
        quality_nbng=QUALITY_NBNG)
    search = at.quality_estimate.last_radius_search
    log(f"phase 4 (main path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    y = torch.from_numpy(y).to(dev)
    graph = main_info.pop("kgraph")
    frac_s1 = main_info["quality"]["frac_without_match"]
    phase_main_quality(at, y, graph, main_info["quality"], search)
    log(f"phase 4 (quality radius held to brute): "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_full_quality(at, y, graph, frac_s1)
    log(f"phase 13 (full-fraction quality): {time.perf_counter() - t0:.2f} s")
    del y
    t0 = time.perf_counter()
    phase_a3_rest(at, graph)
    log(f"phase 14 (graph statistics, adaptive SVD, legacy init): "
        f"{time.perf_counter() - t0:.2f} s")
    del graph, main_info
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exact_launches, _, _ = _hierarchical(
        at, x[:EXACT_ROWS].contiguous(), labels[:EXACT_ROWS], EXACT_BATCHES,
        dict(knbn=KNN_K), MIN_RECALL, "exact path")
    log(f"phase 4 (exact path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_parts(at, x)
    log(f"phase 4 (parts): {time.perf_counter() - t0:.2f} s")
    del x
    torch.cuda.empty_cache()

    phase_bench()
    phase_dmap(at)
    phase_cli()
    phase_metrics(at)
    t0 = time.perf_counter()
    blobs = phase_sampling(at)
    log(f"phase 9 (sampling path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_estimators(at, blobs)
    log(f"phase 10 (estimators): {time.perf_counter() - t0:.2f} s")
    del blobs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    harness_launches = phase_harness(labels, frac_s1)
    log(f"phase 11 (harness): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_knobs_io(at)
    log(f"phase 12 (dense knobs, IO): {time.perf_counter() - t0:.2f} s")
    log(f"chip_smoke: {time.perf_counter() - t_start:.2f} s")

    # the top-level numbers are those of the main path's shape (phase 4's
    # projection, 11M x 440k x 28: the library and the twin timed once
    # each); every shape of phase 3 is in "shapes"
    path_launches = {"higgs_11m": launches, "exact_200k": exact_launches,
                     "slice_1m": None, "bench_rows": None, "ragged": None}
    log(json.dumps({"kernels": [{
        "name": "top1_l2", "route": "cuda",
        "source": "annembed_tpu_torch/csrc/top1_l2.cu",
        "replaces": "annembed_tpu/ops/top1.py:24",
        "launches": launches, "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["twin_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "exact_path_launches": exact_launches,
        "harness_launches": harness_launches,
        "shapes": [dict(s, launches=path_launches[s["shape"]])
                   for s in shapes]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
