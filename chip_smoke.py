#!/usr/bin/env python3
"""Smoke run of annembed_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (so the exit code is non-zero; with no
CUDA device it exits 1 before printing any result):

1. the device, its name and power limit;
2. the CUDA kernels built from this checkout's sources, one nvcc each,
   all started together, with ptxas's report (registers, shared memory,
   spills);
3. the top-1 kernel against its plain PyTorch twin at the hierarchical
   path's
   shapes, every query row (11M x 440k x 28 on the Higgs rows, the twin
   and ``torch.cdist`` + ``min`` timed once at that size; 200k x 8k x 28,
   the exact path's projection; 1M x 40k x 28; 70k x 3.5k x 784 on the
   bench's rows; a ragged 77 x 131 x 5), timed in turns with its
   yardstick and beside its bound;
3b. the dense sweep kernels (``ops/dense_sweep.py``) against their
   twins: the per-sweep pair, one sweep from the same input held after
   the attraction half, after the kicks and for the kicks alone, two
   launches bit-equal, timed in turns with the twins beside
   ``sweep_bounds`` (each half also alone at the path's shapes): phase
   4's large step (11,000,000 rows) and first step (440,000), the bench's
   graph, and one small case per knob (a node block whose partner windows
   wrap past n, parallel kicks, edge masks, a stale snapshot, b = 1.5, no
   neighbour exclusion, d = 3, d = 5); the persistent launch over a run
   of sweeps (60 at 11M, 200 at 440,000 and on the bench's graph; 20 per
   knob) held bit-equal to itself, to the pair over the same sweeps and,
   at the path's shapes, to the twin (per knob its first sweep within
   the pair's band), timed a sweep in turns with the pair;
   ``dense_optimize``'s counts per knob against its ``launch_plan``, and
   its node blocks at d = 3 (rows from an odd start) against the CPU;
   ``torch.profiler`` over a large-step and a first-step segment,
   persistent and pair;
3c. the two IVF join kernels (``ops/ivf_join.py``: the tensor-core one
   and the SIMT one, each where it serves the shape) against their twin,
   the torch join, on the same plan, every row through the fix-up:
   phase 4's large-graph join (all 11,000,000 rows, bf16, k 12, nprobe
   24; the twin once), the first 1,000,000 rows in f32 and in bf16 (the
   parts' knobs), 5,003 rows of small integers with ties and
   underfilled rows (bit-equal), and 300,000 x 3 at k 51 (the quality
   estimate's IVF radius search: the SIMT kernel alone); ids equal
   outside near-ties of the ranked value, dists within 1e-5 relative,
   two launches bit-equal, the tensor-core kernel's expansion error
   within TIE_REL, each timed beside ``join_bounds``;
3d. the NN-descent round kernel (``ops/nndescent.py``) against its twin,
   the torch slab chain, on one round's tables (the union table and its
   rho-sampled subset): the Higgs path's 11,000,000-row large graph and
   its 440,000-row sample (k 12, rho 0.5: 168 candidates a row, bf16),
   the first 1,000,000 rows in f32, and at k 20 (440 candidates a row,
   the kernel's 512-slot sort); ids equal outside near-ties, each
   differing id's distance its own, dists within 1e-5 relative, inf
   where the twin has inf, the scored counts equal,
   two launches bit-equal; each timed beside its byte bound and the
   twin, and the whole round (union table, sampling, kernel) timed;
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
   the power iteration) and ``get_dmap_embedding``;
15. the sharded path (annembed_tpu_torch/parallel) on a mesh of every
   card, W ranks over NCCL started by the package's launcher, each rank
   calling the entry points with ``mesh=make_mesh(W)`` (so NCCL and every
   sharded function run at W = 1 too): (a) ``embed(x, layer=1)`` on phase
   4's 11,000,000 x 28 rows at its operating point with a sampled quality
   estimate, held to recall, label purity, phase 4's graph outside
   near-ties, phase 4's frac_without_match +-0.005, ranks' embeddings
   bit-equal (a checksum all-gather) and the kernel launched on every
   rank; (b) the bench at 70,000 x 784 (sharded brute build, SVD and
   dense optimizer) held to phase 5's JAX constants; (c) ``dmap_embed``
   at 70,000 x 784 against phase 6's result up to sign; (d) the
   full-fraction quality estimate of phase 4's 300,000-row 3-D embedding
   through the sharded IVF rebuild, within 0.001 of the single device's;
   with W > 1, (b) once more through ``embed(n_devices=W)``.

Before each path the kernel launch counts are set to 0 and read after it;
phase 4's main path must run its 8 NN-descent rounds (4 on each graph)
on the round kernel and none on torch;
every graph above the brute limit must launch the IVF join kernel
(phase 4's main path and parts, the harness, every rank of phase 15 (a)
and (d)), and the exact path none; every dense path must launch the
dense sweep kernels by its route, the CLI's and the harness's processes
reporting their own counts: whole-array
sweeps (phases 4, 5, 7, 8, 11, 12's other knobs) only through the
persistent launch, phase 4's every sweep; node blocks (phase 12) and
every rank of the mesh (phase 15) only through the pair; the row-major
scatter knob through neither.
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
KERNEL_SOURCES = ("top1_l2", "dense_sweep", "ivf_join", "ivf_join_tc",
                  "nndescent")
# phase 3: the kernel's other shapes on the path (bench rows at the
# default hierarchy fraction); the H100 SXM data sheet's peaks for the
# bounds
BENCH_FRACTION = 0.05
H100_BYTES_PER_S, H100_TF32_FLOPS, H100_F32_FLOPS = 3.35e12, 495e12, 67e12
# phase 3b: the dense sweep kernel against its twin after one sweep from
# the same input: the attraction half within SWEEP_ATT_REL of max|y|, the
# whole sweep and the kick kernel alone on the twin's attraction within
# SWEEP_REL (the kicks chain n_neg steps, each of which can scale a
# rounding difference by more than 3); two launches on the same input
# bit-equal.  The large step's and the first step's shapes of
# phase 4 (d 2, kg 3, k 6, n_neg 5, hubness weights), the bench's graph,
# and one small case per knob on SWEEP_SMALL_ROWS rows.
SWEEP_ATT_REL, SWEEP_REL = 1e-5, 1e-4
SWEEP_LARGE_ROWS, SWEEP_FIRST_ROWS = N_ROWS, 440_000
SWEEP_SMALL_ROWS = 5_003
# the persistent launch (one cooperative launch a run of sweeps) over
# this many sweeps at the large step, at the first step and the bench's
# graph, and per knob: held bit-equal to the pair over the same sweeps,
# and at the path's three shapes to the twin (max abs err 0)
PERSISTENT_LARGE_STEPS, PERSISTENT_SMALL_STEPS = 60, 200
PERSISTENT_KNOB_STEPS = 20

# phase 3c: both IVF join kernels against the torch join (the twin) on
# the same plan: phase 4's large-graph join (all 11M rows, k 12 = 2 knbn,
# nprobe 24, bf16), the parts' 1M graphs (default nprobe 32) in f32 and
# bf16, a ragged case of small-integer rows (exact: ties and underfilled
# rows bit-equal to the twin), and the quality estimate's IVF radius
# search at k 51 on 300,000 x 3 rows (the SIMT kernel's shared-memory
# lists; the tensor-core kernel's registers hold k <= 24); beside them the
# 1M f32 slice at the default knobs' build k (2 x knbn 10) and at k 32
# (knbn 16), the SIMT kernel's there (its lists and tiles pass 48 KB of
# shared memory).  Ids must agree outside near-ties of the ranked value
# (TIE_REL of |q|^2 + |c|^2) and dists within 1e-5 relative
# (ops/ivf_join.py)
JOIN_K = 2 * KNN_K
JOIN_DEFAULT_K, JOIN_WIDE_K = 20, 32
JOIN_SMALL_ROWS, JOIN_SMALL_K, JOIN_SMALL_NLIST = 5_003, 20, 400
JOIN_QUALITY_K = QUALITY_NBNG + 1
H100_BF16_FLOPS = 989e12
# phase 3d: one NN-descent round, the round kernel against the torch slab
# chain on the same tables: the main path's two graphs (k 12 = 2 knbn,
# rho 0.5, bf16 scoring), a 1M f32 slice, and k 20 at rho 0.5 (440
# candidates a row); ids equal outside near-ties of the row neighbours
# (the last column's too, where its two distances are within 1e-5), each
# differing id's distance its own, every column's distances within 1e-5,
# all relative (tools/nndescent_host_check.py::agreement)
ROUND_RHO, ROUND_WIDE_K = 0.5, 20

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
# phase 15: the mesh path's bands against the single device: the sampled
# frac_without_match of the 11M embedding (phase 11's band: the sweep
# kernels are deterministic, but the mesh's graph agrees with phase 4's
# only outside near-ties and its sharded spectral init sums in another
# order, and the expansive sweep map carries such differences into
# another embedding of the same dynamics), the full fraction of the 300k 3-D
# embedding (the same graph rebuild, sharded), the diffusion coordinates
# up to sign (tests/test_parallel.py::test_dmap_embed_mesh_matches_single)
MESH_FRAC_ABS, MESH_FULL_FRAC_ABS, MESH_DMAP_ATOL = 0.005, 0.001, 5e-3
# graph agreement outside near-ties, as the port's IVF tests define it
MESH_GRAPH_AGREE, MESH_GRAPH_D_REL = 0.999, 1e-5


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


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from annembed_tpu_torch.ops import dense_sweep, ivf_join, nndescent, top1
    top1.reset_launch_count()
    ivf_join.reset_launch_counts()
    dense_sweep.reset_launch_counts()
    nndescent.reset_launch_counts()


def join_counts() -> dict:
    """Each IVF join kernel's launches since the last reset: ``simt``
    (csrc/ivf_join.cu) and ``tc`` (csrc/ivf_join_tc.cu)."""
    from annembed_tpu_torch.ops.ivf_join import launch_counts
    return launch_counts()


def join_since(before: dict) -> dict:
    """Each IVF join kernel's launches since ``before`` (a
    ``join_counts()``)."""
    now = join_counts()
    return {route: now[route] - before[route] for route in now}


def dense_counts() -> dict:
    """The dense sweep kernels' counts since the last reset: ``pair``
    (both halves of every per-sweep pair), ``persistent`` launches and
    ``persistent_sweeps``."""
    from annembed_tpu_torch.ops.dense_sweep import launch_counts
    return launch_counts()


def dense_launches() -> int:
    """Every dense sweep kernel launch since the last reset."""
    counts = dense_counts()
    return counts["pair"] + counts["persistent"]


def require_route(tag, counts, route, joins=None, join_route="tc") -> None:
    """The dense sweeps of a path went through ``route``: "persistent"
    (persistent launches and no pair), "pair" (pairs and no persistent
    launch) or None (no dense sweep kernel); with ``joins`` (the path's
    ``join_counts()``) given, its IVF joins went through ``join_route``
    alone (``require_join_route``)."""
    pair, persistent = counts["pair"] > 0, counts["persistent"] > 0
    if (pair, persistent) != {"persistent": (False, True),
                              "pair": (True, False),
                              None: (False, False)}[route]:
        raise AssertionError(f"{tag}: dense sweep launches {counts}, not "
                             f"the {route} route")
    if joins is not None:
        require_join_route(tag, joins, join_route)


def require_join_route(tag, joins, route) -> None:
    """A path's IVF joins (``joins``, its ``join_counts()``) launched the
    ``route`` kernel ("tc" or "simt") and not the other: the route the
    rule (``ops.ivf_join.join_route``) gives its shapes."""
    other = {"tc": "simt", "simt": "tc"}[route]
    if joins[route] < 1 or joins[other]:
        raise AssertionError(f"{tag}: IVF join launches {joins}, not the "
                             f"{route} route")


def join_bounds(inp, dtype):
    """Least time (ms) an H100 SXM could take for the join of ``inp``:
    the larger of its bytes (every input read once, the outputs written
    once) at 3.35 TB/s and its cross products, 2 d flop for each
    query-candidate pair of the plan, in bf16 at 989 TFLOP/s or
    f32-accurate (three TF32 products) at 495; beside it the f32 CUDA
    cores' bound (2 d flop a pair at 67 TFLOP/s), the time of the
    candidate windows' bytes read once a virtual row, and ``select_ms``:
    one compare a pair at the CUDA cores' issue rate (67e12 / 2 a
    second), the least a selection that looks at every pair costs."""
    xs = inp["xs_pad"]
    n1, d = xs.shape
    n, k = n1 - 1, inp["k"]
    parents = inp["qparents"].long()
    starts, counts = inp["starts"].long(), inp["counts"].long()
    qn = (starts[parents] + counts[parents]
          - inp["qstarts"].long()).clamp(0, inp["qcap"])
    window = counts[inp["cell_nbrs"].long()[parents]].clamp_max(
        inp["cap"]).sum(1)
    pairs = int((qn * window).sum())
    tables = 4 * (2 * parents.numel() + 2 * starts.numel()
                  + inp["cell_nbrs"].numel())
    in_bytes = 4 * n1 * (d + 1) + tables + 8 * n * k
    window_bytes = (4 * int(window.sum()) * (d + 1) + 4 * n * (d + 1)
                    + tables + 8 * n * k)
    flops = 2.0 * d * pairs
    ops_ms = 1e3 * (flops / H100_BF16_FLOPS if dtype == "bfloat16"
                    else 3 * flops / H100_TF32_FLOPS)
    bytes_ms = 1e3 * in_bytes / H100_BYTES_PER_S
    return dict(pairs=pairs, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_f32_ms=max(1e3 * flops / H100_F32_FLOPS, bytes_ms),
                windows_ms=1e3 * window_bytes / H100_BYTES_PER_S,
                select_ms=1e3 * pairs / (H100_F32_FLOPS / 2))


def check_join(name, inp, dtype, reps, exact=False):
    """Both join kernels (each that serves the shape) against the torch
    join on the same plan, all through the fix-up: every row held (bit
    for bit with ``exact``, else ``join_agreement``), two launches
    bit-equal, the tensor-core route's expansion error (its ranked values
    against float64) within TIE_REL, then each timed over ``reps``
    launches beside the bounds and the twin's one call.  ``ms`` and
    ``max_abs_err`` are the route the rule gives the shape; every route's
    record is in ``routes``."""
    from annembed_tpu_torch.knn.ivf import _fixup_underfilled
    from annembed_tpu_torch.ops import ivf_join as ij
    n, d = inp["xs_pad"].shape[0] - 1, inp["xs_pad"].shape[1]
    k, nprobe = inp["k"], inp["cell_nbrs"].shape[1]
    twin = {}
    twin_ms = cuda_once_ms(lambda: twin.update(
        out=ij.ivf_join_reference(**inp, dtype=dtype)))
    want = twin.pop("out")
    underfilled = int(torch.isinf(want[1]).any(1).sum())
    wi, wd = _fixup_underfilled(*want, n)
    del want
    b = join_bounds(inp, dtype)
    routes = {}
    for route in ij.ROUTES:
        kernel = ij._kernel(route)
        if k > kernel.max_k(d, int(dtype == "bfloat16"), nprobe):
            continue
        # the route's kernel whatever the rule says, and no count moves
        stream = torch.cuda.current_stream().cuda_stream
        got = ij._join(kernel, stream, **inp, dtype=dtype,
                       ranked=route == "tc")
        extra = {}
        if route == "tc":
            extra["expansion_err"] = ij.expansion_error(
                inp["xs_pad"], dtype, got[2], got[3])
            got = got[:2]
        again = ij._join(kernel, stream, **inp, dtype=dtype)
        torch.cuda.synchronize()
        repeat = (torch.equal(got[0], again[0])
                  and torch.equal(got[1], again[1]))
        del again
        gi, gd = _fixup_underfilled(*got, n)
        del got
        agree = ij.join_agreement(inp["xs_pad"], dtype, gi, gd, wi, wd)
        same = gi == wi
        max_abs = (float((gd - wd)[same].abs().max()) if bool(same.any())
                   else 0.0)
        clear, rows_differ, _ = graph_agreement(gi.cpu(), gd.cpu(),
                                                wi.cpu(), wd.cpu())
        bits = torch.equal(gi, wi) and torch.equal(gd, wd)
        del gi, gd, same
        ms = cuda_ms(lambda: ij._join(kernel, stream, **inp, dtype=dtype),
                     reps)
        routes[route] = dict(ms=ms, share_of_bound=b["bound_ms"] / ms,
                             repeat_bit_equal=repeat,
                             bit_equal_to_twin=bits, max_abs_err=max_abs,
                             clear_columns_equal=clear,
                             rows_differing=rows_differ, **agree, **extra)
        log(f"join {name} {route}: {json.dumps(routes[route])}")
        if (not repeat or agree["mismatch_rows"] or agree["unsorted_rows"]
                or agree["max_rel_dist_err"] > ij.DIST_REL
                or (exact and not bits)
                or extra.get("expansion_err", 0.0) > ij.TIE_REL):
            raise AssertionError(f"the {route} join kernel disagrees with "
                                 f"the torch join at {name}: "
                                 f"{routes[route]}")
    rule = ij.join_route("cuda", "sorted", "DistL2", d, k)
    out = dict(shape=name, n=n, d=d, k=k, dtype=dtype, nprobe=nprobe,
               cap=inp["cap"], qcap=inp["qcap"],
               virtual_rows=inp["qstarts"].shape[0],
               underfilled_rows=underfilled, pairs=b["pairs"], route=rule,
               ms=routes[rule]["ms"], twin_ms=twin_ms,
               bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_f32_ms=b["bound_f32_ms"], select_ms=b["select_ms"],
               windows_ms=b["windows_ms"], library_ms=None,
               max_abs_err=routes[rule]["max_abs_err"], routes=routes)
    log(f"join {name}: " + json.dumps({key: v for key, v in out.items()
                                         if key != "routes"}))
    return out


def phase_join(x):
    """Phase 3c: the IVF join kernels against their twin at the path's
    shapes.  Returns each shape's record, phase 4's first, the quality
    rebuild's last."""
    from annembed_tpu_torch.knn.ivf import sorted_join_inputs as plan
    rng = np.random.default_rng(SEED)
    shapes = [check_join("higgs_11m", plan(x, JOIN_K, nprobe=24), "bfloat16",
                         reps=3)]
    torch.cuda.empty_cache()
    xs = x[:PARTS_ROWS].contiguous()
    for dtype in ("float32", "bfloat16"):
        shapes.append(check_join(f"slice_1m_{dtype}",
                                 plan(xs, JOIN_K, nprobe=32), dtype, reps=5))
    for k in (JOIN_DEFAULT_K, JOIN_WIDE_K):
        shapes.append(check_join(f"slice_1m_float32_k{k}",
                                 plan(xs, k, nprobe=32), "float32", reps=3))
    del xs
    ints = torch.from_numpy(rng.integers(-6, 7, (JOIN_SMALL_ROWS, 5))
                            .astype(np.float32)).to(x.device)
    shapes.append(check_join(
        "ragged_5003", plan(ints, JOIN_SMALL_K, nprobe=2,
                            nlist=JOIN_SMALL_NLIST),
        "float32", reps=20, exact=True))
    x3 = x[:QUALITY_ROWS, :3].contiguous()
    shapes.append(check_join("quality_300k_k51",
                             plan(x3, JOIN_QUALITY_K, nprobe=32), "float32",
                             reps=5))
    return shapes


def round_inputs(x, idx, dist, dtype, rho=ROUND_RHO, seed=SEED):
    """One NN-descent round's tables as ``nndescent_refine`` builds them
    from the graph (``idx``, ``dist``) of ``x``: the scoring rows, the
    union table, its rho-sampled subset (a generator seeded ``seed``),
    the current lists and the slab plan."""
    from annembed_tpu_torch.knn import nndescent as tnd
    n, d = x.shape
    k = idx.shape[1]
    x_score = x.to(torch.bfloat16) if dtype == "bfloat16" else x
    x_pad = torch.cat([x_score, x_score.new_zeros((1, d))])
    union_pp = tnd._union_pp(idx, k, dist)
    u = union_pp.shape[1]
    s = u if rho >= 1.0 else max(2, int(round(rho * u)))
    inner_pp = union_pp
    if s < u:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        inner_pp = tnd._sample_union_pp(
            torch.rand(union_pp.shape, generator=gen, device=x.device),
            union_pp, s).contiguous()
    slab = max(1, tnd.PANEL_BYTES // ((s * s + u) * (12 * d + k)))
    return dict(x_pad=x_pad, inner_pp=inner_pp, union_pp=union_pp,
                indices=idx.to(torch.int32).contiguous(),
                dists=dist.contiguous(), slab=slab)


def round_bound_ms(pairs, n, d, k, dtype):
    """Least time (ms) an H100 SXM could take for one round: each scored
    candidate's row read once in the scoring dtype, the (n, k) ids and
    distances read and written once, at 3.35 TB/s (the benchmark's
    ``nndescent_roofline`` counts the same bytes)."""
    row = (2 if dtype == "bfloat16" else 4) * d
    return 1e3 * (pairs * row + 16.0 * n * k) / H100_BYTES_PER_S


def check_round(name, x, idx, dist, dtype, reps):
    """The round kernel against the torch slab chain on one round's
    tables: every row (``agreement``: ids equal outside near-ties, each
    differing id's distance its own, dists within 1e-5 relative, inf
    where the twin has inf, rows ascending), the scored counts equal, two launches bit-equal;
    timed over ``reps`` launches beside the byte bound and the twin's one
    call, and the whole round (union table, sampling, kernel) as
    ``nndescent_refine`` runs it."""
    from annembed_tpu_torch.knn import nndescent as tnd
    from annembed_tpu_torch.ops import nndescent as nd
    from tools.nndescent_host_check import agreement
    inp = round_inputs(x, idx, dist, dtype)
    n, k = inp["indices"].shape
    d = x.shape[1]
    c = inp["inner_pp"].shape[1] ** 2 + inp["union_pp"].shape[1]
    route = nd.round_route("cuda", "DistL2", dtype, k, c, d)
    if route != "kernel":
        raise AssertionError(f"round {name}: route {route}, not the kernel")
    stream = torch.cuda.current_stream().cuda_stream
    p_want = torch.zeros((), dtype=torch.int64, device=x.device)
    twin = {}
    twin_ms = cuda_once_ms(lambda: twin.update(
        out=nd.nndescent_round_reference(**inp, pairs=p_want)))
    wi, wd = twin.pop("out")
    p_got = torch.zeros((), dtype=torch.int64, device=x.device)
    gi, gd = nd._round(nd._kernel(), stream, **inp, pairs=p_got)
    ai, ad = nd._round(nd._kernel(), stream, **inp)
    torch.cuda.synchronize()
    repeat = torch.equal(gi, ai) and torch.equal(gd, ad)
    del ai, ad
    agree = agreement(gi, gd, wi, wd, inp["x_pad"])
    rows_differ = int(((gi != wi) | (gd != wd)).any(1).sum())
    inf_rows = int(torch.isinf(wd).any(1).sum())
    del gi, gd, wi, wd
    pairs = int(p_got)
    ms = cuda_ms(lambda: nd._round(nd._kernel(), stream, **inp), reps)
    bound = round_bound_ms(pairs, n, d, k, dtype)
    s = inp["inner_pp"].shape[1]
    x_pad = inp["x_pad"]
    idx32, dist32 = inp["indices"], inp["dists"]
    del inp
    whole_ms = cuda_ms(lambda: tnd._round(
        x_pad, idx32, dist32, 0, k, s, 1, "DistL2", None, None, SEED),
        reps)
    out = dict(shape=name, n=n, d=d, k=k, candidates=c, dtype=dtype,
               pairs=pairs, pairs_twin=int(p_want), ms=ms, twin_ms=twin_ms,
               whole_round_ms=whole_ms, bound_ms=bound,
               share_of_bound=bound / ms, repeat_bit_equal=repeat,
               rows_differing=rows_differ, twin_inf_rows=inf_rows,
               **{key: v for key, v in agree.items() if key != "bit_equal"})
    log(f"round {name}: " + json.dumps(out))
    if (not repeat or agree["id_mismatch"] or agree["own_mismatch"]
            or agree["dist_mismatch"] or agree["inf_mismatch"]
            or agree["unsorted_rows"]
            or pairs != int(p_want)):
        raise AssertionError(f"the round kernel disagrees with its twin at "
                             f"{name}: {out}")
    return out


def phase_nndescent(x):
    """Phase 3d: the NN-descent round kernel against its twin at the
    main path's shapes (its 11M graph and its 440,000-row sample, built
    by the IVF join at phase 4's knobs) and at a 1M f32 slice (k 12 and
    k 20).  Returns each shape's record, the 11M one first."""
    from annembed_tpu_torch.knn.hierarchy import draw_sample_ids
    from annembed_tpu_torch.knn.ivf import knn_graph_ivf
    n = x.shape[0]
    m = max(KNN_K + 1, int(round(n * FRACTION)))
    small = x[draw_sample_ids(n, m, torch.Generator().manual_seed(SEED))
              .to(x.device)].contiguous()
    shapes = []
    for name, rows, k, dtype, reps in (
            ("higgs_11m", x, JOIN_K, "bfloat16", 3),
            ("higgs_440k", small, JOIN_K, "bfloat16", 10),
            ("slice_1m_float32", x[:PARTS_ROWS].contiguous(), JOIN_K,
             "float32", 5),
            (f"slice_1m_float32_k{ROUND_WIDE_K}",
             x[:PARTS_ROWS].contiguous(), ROUND_WIDE_K, "float32", 5)):
        idx, dist = knn_graph_ivf(rows, k, nprobe=24, dtype="bfloat16")
        shapes.append(check_round(name, rows, idx, dist, dtype, reps))
        del idx, dist
        torch.cuda.empty_cache()
    return shapes


def sweep_bounds(n_rows, kg, k, n_neg, d, hub, exclusion=True, mask=False):
    """Least time (ms) an H100 SXM could take for one dense sweep of
    ``n_rows`` rows: the larger of its bytes, every input read once and
    the output written once (y and the new y (n, d); the group's idx, w,
    m, w_rev, m_rev, scale_j and mask (kg, n); scale and the hubness
    weights (n,); the neighbour ids (k, n)) at 3.35 TB/s, and its f32
    operations (counted from the formula, a log or exp as one) at 67
    TFLOP/s.  Beside it, the bytes the two launches touch: each
    neighbour and partner row read once a use, the attraction's output
    written and read back."""
    table = kg * (24 + 4 * mask)
    once = (8 * d + table + 4 + 4 * hub + 4 * k * exclusion) * n_rows
    touched = ((4 * d + 4 + table + kg * 4 * d + 4 * d)
               + (4 * d + 4 + n_neg * (4 * d + 4 * hub) + 4 * k * exclusion
                  + 4 * d)) * n_rows
    ops = (kg * (48 + 5 * d) + n_neg * (16 + 6 * d + k * exclusion)
           + 2 * d) * n_rows
    bytes_ms = once / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_once=once, bytes_touched=touched,
                touched_ms=touched / H100_BYTES_PER_S * 1e3)


def sweep_inputs(n, k=6, d=2, hub=True, seed=0):
    """A sweep's inputs on the card at phase 4's shapes: coordinates
    N(0, 3^2), neighbours uniform over the rows (the relabel permutation
    leaves them so), weights, multiplicities and scales in the ranges of
    the Higgs graph's, half of the reverse weights zero; the edge records
    of both column groups (kg 3)."""
    from annembed_tpu_torch.ops.dense_sweep import pack_groups
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo

    idx = torch.randint(0, n, (n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    w = u((n, k), 0.05, 1.0)
    w_rev = torch.where(u((n, k), 0.0, 1.0) < 0.5, u((n, k), 0.05, 1.0),
                        torch.zeros((), device="cuda"))
    scale = u((n,), 0.5, 2.0)
    return dict(y=3.0 * torch.randn((n, d), generator=g, device="cuda"),
                edges=pack_groups(idx, w, 2.0 * w, w_rev, 2.0 * w_rev, scale,
                                  2),
                scale=scale, neg_weight=u((n,), 0.25, 4.0) if hub else None,
                idx_full=idx.T.contiguous(), gamma=1.0, b=1.0, n_neg=5,
                offset=int(torch.randint(0, n, (), generator=g,
                                         device="cuda")),
                grad_step=2.0, n_sub=60, nb_grad_batch=40)


def bench_sweep_inputs():
    """The bench's graph (70,000 x 784 blobs, exact 6-NN, its edge
    probabilities) through ``prepare_dense_inputs`` at the bench's first
    schedule phase (n_sub 15, two column groups, no hubness weights,
    neighbour exclusion off), from a random start in its data box."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.graph.kgraph import KGraph
    from annembed_tpu_torch.graph.proba import to_proba_edges
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.knn.brute import knn_graph_brute
    from annembed_tpu_torch.ops.dense_sweep import pack_groups
    from annembed_tpu_torch.optim.dense import _gamma, prepare_dense_inputs
    from annembed_tpu_torch.params import EmbedderParams
    x = torch.from_numpy(synthetic_blobs(bench.N, bench.D, 42)
                         .astype(np.float32)).to("cuda")
    gi, gd = knn_graph_brute(x, bench.KNBN, block_rows=bench.BLOCK_ROWS)
    gr = KGraph(indices=gi, dists=gd)
    del x
    params = EmbedderParams(nb_grad_batch=sum(b for b, _ in bench.SCHEDULE),
                            n_sub_schedule=bench.SCHEDULE,
                            dense_neighbor_exclusion=False)
    gen = torch.Generator().manual_seed(SEED)
    y0 = (torch.rand((bench.N, 2), generator=gen) * 20.0 - 10.0).to("cuda")
    (y, idx, w, m, w_rev, m_rev, scale, _, n_neg, _) = prepare_dense_inputs(
        y0, gr, to_proba_edges(gr), params, bench.SCHEDULE[0][1], 2,
        generator=gen)
    idx = idx.to(torch.int32)
    return dict(y=y.contiguous(),
                edges=pack_groups(idx, w, m, w_rev, m_rev, scale, 2),
                scale=scale.contiguous(), neg_weight=None,
                idx_full=idx.T.contiguous(),
                gamma=_gamma(params.grad_step, 1, params.nb_grad_batch),
                b=1.0, n_neg=n_neg, offset=int(torch.randint(
                    0, bench.N, (), generator=gen)), exclusion=False,
                grad_step=params.grad_step, n_sub=bench.SCHEDULE[0][1],
                nb_grad_batch=params.nb_grad_batch)


def check_dense_sweep(name, inp, reps, lo=0, rows=None, y_src=None,
                      mask=None, mask_p=1.0, parallel=False,
                      exclusion=True, flat=None, split=False):
    """Phase 3b on one shape: the kernel pair and its twins from the same
    input (column group 0), held after the attraction half, after the
    kicks, and the kick kernel alone on the twin's attraction; the
    kernel's sweep launched twice, bit-equal; then timed in turns with
    the twin's (twin, kernel, kernel, twin) beside ``sweep_bounds``, and
    with ``split`` each half alone."""
    from annembed_tpu_torch.ops.dense_sweep import (
        dense_attraction_rows, dense_attraction_rows_reference,
        dense_kick_rows, dense_kick_rows_reference)
    y = inp["y"]
    n, d = y.shape
    rows = n - lo if rows is None else rows
    exclusion = inp.get("exclusion", exclusion)
    flat = (rows == n) if flat is None else flat
    sl = slice(lo, lo + rows)
    edges = inp["edges"][0, sl]
    kg = edges.shape[1] // 6
    mask = None if mask is None else mask[:, sl].contiguous()
    idx_full = inp["idx_full"][:, sl].contiguous()
    src = y if y_src is None else y_src
    gamma, b, n_neg = inp["gamma"], inp["b"], inp["n_neg"]
    att = dict(mask=mask, mask_p=mask_p)
    kick = dict(neg_weight=inp["neg_weight"], neighbor_exclusion=exclusion,
                parallel_kicks=parallel, flat=flat)

    def sweep(attraction, kicks, a=None):
        if a is None:
            a = attraction(y, src, lo, edges, inp["scale"], gamma, b, **att)
        return a, kicks(y, a, lo, inp["offset"], idx_full, inp["scale"],
                        gamma, b, n_neg, **kick)

    a_k, o_k = sweep(dense_attraction_rows, dense_kick_rows)
    a_k2, o_k2 = sweep(dense_attraction_rows, dense_kick_rows)
    a_t, o_t = sweep(dense_attraction_rows_reference,
                     dense_kick_rows_reference)
    _, o_kt = sweep(None, dense_kick_rows, a=a_t)
    torch.cuda.synchronize()
    y_max = float(y.abs().max())
    att_err = float((a_k - a_t).abs().max())
    err = float((o_k - o_t).abs().max())
    kick_err = float((o_kt - o_t).abs().max())
    bit_equal = torch.equal(a_k, a_k2) and torch.equal(o_k, o_k2)
    moved = float((o_t - y[sl]).abs().max())
    finite = bool(torch.isfinite(o_k).all())
    del a_k, o_k, a_k2, o_k2, a_t, o_t, o_kt
    kernel = lambda: sweep(dense_attraction_rows, dense_kick_rows)  # noqa
    twin = lambda: sweep(dense_attraction_rows_reference,  # noqa: E731
                         dense_kick_rows_reference)
    twin_a = cuda_ms(twin, reps)
    ms_a = cuda_ms(kernel, reps)
    ms_b = cuda_ms(kernel, reps)
    twin_b = cuda_ms(twin, reps)
    ms, twin_ms = (ms_a + ms_b) / 2, (twin_a + twin_b) / 2
    bnd = sweep_bounds(rows, kg, idx_full.shape[0], n_neg, d,
                       inp["neg_weight"] is not None, exclusion,
                       mask is not None)
    halves = {}
    if split:
        a_k = dense_attraction_rows(y, src, lo, edges, inp["scale"], gamma, b,
                                    **att)
        halves = dict(attraction_ms=cuda_ms(lambda: dense_attraction_rows(
            y, src, lo, edges, inp["scale"], gamma, b, **att), reps),
            kick_ms=cuda_ms(lambda: dense_kick_rows(
                y, a_k, lo, inp["offset"], idx_full, inp["scale"], gamma, b,
                n_neg, **kick), reps))
        del a_k
    out = dict(shape=name, n=n, rows=rows, lo=lo, d=d, kg=kg,
               k=idx_full.shape[0], n_neg=n_neg,
               hub=inp["neg_weight"] is not None, exclusion=exclusion,
               parallel_kicks=parallel, stale=y_src is not None,
               mask_p=mask_p, b=b, flat=flat, max_abs_err=err,
               attraction_max_abs_err=att_err, kick_max_abs_err=kick_err,
               max_abs_y=y_max,
               max_move=moved, bit_equal=bit_equal, ms=ms, twin_ms=twin_ms,
               bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
               touched_ms=bnd["touched_ms"],
               share_of_bound=bnd["bound_ms"] / ms, **halves)
    log(f"dense sweep {name}: n={n} rows={rows} lo={lo} d={d} "
        f"kg={out['kg']} k={out['k']} n_neg={n_neg} hub={out['hub']} "
        f"exclusion={exclusion} parallel={parallel} stale={out['stale']} "
        f"mask_p={mask_p} b={b} flat={flat}: attraction max abs err "
        f"{att_err:.3e}, sweep {err:.3e}, kicks alone {kick_err:.3e} "
        f"(max|y| {y_max:.3e}, largest move "
        f"{moved:.3e}); two launches bit-equal {bit_equal}; ms={ms:.4f} "
        f"twin_ms={twin_ms:.4f} bound_ms={bnd['bound_ms']:.4f} "
        f"({bnd['bound_by']}; touched {bnd['touched_ms']:.4f}) "
        f"share={bnd['bound_ms'] / ms:.4f}; turns twin {twin_a:.4f} kernel "
        f"{ms_a:.4f} {ms_b:.4f} twin {twin_b:.4f}"
        + (f"; attraction alone {halves['attraction_ms']:.4f} ms, kicks "
           f"alone {halves['kick_ms']:.4f} ms" if split else ""))
    if not finite or att_err > SWEEP_ATT_REL * y_max or \
            max(err, kick_err) > SWEEP_REL * y_max or not bit_equal:
        raise AssertionError(
            f"dense sweep kernel at {name}: attraction err {att_err}, sweep "
            f"err {err}, kicks alone {kick_err} (max|y| {y_max}), bit-equal "
            f"{bit_equal}, finite {finite}")
    return out


def sweep_plan(inp, steps, seed=0):
    """A run of ``steps`` whole-array sweeps as ``dense_optimize`` plans
    one: gamma by the global schedule from its first batch, random pool
    offsets, the column groups alternating; device tensors."""
    from annembed_tpu_torch.optim.dense import _gamma
    n = inp["y"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    gammas = [_gamma(inp["grad_step"], 1 + s // inp["n_sub"],
                     inp["nb_grad_batch"]) for s in range(steps)]
    return (torch.tensor(gammas, dtype=torch.float32, device="cuda"),
            torch.randint(0, n, (steps,), generator=gen).to("cuda"),
            (torch.arange(steps, dtype=torch.int32) % 2).to("cuda"))


def check_persistent(name, inp, steps, reps, y_src=None, parallel=False,
                     exclusion=True, exact=True):
    """Phase 3b's persistent launch on one shape: ``steps`` sweeps from
    the same input through one ``dense_sweeps`` launch, twice (bit-equal),
    through the per-sweep pair as ``dense_optimize`` drives it (bit-equal)
    and through its twin: max abs err 0 with ``exact``; else (over many
    sweeps the expansive map amplifies any ulp past any band) the first
    sweep alone within the pair's band, SWEEP_REL of max|y|.  Then timed
    a sweep in turns with the pair (pair, persistent, persistent, pair)
    beside ``sweep_bounds``."""
    from annembed_tpu_torch.ops.dense_sweep import (
        dense_attraction_rows, dense_kick_rows, dense_sweeps,
        dense_sweeps_reference, launch_counts)
    y0 = inp["y"]
    n, d = y0.shape
    exclusion = inp.get("exclusion", exclusion)
    gammas, offsets, groups = plan = sweep_plan(inp, steps)
    b, n_neg = inp["b"], inp["n_neg"]
    knobs = dict(neg_weight=inp["neg_weight"], neighbor_exclusion=exclusion,
                 parallel_kicks=parallel)
    args = (inp["edges"], inp["scale"], *plan, b, n_neg, inp["idx_full"])
    work = torch.empty_like(y0)
    gamma_l, offset_l, group_l = (t.tolist() for t in plan)

    def persistent():
        work.copy_(y0)
        return dense_sweeps(work, y_src, *args, **knobs)

    def pair():
        work.copy_(y0)
        src = work if y_src is None else y_src
        for g, o, c in zip(gamma_l, offset_l, group_l):
            a = dense_attraction_rows(work, src, 0, inp["edges"][c],
                                      inp["scale"], g, b)
            dense_kick_rows(work, a, 0, o, inp["idx_full"], inp["scale"], g,
                            b, n_neg, flat=True, out=work, **knobs)
        return work

    before = launch_counts()
    got = persistent().clone()
    counted = launch_counts()
    again = persistent().clone()
    by_pair = pair().clone()
    twin = dense_sweeps_reference(y0.clone(), y_src, *args, **knobs)
    first = (inp["edges"], inp["scale"], *(t[:1] for t in plan), b, n_neg,
             inp["idx_full"])
    first_err = float((dense_sweeps(y0.clone(), y_src, *first, **knobs)
                       - dense_sweeps_reference(y0.clone(), y_src, *first,
                                                **knobs)).abs().max())
    torch.cuda.synchronize()
    y_max = float(y0.abs().max())
    err = float((got - twin).abs().max())
    pair_err = float((got - by_pair).abs().max())
    bit_equal = torch.equal(got, again)
    finite = bool(torch.isfinite(got).all())
    moved = float((got - y0).abs().max())
    del got, again, by_pair, twin
    pair_a = cuda_ms(pair, reps) / steps
    ms_a = cuda_ms(persistent, reps) / steps
    ms_b = cuda_ms(persistent, reps) / steps
    pair_b = cuda_ms(pair, reps) / steps
    ms, pair_ms = (ms_a + ms_b) / 2, (pair_a + pair_b) / 2
    bnd = sweep_bounds(n, inp["edges"].shape[2] // 6, inp["idx_full"].shape[0],
                       n_neg, d, inp["neg_weight"] is not None, exclusion)
    out = dict(shape=name, n=n, d=d, steps=steps, n_neg=n_neg,
               parallel_kicks=parallel, stale=y_src is not None, b=b,
               exclusion=exclusion, max_abs_err=err,
               first_sweep_max_abs_err=first_err, pair_max_abs_err=pair_err,
               max_abs_y=y_max, max_move=moved, bit_equal=bit_equal,
               launches=counted["persistent"] - before["persistent"],
               sweeps=counted["persistent_sweeps"]
               - before["persistent_sweeps"],
               ms=ms, pair_ms=pair_ms, bound_ms=bnd["bound_ms"],
               bound_by=bnd["bound_by"], touched_ms=bnd["touched_ms"],
               share_of_bound=bnd["bound_ms"] / ms)
    log(f"persistent {name}: n={n} d={d} {steps} sweeps n_neg={n_neg} "
        f"parallel={parallel} stale={y_src is not None} b={b} "
        f"exclusion={exclusion}: vs twin max abs err {err:.3e} (first "
        f"sweep {first_err:.3e}), vs pair "
        f"{pair_err:.3e}, two launches bit-equal {bit_equal} (max|y| "
        f"{y_max:.3e}, largest move {moved:.3e}); one launch counted "
        f"{out['launches']} with {out['sweeps']} sweeps; ms a sweep "
        f"{ms:.4f} (pair {pair_ms:.4f}) bound_ms={bnd['bound_ms']:.4f} "
        f"share={bnd['bound_ms'] / ms:.4f}; turns pair {pair_a:.4f} "
        f"persistent {ms_a:.4f} {ms_b:.4f} pair {pair_b:.4f}")
    if not finite or not bit_equal or pair_err != 0.0 or \
            (out["launches"], out["sweeps"]) != (1, steps) or \
            (exact and err != 0.0) or first_err > SWEEP_REL * y_max:
        raise AssertionError(
            f"persistent sweeps at {name}: twin err {err} (first sweep "
            f"{first_err}), pair err "
            f"{pair_err}, bit-equal {bit_equal}, finite {finite}, counted "
            f"{out['launches']} launches of {out['sweeps']} sweeps")
    return out


def check_dispatch():
    """``dense_optimize`` on the card, one small call per knob: the
    kernel counts it adds are exactly its ``launch_plan``'s (the
    persistent launch for whole-array sweeps, fresh and stale, stacked
    kicks; the pair for node blocks and edge masks; none on the
    row-major path)."""
    from annembed_tpu_torch.optim.dense import dense_optimize, launch_plan
    n, k = SWEEP_SMALL_ROWS, 6
    g = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, n, (n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    w = torch.rand((n, k), generator=g, device="cuda")
    args = (3.0 * torch.randn((n, 2), generator=g, device="cuda"), idx, w,
            2.0 * w, w.flip(0), 2.0 * w.flip(0),
            torch.rand((n,), generator=g, device="cuda") + 0.5, None)
    plan_args = dict(total_steps=2 * 15, n=n, n_groups=2, n_sub=15,
                     nb_grad_batch=4, batch0=0, gather_reuse_after=0.0)
    knobs = {"default": dict(), "stale": dict(gather_reuse=4),
             "parallel_kicks": dict(parallel_kicks=True),
             "mask": dict(mask_p=0.7), "n_blocks": dict(n_blocks=3),
             "row_major": dict(scatter_free=False)}
    counts = {}
    for knob, kw in knobs.items():
        reset_launches()
        y = dense_optimize(*args, grad_step_init=2.0, b=1.0, n_sub=15,
                           n_neg=20, nb_grad_batch=4, n_groups=2, batch0=0,
                           batch1=2,
                           generator=torch.Generator().manual_seed(1),
                           **kw)
        torch.cuda.synchronize()
        counts[knob] = dense_counts()
        # the row-major knob runs torch ops; the scatter-free path two
        # launches a sweep on the pair, one a run on the persistent route
        plan = launch_plan(**plan_args, n_blocks=kw.get("n_blocks", 1),
                           gather_reuse=kw.get("gather_reuse", 1),
                           mask_p=kw.get("mask_p", 1.0))
        route = plan["route"] if kw.get("scatter_free", True) else None
        steps = plan_args["total_steps"]
        want = dict(pair=2 * steps if route == "pair" else 0,
                    persistent=(len(plan["runs"]) if route == "persistent"
                                else 0),
                    persistent_sweeps=steps if route == "persistent" else 0)
        log(f"dispatch {knob}: route {route}, counts "
            f"{json.dumps(counts[knob])}")
        if counts[knob] != want or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"dispatch {knob}: {counts[knob]}, plan "
                                 f"{want}")
    return counts


def check_node_blocks_d3():
    """``dense_optimize(n_blocks=3)`` at d = 3 on SWEEP_SMALL_ROWS rows,
    whose second block starts at an odd row (4 bytes off an 8-byte
    word), through the pair on the card against the same call on the
    CPU (the twins), at a step small enough that six sweeps stay within
    the pair's band.  Returns the kernel counts it added."""
    from annembed_tpu_torch.optim.dense import _block_bounds, dense_optimize
    n, k = SWEEP_SMALL_ROWS, 6
    g = torch.Generator(device="cuda").manual_seed(6)
    idx = torch.randint(0, n, (n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    w = torch.rand((n, k), generator=g, device="cuda")
    args = (3.0 * torch.randn((n, 3), generator=g, device="cuda"), idx, w,
            2.0 * w, w.flip(0), 2.0 * w.flip(0),
            torch.rand((n,), generator=g, device="cuda") + 0.5,
            torch.rand((n,), generator=g, device="cuda") + 0.5)
    kw = dict(grad_step_init=0.02, b=1.0, n_sub=3, n_neg=5, nb_grad_batch=4,
              n_groups=2, batch0=0, batch1=2, n_blocks=3,
              offsets=[17, n - 4, 101, 5, n // 2, 62])
    reset_launches()
    got = dense_optimize(*args, **kw)
    torch.cuda.synchronize()
    counts = dense_counts()
    twin = dense_optimize(*(a.cpu() for a in args), **kw)
    y_max = float(args[0].abs().max())
    err = float((got.cpu() - twin).abs().max())
    lo = _block_bounds(n, 3)[1][0]
    log(f"node blocks at d 3: second block from row {lo}, max abs err vs "
        f"the CPU run {err:.3e} (max|y| {y_max:.3e}), counts "
        f"{json.dumps(counts)}")
    if lo % 2 == 0 or err > SWEEP_REL * y_max or \
            not bool(torch.isfinite(got).all()) or \
            counts != dict(pair=12, persistent=0, persistent_sweeps=0):
        raise AssertionError(f"node blocks at d 3: err {err}, counts "
                             f"{counts}")
    return counts


def profile_launches(name, fn):
    """``torch.profiler`` over one call of ``fn`` after a warm-up: device
    time of each kernel, the window's wall and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
        if dev_us and getattr(evt, "device_type", None) is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key[:60]] = dict(ms=dev_us / 1e3, count=evt.count)
    busy = sum(v["ms"] for v in kernels.values())
    out = dict(shape=name, wall_ms=wall_ms, kernel_ms=busy,
               busy_share=busy / wall_ms, kernels=kernels)
    log(f"profile {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall_ms:.4f}); {json.dumps(kernels)}")
    return out


def profile_sweeps(inp, steps, tag):
    """The profiler over one persistent launch of ``steps`` sweeps and
    over the pair driving the same sweeps."""
    from annembed_tpu_torch.ops.dense_sweep import (
        dense_attraction_rows, dense_kick_rows, dense_sweeps)
    plan = sweep_plan(inp, steps)
    y = inp["y"].clone()
    knobs = dict(neg_weight=inp["neg_weight"],
                 neighbor_exclusion=inp.get("exclusion", True))
    lists = [t.tolist() for t in plan]

    def pair():
        for g, o, c in zip(*lists):
            a = dense_attraction_rows(y, y, 0, inp["edges"][c], inp["scale"],
                                      g, inp["b"])
            dense_kick_rows(y, a, 0, o, inp["idx_full"], inp["scale"], g,
                            inp["b"], inp["n_neg"], flat=True, out=y,
                            **knobs)

    return [profile_launches(f"{tag} persistent, {steps} sweeps",
                             lambda: dense_sweeps(
                                 y, None, inp["edges"], inp["scale"], *plan,
                                 inp["b"], inp["n_neg"], inp["idx_full"],
                                 **knobs)),
            profile_launches(f"{tag} pair, {steps} sweeps", pair)]


def phase_dense_sweep():
    """Phase 3b: the dense sweep kernels against their twins: the pair at
    phase 4's two steps, the bench's graph and one small case per knob,
    each half timed alone at the path's shapes; the persistent launch
    over a run of sweeps at the same shapes and per knob; the dispatch of
    ``dense_optimize``; profiler readings of a large-step segment and a
    first-step segment.  Returns (pair shapes, persistent shapes,
    dispatch counts, profiles)."""
    from annembed_tpu_torch.optim.dense import _segment_cap
    shapes, runs, profiles = [], [], []
    inp = sweep_inputs(SWEEP_LARGE_ROWS)
    shapes.append(check_dense_sweep("higgs_large_step", inp, reps=20,
                                    split=True))
    runs.append(check_persistent("higgs_large_step", inp,
                                 PERSISTENT_LARGE_STEPS, reps=3))
    profiles += profile_sweeps(inp, _segment_cap(SWEEP_LARGE_ROWS, 2),
                               "higgs_large_step")
    del inp
    inp = sweep_inputs(SWEEP_FIRST_ROWS)
    shapes.append(check_dense_sweep("higgs_first_step", inp, reps=50,
                                    split=True))
    runs.append(check_persistent("higgs_first_step", inp,
                                 PERSISTENT_SMALL_STEPS, reps=5))
    profiles += profile_sweeps(inp, _segment_cap(SWEEP_FIRST_ROWS, 2),
                               "higgs_first_step")
    inp = bench_sweep_inputs()
    shapes.append(check_dense_sweep("bench_graph", inp, reps=50, split=True))
    runs.append(check_persistent("bench_graph", inp, PERSISTENT_SMALL_STEPS,
                                 reps=5))
    n = SWEEP_SMALL_ROWS
    inp = sweep_inputs(n, seed=1)
    g = torch.Generator(device="cuda").manual_seed(2)
    # a node block whose partner windows wrap past n
    shapes.append(check_dense_sweep("block_wrap", dict(inp, offset=n - 97),
                                    reps=5, lo=3_001, rows=1_700))
    shapes.append(check_dense_sweep("parallel_kicks", inp, reps=5,
                                    parallel=True))
    shapes.append(check_dense_sweep(
        "mask", inp, reps=5, mask_p=0.7, mask=(torch.rand(
            (3, n), generator=g, device="cuda") < 0.7).float()))
    stale = inp["y"] + 0.1 * torch.randn(inp["y"].shape, generator=g,
                                         device="cuda")
    shapes.append(check_dense_sweep("stale", inp, reps=5, y_src=stale))
    shapes.append(check_dense_sweep("b_1.5", dict(inp, b=1.5), reps=5))
    shapes.append(check_dense_sweep("no_exclusion", inp, reps=5,
                                    exclusion=False))
    shapes.append(check_dense_sweep("d3", sweep_inputs(n, d=3, seed=3),
                                    reps=5))
    shapes.append(check_dense_sweep("d5_block", sweep_inputs(n, d=5, seed=4),
                                    reps=5, lo=11, rows=4_000,
                                    parallel=True))
    # the persistent launch per knob, compile-time instances (d 2, kg 3,
    # n_neg 5) and runtime-bound ones (n_neg 7, d 3, d 5): over many
    # sweeps only the pair is its bit-level yardstick
    small = PERSISTENT_KNOB_STEPS
    runs.append(check_persistent("parallel_kicks", inp, small, reps=3,
                                 parallel=True, exact=False))
    runs.append(check_persistent("stale", inp, small, reps=3, y_src=stale,
                                 exact=False))
    runs.append(check_persistent("b_1.5", dict(inp, b=1.5), small, reps=3,
                                 exact=False))
    runs.append(check_persistent("no_exclusion_n_neg_7",
                                 dict(inp, n_neg=7, neg_weight=None), small,
                                 reps=3, exclusion=False, exact=False))
    runs.append(check_persistent("d3", sweep_inputs(n, d=3, seed=3), small,
                                 reps=3, exact=False))
    runs.append(check_persistent("d5", sweep_inputs(n, d=5, seed=4), small,
                                 reps=3, exact=False))
    dispatch = check_dispatch()
    dispatch["n_blocks_d3"] = check_node_blocks_d3()
    return shapes, runs, dispatch, profiles


def phase_bench():
    """Phase 5: bench.py's one-step workload at 70,000 x 784.  Returns
    the dense sweep kernels' counts."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    reset_launches()
    rec, t, y, tm = bench.run(bench.N, "cuda")
    dense = dense_counts()
    log(f"bench: phases (s) {json.dumps(t)}; manifold row {json.dumps(tm)}; "
        f"top1_l2 launches={top1_launch_count()}; dense sweep launches="
        f"{json.dumps(dense)}")
    require_route("bench", dense, "persistent")
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
    return dense


def phase_dmap(at):
    """Phase 6: ``dmap_embed`` at 70,000 x 784, layer 0."""
    from annembed_tpu_torch.bench import D, N
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    x = synthetic_blobs(N, D, 42)
    reset_launches()
    t0 = time.perf_counter()
    y, info = at.dmap_embed(x, dim=2, device="cuda")
    wall = time.perf_counter() - t0
    log(f"dmap_embed: n={N} d={D} wall={wall:.2f} s info={json.dumps(info)} "
        f"top1_l2 launches={top1_launch_count()}")
    if y.shape != (N, 2) or not np.isfinite(y).all():
        raise AssertionError(f"dmap_embed output {y.shape} or non-finite")
    return y


# ``python -m annembed_tpu_torch.cli`` run by runpy, the process's kernel
# launches printed to stderr at its exit
_CLI_COUNTED = (
    "import atexit, json, runpy, sys\n"
    "from annembed_tpu_torch.ops import dense_sweep as ds, top1\n"
    "atexit.register(lambda: print('launches: ' + json.dumps(dict(\n"
    "    top1_l2=top1.launch_count(), dense_sweep=ds.launch_counts())),\n"
    "    file=sys.stderr, flush=True))\n"
    "runpy.run_module('annembed_tpu_torch.cli', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def _run_cli(args):
    """The CLI with ``args``: (its last stdout line's JSON, its kernel
    launches, wall seconds)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI_COUNTED, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[0]} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    launches = next(json.loads(line[len("launches: "):]) for line in
                    proc.stderr.splitlines() if line.startswith("launches: "))
    return json.loads(proc.stdout.strip().splitlines()[-1]), launches, wall


def _csv_rows(path: Path) -> int:
    with open(path) as f:
        return sum(1 for _ in f)


def phase_cli():
    """Phase 7: the CLI on a 20,000 x 784 csv with a '#' header.
    Returns the dense sweep kernels' counts in ``embed``."""
    from annembed_tpu_torch.bench import MIN_CLUSTER_SIZE
    from annembed_tpu_torch.io.synthetic import synthetic_clustered_manifold
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        src = d / "manifold.csv"
        np.savetxt(src, synthetic_clustered_manifold(CLI_ROWS, 784), fmt="%d",
                   delimiter=",", header="synthetic clustered manifold")
        out, launches, wall = _run_cli(
            ["embed", "--csv", str(src), "--nbng", "6", "--quality",
             "--stats", "--cluster", str(MIN_CLUSTER_SIZE), "--outfile",
             str(d / "embedded.csv"), "--device", "cuda"])
        log(f"cli embed: wall={wall:.2f} s launches {json.dumps(launches)} "
            f"{json.dumps(out)}")
        require_route("cli embed", launches["dense_sweep"], "persistent")
        keys = {"quality", "cluster", "intrinsic_dim", "intrinsic_dim_2nn",
                "hubness_skew", "hubness_hist"}
        if not keys <= set(out) or out["n"] != CLI_ROWS:
            raise AssertionError(f"cli embed printed {sorted(out)}")
        for name in ("embedded.csv", "first_dist.csv",
                     "continuity_ratio.csv", "clusters.csv"):
            rows = _csv_rows(d / name)
            if rows != CLI_ROWS:
                raise AssertionError(f"{name}: {rows} rows, not {CLI_ROWS}")
        out, _, wall = _run_cli(["dmapembed", "--csv", str(src),
                                 "--outfile", str(d / "dmap.csv"),
                                 "--device", "cuda"])
        log(f"cli dmapembed: wall={wall:.2f} s {json.dumps(out)}")
        rows = _csv_rows(d / "dmap.csv")
        if out["n"] != CLI_ROWS or rows != CLI_ROWS:
            raise AssertionError(f"cli dmapembed: n={out['n']}, {rows} rows")
    return launches["dense_sweep"]


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
    same rows on a sample.  Returns the dense sweep kernels' counts per
    metric."""
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.knn.brute import knn_search_brute
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    x = synthetic_blobs(METRIC_ROWS, METRIC_D, 5).astype(np.float32)
    prob = x / x.sum(1, keepdims=True)
    sample = np.sort(np.random.default_rng(0).choice(
        METRIC_ROWS, METRIC_SAMPLE, replace=False))
    launches = {}
    for metric in ("DistL1", "DistCosine", "DistJeffreys",
                   "DistJensenShannon"):
        data = prob if metric in ("DistJeffreys", "DistJensenShannon") else x
        reset_launches()
        t0 = time.perf_counter()
        y, info = at.embed(data, dim=2, nbng=KNN_K, distance=metric,
                           return_graph=True, device="cuda")
        wall = time.perf_counter() - t0
        launches[metric] = dense_counts()
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
            f"{bad_d} dists out of tol; top1_l2 launches={top1_launch_count()}, "
            f"dense sweep launches={json.dumps(launches[metric])}")
        if y.shape != (METRIC_ROWS, 2) or not np.isfinite(y).all():
            raise AssertionError(f"{metric}: embedding {y.shape} or "
                                 "non-finite")
        if agree < METRIC_MIN_AGREE or bad_d:
            raise AssertionError(f"{metric}: CUDA graph disagrees with the "
                                 "CPU search")
        require_route(metric, launches[metric], "persistent")
    return launches


def phase_sampling(at):
    """Phase 9: ``embed(**bench.SAMPLING_EMBED)`` with the sampling
    optimizer on the bench's two 70,000 x 784 rows.  Returns the blobs
    rows on the card for phase 10."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io.synthetic import (synthetic_blobs,
                                                 synthetic_clustered_manifold)
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    from annembed_tpu_torch.utils.native import BACKENDS
    rows = {"": synthetic_blobs(bench.N, bench.D, 42),
            "manifold_": synthetic_clustered_manifold(bench.N, bench.D)}
    for prefix, x in rows.items():
        tag = f"sampling {prefix or 'blobs_'}row"
        BACKENDS.clear()
        reset_launches()
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
            f"{top1_launch_count()}")
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
    output, one launch at least of each kernel, graph recall and label
    purity.  Returns (top-1 launches, dense sweep counts, info, y, IVF
    join launches, NN-descent rounds by route)."""
    from annembed_tpu_torch.io.synthetic import label_purity
    from annembed_tpu_torch.knn.api import sampled_exact_recall
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    n = x.shape[0]
    x_host = x.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    y, info = at.embed(
        x_host, batch=batches, knn_params=at.KnnParams(**knn),
        params=at.EmbedderParams(grad_factor=5, hubness_weighting=True),
        **HIGGS_EMBED, **extra)
    wall = time.perf_counter() - t0
    launches = top1_launch_count()
    dense = dense_counts()
    joins = join_counts()
    from annembed_tpu_torch.ops.nndescent import launch_counts as nnd_counts
    rounds = nnd_counts()
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
        f"({info['sweeps']} sweeps); top1_l2 launches={launches}, dense "
        f"sweep launches={json.dumps(dense)}, ivf_join launches={joins}, "
        f"nndescent rounds={rounds}")
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
    # every whole-array sweep through the persistent launch; every graph
    # above the brute limit through the tensor-core join kernel (d 28, k
    # 12), and none below it
    ivf = n > at.KnnParams().brute_force_limit
    require_route(tag, dense, "persistent", joins if ivf else None)
    if not ivf and sum(joins.values()):
        raise AssertionError(f"{tag}: {joins} join launches on exact graphs")
    # every NN-descent round of a graph above the brute limit on the round
    # kernel (the Higgs knobs: 168 candidates a row), none on torch
    kp = at.KnnParams(**knn)
    graphs = sum(r > kp.brute_force_limit
                 for r in (n, max(KNN_K + 1, int(round(n * FRACTION)))))
    want = graphs * kp.refine_rounds if knn == HIGGS_KNN else 0
    if rounds != {"kernel": want, "torch": 0}:
        raise AssertionError(f"{tag}: NN-descent rounds {rounds}, not "
                             f"{want} on the kernel")
    if dense["persistent_sweeps"] != first["sweeps"] + info["sweeps"]:
        raise AssertionError(f"{tag}: {dense['persistent_sweeps']} sweeps "
                             f"in persistent launches, not "
                             f"{first['sweeps']} + {info['sweeps']}")
    if recall < min_recall:
        raise AssertionError(f"{tag}: recall@{KNN_K} {recall} < {min_recall}")
    if purity < MIN_PURITY:
        raise AssertionError(f"{tag}: label purity {purity} < {MIN_PURITY}")
    return launches, dense, info, y, joins, rounds


def rank_checksum(t: torch.Tensor) -> int:
    """An order-sensitive checksum of a float32 tensor's bits: the int32
    words weighted by their position, summed mod 2^64 (integer sums do
    not depend on the reduction order)."""
    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    pos = torch.arange(1, bits.numel() + 1, device=t.device) % 1_000_003
    return int((bits * pos).sum())


def checksums_agree(sums) -> bool:
    """Every rank's checksum equals rank 0's."""
    return len(sums) > 0 and all(c == sums[0] for c in sums)


def within_band(value: float, ref: float, band: float) -> bool:
    return abs(value - ref) <= band


def graph_agreement(got_i, got_d, want_i, want_d):
    """(share of equal ids on the columns outside near-ties, rows that
    differ anywhere, largest relative distance difference where the ids
    agree) of two (n, k) graphs on the host."""
    clear = torch.from_numpy(_clear_ties(want_d.numpy()))
    same = got_i == want_i
    agree = float(same[clear].float().mean()) if bool(clear.any()) else 1.0
    rows = int((~same).any(1).sum())
    rel = ((got_d - want_d).abs() / want_d.abs().clamp_min(1e-30))[same]
    return agree, rows, float(rel.max()) if rel.numel() else 0.0


def rows_bit_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape and the same f32 bits in every entry."""
    return got.shape == want.shape and bool(torch.equal(got, want))


def frac_within_band(full: float, sampled: float) -> bool:
    """Phase 13: the full fraction's frac_without_match against phase 4's
    sampled reading of the same embedding."""
    return within_band(full, sampled, FULL_FRAC_ABS)


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
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    est = at.quality_estimate(graph, y, nbng=QUALITY_NBNG,
                              radius_k=QUALITY_NBNG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    frac = est.frac_without_match
    log(f"full quality: n={N_ROWS} nbng={QUALITY_NBNG} wall={wall:.2f} s "
        f"peak_mem={peak:.2f} GiB top1_l2 launches={top1_launch_count()}; "
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
    """The parts of the IVF build against exact search on the card.
    Returns the 3-D embedding, its graph (on the host) and the IVF
    route's full-fraction frac_without_match, for phase 15, the dense
    sweep kernel's launches in the embedding and the IVF join kernel's
    launches of each part, each required."""
    from annembed_tpu_torch.graph.kgraph import KGraph
    from annembed_tpu_torch.knn.api import build_kgraph, sampled_exact_recall
    from annembed_tpu_torch.knn.ivf import knn_graph_ivf
    from annembed_tpu_torch.utils.profiling import PhaseTimer
    dev = x.device
    joins = {}
    xp = x[:PARTS_ROWS].contiguous()
    for dtype in ("float32", "bfloat16"):
        before = join_counts()
        timer = PhaseTimer()
        t0 = time.perf_counter()
        g = build_kgraph(xp, KNN_K, params=at.KnnParams(knbn=KNN_K,
                                                        dtype=dtype),
                         timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recall = sampled_exact_recall(xp, g, sample=2000)
        joins[f"graph_1m_{dtype}"] = join_since(before)
        log(f"parts: IVF + NN-descent graph, {PARTS_ROWS} x {x.shape[1]}, "
            f"{dtype}, default knobs: {wall:.2f} s "
            f"{json.dumps(timer.timings)} recall@{KNN_K}={recall:.4f} "
            f"ivf_join launches={joins[f'graph_1m_{dtype}']}")
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
    before = join_counts()
    t0 = time.perf_counter()
    gi, gd = knn_graph_ivf(cloud, GRID_K, quantizer="grid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joins["grid_1m"] = join_since(before)
    recall = sampled_exact_recall(cloud, KGraph(indices=gi, dists=gd),
                                  sample=2000)
    log(f"parts: grid quantizer, {PARTS_ROWS} x 2, k={GRID_K}: {wall:.2f} s "
        f"recall@{GRID_K}={recall:.4f} ivf_join launches={joins['grid_1m']}")
    if recall < MIN_RECALL_GRID or not torch.isfinite(gd).all():
        raise AssertionError(f"grid recall {recall} < {MIN_RECALL_GRID} or "
                             "non-finite distances")
    del cloud, gi, gd
    # the full-fraction quality estimate of a 3-D embedding above the
    # limit: its radius through the IVF rebuild, against the exact search
    reset_launches()
    y3, info = at.embed(x[:QUALITY_ROWS].cpu().numpy(), dim=3, nbng=KNN_K,
                        batch=5, seed=SEED, return_graph=True, device="cuda")
    dense = dense_counts()
    joins["embed_300k"] = join_counts()
    log(f"parts: {QUALITY_ROWS} x 3 embedding, {info['sweeps']} sweeps, "
        f"dense sweep launches={json.dumps(dense)}, ivf_join launches="
        f"{joins['embed_300k']}")
    require_route("parts 3-D embedding", dense, "persistent")
    y3 = torch.from_numpy(y3).to(dev)
    out = {}
    for name, limit in (("ivf", at.KnnParams().brute_force_limit),
                        ("exact", QUALITY_ROWS)):
        before = join_counts()
        t0 = time.perf_counter()
        q = at.quality_estimate(
            info["kgraph"], y3, nbng=QUALITY_NBNG,
            knn_params=at.KnnParams(knbn=KNN_K, brute_force_limit=limit))
        torch.cuda.synchronize()
        out[name] = (q.nb_without_match, q.mean_nb_matched,
                     time.perf_counter() - t0, q.frac_without_match)
        joins[f"quality_{name}"] = join_since(before)
    rel = abs(out["ivf"][0] - out["exact"][0]) / max(out["exact"][0], 1)
    log(f"parts: quality at full fraction, {QUALITY_ROWS} x 3, nbng "
        f"{QUALITY_NBNG}: IVF radius no_match {out['ivf'][0]} mean_matched "
        f"{out['ivf'][1]:.4f} in {out['ivf'][2]:.2f} s; exact radius no_match "
        f"{out['exact'][0]} mean_matched {out['exact'][1]:.4f} in "
        f"{out['exact'][2]:.2f} s; relative difference {rel:.4f}; ivf_join "
        f"launches {json.dumps(joins)}")
    # each IVF build through the kernel the rule gives its shape: the 1M
    # x 28 graphs and the 300k embedding's own (k 12) the tensor cores,
    # the grid's 1M x 2 and the quality radius's rebuild (d 3, k 51) the
    # SIMT kernel; the exact radius neither
    if sum(joins["quality_exact"].values()):
        raise AssertionError(f"parts: IVF join launches {joins}: the exact "
                             "radius must launch no join kernel")
    for part, route in (("graph_1m_float32", "tc"),
                        ("graph_1m_bfloat16", "tc"), ("embed_300k", "tc"),
                        ("grid_1m", "simt"), ("quality_ivf", "simt")):
        require_join_route(f"parts {part}", joins[part], route)
    if rel > QUALITY_NO_MATCH_REL:
        raise AssertionError(f"quality no_match through the IVF radius "
                             f"differs by {rel:.4f} > {QUALITY_NO_MATCH_REL}")
    g3 = info["kgraph"]
    return (y3.cpu(), (g3.indices.cpu(), g3.dists.cpu()), out["ivf"][3],
            dense, joins)


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
            and port["top1_l2_launches"] == 0
            and not sum(port["ivf_join_counts"].values())
            and port["dense_sweep_launches"] == 0)


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
    top-1, dense sweep and IVF join launches."""
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
        f"{again['wall_s']} s, launches {port2['top1_l2_launches']}; dense "
        f"sweep launches {json.dumps(port['dense_sweep_counts'])}; ivf_join "
        f"launches {port['ivf_join_counts']}")
    if y.shape != (N_ROWS, 2) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"harness embedding {tuple(y.shape)} or "
                             "non-finite")
    if port["top1_l2_launches"] < 1:
        raise AssertionError("the harness never launched top1_l2")
    require_route("harness", port["dense_sweep_counts"], "persistent",
                  port["ivf_join_counts"])
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
    return (port["top1_l2_launches"], port["dense_sweep_counts"],
            port["ivf_join_counts"])


def phase_knobs_io(at):
    """Phase 12: ``embed(**bench.KNOB_EMBED)`` on the bench's blobs rows
    with each dense knob, held to the JAX package's no_match; a
    ``trace_dir`` capture; the rows through gzip IDX files and back; a
    neighbourhood's BSON from the card against the CPU's.  Returns the
    dense sweep kernels' counts per knob (none on the row-major scatter
    path, which runs torch ops)."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io import mnist_io, ripser
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.ops.top1 import top1_l2
    x = synthetic_blobs(bench.N, bench.D, 42).astype(np.float32)
    off, launches = {}, {}
    for knob, kw in bench.DENSE_KNOBS.items():
        reset_launches()
        t0 = time.perf_counter()
        y, info = at.embed(x, params=at.EmbedderParams(**kw), device="cuda",
                           **bench.KNOB_EMBED)
        wall = time.perf_counter() - t0
        launches[knob] = dense_counts()
        no_match = int(info["quality"]["nb_without_match"])
        want = JAX_KNOB_NO_MATCH[knob]
        rel = abs(no_match - want) / want
        log(f"knob {knob} {json.dumps(kw)}: wall {wall:.2f} s, optimize "
            f"{info['optimize_time']:.3f} s ({info['sweeps']} sweeps); "
            f"no_match {no_match} vs JAX {want} ({rel:.4f} relative); "
            f"mean_matched {info['quality']['mean_nb_matched']:.4f}; dense "
            f"sweep launches {json.dumps(launches[knob])}")
        if y.shape != (bench.N, 2) or not np.isfinite(y).all():
            raise AssertionError(f"knob {knob}: {y.shape} or non-finite")
        # node blocks through the pair, the row-major path on torch ops,
        # every other knob through the persistent launch
        require_route(f"knob {knob}", launches[knob],
                      None if not kw.get("dense_scatter_free", True) else
                      "pair" if kw.get("dense_n_blocks", 1) > 1 else
                      "persistent")
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
    return launches


def _mesh_rank(mesh, rows_path, y3, g3):
    """Phase 15 on one rank: (a)-(d) under ``mesh``, each part timed,
    launch counts from 0, the peak memory of the rank; the results the
    parent checks come back from rank 0, the checksums from all."""
    import annembed_tpu_torch as at
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
    from annembed_tpu_torch.parallel.launch import load_rows
    dev = mesh.device
    out = {"rank": mesh.rank, "device": str(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    # (a) the hierarchical path at phase 4's operating point
    reset_launches()
    t0 = time.perf_counter()
    y, info = at.embed(
        load_rows(rows_path), batch=MAIN_BATCHES,
        knn_params=at.KnnParams(**HIGGS_KNN),
        params=at.EmbedderParams(grad_factor=5, hubness_weighting=True),
        with_quality=True, quality_fraction=QUALITY_FRACTION,
        quality_nbng=QUALITY_NBNG, mesh=mesh,
        **{k: v for k, v in HIGGS_EMBED.items() if k != "device"})
    out["a_wall"] = time.perf_counter() - t0
    out["a_launches"] = top1_launch_count()
    out["a_dense"] = dense_counts()
    out["a_joins"] = join_counts()
    out["a_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    mine = torch.tensor([rank_checksum(torch.from_numpy(y).to(dev))],
                        dtype=torch.int64, device=dev)
    out["a_checksums"] = mesh.all_gather_rows(mine).tolist()
    g = info.pop("kgraph")
    if mesh.rank == 0:
        out.update(a_y=y, a_info=info,
                   a_graph=(g.indices.cpu(), g.dists.cpu()))
    del y, g
    torch.cuda.empty_cache()
    # (b) the bench's one-step workload, sharded
    reset_launches()
    t0 = time.perf_counter()
    rec, t, yb, _ = bench.run(bench.N, mesh=mesh)
    out["b_wall"] = time.perf_counter() - t0
    out["b_dense"] = dense_counts()
    out["b_rec"], out["b_phases"] = rec, t
    out["b_finite"] = bool(torch.isfinite(yb).all()) and \
        tuple(yb.shape) == (bench.N, 2)
    # (c) dmap_embed
    t0 = time.perf_counter()
    yd, _ = at.dmap_embed(synthetic_blobs(bench.N, bench.D, 42), dim=2,
                          mesh=mesh)
    out["c_wall"] = time.perf_counter() - t0
    if mesh.rank == 0:
        out["c_y"] = yd
    # (d) the full-fraction quality estimate through the sharded rebuild
    reset_launches()
    t0 = time.perf_counter()
    q = at.quality_estimate(at.KGraph(indices=g3[0].to(dev),
                                      dists=g3[1].to(dev)),
                            y3.to(dev), nbng=QUALITY_NBNG,
                            knn_params=at.KnnParams(knbn=KNN_K), mesh=mesh)
    out["d_wall"] = time.perf_counter() - t0
    out["d_frac"], out["d_search"] = q.frac_without_match, q.radius_search
    out["d_joins"] = join_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def phase_mesh(at, rows_path, labels, graph4, frac_s1, y3, g3, frac3,
               y_dmap):
    """Phase 15: the sharded path on every card, held to the single
    device's readings of phases 4, 5, 6 and 4's parts.  Returns the
    ranks' top1_l2 launch counts in (a), their dense sweep kernel's
    launches in (a) and (b) and their IVF join kernel's in (a) and
    (d)."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io.synthetic import label_purity
    from annembed_tpu_torch.knn.api import sampled_exact_recall
    from annembed_tpu_torch.parallel.launch import load_rows, run_on_ranks
    w = torch.cuda.device_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = run_on_ranks(_mesh_rank, w, (rows_path, y3, g3), device="cuda")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    info = r0["a_info"]
    first = info["first_step"]
    rest = info["total_time"] - (info["graph_build_time"]
                                 + first["init_time"]
                                 + first["optimize_time"]
                                 + info["optimize_time"])
    log(f"mesh: W={w} ranks over NCCL, {wall:.2f} s with the launch; per "
        f"rank (a) {[round(r['a_wall'], 2) for r in ranks]} s, (b) "
        f"{[round(r['b_wall'], 2) for r in ranks]} s, (c) "
        f"{[round(r['c_wall'], 2) for r in ranks]} s, (d) "
        f"{[round(r['d_wall'], 2) for r in ranks]} s; peak memory (a) "
        f"{[round(r['a_peak_gib'], 2) for r in ranks]} GiB, all "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB")
    log(f"mesh (a): n={N_ROWS} W={w} graph_build="
        f"{info['graph_build_time']:.2f} s first_init={first['init_time']:.2f}"
        f" s first_optimize={first['optimize_time']:.2f} s large_optimize="
        f"{info['optimize_time']:.2f} s ({info['sweeps']} sweeps, "
        f"{1e3 * info['optimize_time'] / max(info['sweeps'], 1):.3f} ms a "
        f"sweep) rest={rest:.2f} s total={info['total_time']:.2f} s; "
        f"n_devices={info['n_devices']}")
    log(f"mesh (a): graph build phases (s) "
        f"{json.dumps(info['graph_build_phases'])}")
    y = torch.from_numpy(r0["a_y"]).to("cuda")
    x = torch.from_numpy(np.ascontiguousarray(load_rows(rows_path))).to("cuda")
    gi, gd = r0["a_graph"]
    recall = sampled_exact_recall(x, at.KGraph(indices=gi.to("cuda"),
                                               dists=gd.to("cuda")),
                                  sample=2000)
    del x
    purity = label_purity(y, labels, k=KNN_K)
    agree, rows, d_rel = graph_agreement(gi, gd, *graph4)
    frac = info["quality"]["frac_without_match"]
    launches = [r["a_launches"] for r in ranks]
    dense = {"a": [r["a_dense"] for r in ranks],
             "b": [r["b_dense"] for r in ranks]}
    joins = {"a": [r["a_joins"] for r in ranks],
             "d": [r["d_joins"] for r in ranks]}
    sums = [r["a_checksums"] for r in ranks]
    log(f"mesh (a): recall@{KNN_K}={recall:.4f} purity={purity:.4f}; large "
        f"graph vs phase 4's: {agree:.6f} of the clear columns equal, {rows} "
        f"rows differ, largest relative distance difference {d_rel:.3e}; "
        f"frac_without_match {frac} vs phase 4's {frac_s1} ({frac - frac_s1:+.5f}"
        f", band +-{MESH_FRAC_ABS}); embedding checksums {sums[0]} (every "
        f"rank's gather equal: {all(s == sums[0] for s in sums)}); top1_l2 "
        f"launches {launches}; dense sweep launches (a) {dense['a']}, (b) "
        f"{dense['b']}; ivf_join launches (a) {joins['a']}, (d) "
        f"{joins['d']}")
    if tuple(y.shape) != (N_ROWS, 2) or not bool(torch.isfinite(y).all()):
        raise AssertionError("mesh (a): embedding shape or non-finite")
    if recall < MIN_RECALL_IVF or purity < MIN_PURITY:
        raise AssertionError(f"mesh (a): recall {recall} or purity {purity}")
    if agree < MESH_GRAPH_AGREE or d_rel > MESH_GRAPH_D_REL:
        raise AssertionError(f"mesh (a): graph differs from phase 4's "
                             f"({agree}, {d_rel})")
    if not checksums_agree(sums[0]) or any(s != sums[0] for s in sums):
        raise AssertionError(f"mesh (a): ranks' embeddings differ {sums}")
    if not within_band(frac, frac_s1, MESH_FRAC_ABS):
        raise AssertionError(f"mesh (a): frac_without_match {frac} vs "
                             f"{frac_s1}")
    for part in ("a", "b"):
        for rank, counts in enumerate(dense[part]):
            require_route(f"mesh ({part}) rank {rank}", counts, "pair",
                          joins["a"][rank] if part == "a" else None)
    if min(launches) < 1 or info["n_devices"] != w:
        raise AssertionError(f"mesh (a): launches {launches}, dense {dense}, "
                             f"n_devices {info['n_devices']}")
    # (b)
    rec = r0["b_rec"]
    rel = abs(rec["no_match"] - JAX_NO_MATCH) / JAX_NO_MATCH
    diff = abs(rec["manifold_mean_matched"] - JAX_MANIFOLD_MEAN_MATCHED)
    log(f"mesh (b): bench phases (s) {json.dumps(r0['b_phases'])}; "
        f"{json.dumps(rec)}; no_match vs JAX {rel:.4f} relative, manifold "
        f"mean_matched {diff:.4f}")
    if not all(r["b_finite"] for r in ranks) or \
            rec["recall"] < BENCH_MIN_RECALL or rel > NO_MATCH_REL or \
            diff > MANIFOLD_MATCHED_ABS:
        raise AssertionError("mesh (b): the sharded bench is off phase 5's "
                             "JAX constants")
    # (c)
    yd = r0["c_y"]
    sign = np.sign((yd * y_dmap).sum(0))
    dmap_err = float(np.abs(yd * sign - y_dmap).max())
    log(f"mesh (c): dmap_embed {yd.shape} vs phase 6's, up to sign: max "
        f"abs difference {dmap_err:.3e} (coordinates up to "
        f"{float(np.abs(y_dmap).max()):.3e})")
    if yd.shape != y_dmap.shape or dmap_err > MESH_DMAP_ATOL:
        raise AssertionError(f"mesh (c): dmap differs by {dmap_err}")
    # (d)
    fracs = [r["d_frac"] for r in ranks]
    log(f"mesh (d): full-fraction quality of the {QUALITY_ROWS} x 3 "
        f"embedding, radius {json.dumps(r0['d_search'])}: "
        f"frac_without_match {fracs} vs the single device's {frac3}")
    for rank, counts in enumerate(joins["d"]):
        require_join_route(f"mesh (d) rank {rank}", counts, "simt")
    if r0["d_search"]["route"] != "ivf" or any(
            not within_band(f, frac3, MESH_FULL_FRAC_ABS) for f in fracs):
        raise AssertionError("mesh (d): the sharded rebuild's estimate is "
                             "off the single device's")
    if w > 1:
        phase_mesh_entry(at, w)
    return launches, dense, joins


def phase_mesh_entry(at, w):
    """Phase 15 with W > 1: the bench's blobs rows through
    ``embed(n_devices=W)`` from this process (the package spawns the
    ranks), at the bench's schedule."""
    from annembed_tpu_torch import bench
    from annembed_tpu_torch.io.synthetic import synthetic_blobs
    x = synthetic_blobs(bench.N, bench.D, 42)
    t0 = time.perf_counter()
    y, info = at.embed(
        x, dim=2, nbng=bench.KNBN, batch=sum(b for b, _ in bench.SCHEDULE),
        params=at.EmbedderParams(n_sub_schedule=bench.SCHEDULE,
                                 dense_neighbor_exclusion=False),
        with_quality=True, quality_nbng=50, quality_radius_compat=125,
        n_devices=w, device="cuda")
    log(f"mesh entry: embed(n_devices={w}) on the bench's blobs rows in "
        f"{time.perf_counter() - t0:.2f} s (spawn included); n_devices "
        f"{info['n_devices']}, {info['sweeps']} sweeps; quality (not held) "
        f"{json.dumps(info['quality'])}")
    if info["n_devices"] != w or y.shape != (bench.N, 2) or \
            not np.isfinite(y).all():
        raise AssertionError("mesh entry: wrong n_devices, shape or values")


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
    from annembed_tpu_torch.parallel.launch import save_rows
    disable_tf32()

    # phase 2: build the kernels from this checkout's sources, one nvcc
    # each, all started together
    t0 = time.perf_counter()
    _build.build_libraries(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        _build.load_library(name)
        log(f"build: {name}.cu -> {_build.library_path(name)}; ptxas:\n"
            f"{_build.build_log(name).strip()}")
    log(f"build: {time.perf_counter() - t0:.2f} s")

    # phase 3: kernel against twin and library at the path's shapes
    t0 = time.perf_counter()
    x_np, labels = synthetic_higgs(N_ROWS, seed=SEED, return_labels=True)
    x_np = zscore(x_np)
    # phase 15's ranks memory-map the rows from a file
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    rows_path = save_rows(x_np, work.name)
    x = torch.from_numpy(x_np).to(dev)
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
    t0 = time.perf_counter()
    sweep_shapes, persistent_runs, dispatch, profiles = phase_dense_sweep()
    log(f"phase 3b (dense sweep kernel): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    join_shapes = phase_join(x)
    torch.cuda.empty_cache()
    log(f"phase 3c (IVF join kernel): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    round_shapes = phase_nndescent(x)
    torch.cuda.empty_cache()
    log(f"phase 3d (NN-descent round kernel): "
        f"{time.perf_counter() - t0:.2f} s")

    # phase 4: the main path at full size, then the exact hierarchical
    # path at a smaller depth, then the parts of the IVF build
    t0 = time.perf_counter()
    (launches, main_dense, main_info, y, main_joins,
     main_rounds) = _hierarchical(
        at, x, labels, MAIN_BATCHES, HIGGS_KNN, MIN_RECALL_IVF, "main path",
        with_quality=True, quality_fraction=QUALITY_FRACTION,
        quality_nbng=QUALITY_NBNG)
    search = at.quality_estimate.last_radius_search
    log(f"phase 4 (main path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    y = torch.from_numpy(y).to(dev)
    graph = main_info.pop("kgraph")
    # phase 15 holds its large graph to this one
    graph4 = (graph.indices.cpu(), graph.dists.cpu())
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
    exact_launches, exact_dense, _, _, exact_joins, _ = _hierarchical(
        at, x[:EXACT_ROWS].contiguous(), labels[:EXACT_ROWS], EXACT_BATCHES,
        dict(knbn=KNN_K), MIN_RECALL, "exact path")
    log(f"phase 4 (exact path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    y3, g3, frac3, parts_dense, parts_joins = phase_parts(at, x)
    log(f"phase 4 (parts): {time.perf_counter() - t0:.2f} s")
    del x
    torch.cuda.empty_cache()

    bench_dense = phase_bench()
    y_dmap = phase_dmap(at)
    cli_dense = phase_cli()
    metric_dense = phase_metrics(at)
    t0 = time.perf_counter()
    blobs = phase_sampling(at)
    log(f"phase 9 (sampling path): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_estimators(at, blobs)
    log(f"phase 10 (estimators): {time.perf_counter() - t0:.2f} s")
    del blobs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    harness_launches, harness_dense, harness_joins = phase_harness(
        labels, frac_s1)
    log(f"phase 11 (harness): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    knob_dense = phase_knobs_io(at)
    log(f"phase 12 (dense knobs, IO): {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches, mesh_dense, mesh_joins = phase_mesh(
        at, rows_path, labels, graph4, frac_s1, y3, g3, frac3, y_dmap)
    work.cleanup()
    log(f"phase 15 (mesh of {torch.cuda.device_count()}): "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"chip_smoke: {time.perf_counter() - t_start:.2f} s")

    # the top-level numbers are those of the main path's shape (phase 4's
    # projection, 11M x 440k x 28: the library and the twin timed once
    # each); every shape of phase 3 is in "shapes"
    path_launches = {"higgs_11m": launches, "exact_200k": exact_launches,
                     "slice_1m": None, "bench_rows": None, "ragged": None}
    top1 = {
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
        "mesh_launches_by_rank": mesh_launches,
        "shapes": [dict(s, launches=path_launches[s["shape"]])
                   for s in shapes]}
    # the dense sweep's numbers are those of phase 4's large step (one
    # sweep of 11M rows).  Every whole-array sweep of phase 4's path runs
    # in the persistent launch, so the main path launches no pair; the
    # pair's own path is the node blocks, and its "launches" (both halves
    # of every sweep) are those of phase 12's dense_n_blocks run, counts
    # set to 0 just before it and read just after.  Every path's counts
    # are in launches_by_path, every mesh rank's in mesh_launches_by_rank
    large, large_run = sweep_shapes[0], persistent_runs[0]
    by_path = {
        "main_path": main_dense, "exact_path": exact_dense,
        "parts_3d": parts_dense, "bench": bench_dense, "cli": cli_dense,
        "metrics": metric_dense, "harness": harness_dense,
        "knobs": knob_dense, "dispatch": dispatch}
    sweep = {
        "name": "dense_sweep", "route": "cuda",
        "source": "annembed_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "annembed_tpu/optim/dense.py:272,406",
        "replaces_note": "an XLA fusion of jnp code; the JAX package has "
                         "no Pallas kernel for the sweep",
        "launches": knob_dense["n_blocks"]["pair"],
        "launches_path": "phase 12: embed(dense_n_blocks=2) on the "
                         "bench's blobs rows",
        "main_path_launches": main_dense["pair"],
        "max_abs_err": large["max_abs_err"],
        "ms": large["ms"], "plain_ms": large["twin_ms"],
        "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
        "library_ms": None,
        "attraction_ms": large["attraction_ms"],
        "kick_ms": large["kick_ms"],
        "launches_by_path": by_path,
        "mesh_launches_by_rank": mesh_dense,
        "shapes": sweep_shapes}
    persistent = {
        "name": "dense_sweeps", "route": "cuda",
        "source": "annembed_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "annembed_tpu/optim/dense.py:272,406",
        "replaces_note": "a run of whole-array sweeps in one cooperative "
                         "launch; ms, plain_ms and bound_ms a sweep",
        "launches": main_dense["persistent"],
        "sweeps": main_dense["persistent_sweeps"],
        "max_abs_err": large_run["max_abs_err"],
        "ms": large_run["ms"], "plain_ms": large["twin_ms"],
        "pair_ms": large_run["pair_ms"],
        "bound_ms": large_run["bound_ms"],
        "bound_by": large_run["bound_by"], "library_ms": None,
        "shapes": persistent_runs, "profiles": profiles}
    # each join kernel's numbers at the shape of its path: the tensor-core
    # kernel at phase 4's large-graph join (all 11M rows, bf16, k 12,
    # nprobe 24; the twin timed once) with the main path's launches (both
    # graphs); the SIMT kernel, which the main path no longer launches,
    # at the quality radius's IVF rebuild (300,000 x 3, k 51) with the
    # launches of that rebuild alone (the parts' quality_ivf run, counts
    # read just before it and just after).  Every path's launches in
    # launches_by_path, every shape in "shapes" with the kernel's own
    # record there (null where it does not serve the shape)

    def join_entry(name, route, shape, launches, path):
        rec = shape["routes"][route]
        return {
            "name": name, "route": "cuda",
            "source": f"annembed_tpu_torch/csrc/{name}.cu",
            "replaces": "annembed_tpu/knn/ivf.py:159",
            "replaces_note": "an XLA lax.map of jnp code (:159-230, "
                             "_ivf_join_sorted); the JAX package has no "
                             "Pallas kernel for the join; no single PyTorch "
                             "call computes it",
            "launches": launches, "launches_path": path,
            "main_path_launches": main_joins[route],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": shape["twin_ms"],
            "bound_ms": shape["bound_ms"], "bound_by": shape["bound_by"],
            "select_ms": shape["select_ms"], "library_ms": None,
            "at_shape": shape["shape"],
            "launches_by_path": {
                "main_path": main_joins[route],
                "exact_path": exact_joins[route],
                "parts": {part: c[route] for part, c in parts_joins.items()},
                "harness": harness_joins[route]},
            "mesh_launches_by_rank": {part: [c[route] for c in ranks]
                                      for part, ranks in mesh_joins.items()},
            "shapes": [dict({key: v for key, v in sh.items()
                             if key != "routes"},
                            kernel=sh["routes"].get(route))
                       for sh in join_shapes]}
    join_tc = join_entry("ivf_join_tc", "tc", join_shapes[0],
                         main_joins["tc"], "phase 4: the main path")
    join_simt = join_entry("ivf_join", "simt", join_shapes[-1],
                           parts_joins["quality_ivf"]["simt"],
                           "parts: the full-fraction quality estimate's "
                           "IVF radius rebuild, 300,000 x 3, k 51")
    main_round = round_shapes[0]
    nndescent = {
        "name": "nndescent", "route": "cuda",
        "source": "annembed_tpu_torch/csrc/nndescent.cu",
        "replaces": "annembed_tpu/knn/nndescent.py:87",
        "replaces_note": "XLA code (:87-165, _nndescent_slab); the JAX "
                         "package has no Pallas kernel for the round; no "
                         "single PyTorch call computes it",
        "main_path_rounds": main_rounds,
        "ms": main_round["ms"], "plain_ms": main_round["twin_ms"],
        "bound_ms": main_round["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "at_shape": main_round["shape"],
        "shapes": round_shapes}
    log(json.dumps({"kernels": [top1, sweep, persistent, join_tc,
                                join_simt, nndescent]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
