"""Higgs 11M x 28 harness on the port (reference examples/higgs.rs).

    python -m annembed_tpu_torch.examples.higgs --synthetic 11000000 \\
        --quality --json [--device cuda]

Port of examples/higgs.py, with its flags and defaults, plus
``--device``.  Flow: the csv rows (``--csv``; the label column dropped)
or synthetic 28-d rows, z-scored -> IVF kNN graph with rho-sampled
NN-descent -> hierarchical two-level embedding (``embed(layer=1)``) ->
quality at nbng 100 with the compat radius 250.  ``--graph-cache`` saves
the projection right after the build and loads it on a rerun;
``--embed-cache`` saves the embedding after the optimize phase and a
rerun resumes straight into quality; ``--data-cache`` keeps the z-scored
rows (.npy).  Large-phase defaults are the JAX package's tuned point
(batch 60, n_sub 120, schedule 40x60,20x120); the reference's own point
is ``--batch 40 --n-sub 60``.

The last stdout line has the keys of the JAX harness's record
(phase times, the steps' optimizer fields, build-graph recall@k on
sampled rows, the quality summary).  The port's own fields
(``graph_build_phases``, ``projection_distance_quantiles``,
``checkpoints`` with the cache load and save seconds, the top-1
kernel's launches, the quality radius search's route, seconds and
certificate fallbacks, peak host and device memory) go to stderr as
one line starting ``port:``.

The JAX harness's channel-preflight watchdog (a thread that exits the
process when the TPU runtime's first readback stalls) guards a TPU
runtime fault and is not ported.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import sys
import time

import numpy as np
import torch

import annembed_tpu_torch as at
from annembed_tpu_torch.io.csv_io import (get_toembed_from_csv,
                                          write_csv_array2)
from annembed_tpu_torch.io.synthetic import (synthetic_clustered_manifold,
                                             synthetic_higgs)
from annembed_tpu_torch.knn.api import sampled_exact_recall
from annembed_tpu_torch.ops.top1 import top1_l2

#: ``info`` fields the JAX harness's record does not carry
PORT_ONLY = ("graph_build_phases", "projection_distance_quantiles",
             "checkpoints")


def parse_schedule(spec, batch=None, n_sub=None):
    """'30x60,30x120' -> ((30, 60), (30, 120)); None/''/'none' -> None.

    'auto' is the tuned coarse->fine recipe ((40, 60), (20, 120)) when
    batch/n_sub are at the harness defaults (60/120), else flat, so
    explicit operating-point flags are never reshaped."""
    if spec == "auto":
        return (((40, 60), (20, 120))
                if (batch, n_sub) == (60, 120) else None)
    if not spec or spec == "none":
        return None
    return tuple(tuple(int(v) for v in part.split("x"))
                 for part in spec.split(","))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "annembed_tpu_torch.examples.higgs",
        description="Higgs harness: hierarchical embed + quality")
    ap.add_argument("--csv", default=None, help="HIGGS.csv path")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic 28-dim rows instead")
    ap.add_argument("--manifold", action="store_true",
                    help="with --synthetic: the intrinsic-dim-2 clustered "
                         "manifold (io/synthetic.py) instead of the 8-d "
                         "latent blobs, which a 2-d embedding cannot "
                         "conserve")
    ap.add_argument("--sampling", type=float, default=1.0)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--nbng", type=int, default=6)
    ap.add_argument("--fraction", type=float, default=0.04,
                    help="hierarchical subsample fraction (~HNSW layer>=1)")
    ap.add_argument("--graph-cache", default=None,
                    help="npz path: the projection, saved right after the "
                         "build; an existing file is loaded instead")
    ap.add_argument("--embed-cache", default=None,
                    help="npz path: the embedding, saved after the "
                         "optimize phase; an existing file resumes "
                         "straight into quality")
    ap.add_argument("--data-cache", default=None,
                    help="npy path: save/load the z-scored rows")
    ap.add_argument("--svd-n-iter", type=int, default=5,
                    help="dmap spectral subspace iterations (reference 5, "
                         "graphlaplace.rs:115)")
    ap.add_argument("--dmap", action="store_true",
                    help="diffusion-maps variant (dim=5, alfa=1, beta=0, "
                         "gnbn=8; higgs.rs:488-502)")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--quality-nbng", type=int, default=100,
                    help="embedded neighbourhood size (the reference's "
                         "Higgs table uses 100)")
    ap.add_argument("--quality-radius-compat", type=int, default=250,
                    help="also report conservation at this radius_k "
                         "(0 = off)")
    ap.add_argument("--quality-fraction", type=float, default=0.0,
                    help="query-node subsample for the quality estimate; "
                         "0 = auto (min(1, 200k/n))")
    ap.add_argument("--recall-sample", type=int, default=2000,
                    help="rows for the build-graph recall check (0 = skip)")
    ap.add_argument("--batch", type=int, default=60,
                    help="large-phase gradient batches (reference point 40, "
                         "higgs.rs:204-242)")
    ap.add_argument("--n-sub", type=int, default=120,
                    help="dense-optimizer sub-sweeps per batch")
    ap.add_argument("--n-blocks", type=int, default=1,
                    help="node-block sub-sweeps (dense_n_blocks)")
    ap.add_argument("--schedule", default="auto",
                    help="n_sub schedule 'NBxS,NBxS,...' summing to "
                         "--batch; 'auto' = 40x60,20x120 at the default "
                         "--batch/--n-sub, else flat; 'none' = flat")
    ap.add_argument("--nprobe", type=int, default=24,
                    help="IVF cells probed per query")
    ap.add_argument("--refine-rounds", type=int, default=4)
    ap.add_argument("--rho", type=float, default=0.5,
                    help="NN-descent candidate sampling fraction")
    ap.add_argument("--optimizer", default="dense",
                    choices=["dense", "sampling"],
                    help="CE optimizer: the dense sweeps or the "
                         "reference's negative-sampling SGD")
    ap.add_argument("--no-exclusion", action="store_true",
                    help="skip the negative-sample neighbour-rejection "
                         "test (dense_neighbor_exclusion=False)")
    ap.add_argument("--parallel-kicks", action="store_true",
                    help="stacked repulsion kicks (dense_parallel_kicks)")
    ap.add_argument("--gather-reuse", type=int, default=1,
                    help="reuse one neighbour gather for S consecutive "
                         "sweeps (dense_gather_reuse)")
    ap.add_argument("--gather-reuse-after", type=float, default=0.0,
                    help="fraction of the batch schedule run exact before "
                         "the stale gather starts")
    ap.add_argument("--packed-gather", action="store_true",
                    help="dense_packed_gather (accepted; the port's gather "
                         "is the same either way)")
    ap.add_argument("--json", action="store_true",
                    help="accepted, as the JAX harness does: the result "
                         "line is always printed")
    ap.add_argument("--out", default="higgs_embedded.csv",
                    help="csv of the embedding ('none' = skip; minutes of "
                         "formatting at 11M rows)")
    ap.add_argument("--device", default="cuda")
    return ap


def load_rows(args) -> np.ndarray:
    """The z-scored float32 rows: from ``--data-cache`` when it exists,
    else generated or read (and cached)."""
    if args.data_cache and os.path.exists(args.data_cache):
        x = np.load(args.data_cache)
        if args.synthetic and x.shape[0] != args.synthetic:
            raise SystemExit(
                f"--data-cache {args.data_cache} holds {x.shape[0]} rows "
                f"but --synthetic asked for {args.synthetic}: stale cache "
                "from another run; delete it or change the path")
        return x
    if args.synthetic and args.manifold:
        x = synthetic_clustered_manifold(args.synthetic, d=28, seed=7,
                                         n_clusters=32).astype(np.float32)
    elif args.synthetic:
        x = synthetic_higgs(args.synthetic)
    elif args.csv:
        x = get_toembed_from_csv(args.csv, subsample=args.sampling)
        x = x[:, 1:]  # the first column is the label (higgs.rs:77-155)
    else:
        raise SystemExit("pass --csv or --synthetic N")
    # z-score rescale (higgs.rs:158-176)
    x = ((x - x.mean(0)) / np.maximum(x.std(0), 1e-12)).astype(np.float32)
    if args.data_cache:
        np.save(args.data_cache, x)
    return x


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    x = load_rows(args)
    n = x.shape[0]
    print(f"data: {x.shape}", file=sys.stderr, flush=True)
    qfrac = args.quality_fraction or min(1.0, 200_000 / max(n, 1))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    if args.dmap:
        kp = at.KnnParams(knbn=8, nprobe=args.nprobe, dtype="bfloat16",
                          refine_rounds=args.refine_rounds,
                          nndescent_rho=args.rho)
        y, info = at.dmap_embed(x, dim=5, alfa=1.0, beta=0.0, nbng=8,
                                knn_params=kp, svd_n_iter=args.svd_n_iter,
                                device=dev)
        g = None
    else:
        # bf16 IVF join panels (exact L2 rerank in the join)
        kp = at.KnnParams(knbn=args.nbng, nprobe=args.nprobe,
                          dtype="bfloat16", refine_rounds=args.refine_rounds,
                          nndescent_rho=args.rho)
        y, info = at.embed(
            x, dim=args.dim, batch=args.batch, nbng=args.nbng, layer=1,
            hierarchy_fraction=args.fraction, scale=0.75, knn_params=kp,
            with_quality=args.quality, quality_nbng=args.quality_nbng,
            quality_fraction=qfrac,
            quality_radius_compat=args.quality_radius_compat,
            # eager: saved right after the build, as the reference dumps
            # its HNSW index (higgs.rs:466-474)
            graph_cache=args.graph_cache, graph_cache_eager=True,
            embed_cache=args.embed_cache, return_graph=True, device=dev,
            params=at.EmbedderParams(
                grad_factor=5, hubness_weighting=True,
                optimizer=args.optimizer, n_sub=args.n_sub,
                dense_n_blocks=args.n_blocks,
                dense_neighbor_exclusion=not args.no_exclusion,
                dense_parallel_kicks=args.parallel_kicks,
                dense_packed_gather=args.packed_gather,
                dense_gather_reuse=args.gather_reuse,
                dense_gather_reuse_after=args.gather_reuse_after,
                n_sub_schedule=parse_schedule(args.schedule, args.batch,
                                              args.n_sub)))
        g = info.pop("kgraph", None)
    wall = time.perf_counter() - t0

    recall = None
    if g is not None and args.recall_sample > 0:
        recall = sampled_exact_recall(torch.from_numpy(x).to(dev), g,
                                      sample=args.recall_sample)

    port = {k: info.pop(k) for k in PORT_ONLY if k in info}
    port["top1_l2_launches"] = top1_l2.launches
    if args.quality:
        port["quality_radius"] = at.quality_estimate.last_radius_search
    port["peak_host_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF)
                                 .ru_maxrss / 2**20)
    if dev.type == "cuda":
        port["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("port: " + json.dumps(port), file=sys.stderr, flush=True)
    rec = {"n": n, "wall_s": round(wall, 1),
           **({"manifold": True} if args.manifold else {}),
           **{k: (round(v, 2) if isinstance(v, float) else v)
              for k, v in info.items()
              if isinstance(v, (int, float, dict))}}
    if recall is not None:
        rec[f"recall@{args.nbng}"] = round(recall, 4)
        rec["recall_sample"] = args.recall_sample
    if args.quality:
        rec["quality_fraction"] = round(qfrac, 4)
        rec["quality_nbng"] = args.quality_nbng
    print(json.dumps(rec, default=float), flush=True)
    if args.out and args.out.lower() != "none":
        write_csv_array2(args.out, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
