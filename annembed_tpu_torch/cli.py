"""Command-line interface (port of annembed_tpu/cli.py):

    python -m annembed_tpu_torch.cli embed --csv data.csv [--quality] ...
    python -m annembed_tpu_torch.cli dmapembed --csv data.csv ...

Same flags and the same printed JSON as the JAX package's CLI
(reference src/bin/embed.rs:185-321, src/bin/dmapembed.rs:183-306), plus
``--device`` (default ``cuda``).  ``--nlist``, ``--nprobe`` and ``--rho``
tune the IVF + NN-descent graph build that rows above
``KnnParams.brute_force_limit`` take.  ``embed --cluster MCS`` adds
HDBSCAN* on the kNN graph, ``embed --stats`` the intrinsic dimension and
hubness of a max(nbng, 20)-NN graph.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def _common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--csv", required=True, help="input csv file")
    p.add_argument("--outfile", default="embedded.csv")
    p.add_argument("--delim", default=",")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--layer", type=int, default=0,
                   help=">0 switches to hierarchical embedding")
    p.add_argument("--fraction", type=float, default=0.05,
                   help="subsample fraction for the hierarchical layer")
    p.add_argument("--sampling", type=float, default=1.0,
                   help="Bernoulli row-subsampling probability")
    p.add_argument("--distance", default="DistL2",
                   choices=["DistL2", "DistL1", "DistCosine",
                            "DistJeffreys", "DistJensenShannon"])
    p.add_argument("--nbng", type=int, default=10,
                   help="number of neighbours in the kNN graph (knbn)")
    p.add_argument("--nlist", type=int, default=0,
                   help="IVF centroids (0 = auto sqrt(n))")
    p.add_argument("--nprobe", type=int, default=16)
    p.add_argument("--rho", type=float, default=1.0,
                   help="NN-descent candidate sampling fraction")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-devices", type=int, default=0,
                   help=">1 shards the pipeline (not ported: ROADMAP A14)")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on")
    p.add_argument("-v", "--verbose", action="store_true")


def _knn_params(args):
    from .params import KnnParams
    return KnnParams(knbn=args.nbng, distance=args.distance,
                     nlist=args.nlist, nprobe=args.nprobe,
                     nndescent_rho=args.rho)


def main_embed(argv=None) -> int:
    from .api import embed

    p = argparse.ArgumentParser(
        "annembed-embed",
        description="kNN graph + cross-entropy optimized embedding")
    _common_args(p)
    p.add_argument("--batch", type=int, default=20,
                   help="number of gradient batches")
    p.add_argument("--nbsample", type=int, default=10,
                   help="edge samplings per edge per batch")
    p.add_argument("--scale", type=float, default=1.0, help="scale_rho")
    p.add_argument("--quality", action="store_true",
                   help="compute the neighborhood-conservation estimate")
    p.add_argument("--quality-nbng", type=int, default=50,
                   help="embedded neighbourhood size for --quality")
    p.add_argument("--quality-fraction", type=float, default=1.0,
                   help="query-node subsample for --quality (exact radii)")
    p.add_argument("--stats", action="store_true",
                   help="intrinsic dimension + hubness statistics on a "
                        "max(nbng, 20)-NN graph of the csv rows")
    p.add_argument("--graph-cache", default=None,
                   help="npz path: load the kNN graph (the projection with "
                        "--layer > 0) from it, or save it there after the "
                        "run")
    p.add_argument("--graph-cache-eager", action="store_true",
                   help="save the --graph-cache right after the build")
    p.add_argument("--cluster", type=int, default=0, metavar="MCS",
                   help="run HDBSCAN* on the kNN graph with this "
                        "min_cluster_size; writes clusters.csv next to "
                        "the embedding")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)

    y, info = embed(args.csv, outfile=args.outfile, dim=args.dim,
                    batch=args.batch, nbsample=args.nbsample,
                    layer=args.layer, hierarchy_fraction=args.fraction,
                    scale=args.scale, quality_sampling=args.sampling,
                    distance=args.distance, nbng=args.nbng,
                    knn_params=_knn_params(args),
                    with_quality=args.quality, delim=args.delim,
                    seed=args.seed, graph_cache=args.graph_cache,
                    graph_cache_eager=args.graph_cache_eager,
                    quality_nbng=args.quality_nbng,
                    quality_fraction=args.quality_fraction,
                    cluster=args.cluster, n_devices=args.n_devices,
                    device=args.device)
    out = {"n": int(y.shape[0]), "dim": int(y.shape[1]),
           **{k: v for k, v in info.items()
              if isinstance(v, (int, float, dict))}}
    if "cluster" in out:        # keep only json-safe scalars
        out["cluster"] = {k: v for k, v in out["cluster"].items()
                          if isinstance(v, (int, float))}
    if args.stats:
        out.update(_stats(args))
    print(json.dumps(out, default=float))
    return 0


def _stats(args) -> dict:
    """The JAX CLI's ``--stats`` keys: Levina-Bickel and 2NN intrinsic
    dimension and hubness of a max(nbng, 20)-NN graph of the csv rows,
    built with the CLI's kNN knobs on ``--device``."""
    import torch

    from .device import resolve_device
    from .estimators.dimension import (intrinsic_dim_2nn,
                                       intrinsic_dim_levina_bickel)
    from .estimators.hubness import Hubness
    from .io.csv_io import get_toembed_from_csv
    from .knn.api import build_kgraph

    x = get_toembed_from_csv(args.csv, delimiter=args.delim,
                             subsample=args.sampling)
    x = torch.from_numpy(x).to(resolve_device(args.device))
    gs = build_kgraph(x, max(args.nbng, 20), distance=args.distance,
                      params=_knn_params(args))
    hub = Hubness.new(gs)
    return {"intrinsic_dim": list(intrinsic_dim_levina_bickel(gs)),
            "intrinsic_dim_2nn": intrinsic_dim_2nn(gs),
            "hubness_skew": hub.get_standard3m(),
            "hubness_hist": hub.get_hubness_histogram()}


def main_dmapembed(argv=None) -> int:
    from .api import dmap_embed

    p = argparse.ArgumentParser(
        "annembed-dmapembed", description="diffusion maps embedding")
    _common_args(p)
    p.add_argument("--alfa", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--time", type=float, default=5.0, dest="time_param")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)

    y, info = dmap_embed(args.csv, outfile=args.outfile, dim=args.dim,
                         alfa=args.alfa, beta=args.beta,
                         time_param=args.time_param,
                         distance=args.distance, nbng=args.nbng,
                         layer=args.layer,
                         hierarchy_fraction=args.fraction,
                         knn_params=_knn_params(args),
                         quality_sampling=args.sampling, delim=args.delim,
                         seed=args.seed, n_devices=args.n_devices,
                         device=args.device)
    print(json.dumps({"n": int(y.shape[0]), "dim": int(y.shape[1]),
                      "total_time": info["total_time"]}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    prog = argv[0] if argv else "embed"
    if prog == "dmapembed":
        return main_dmapembed(argv[1:])
    return main_embed(argv[1:] if prog == "embed" else argv)


if __name__ == "__main__":
    sys.exit(main())
