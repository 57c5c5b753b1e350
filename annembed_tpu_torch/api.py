"""Top-level ``embed`` and ``dmap_embed`` (port of annembed_tpu/api.py;
reference src/python.rs:109 and :201).

Same keyword surface as the JAX package, csv paths or arrays in, plus an
explicit ``device``.  The multi-device knobs (``mesh``, ``n_devices``)
raise ``NotImplementedError`` naming their ROADMAP item, before any data
is moved to the device or any graph is built.  Graphs above
``KnnParams.brute_force_limit`` rows take the IVF + NN-descent build.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .estimators.hdbscan import hdbscan
from .io import checkpoint as ckpt
from .io.csv_io import (get_toembed_from_csv, write_csv_array2,
                        write_csv_labeled_array2)
from .knn.api import build_kgraph
from .knn.brute import check_knobs
from .knn.distances import check_distance
from .knn.hierarchy import build_projection
from .optim.embedder import Embedder, check_embedder_params
from .params import DiffusionParams, EmbedderParams, KnnParams
from .spectral.diffmaps import DiffusionMaps

logger = logging.getLogger(__name__)

ArrayLike = Union[str, os.PathLike, np.ndarray]


def _finalize_info(info: dict) -> dict:
    """0-d tensors (the CE values) become Python floats."""
    out = {}
    for key, v in info.items():
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            out[key] = v.item()
        elif isinstance(v, dict):
            out[key] = _finalize_info(v)
        else:
            out[key] = v
    return out


def _refuse(**flags) -> None:
    for name, on in flags.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet "
                                      "(ROADMAP A14)")


def _check_graph_options(distance: str, knn_params: KnnParams) -> None:
    check_distance(distance)
    check_knobs(knn_params.dtype, knn_params.topk_recall)
    if knn_params.quantizer not in ("kmeans", "grid"):
        raise ValueError(f"unknown quantizer {knn_params.quantizer!r}")
    if knn_params.ivf_layout not in ("sorted", "gathered"):
        raise ValueError(f"unknown IVF layout {knn_params.ivf_layout!r}")


def _load(data: ArrayLike, delim: str, subsample: float,
          knn_params: KnnParams) -> np.ndarray:
    """Host rows to embed; refuses rows the chosen quantizer cannot take
    (the grid serves d == 2 only) while they are still on the host."""
    if isinstance(data, (str, bytes)) or hasattr(data, "__fspath__"):
        x = get_toembed_from_csv(data, delimiter=delim, subsample=subsample)
    else:
        x = np.asarray(data, np.float32)
    n, d = x.shape
    if (knn_params.quantizer == "grid" and d != 2
            and n > knn_params.brute_force_limit):
        raise ValueError(f"grid quantizer supports exactly d == 2 (got "
                         f"d={d}); use quantizer='kmeans'")
    return x


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def embed(csv: ArrayLike, outfile: Optional[str] = None, dim: int = 2,
          batch: int = 20, nbsample: int = 10, layer: int = 0,
          hierarchy_fraction: float = 0.05, scale: float = 1.0,
          quality_sampling: float = 1.0, distance: str = "DistL2",
          nbng: int = 10, knn_params: Optional[KnnParams] = None,
          params: Optional[EmbedderParams] = None, delim: str = ",",
          with_quality: bool = False, seed: int = 0,
          graph_cache: Optional[str] = None, graph_cache_eager: bool = False,
          embed_cache: Optional[str] = None, quality_fraction: float = 1.0,
          quality_nbng: int = 50, quality_radius_compat: int = 0,
          return_graph: bool = False, cluster: int = 0, n_devices: int = 0,
          mesh=None, device="cuda"):
    """kNN graph + CE-optimized embedding of the rows of ``csv`` (a csv
    path or an (n, d) array) on ``device``; ``layer > 0`` runs the
    hierarchical two-step embedding.  Returns (embedding (n, dim)
    np.ndarray, info).

    ``cluster`` > 0 runs HDBSCAN* on the kNN graph at that
    ``min_cluster_size``: ``info["cluster"]`` holds n_clusters,
    noise_fraction, labels, probabilities and the stages' seconds, and
    ``clusters.csv`` (label, coordinates) goes next to ``outfile``.
    ``with_quality`` adds the neighbourhood-conservation summary as
    ``info["quality"]`` (embedded neighbourhood ``quality_nbng``, node
    subsample ``quality_fraction``, second radius
    ``quality_radius_compat``).  ``outfile`` receives the embedding at
    %.5e; with ``with_quality`` also ``first_dist.csv`` and
    ``continuity_ratio.csv`` next to it, rows paired with the evaluated
    nodes.  ``info`` carries the JAX package's keys; with ``layer > 0``
    also ``graph_build_phases`` (small graph, large graph, projection
    seconds, and the IVF build's phases as ``<graph>/<phase>``) and
    ``projection_distance_quantiles``.

    ``graph_cache`` (an npz path, either package's layout) loads the kNN
    graph, or for ``layer > 0`` the projection, in place of the build;
    if absent, the graph is saved there at the end of the pipeline, or
    right after the build with ``graph_cache_eager``.  ``embed_cache``
    saves the embedding after the optimize phase; an existing one is
    loaded instead and the run goes straight to the quality tail (a
    shape other than (n, dim) raises).  With either cache,
    ``info["checkpoints"]`` holds the seconds of each load and save."""
    _refuse(mesh=mesh is not None, n_devices=n_devices > 1)
    if cluster == 1:
        raise ValueError("cluster is HDBSCAN*'s min_cluster_size: >= 2")
    if params is None:
        params = EmbedderParams()
    # the CLI-surface kwargs always win; the caller's object is copied
    params = dataclasses.replace(
        params, asked_dim=dim, nb_grad_batch=batch,
        nb_sampling_by_edge=nbsample, scale_rho=scale,
        hierarchy_layer=layer, seed=seed)
    if knn_params is None:
        knn_params = KnnParams(knbn=nbng, distance=distance)
    check_embedder_params(params)
    _check_graph_options(distance, knn_params)
    x_host = _load(csv, delim, quality_sampling, knn_params)
    dev = resolve_device(device)
    x = _to_device(x_host, dev)
    del x_host

    t0 = time.perf_counter()
    extra = {}
    saves = {}        # the checkpoints' load and save seconds
    graph_loaded = bool(graph_cache) and ckpt.checkpoint_exists(graph_cache)
    if graph_loaded:
        load = ckpt.load_projection if layer > 0 else ckpt.load_kgraph
        graph = load(graph_cache, expect_n=x.shape[0], device=dev)
        logger.info("loaded %s checkpoint from %s",
                    "projection" if layer > 0 else "kNN graph", graph_cache)
    elif layer > 0:
        graph = build_projection(x, nbng, sample_fraction=hierarchy_fraction,
                                 distance=distance, params=knn_params,
                                 seed=seed)
        extra["graph_build_phases"] = dict(graph.timings)
    else:
        graph = build_kgraph(x, nbng, distance=distance, params=knn_params)
    _sync(dev)
    if graph_loaded:
        saves["graph_load_s"] = time.perf_counter() - t0

    def save_graph():
        t = time.perf_counter()
        (ckpt.save_projection if layer > 0 else ckpt.save_kgraph)(
            graph_cache, graph)
        saves["graph_save_s"] = time.perf_counter() - t

    if graph_cache and graph_cache_eager and not graph_loaded:
        save_graph()
    graph_build_time = time.perf_counter() - t0
    if layer > 0:
        extra["projection_distance_quantiles"] = \
            graph.projection_distance_quantiles()
        emb = Embedder.from_hkgraph(graph, params)
    else:
        emb = Embedder.new(graph, params)
    y_host = None
    if embed_cache and ckpt.checkpoint_exists(embed_cache):
        # resume straight into the quality tail
        t = time.perf_counter()
        y_host = ckpt.load_embedding(embed_cache)
        if y_host.shape != (x.shape[0], dim):
            raise ValueError(
                f"embed_cache {embed_cache!r} has shape {y_host.shape}, "
                f"expected {(x.shape[0], dim)} — stale checkpoint from "
                "another run? delete it or fix the path")
        emb.embedding = y_dev = torch.from_numpy(y_host).to(dev)
        saves["embedding_load_s"] = time.perf_counter() - t
        logger.info("loaded embedding checkpoint from %s", embed_cache)
    else:
        y_dev = emb.embed()
        if embed_cache:
            t = time.perf_counter()
            y_host = y_dev.cpu().numpy()
            ckpt.save_embedding(embed_cache, y_host)
            saves["embedding_save_s"] = time.perf_counter() - t
    q = None
    if with_quality:
        q = emb.get_quality_estimate_from_edge_length(
            nbng=quality_nbng, sample_fraction=quality_fraction,
            knn_params=knn_params,
            radius_k_compat=quality_radius_compat or None)
    y = y_dev.cpu().numpy() if y_host is None else y_host
    info = _finalize_info(emb.info)
    info.update(extra)
    info["graph_build_time"] = graph_build_time
    info["total_time"] = time.perf_counter() - t0
    if graph_cache and not ckpt.checkpoint_exists(graph_cache):
        save_graph()
    if saves:
        info["checkpoints"] = saves
    if return_graph:
        info["kgraph"] = emb.get_kgraph()
    if cluster > 0:
        res = hdbscan(emb.get_kgraph(), min_cluster_size=cluster)
        info["cluster"] = {
            "n_clusters": len(res.selected),
            "noise_fraction": float((res.labels == -1).mean()),
            "labels": res.labels,
            "probabilities": res.probabilities,
            "timings": res.timings,
        }
        if outfile:
            d = os.path.dirname(os.fspath(outfile)) or "."
            write_csv_labeled_array2(os.path.join(d, "clusters.csv"),
                                     res.labels, y)
    if q is not None:
        info["quality"] = q.summary()
        if outfile:
            # per-node dumps next to the embedding (reference
            # embedder.rs:729-743); under quality sampling the stat rows
            # follow q.sample_ids, paired with the same embedding rows
            d = os.path.dirname(os.fspath(outfile)) or "."
            y_rows = y if q.sample_ids is None else y[q.sample_ids]
            write_csv_labeled_array2(os.path.join(d, "first_dist.csv"),
                                     q.first_dist.cpu().numpy(), y_rows)
            write_csv_labeled_array2(os.path.join(d, "continuity_ratio.csv"),
                                     q.ratio_by_node.cpu().numpy(), y_rows)
    if outfile:
        write_csv_array2(outfile, y)
    return y, info


def dmap_embed(csv: ArrayLike, outfile: Optional[str] = None, dim: int = 2,
               alfa: float = 1.0, beta: float = 0.0, time_param: float = 5.0,
               distance: str = "DistL2", nbng: int = 16, layer: int = 0,
               hierarchy_fraction: float = 0.05,
               knn_params: Optional[KnnParams] = None,
               quality_sampling: float = 1.0, delim: str = ",",
               seed: int = 0, n_devices: int = 0, mesh=None,
               svd_n_iter: int = 5, device="cuda"):
    """Diffusion-maps-only embedding (reference python.rs:201,
    bin/dmapembed.rs:390-432) on ``device``.  With layer > 0 only the
    subsample graph is embedded (dmapembed.rs:415-422) and ``info``
    carries its ``sample_ids``.  ``svd_n_iter`` = subspace iterations
    of the spectral SVD (the reference's 5, graphlaplace.rs:115)."""
    _refuse(mesh=mesh is not None, n_devices=n_devices > 1)
    if knn_params is None:
        knn_params = KnnParams(knbn=nbng, distance=distance)
    _check_graph_options(distance, knn_params)
    x_host = _load(csv, delim, quality_sampling, knn_params)
    dev = resolve_device(device)
    x = _to_device(x_host, dev)
    n = x_host.shape[0]
    del x_host
    dm = DiffusionMaps(params=DiffusionParams(
        asked_dim=dim, alfa=alfa, beta=beta, t=time_param, gnbn=nbng,
        svd_n_iter=svd_n_iter))
    t0 = time.perf_counter()
    if layer > 0:
        proj = build_projection(x, nbng, sample_fraction=hierarchy_fraction,
                                distance=distance, params=knn_params,
                                seed=seed)
        y = dm.embed_from_kgraph(proj.small_graph).cpu().numpy()
        info = {"nb_embedded": int(proj.nb_small),
                "sample_ids": proj.sample_ids.cpu().numpy()}
    else:
        g = build_kgraph(x, nbng, distance=distance, params=knn_params)
        _sync(dev)
        t_g = time.perf_counter() - t0
        y = dm.embed_from_kgraph(g).cpu().numpy()
        info = {"nb_embedded": int(n),
                "graph_build_time": round(t_g, 1),
                "dmap_time": round(time.perf_counter() - t0 - t_g, 1)}
    info["total_time"] = time.perf_counter() - t0
    if outfile:
        write_csv_array2(outfile, y)
    return y, info
