"""Top-level ``embed`` (port of annembed_tpu/api.py::embed, arrays only).

Same keyword surface as the JAX package for what the port supports, plus
an explicit ``device``.  What it does not support yet raises
``NotImplementedError`` naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .knn.api import build_kgraph
from .knn.hierarchy import build_projection
from .optim.embedder import Embedder
from .params import EmbedderParams, KnnParams


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
    roadmap = {"mesh": "A14", "n_devices": "A14", "graph_cache": "A12",
               "embed_cache": "A12", "with_quality": "A6", "cluster": "A11",
               "outfile": "A7"}
    for name, on in flags.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet "
                                      f"(ROADMAP {roadmap[name]})")


def embed(csv, outfile: Optional[str] = None, dim: int = 2, batch: int = 20,
          nbsample: int = 10, layer: int = 0,
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
    """kNN graph + CE-optimized embedding of the rows of ``csv`` (an
    (n, d) array), on ``device``; ``layer > 0`` runs the hierarchical
    two-step embedding.  Returns (embedding (n, dim) np.ndarray, info).

    ``info`` carries the JAX package's keys; with ``layer > 0`` it also
    carries ``graph_build_phases`` (small graph, large graph, projection
    seconds)."""
    if isinstance(csv, (str, bytes)) or hasattr(csv, "__fspath__"):
        raise NotImplementedError("csv paths are not ported yet (ROADMAP "
                                  "A7); pass an (n, d) array")
    _refuse(mesh=mesh is not None, n_devices=n_devices > 1,
            graph_cache=bool(graph_cache), embed_cache=bool(embed_cache),
            with_quality=with_quality, cluster=cluster > 0,
            outfile=bool(outfile))
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(csv, np.float32)).to(dev)
    if params is None:
        params = EmbedderParams()
    # the CLI-surface kwargs always win; the caller's object is copied
    params = dataclasses.replace(
        params, asked_dim=dim, nb_grad_batch=batch,
        nb_sampling_by_edge=nbsample, scale_rho=scale,
        hierarchy_layer=layer, seed=seed)
    if knn_params is None:
        knn_params = KnnParams(knbn=nbng, distance=distance)

    t0 = time.perf_counter()
    extra = {}
    if layer > 0:
        proj = build_projection(x, nbng, sample_fraction=hierarchy_fraction,
                                distance=distance, params=knn_params,
                                seed=seed)
        graph_build_time = time.perf_counter() - t0
        extra["graph_build_phases"] = dict(proj.timings)
        emb = Embedder.from_hkgraph(proj, params)
    else:
        g = build_kgraph(x, nbng, distance=distance, params=knn_params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        graph_build_time = time.perf_counter() - t0
        emb = Embedder.new(g, params)
    y = emb.embed().cpu().numpy()
    info = _finalize_info(emb.info)
    info.update(extra)
    info["graph_build_time"] = graph_build_time
    info["total_time"] = time.perf_counter() - t0
    if return_graph:
        info["kgraph"] = emb.get_kgraph()
    return y, info
