"""Checkpoint / resume of the expensive pipeline phases.

Port of annembed_tpu/io/checkpoint.py.  The reference checkpoints its
HNSW index (HnswIo dump/reload, examples/higgs.rs:397-474) to skip the
graph build; here the kNN graph, the hierarchical projection and the
embedding are npz archives with the JAX package's keys and dtypes
(indices and ids int32, distances and coordinates float32), so a file
written by either package loads in the other.

Saves go through an open file handle so the archive lands at exactly
the requested path (``np.savez(str)`` appends ``.npz``); loads also
resolve a legacy ``<path>.npz``.  The port stores its archives
uncompressed: deflate runs at ~15 MB/s on a host core and saves ~12% of
a graph's bytes (random ids and distances), which at 11M rows would add
~40 s to a save.  ``np.load`` reads either kind, so the JAX package's
compressed files load here and the port's there.  Loaded graphs land on
``device``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..interop import kgraph_from_numpy, projection_from_numpy

logger = logging.getLogger(__name__)


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a if dtype is None else a.astype(dtype, copy=False)


def _save_npz(path, **data) -> None:
    with open(os.fspath(path), "wb") as f:
        np.savez(f, **data)


def _resolve(path) -> str:
    p = os.fspath(path)
    if not os.path.exists(p) and os.path.exists(p + ".npz"):
        return p + ".npz"
    return p


def checkpoint_exists(path) -> bool:
    """True if a checkpoint exists at ``path`` (or legacy ``path.npz``)."""
    p = os.fspath(path)
    return os.path.exists(p) or os.path.exists(p + ".npz")


def _check_n(what: str, path, got: int, expect: Optional[int]) -> None:
    if expect is not None and got != expect:
        raise ValueError(
            f"{what} checkpoint {os.fspath(path)!r} holds {got} nodes, "
            f"expected {expect} — stale cache from another run/sampling? "
            "delete it or fix the path")


def save_kgraph(path, g: KGraph, extra: Optional[dict] = None) -> None:
    data = {"indices": _host(g.indices, np.int32),
            "dists": _host(g.dists, np.float32)}
    if extra:
        data.update({k: _host(v) for k, v in extra.items()})
    _save_npz(path, **data)
    logger.info("kgraph checkpoint written to %s", path)


def load_kgraph(path, expect_n: Optional[int] = None,
                device="cpu") -> KGraph:
    with np.load(_resolve(path)) as z:
        _check_n("kgraph", path, z["indices"].shape[0], expect_n)
        return kgraph_from_numpy(z["indices"], z["dists"], device)


def save_projection(path, proj) -> None:
    """Persist a KGraphProjection (small graph, large graph, top-1
    projection): at 11M rows the graph build and the projection are the
    phases worth skipping."""
    _save_npz(
        path,
        small_indices=_host(proj.small_graph.indices, np.int32),
        small_dists=_host(proj.small_graph.dists, np.float32),
        large_indices=_host(proj.large_graph.indices, np.int32),
        large_dists=_host(proj.large_graph.dists, np.float32),
        sample_ids=_host(proj.sample_ids, np.int32),
        proj_small_idx=_host(proj.proj_small_idx, np.int32),
        proj_dist=_host(proj.proj_dist, np.float32))
    logger.info("projection checkpoint written to %s", path)


def load_projection(path, expect_n: Optional[int] = None, device="cpu"):
    with np.load(_resolve(path)) as z:
        _check_n("projection", path, z["large_indices"].shape[0], expect_n)
        return projection_from_numpy(
            z["small_indices"], z["small_dists"], z["large_indices"],
            z["large_dists"], z["sample_ids"], z["proj_small_idx"],
            z["proj_dist"], device)


def save_embedding(path, y) -> None:
    _save_npz(path, embedding=_host(y, np.float32))


def load_embedding(path) -> np.ndarray:
    with np.load(_resolve(path)) as z:
        return z["embedding"]
