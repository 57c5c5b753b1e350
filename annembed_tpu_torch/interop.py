"""Carry the JAX package's state into the port as numpy arrays.

This system has no weights: its state is the graph, the edge
probabilities and the coordinates.  These helpers build the port's
dataclasses from numpy arrays (``np.asarray`` of the JAX package's
arrays) on a given device, so one package's intermediate can be fed to
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.kgraph import KGraph
from .graph.proba import NodeParams
from .knn.hierarchy import KGraphProjection


def _t(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def kgraph_from_numpy(indices, dists, device="cpu") -> KGraph:
    return KGraph(indices=_t(indices, torch.int32, device),
                  dists=_t(dists, torch.float32, device))


def nodeparams_from_numpy(scale, probas, device="cpu") -> NodeParams:
    return NodeParams(scale=_t(scale, torch.float32, device),
                      probas=_t(probas, torch.float32, device))


def projection_from_numpy(small_indices, small_dists, large_indices,
                          large_dists, sample_ids, proj_small_idx,
                          proj_dist, device="cpu") -> KGraphProjection:
    return KGraphProjection(
        small_graph=kgraph_from_numpy(small_indices, small_dists, device),
        large_graph=kgraph_from_numpy(large_indices, large_dists, device),
        sample_ids=_t(sample_ids, torch.int64, device),
        proj_small_idx=_t(proj_small_idx, torch.int64, device),
        proj_dist=_t(proj_dist, torch.float32, device))
