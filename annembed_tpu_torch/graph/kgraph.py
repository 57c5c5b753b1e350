"""Fixed-degree kNN graph container, its statistics and its COO
symmetrization.

Port of annembed_tpu/graph/kgraph.py (reference src/fromhnsw/kgraph.rs):
a graph is a pair of dense tensors ``indices (n, k) int32`` and
``dists (n, k) float32`` (ascending per row); every downstream graph
operation is a gather, a sort or an ``index_add_``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..utils.stats import quantiles


@dataclasses.dataclass
class KGraph:
    """k-NN graph: for node i, ``indices[i]`` are its k nearest
    neighbours with distances ``dists[i]`` sorted ascending."""

    indices: torch.Tensor  # (n, k) int32
    dists: torch.Tensor    # (n, k) float32

    @property
    def nb_nodes(self) -> int:
        return self.indices.shape[0]

    @property
    def nbng(self) -> int:
        return self.indices.shape[1]

    def compute_max_edge(self) -> torch.Tensor:
        """Per-node max out-edge length (reference kgraph.rs:167)."""
        return self.dists[:, -1]


def kgraph_stats(g: KGraph) -> Dict[str, float]:
    """In-degree extrema and quantiles of the min radius (distance to the
    first neighbour) and of the max edge (reference ``KGraphStat`` /
    ``get_kraph_stats``, kgraph.rs:47,372)."""
    n, k = g.indices.shape
    indeg = in_degree_counts(g)
    first, last = g.dists[:, 0], g.dists[:, -1]
    stats = {
        "nb_nodes": float(n),
        "nbng": float(k),
        "min_in_degree": float(indeg.min()),
        "max_in_degree": float(indeg.max()),
        "mean_radius": float(first.mean()),
    }
    qs = (0.05, 0.25, 0.5, 0.75, 0.95)
    for name, v in (("min_radius", first), ("max_radius", last)):
        for q, val in zip(qs, quantiles(v, qs)):
            stats[f"{name}_q{q:g}"] = float(val)
    return stats


@dataclasses.dataclass
class SymCooPlan:
    """Sort plan for :func:`symmetric_coo`, reusable across weight
    vectors on the same graph (the diffusion-maps beta<0 pass
    symmetrizes two kernels on one edge structure)."""

    rows: torch.Tensor   # (2nk,) int32, sorted by (row, col)
    cols: torch.Tensor   # (2nk,) int32
    perm: torch.Tensor   # (2nk,) int64: position in the concatenated list
    dup: torch.Tensor    # (2nk,) bool: same (row, col) as predecessor


def symmetric_coo_plan(g: KGraph) -> SymCooPlan:
    """Both directions of every edge, sorted lexicographically by
    (row, col): one int64 key ``row * n + col`` under a stable sort
    (equal keys keep their concatenation order, like the JAX package's
    two-key ``lax.sort``)."""
    n, k = g.indices.shape
    dev = g.indices.device
    src = torch.arange(n, device=dev, dtype=torch.int64).repeat_interleave(k)
    dst = g.indices.reshape(-1).to(torch.int64)
    rows = torch.cat([src, dst])
    cols = torch.cat([dst, src])
    _, perm = torch.sort(rows * n + cols, stable=True)
    rows_s, cols_s = rows[perm], cols[perm]
    dup = torch.zeros_like(rows_s, dtype=torch.bool)
    dup[1:] = (rows_s[1:] == rows_s[:-1]) & (cols_s[1:] == cols_s[:-1])
    return SymCooPlan(rows=rows_s.to(torch.int32), cols=cols_s.to(torch.int32),
                      perm=perm, dup=dup)


def symmetric_coo_apply(plan: SymCooPlan, weights: torch.Tensor,
                        mode: str = "mean") -> torch.Tensor:
    """Symmetrized edge values for one weight vector under a plan."""
    val = weights.reshape(-1).to(torch.float32)
    vals_s = torch.cat([val, val])[plan.perm]
    if mode == "mean":
        # both directions contribute w/2 at the same key and sum to the
        # mean; a lone direction contributes w/2, exactly 0.5*(A+A^T)
        return vals_s * 0.5
    if mode != "max":
        raise ValueError(mode)
    # max: fold the duplicate into its predecessor via max, zero it
    folded = torch.where(plan.dup, torch.zeros_like(vals_s), vals_s)
    nxt_dup = torch.zeros_like(plan.dup)
    nxt_dup[:-1] = plan.dup[1:]
    nxt_val = torch.zeros_like(vals_s)
    nxt_val[:-1] = vals_s[1:]
    return torch.where(nxt_dup, torch.maximum(vals_s, nxt_val), folded)


def symmetric_coo(g: KGraph, weights: torch.Tensor | None = None,
                  mode: str = "mean", include_self: bool = False,
                  self_weight: float = 1.0):
    """Symmetrize the directed k-NN graph into COO arrays of static size
    (annembed_tpu/graph/kgraph.py::symmetric_coo): total weight at
    (i, j) is the mean or max of the two directions; folded duplicates
    keep a zero weight.  Returns (rows, cols, vals), each of length
    2*n*k (+n if include_self)."""
    n = g.indices.shape[0]
    plan = symmetric_coo_plan(g)
    vals = symmetric_coo_apply(plan, g.dists if weights is None else weights,
                               mode)
    rows, cols = plan.rows, plan.cols
    if include_self:
        ar = torch.arange(n, device=rows.device, dtype=torch.int32)
        rows = torch.cat([rows, ar])
        cols = torch.cat([cols, ar])
        vals = torch.cat([vals, torch.full((n,), self_weight,
                                           dtype=torch.float32,
                                           device=vals.device)])
    return rows, cols, vals


def coo_to_dense(rows, cols, vals, n: int) -> torch.Tensor:
    """Materialize a COO graph as a dense (n, n) matrix (small n)."""
    out = torch.zeros((n * n,), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, rows.to(torch.int64) * n + cols.to(torch.int64), vals)
    return out.reshape(n, n)


def in_degree_counts(g: KGraph) -> torch.Tensor:
    """k-occurrence counts (reference src/fromhnsw/hubness.rs:39-62)."""
    n = g.nb_nodes
    return torch.bincount(g.indices.reshape(-1).to(torch.int64),
                          minlength=n).to(torch.int32)
