"""Hierarchical two-level graph for coarse-to-fine embedding.

Port of annembed_tpu/knn/hierarchy.py (reference
src/fromhnsw/kgproj.rs:35): a uniform random subsample of fraction
``sample_fraction`` plays the role of HNSW's upper layers, and every
point is projected onto its nearest sampled point by one top-1 search:
for DistL2 ``ops/top1.py`` (the CUDA kernel on the card), for the other
metrics a k=1 brute search.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import torch

from ..graph.kgraph import KGraph
from ..ops.top1 import top1_l2
from ..params import KnnParams
from ..utils.profiling import PhaseTimer, span
from ..utils.stats import quantiles
from .api import build_kgraph
from .brute import knn_search_brute

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class KGraphProjection:
    """Small graph over a subsample + projection of all points onto it.

    ``proj_small_idx[i]`` is the index *within the sample* of the point
    nearest to i (identity for sampled points, kgproj.rs:254-267) and
    ``proj_dist[i]`` its distance (0 for sampled points).  ``timings``
    holds the wall seconds of the three builds and, for a graph above
    ``brute_force_limit``, of its phases as ``<graph>/<phase>``."""

    small_graph: KGraph
    large_graph: KGraph
    sample_ids: torch.Tensor      # (m,) int64 indices into [0, n)
    proj_small_idx: torch.Tensor  # (n,) int64 indices into [0, m)
    proj_dist: torch.Tensor       # (n,) float32
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def nb_small(self) -> int:
        return self.sample_ids.shape[0]

    def projection_distance_quantiles(self) -> Dict[str, float]:
        """Quantiles of the projection distance over all points
        (reference get_projection_distance_quant, kgproj.rs:403), the
        sampled ones included at their identity distance 0, as the
        reference counts them."""
        qs = (0.05, 0.5, 0.95, 0.99)
        return {f"q{q:g}": v for q, v in
                zip(qs, quantiles(self.proj_dist, qs))}


def draw_sample_ids(n: int, m: int, generator: torch.Generator) -> torch.Tensor:
    """m distinct sorted row ids out of n, from ``generator``."""
    with span("rng.sample_ids"):
        return torch.sort(torch.randperm(n, generator=generator)[:m]).values


def _nearest(q: torch.Tensor, xs: torch.Tensor, distance: str):
    """(index, distance) of each query row's nearest sampled point."""
    if distance == "DistL2":
        return top1_l2(q, xs)
    idx1, dist1 = knn_search_brute(q, xs, k=1, distance=distance)
    return idx1[:, 0], dist1[:, 0]


def _project(x: torch.Tensor, xs: torch.Tensor, distance: str, mesh):
    """The projection's search; under a mesh rank r searches rows
    [r s, (r + 1) s) and the padded blocks are all-gathered."""
    if mesh is None:
        return _nearest(x, xs, distance)
    n = x.shape[0]
    s = -(-n // mesh.size)
    r0 = min(mesh.rank * s, n)
    r1 = min(r0 + s, n)
    idx = torch.zeros(s, dtype=torch.int64, device=x.device)
    dist = torch.zeros(s, dtype=torch.float32, device=x.device)
    if r1 > r0:
        i, d = _nearest(x[r0:r1], xs, distance)
        idx[:r1 - r0], dist[:r1 - r0] = i, d
    return mesh.all_gather_rows(idx)[:n], mesh.all_gather_rows(dist)[:n]


def build_projection(x: torch.Tensor, knbn: int,
                     sample_fraction: float = 0.05,
                     distance: str = "DistL2",
                     params: Optional[KnnParams] = None, seed: int = 0,
                     sample_ids: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None) -> KGraphProjection:
    """Small graph, large graph and projection (kgproj.rs:59).

    ``sample_ids`` (sorted, distinct) may be given; otherwise they are
    drawn from ``generator`` (default: a CPU generator seeded with
    ``seed``, the same draw on every rank).  ``mesh``
    (parallel/sharded.py) routes both graph builds through the sharded
    joins, and each rank projects its own block of rows (the kernel on
    every rank) before one all-gather: the same projection, replicated."""
    x = x.to(torch.float32).contiguous()
    if mesh is not None:
        x = x.to(mesh.device)
    n = x.shape[0]
    m = max(knbn + 1, int(round(n * sample_fraction)))
    if sample_ids is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        sample_ids = draw_sample_ids(n, m, generator)
    sample_ids = sample_ids.to(device=x.device, dtype=torch.int64)
    m = sample_ids.shape[0]
    xs = x[sample_ids]
    logger.info("hierarchy: %d sampled of %d (fraction %.3f)", m, n, m / n)

    timer = PhaseTimer()
    graphs = {}
    for name, rows in (("small_graph", xs), ("large_graph", x)):
        inner = PhaseTimer()
        with timer.phase(name) as sync:
            if mesh is None:
                graphs[name] = build_kgraph(rows, knbn, distance=distance,
                                            params=params, timer=inner)
            else:
                from ..parallel.sharded_knn import sharded_build_kgraph
                graphs[name] = sharded_build_kgraph(
                    rows, knbn, mesh, distance=distance, params=params,
                    timer=inner)
            sync.append(graphs[name].dists)
        timer.timings.update({f"{name}/{phase}": s
                              for phase, s in inner.timings.items()})
    small, large = graphs["small_graph"], graphs["large_graph"]
    with timer.phase("projection") as sync:
        idx1, dist1 = _project(x, xs, distance, mesh)
        # sampled points project to themselves at distance 0
        in_sample_pos = torch.zeros(n, dtype=torch.int64, device=x.device)
        in_sample_pos[sample_ids] = torch.arange(m, device=x.device)
        is_sampled = torch.zeros(n, dtype=torch.bool, device=x.device)
        is_sampled[sample_ids] = True
        proj_small_idx = torch.where(is_sampled, in_sample_pos,
                                     idx1.to(torch.int64))
        proj_dist = torch.where(is_sampled, torch.zeros_like(dist1), dist1)
        sync.append(proj_dist)
    return KGraphProjection(small_graph=small, large_graph=large,
                            sample_ids=sample_ids,
                            proj_small_idx=proj_small_idx,
                            proj_dist=proj_dist, timings=timer.timings)
