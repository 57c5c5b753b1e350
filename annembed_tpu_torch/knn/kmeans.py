"""Lloyd k-means, the IVF coarse quantizer (port of
annembed_tpu/knn/kmeans.py).

Assignment is one L2 panel per row block and an ``argmin`` (ties to the
first centroid); the update is a segment mean, a ``segment_reduce`` of
the rows sorted by cell (on the CPU the same sums as ``index_add_``; on
the card ``index_add_`` adds with atomics, whose order, and so whose last
bits, vary from run to run and from rank to rank).  The random-point
initialization is an argument (``init_ids``), drawn from a
``torch.Generator`` when absent.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from .distances import corpus_sqnorm, l2_panel, panel_rows

#: most rows of one assignment panel (the panel itself stays within
#: distances.PANEL_BYTES)
_ASSIGN_ROWS = 1 << 16


def assign_to_centroids(x: torch.Tensor,
                        centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid id for every row of x: (n,) int32."""
    n = x.shape[0]
    c_sq = corpus_sqnorm(centroids)
    br = panel_rows(centroids.shape[0], _ASSIGN_ROWS)
    cells = torch.empty(n, dtype=torch.int32, device=x.device)
    for r0 in range(0, n, br):
        dist = l2_panel(x[r0:r0 + br], centroids, c_sq)
        cells[r0:r0 + br] = torch.argmin(dist, dim=1)
    return cells


def _segment_sum(x: torch.Tensor, cells: torch.Tensor,
                 n_clusters: int) -> torch.Tensor:
    """(n_clusters, d) sums of the rows of each cell, bit-reproducible."""
    order = torch.argsort(cells, stable=True)
    counts = torch.bincount(cells, minlength=n_clusters)
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)


def kmeans_fit(x: torch.Tensor, n_clusters: int, n_iter: int = 10,
               seed: int = 0, init_ids: Optional[torch.Tensor] = None):
    """Lloyd iterations from a random-point init.  Empty clusters keep
    their previous centroid.  Returns (centroids (n_clusters, d) f32,
    cells (n,) int32).

    ``init_ids`` (n_clusters distinct row ids) may be given; otherwise
    they are drawn from a CPU ``torch.Generator`` seeded with ``seed``."""
    x = x.to(torch.float32)
    n, d = x.shape
    if init_ids is None:
        gen = torch.Generator().manual_seed(seed)
        with span("rng.kmeans_init"):
            init_ids = torch.randperm(n, generator=gen)[:n_clusters]
    centroids = x[init_ids.to(x.device)]
    for _ in range(n_iter):
        cells = assign_to_centroids(x, centroids).to(torch.int64)
        sums = _segment_sum(x, cells, n_clusters)
        counts = torch.bincount(cells, minlength=n_clusters).to(torch.float32)
        new = sums / counts.clamp_min(1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids, assign_to_centroids(x, centroids)
