"""Hubness (k-occurrence) statistics.

Port of annembed_tpu/estimators/hubness.py (reference
src/fromhnsw/hubness.rs): the in-degree counters (:46-62) are one
``bincount``; the hdrhistogram quantiles (:111-156) are exact quantiles
over one sort (``utils/stats.py``: in-degree counts reach 11M entries,
past ``torch.quantile``'s 2^24); the standardized third moment (:86) is
a direct reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..graph.kgraph import KGraph, in_degree_counts
from ..utils.stats import quantiles

_QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)


@dataclasses.dataclass
class Hubness:
    counts: torch.Tensor  # (n,) int32 in-degree of each node

    @staticmethod
    def new(g: KGraph) -> "Hubness":
        return Hubness(counts=in_degree_counts(g))

    def get_counts(self) -> torch.Tensor:
        return self.counts

    def get_standard3m(self) -> float:
        """Standardized third moment (skewness) of the k-occurrence
        distribution, Radovanovic's hubness score (hubness.rs:86), with
        the population standard deviation (``jnp.std``'s)."""
        c = self.counts.to(torch.float32)
        sigma = c.std(correction=0).clamp_min(1e-30)
        return float(torch.mean(((c - c.mean()) / sigma) ** 3))

    def get_hubness_histogram(self, nb_bins: int = 50) -> Dict[str, float]:
        """Quantiles, mean and max of the in-degree distribution
        (hubness.rs:111-156); ``nb_bins`` is kept for the signature."""
        del nb_bins
        c = self.counts.to(torch.float32)
        out = {f"q{q:g}": v for q, v in zip(_QUANTILES,
                                            quantiles(c, _QUANTILES))}
        out["mean"] = float(c.mean())
        out["max"] = float(c.max())
        return out

    def get_largest_hubs(self, nb_hubs: int = 10
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """ids and counts of the nb_hubs most-pointed-to nodes
        (hubness.rs:160); equal counts keep the lower id first."""
        c = self.counts.cpu().numpy()
        ids = np.argsort(-c, kind="stable")[:nb_hubs]
        return ids, c[ids]
