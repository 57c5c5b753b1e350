"""Neighbourhood-conservation quality estimator.

Port of annembed_tpu/estimators/quality.py (reference
src/embedder.rs:620-753):

  1. for every original edge (i, j), the embedded length |y_i - y_j|;
  2. each evaluated node's embedded radius: the distance to its
     ``radius_k``-th embedded neighbour in a search of the embedded
     cloud with self included, so column ``radius_k`` is the
     radius_k-th neighbour;
  3. per node, how many original neighbours fall inside that radius,
     and the quantiles of edge_length / radius.

The radius search takes the JAX package's routes.  At d = 2 above
50,000 rows, sampled or not, it is the certified grid search
(``knn/radius.py``), whose distances equal the brute search's; only the
radius columns are kept.  The full fraction above ``brute_force_limit``
at d != 2 takes an approximate IVF rebuild of the embedded cloud
(``_ivf_radius``).  Everything else is the exact brute search, whose
self-included column radius_k is the JAX graph rebuild's self-excluded
column radius_k - 1.

``sample_fraction`` < 1 evaluates a node subsample drawn with numpy's
``default_rng(seed).choice``, the JAX package's draw, so both packages
evaluate the same nodes.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import disable_tf32
from ..graph.kgraph import KGraph
from ..knn.api import build_kgraph
from ..knn.brute import knn_search_brute
from ..knn.radius import grid_radius_search, grid_shape
from ..params import KnnParams
from ..utils.stats import quantiles

logger = logging.getLogger(__name__)

_QS = (0.05, 0.25, 0.5, 0.75, 0.85, 0.95)
#: d = 2 clouds above this many rows take the certified grid search
GRID_MIN_ROWS = 50_000


@dataclasses.dataclass
class QualityEstimate:
    nb_nodes: int
    nbng_used: int          # neighbourhood size of the original graph
    nbng_target: int        # neighbourhood size in embedded space
    nb_without_match: int
    #: mean conserved neighbours over nodes WITH >= 1 match (the
    #: reference's semantics, embedder.rs:679-681)
    mean_nb_matched: float
    median_ratio: float
    mean_ratio: float
    radii_quantiles: Dict[str, float]
    ratio_quantiles: Dict[str, float]
    #: per-node mean ratio (continuity_ratio.csv); rows follow
    #: ``sample_ids`` when sampling is active
    ratio_by_node: torch.Tensor
    #: per-node min embedded edge length (first_dist.csv)
    first_dist: torch.Tensor
    #: nodes actually evaluated (== nb_nodes without sampling)
    nb_sampled: int = 0
    #: exact fraction of evaluated nodes with zero conserved neighbours
    frac_without_match: float = 0.0
    #: evaluated node ids (None = all nodes in order)
    sample_ids: Optional[np.ndarray] = None
    #: mean conserved neighbours over ALL evaluated nodes
    mean_nb_matched_marginal: float = 0.0
    #: the headline counts at ``radius_k_compat`` from the same search
    #: (keys: radius_k, nb_without_match, frac_without_match,
    #: mean_nb_matched, mean_nb_matched_marginal, median_ratio)
    compat: Optional[Dict[str, float]] = None
    #: per-node embedded radius at ``radius_k`` (rows as ratio_by_node)
    radius: Optional[torch.Tensor] = None
    #: how the radius was searched: route ("grid", "brute" or "ivf"),
    #: queries, k, seconds (device synchronised), and for the grid g,
    #: cap_cell and n_fallback (rows the certificate sent to brute)
    radius_search: Optional[Dict[str, object]] = None

    def summary(self) -> Dict[str, float]:
        out = {
            "nb_without_match": float(self.nb_without_match),
            "mean_nb_matched": self.mean_nb_matched,
            "mean_nb_matched_marginal": self.mean_nb_matched_marginal,
            "median_ratio": self.median_ratio,
            "mean_ratio": self.mean_ratio,
            "frac_without_match": self.frac_without_match,
        }
        if self.nb_sampled != self.nb_nodes:
            out["nb_sampled"] = float(self.nb_sampled)
        if self.compat is not None:
            out.update({f"compat_{k}": v for k, v in self.compat.items()})
        out.update({f"radius_{k}": v for k, v in self.radii_quantiles.items()})
        out.update({f"ratio_{k}": v for k, v in self.ratio_quantiles.items()})
        return out


def edge_lengths_rows(y_rows: torch.Tensor, y: torch.Tensor,
                      indices_rows: torch.Tensor) -> torch.Tensor:
    """(m, k) embedded L2 lengths for a row subset: y_rows (m, d) are the
    evaluated nodes' coordinates, indices_rows (m, k) their original
    neighbour ids into the full cloud ``y``.  Summed over d, then sqrt,
    as the radius search's exact rerank computes its distances, so a
    node's own radius-defining neighbour compares equal."""
    yj = y[indices_rows.to(torch.int64)]
    return torch.sqrt(torch.square(y_rows[:, None, :] - yj).sum(-1)
                      .clamp_min(0.0))


def _ivf_radius(y: torch.Tensor, cols: Sequence[int],
                knn_params: Optional[KnnParams]) -> torch.Tensor:
    """(len(cols), n) approximate embedded radii through the IVF graph
    rebuild: the full-fraction route above ``brute_force_limit`` at
    d != 2.  ``cols`` count neighbours with self included in column 0,
    as ``_radius_columns`` does, so column c reads the self-excluded
    graph's column c - 1.

    NN-descent is skipped: at nbng ~ 50 its candidate set is (2 nbng)^2
    per node, and the radius only shifts marginally with IVF-level
    recall.  The caller's params carry the original-space tuning; the
    strategy knobs that transfer are kept (brute_force_limit, nlist,
    nprobe) and the embedded-space essentials forced: knbn, no
    refinement, and float32 panels (a bf16 cross product corrupts
    low-d candidate selection)."""
    k_search = max(cols)
    if knn_params is None:
        knn_params = KnnParams(knbn=k_search, refine_rounds=0)
    else:
        knn_params = dataclasses.replace(knn_params, knbn=k_search,
                                         refine_rounds=0, dtype="float32")
    emb_graph = build_kgraph(y, k_search, distance="DistL2",
                             params=knn_params)
    # only the radius columns outlive the graph
    return emb_graph.dists[:, [c - 1 for c in cols]].T.contiguous()


def _radius_columns(y, sub, cols, knn_params: Optional[KnnParams]):
    """(len(cols), m) embedded distances at the given columns of a
    self-including search of the evaluated rows (``sub``, an int64
    tensor on y's device, None for all) against the whole cloud, and
    the route's record.  Exact, except for the full fraction above
    ``brute_force_limit`` at d != 2 (``_ivf_radius``)."""
    n, d = y.shape
    k = max(cols) + 1
    m = n if sub is None else sub.shape[0]
    limit = (knn_params.brute_force_limit if knn_params is not None
             else KnnParams().brute_force_limit)
    t0 = time.perf_counter()
    rec = {"queries": m, "k": k}
    if d == 2 and n > GRID_MIN_ROWS:
        ids = torch.arange(n, device=y.device) if sub is None else sub
        sd, n_fb = grid_radius_search(y, ids, k, keep_cols=cols)
        g, cap_cell = grid_shape(n, k)
        rec.update(route="grid", g=g, cap_cell=cap_cell, n_fallback=n_fb)
        radii = sd.T.contiguous()
    elif sub is None and d != 2 and n > limit:
        rec["route"] = "ivf"
        radii = _ivf_radius(y, cols, knn_params)
    else:
        rec["route"] = "brute"
        _, sd = knn_search_brute(y if sub is None else y[sub], y, k=k)
        radii = sd[:, list(cols)].T.contiguous()
    if y.is_cuda:
        torch.cuda.synchronize(y.device)
    rec["seconds"] = time.perf_counter() - t0
    logger.info("quality radius search: %s", rec)
    return radii, rec


def _counts(lengths: torch.Tensor, radius: torch.Tensor, n: int,
            qs: Sequence[float] = (0.5,)):
    """The headline counts of m evaluated nodes at one radius each:
    conserved neighbours (int64; f32 loses integers past 2^24), nodes
    with none (extrapolated to all n when sampled), their means and the
    median ratio edge length / radius.  Also returns the (m, k) ratios
    and their quantiles at ``qs``, which holds 0.5."""
    m = lengths.shape[0]
    matched = (lengths <= radius[:, None]).sum(1)
    nb_without, nb_matched = int((matched == 0).sum()), int(matched.sum())
    ratios = lengths / radius.clamp_min(1e-30)[:, None]
    ratio_q = quantiles(ratios, qs)
    return {
        "nb_without_match": (nb_without if m == n
                             else int(round(nb_without / m * n))),
        "frac_without_match": nb_without / m,
        "mean_nb_matched": nb_matched / max(m - nb_without, 1),
        "mean_nb_matched_marginal": nb_matched / m,
        "median_ratio": ratio_q[list(qs).index(0.5)],
    }, ratios, ratio_q


def quality_sample_ids(n: int, sample_fraction: float,
                       seed: int) -> np.ndarray:
    """The sorted node subsample of ``quality_estimate``: numpy's
    ``default_rng(seed).choice``, the JAX package's draw."""
    m = max(1, min(n, int(round(n * sample_fraction))))
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=m, replace=False)).astype(np.int32)


def quality_estimate(g: KGraph, y, nbng: int = 50,
                     knn_params: KnnParams | None = None,
                     sample_fraction: float = 1.0, seed: int = 0,
                     radius_k: int | None = None,
                     radius_k_compat: int | None = None) -> QualityEstimate:
    """The neighbourhood-conservation summary of embedding ``y`` (n, d)
    of graph ``g`` (a tensor, on the graph's device, or an array).

    ``sample_fraction`` < 1 measures a random node subsample and
    extrapolates ``nb_without_match`` to all n (``frac_without_match``
    holds the sample's exact fraction).  ``radius_k`` (default nbng) is
    the embedded neighbour whose distance is a node's radius;
    ``radius_k_compat`` reports the headline counts at a second radius
    from the same search (``QualityEstimate.compat``)."""
    disable_tf32()
    n, k = g.indices.shape
    dev = g.indices.device
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    if radius_k is None:
        radius_k = nbng
    cols = (radius_k, radius_k_compat) if radius_k_compat else (radius_k,)

    sample_ids = sub = None
    if sample_fraction < 1.0:
        sample_ids = quality_sample_ids(n, sample_fraction, seed)
        m = sample_ids.shape[0]
        sub = torch.as_tensor(sample_ids, dtype=torch.int64, device=dev)
        lengths = edge_lengths_rows(y[sub], y, g.indices[sub])
    else:
        m = n
        lengths = edge_lengths_rows(y, y, g.indices)
    radii, search = _radius_columns(y, sub, cols, knn_params)
    radius = radii[0]

    head, ratios, ratio_q = _counts(lengths, radius, n, _QS)
    ratio_q = dict(zip((f"q{q:g}" for q in _QS), ratio_q))
    radii_q = dict(zip((f"q{q:g}" for q in _QS), quantiles(radius, _QS)))
    compat = None
    if radius_k_compat:
        compat = {"radius_k": float(radius_k_compat),
                  **_counts(lengths, radii[1], n)[0]}
        compat["nb_without_match"] = float(compat["nb_without_match"])
    est = QualityEstimate(
        nb_nodes=n, nbng_used=k, nbng_target=nbng,
        nb_without_match=head["nb_without_match"],
        mean_nb_matched=head["mean_nb_matched"],
        median_ratio=head["median_ratio"], mean_ratio=float(ratios.mean()),
        radii_quantiles=radii_q, ratio_quantiles=ratio_q,
        ratio_by_node=ratios.mean(1), first_dist=lengths.min(1).values,
        nb_sampled=m, frac_without_match=head["frac_without_match"],
        sample_ids=sample_ids,
        mean_nb_matched_marginal=head["mean_nb_matched_marginal"],
        compat=compat, radius=radius, radius_search=search)
    quality_estimate.last_radius_search = search
    logger.info(
        "quality: nb_without_match=%d (frac %.4f of %d sampled) "
        "mean_matched=%.3f median_ratio=%.3e mean_ratio=%.3e",
        est.nb_without_match, est.frac_without_match, m,
        est.mean_nb_matched, est.median_ratio, est.mean_ratio)
    return est


#: the radius search record of the latest call, for callers that see
#: only the summary (``embed(with_quality=True)``'s ``info["quality"]``)
quality_estimate.last_radius_search = None
