"""Cross-entropy embedding optimizer: batched negative-sampling SGD.

Port of annembed_tpu/optim/ce.py, which rebuilds the reference's Hogwild
hot loop ``ce_optim_edge_shannon`` (src/embedder.rs:1167-1302) as
synchronous mini-batched SGD: each step samples a batch of positive
edges (alias table over the edge probabilities) and 5 negatives each,
computes the reference's per-sample updates and applies them with one
``index_add``.  Constants (embedder.rs:1216-1299):

  * embedded weight:  cauchy = 1 / (1 + (d/scale)^{2b})
  * common coeff:     2 b cauchy (d2/scale^2)^{b-1} / scale^2
  * attraction:       coeff_ij = max(step * coeff * (-w + (1-w) *
                      1/max(d2s^2, 1/PROBA_MIN)), -0.49); y_i -= g,
                      y_j += g with g = (y_j - y_i) * coeff_ij
  * repulsion (negatives equal to i, to j or among i's neighbours are
    rejected, embedder.rs:1241-1252): coeff_ik = min(step * coeff *
    1/max(d2s^2, 1/16), 2.0); y_i -= (y_k - y_i) * coeff_ik
  * embedded scales = 0.2 * clamp(rho_i / mean(rho), 1/4, 4)
  * step decay: gamma = gamma_0 * (1 - batch/nb_batch) over
    nb_grad_batch outer batches (embedder.rs:875)

The steps run as one Python loop of torch ops (the JAX package splits
its scan into segments for a TPU watchdog).  Every step's draws come
from a ``torch.Generator`` on the embedding's device, seeded from
``params.seed``, or from a caller's ``draws(step)`` (the tests inject
``jax.random``'s).  The dense optimizer (optim/dense.py) shares the
coefficient helpers and ``ce_value_dense``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..graph.proba import NodeParams
from ..params import PROBA_MIN, EmbedderParams
from ..utils.alias import alias_sample, build_alias_table

NB_NEGATIVE = 5  # fixed in the reference (embedder.rs:1241)


@dataclasses.dataclass
class EdgeSet:
    """Flattened positive edges and their sampling tables (EntropyOptim
    state, embedder.rs:936-951, minus the RwLock'd coordinates).  The
    JAX package's ``edge_cdf`` serves its sharded stratified sampler
    only (ROADMAP A14), so it is not kept here."""

    src: torch.Tensor             # (E,) int32
    dst: torch.Tensor             # (E,) int32
    weight: torch.Tensor          # (E,) f32 calibrated edge probabilities
    neighbors: torch.Tensor       # (n, k) int32 for negative rejection
    embedded_scale: torch.Tensor  # (n,) f32
    edge_prob: torch.Tensor       # (E,) f32 alias table of the edges
    edge_alias: torch.Tensor      # (E,) int32
    # hubness-weighted negative sampling (alias table over the nodes)
    neg_prob: Optional[torch.Tensor] = None
    neg_alias: Optional[torch.Tensor] = None

    @property
    def nb_edges(self) -> int:
        return self.src.shape[0]

    @property
    def nb_nodes(self) -> int:
        return self.neighbors.shape[0]


def embedded_scales_from_initial(scale: torch.Tensor) -> torch.Tensor:
    """0.2 * clamp(rho/mean, 1/4, 4) (embedder.rs:1356-1373)."""
    mean = scale.mean()
    return 0.2 * torch.clamp(scale / mean.clamp_min(1e-30), 0.25, 4.0)


def build_edge_set(g: KGraph, npar: NodeParams,
                   hubness_weights: Optional[torch.Tensor] = None) -> EdgeSet:
    """Edges in row order with their alias table; with
    ``hubness_weights`` also the negatives' table."""
    n, k = g.indices.shape
    src = torch.arange(n, dtype=torch.int32,
                       device=g.indices.device).repeat_interleave(k)
    w = npar.probas.reshape(-1).to(torch.float32)
    edge_prob, edge_alias = build_alias_table(w)
    neg_prob = neg_alias = None
    if hubness_weights is not None:
        neg_prob, neg_alias = build_alias_table(hubness_weights)
    return EdgeSet(src=src, dst=g.indices.reshape(-1), weight=w,
                   neighbors=g.indices,
                   embedded_scale=embedded_scales_from_initial(npar.scale),
                   edge_prob=edge_prob, edge_alias=edge_alias,
                   neg_prob=neg_prob, neg_alias=neg_alias)


def _cauchy_weight(d2_scaled: torch.Tensor, b: float) -> torch.Tensor:
    """1 / (1 + (d^2/scale^2)^b), clamped below 1 (embedder.rs:1322-1345)."""
    w = 1.0 / (1.0 + torch.pow(d2_scaled.clamp_min(0.0), b))
    return w.clamp_max(1.0 - 1e-7)


def _common_coeff(d2s: torch.Tensor, scale: torch.Tensor, b: float):
    """2 b cauchy d2s^{b-1} / scale^2 (embedder.rs:1216-1222)."""
    if b == 1.0:
        cauchy = 1.0 / (1.0 + d2s)
        return 2.0 * cauchy / torch.square(scale)
    d2c = d2s.clamp_min(1e-30)
    cauchy = 1.0 / (1.0 + torch.pow(d2c, b))
    return 2.0 * b * cauchy * torch.pow(d2c, b - 1.0) / torch.square(scale)


def _ce_terms(yi, yj, scale, w, b: float) -> torch.Tensor:
    d2s = torch.square(yi - yj).sum(-1) / torch.square(scale)
    we = _cauchy_weight(d2s, b)
    return (-w * torch.log(we) - (1.0 - w) * torch.log1p(-we)).sum()


def ce_value(y: torch.Tensor, es: EdgeSet, b: float = 1.0,
             n_chunks: int = 16) -> torch.Tensor:
    """Shannon cross entropy between graph and embedded edge weights
    (embedder.rs:1127-1163) over the flattened edges, summed over edge
    chunks.  Returns a 0-d tensor on y's device."""
    e = es.nb_edges
    chunk = -(-e // n_chunks)
    parts = []
    for e0 in range(0, e, chunk):
        s = es.src[e0:e0 + chunk]
        parts.append(_ce_terms(y[s], y[es.dst[e0:e0 + chunk]],
                               es.embedded_scale[s], es.weight[e0:e0 + chunk],
                               b))
    return torch.stack(parts).sum()


def ce_value_dense(y: torch.Tensor, g: KGraph, probas: torch.Tensor,
                   scale: torch.Tensor, b: float = 1.0,
                   n_chunks: int = 16) -> torch.Tensor:
    """Shannon cross entropy between graph and embedded edge weights
    from the (n, k) layout (embedder.rs:1127-1163), summed over row
    chunks so the (chunk, k, d) temporaries stay bounded.  Returns a
    0-d tensor on y's device."""
    n = g.indices.shape[0]
    emb_scale = embedded_scales_from_initial(scale)
    chunk = -(-n // n_chunks)
    parts = []
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        yj = y[g.indices[r0:r1].to(torch.int64)]          # (c, k, d)
        parts.append(_ce_terms(y[r0:r1, None, :], yj,
                               emb_scale[r0:r1, None], probas[r0:r1], b))
    return torch.stack(parts).sum()


# ---------------------------------------------------------------------------
# the sampling optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepDraws:
    """One step's random draws.  JAX: ``k_edge, k_neg = split(key)``;
    the edges' ``alias_sample(k_edge)`` splits again into ``randint``
    (``edge_ids``) and ``uniform`` (``edge_u``); the negatives are
    ``randint(k_neg)`` node ids, or under hubness weighting
    ``alias_sample(k_neg)``'s ids and uniforms."""

    edge_ids: torch.Tensor              # (B,) int32 uniform in [0, E)
    edge_u: torch.Tensor                # (B,) f32 uniform in [0, 1)
    neg_ids: torch.Tensor               # (B, 5) int32 uniform in [0, n)
    neg_u: Optional[torch.Tensor] = None  # (B, 5) f32, hubness only


def draw_step(es: EdgeSet, batch_size: int,
              generator: torch.Generator) -> StepDraws:
    """One step's draws from ``generator`` on the edges' device."""
    kw = dict(generator=generator, device=es.src.device)
    shape = (batch_size, NB_NEGATIVE)
    return StepDraws(
        edge_ids=torch.randint(0, es.nb_edges, (batch_size,),
                               dtype=torch.int32, **kw),
        edge_u=torch.rand((batch_size,), **kw),
        neg_ids=torch.randint(0, es.nb_nodes, shape, dtype=torch.int32,
                              **kw),
        neg_u=None if es.neg_prob is None else torch.rand(shape, **kw))


def minibatch_update(y: torch.Tensor, draws: StepDraws, es: EdgeSet,
                     grad_step: float, b: float,
                     collision_mode: str = "sum") -> torch.Tensor:
    """One synchronous batch of the reference per-sample update; returns
    the new coordinates.

    collision_mode: "sum" adds all sampled updates of a node (closest to
    Hogwild at low collision rates); "mean" divides each node's summed
    update by its touch count, which bounds the per-node step and allows
    much larger batches."""
    n = y.shape[0]
    eidx = alias_sample(es.edge_prob, es.edge_alias, draws.edge_ids,
                        draws.edge_u)
    i = es.src[eidx]
    j = es.dst[eidx]
    w = es.weight[eidx]

    yi = y[i]                                   # (B, dim)
    yj = y[j]
    scale = es.embedded_scale[i]                # (B,)
    d2s = torch.square(yi - yj).sum(-1) / torch.square(scale)
    coeff = _common_coeff(d2s, scale, b)
    # repulsion annihilation (embedder.rs:1225)
    coeff_rep_att = 1.0 / torch.square(d2s).clamp_min(1.0 / PROBA_MIN)
    coeff_ij = (grad_step * coeff * (-w + (1.0 - w) * coeff_rep_att)
                ).clamp_min(-0.49)
    coeff_ij = torch.where(d2s > 0.0, coeff_ij, 0.0)
    g_att = (yj - yi) * coeff_ij[:, None]       # (B, dim)

    if es.neg_prob is None:
        neg = draws.neg_ids
    else:
        neg = alias_sample(es.neg_prob, es.neg_alias, draws.neg_ids,
                           draws.neg_u)
    # reject neg == i, neg == j and neg among i's neighbours
    # (embedder.rs:1246-1252): they contribute nothing
    is_nbr = (neg[:, :, None] == es.neighbors[i][:, None, :]).any(-1)
    reject = (neg == i[:, None]) | (neg == j[:, None]) | is_nbr

    yk = y[neg]                                 # (B, 5, dim)
    d2ks = torch.square(yi[:, None, :] - yk).sum(-1) \
        / torch.square(scale)[:, None]
    coeff_k = _common_coeff(d2ks, scale[:, None], b)
    coeff_rep = 1.0 / torch.square(d2ks).clamp_min(1.0 / 16.0)
    coeff_ik = (grad_step * coeff_k * coeff_rep).clamp_max(2.0)
    coeff_ik = torch.where((d2ks > 0.0) & ~reject, coeff_ik, 0.0)
    g_rep = (yk - yi[:, None, :]) * coeff_ik[:, :, None]  # (B, 5, dim)

    # y_i -= g_att + sum_k g_rep ; y_j += g_att, in one index_add
    all_idx = torch.cat([i, j])
    all_upd = torch.cat([-(g_att + g_rep.sum(1)), g_att])
    if collision_mode == "mean":
        acc = torch.zeros_like(y).index_add_(0, all_idx, all_upd)
        cnt = torch.zeros((n, 1), dtype=y.dtype, device=y.device).index_add_(
            0, all_idx, torch.ones_like(all_upd[:, :1]))
        return y + acc / cnt.clamp_min(1.0)
    return y.index_add(0, all_idx, all_upd)


def step_gamma(step: int, grad_step_init: float, steps_per_batch: int,
               nb_grad_batch: int) -> float:
    """gamma_0 * (1 - batch/nb_grad_batch) of the step's batch, clamped
    at 0, in float32 as the JAX package computes it."""
    f32 = np.float32
    batch = f32(step // steps_per_batch + 1)
    return float(max(f32(grad_step_init) * (f32(1.0) - batch
                                            / f32(nb_grad_batch)), f32(0.0)))


def optimize(y0: torch.Tensor, es: EdgeSet, grad_step_init: float, b: float,
             batch_size: int, steps_per_batch: int, nb_grad_batch: int,
             collision_mode: str = "sum",
             draws: Optional[Callable[[int], StepDraws]] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """nb_grad_batch outer batches of steps_per_batch steps under the
    linear decay gamma_0 * (1 - batch/nb_batch) (embedder.rs:873-879).
    The schedule's last batch runs at gamma = 0, a no-op, and is
    skipped.  ``draws(step)`` gives each step's draws; by default they
    come from ``generator`` (seed 0 on y0's device)."""
    total_steps = steps_per_batch * max(nb_grad_batch - 1, 0)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=y0.device).manual_seed(0)
        draws = lambda step: draw_step(es, batch_size, generator)  # noqa: E731
    y = y0
    for step in range(total_steps):
        gamma = step_gamma(step, grad_step_init, steps_per_batch,
                           nb_grad_batch)
        y = minibatch_update(y, draws(step), es, gamma, b, collision_mode)
    return y


def sampling_batch_size(params: EmbedderParams, nb_edges: int,
                        nb_nodes: int) -> int:
    """The mini-batch, capped at ~n/7 under "sum" so that a node is
    touched about once per synchronous batch (each sample moves 2
    endpoints + 5 negatives): summed collisions beyond that overshoot
    the sequential dynamics the constants were tuned for.
    ``params.batch_size`` is an upper bound."""
    if params.collision_mode == "mean":
        return min(params.batch_size, max(256, nb_edges))
    collision_cap = max(256, nb_nodes // (2 + NB_NEGATIVE))
    return min(params.batch_size, collision_cap, max(256, nb_edges))


def run_entropy_optimization(
        y0: torch.Tensor, es: EdgeSet, params: EmbedderParams,
        compute_ce: bool = True,
        draws: Optional[Callable[[int], StepDraws]] = None
) -> Tuple[torch.Tensor, dict]:
    """Mirrors ``entropy_optimize`` (embedder.rs:794-904).
    ``info``: initial_ce and final_ce (0-d tensors), batch_size,
    steps_per_batch."""
    e = es.nb_edges
    batch_size = sampling_batch_size(params, e, es.nb_nodes)
    samples_per_batch = params.nb_sampling_by_edge * e
    steps_per_batch = max(1, -(-samples_per_batch // batch_size))
    info = {}
    if compute_ce:
        info["initial_ce"] = ce_value(y0, es, b=params.b)
    generator = torch.Generator(device=y0.device).manual_seed(params.seed)
    y = optimize(y0.to(torch.float32), es, float(params.grad_step),
                 float(params.b), batch_size, steps_per_batch,
                 int(params.nb_grad_batch), params.collision_mode,
                 draws=draws, generator=generator)
    if compute_ce:
        info["final_ce"] = ce_value(y, es, b=params.b)
    info["batch_size"] = batch_size
    info["steps_per_batch"] = steps_per_batch
    return y, info
