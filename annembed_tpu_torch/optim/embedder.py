"""Embedder driver: diffusion-map init + cross-entropy optimization.

Port of annembed_tpu/optim/embedder.py (reference src/embedder.rs):
  * ``one_step_embed`` (embedder.rs:298): diffusion-maps initialization
    (t=5, gnbn=12, alfa=0.5, beta=-0.1), box normalization to size 10,
    probability-edge calibration, CE optimization by the dense sweeps
    (optim/dense.py) or, with ``optimizer="sampling"``, by the
    reference's negative-sampling SGD (optim/ce.py);
  * ``h_embed`` (embedder.rs:194): embed the small (subsample) graph with
    grad_factor x the batches at grad_step 1, seed the full graph from
    the projected neighbours + clipped Gaussian jitter scaled by the
    projection-distance median ratio, then optimize the full graph.

Every random draw comes from a ``torch.Generator`` seeded from
``params.seed`` as the JAX package seeds its keys: relabel permutation
and sweep offsets from ``seed``, the random init from ``seed + 17``, the
jitter from ``seed + 23``, the SVD test matrix from 4664397; the sampling
optimizer's steps from ``seed`` on the embedding's device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import torch

from ..graph.kgraph import KGraph, in_degree_counts
from ..graph.proba import NodeParams, to_proba_edges
from ..knn.hierarchy import KGraphProjection
from ..params import DiffusionParams, EmbedderParams
from ..spectral.diffmaps import DiffusionMaps
from ..utils.profiling import PhaseTimer, device_trace
from .ce import build_edge_set, ce_value_dense, run_entropy_optimization
from .dense import run_dense_optimization

logger = logging.getLogger(__name__)


def set_data_box(data: torch.Tensor, box_size: float) -> torch.Tensor:
    """Center columns and rescale so max |coord| = box_size / 2
    (reference embedder.rs:1376-1408)."""
    centered = data - data.mean(0, keepdim=True)
    scale = (centered.abs().max() / (box_size / 2.0)).clamp_min(1e-30)
    return centered / scale


def hubness_sampling_weights(g: KGraph) -> torch.Tensor:
    """Negative-sampling weights from in-degree counts, clamped to
    [1, n] (reference embedder.rs:823-833)."""
    w = in_degree_counts(g).to(torch.float32).clamp(1.0, float(g.nb_nodes))
    return w / w.mean()


def median(x: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated median (``jnp.quantile(x, 0.5)``).  Two
    ``kthvalue`` calls instead of ``torch.quantile``, which refuses
    inputs above 2^24 elements (the 11M-row Higgs projection)."""
    n = x.numel()
    lo = torch.kthvalue(x, (n - 1) // 2 + 1).values
    hi = torch.kthvalue(x, n // 2 + 1).values
    return lo + (hi - lo) * (0.5 * (n - 1) - (n - 1) // 2)


OPTIMIZERS = ("dense", "dense!", "sampling")


def check_embedder_params(params: EmbedderParams) -> None:
    """Raise on an unknown optimizer name."""
    if params.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {params.optimizer!r}; "
                         f"expected one of {OPTIMIZERS}")


def _is_dense(params: EmbedderParams) -> bool:
    """"dense" (and its alias "dense!") picks the dense sweeps,
    "sampling" the reference's negative-sampling SGD."""
    return params.optimizer in ("dense", "dense!")


@dataclasses.dataclass
class Embedder:
    """One-shot or hierarchical embedding driver."""

    kgraph: Optional[KGraph] = None
    hkgraph: Optional[KGraphProjection] = None
    params: EmbedderParams = dataclasses.field(default_factory=EmbedderParams)

    initial_embedding: Optional[torch.Tensor] = None
    embedding: Optional[torch.Tensor] = None
    initial_space: Optional[NodeParams] = None
    info: dict = dataclasses.field(default_factory=dict)
    timer: PhaseTimer = dataclasses.field(default_factory=PhaseTimer)

    @staticmethod
    def new(kgraph: KGraph, params: EmbedderParams) -> "Embedder":
        return Embedder(kgraph=kgraph, params=params)

    @staticmethod
    def from_hkgraph(proj: KGraphProjection,
                     params: EmbedderParams) -> "Embedder":
        return Embedder(hkgraph=proj, params=params)

    def embed(self) -> torch.Tensor:
        """Dispatch (embedder.rs:183-191)."""
        check_embedder_params(self.params)
        if self.kgraph is not None:
            return self.one_step_embed()
        if self.hkgraph is not None:
            return self.h_embed()
        raise ValueError("Embedder needs a kgraph or a graph projection")

    def _dmap_initial(self, g: KGraph, dim: int) -> torch.Tensor:
        """Diffusion-map initialization with the constants hard-wired in
        one_step_embed (embedder.rs:315-325)."""
        dparams = DiffusionParams(asked_dim=dim, alfa=0.5, beta=-0.1,
                                  t=5.0, gnbn=12)
        return DiffusionMaps(params=dparams).embed_from_kgraph(g)

    def _random_initial(self, n: int, dim: int, size: float,
                        device) -> torch.Tensor:
        gen = torch.Generator().manual_seed(self.params.seed + 17)
        y = (torch.rand((n, dim), generator=gen) - 0.5) * size
        return y.to(device)

    def one_step_embed(self, g: Optional[KGraph] = None) -> torch.Tensor:
        g = g if g is not None else self.kgraph
        p = self.params
        dim = p.asked_dim
        with self.timer.phase("initialization") as sync:
            if p.dmap_init:
                init = set_data_box(self._dmap_initial(g, dim), 10.0)
            else:
                init = self._random_initial(g.nb_nodes, dim, 1.0,
                                            g.indices.device)
            sync.append(init)
        self.info["init_time"] = self.timer.timings["initialization"]
        logger.info("initialization done in %.2fs", self.info["init_time"])

        with self.timer.phase("proba_edges") as sync:
            self.initial_space = to_proba_edges(g, p.scale_rho, p.beta)
            sync.append(self.initial_space.probas)
        self.initial_embedding = init
        y = self._entropy_optimize(g, self.initial_space, init)
        self.embedding = y
        return y

    def h_embed(self) -> torch.Tensor:
        """Two-step hierarchical embedding (embedder.rs:194-295)."""
        proj = self.hkgraph
        p = self.params
        # step 1: the small graph with grad_factor x the batches at step
        # 1, flat n_sub (an n_sub_schedule targets the large phase)
        first_params = dataclasses.replace(
            p, nb_grad_batch=p.grad_factor * p.nb_grad_batch,
            grad_step=1.0, hierarchy_layer=0, n_sub_schedule=None)
        first = Embedder(kgraph=proj.small_graph, params=first_params)
        y_small = first.one_step_embed()
        self.info["first_step"] = first.info

        # step 2: seed the full embedding from the projection
        large = proj.large_graph
        n = large.nb_nodes
        dim = p.asked_dim
        ratio = proj.proj_dist / median(proj.proj_dist).clamp_min(1e-30)
        correction = torch.sqrt(ratio / dim)
        gen = torch.Generator().manual_seed(p.seed + 23)
        noise = torch.randn((n, dim), generator=gen).to(y_small.device)
        jitter = torch.clamp(correction[:, None] * noise, -2.0, 2.0)
        init = y_small[proj.proj_small_idx] + jitter
        # sampled points keep their exact small-graph coordinates
        init[proj.sample_ids] = y_small
        self.initial_embedding = init

        self.initial_space = to_proba_edges(large, p.scale_rho, p.beta)
        y = self._entropy_optimize(large, self.initial_space, init)
        self.embedding = y
        return y

    def _entropy_optimize(self, g: KGraph, npar: NodeParams,
                          init: torch.Tensor) -> torch.Tensor:
        """The JAX package's ``_entropy_optimize``: the dense sweeps or
        the sampling optimizer."""
        p = self.params
        t0 = time.perf_counter()
        dense = _is_dense(p)
        logger.info("entropy optimization: starting (n=%d, k=%d, "
                    "optimizer=%s, batches=%d)", g.nb_nodes,
                    g.indices.shape[1], "dense" if dense else "sampling",
                    p.nb_grad_batch)
        trace = device_trace(p.trace_dir,
                             f"entropy_optimization_n{g.nb_nodes}")
        with trace, self.timer.phase("entropy_optimization") as sync:
            hub = hubness_sampling_weights(g) if p.hubness_weighting else None
            if dense:
                info = {"initial_ce": ce_value_dense(init, g, npar.probas,
                                                     npar.scale, p.b)}
                y, dinfo = run_dense_optimization(init, g, npar, p,
                                                  n_sub=p.n_sub,
                                                  neg_weights=hub)
                info.update(dinfo)
                info["final_ce"] = ce_value_dense(y, g, npar.probas,
                                                  npar.scale, p.b)
            else:
                es = build_edge_set(g, npar, hubness_weights=hub)
                y, info = run_entropy_optimization(init, es, p)
            sync.append(y)
        info["optimize_time"] = time.perf_counter() - t0
        self.info.update(info)
        return y

    def get_embedded(self) -> Optional[torch.Tensor]:
        return self.embedding

    # rows are positional (no IndexSet remap), so reindexed == raw
    # (reference embedder.rs:384-405)
    def get_embedded_reindexed(self) -> Optional[torch.Tensor]:
        return self.embedding

    def get_initial_embedding(self) -> Optional[torch.Tensor]:
        return self.initial_embedding

    def get_embedded_by_nodeid(self, node: int) -> torch.Tensor:
        """Row of the embedding (reference embedder.rs:421; node ids are
        positional, so dataid == nodeid)."""
        return self.embedding[node]

    get_embedded_by_dataid = get_embedded_by_nodeid

    def get_kgraph(self) -> Optional[KGraph]:
        if self.kgraph is not None:
            return self.kgraph
        if self.hkgraph is not None:
            return self.hkgraph.large_graph
        return None

    def get_quality_estimate_from_edge_length(self, nbng: int = 50,
                                              sample_fraction: float = 1.0,
                                              knn_params=None,
                                              radius_k_compat=None):
        """Neighbourhood conservation of the embedding against the
        (large) kNN graph (reference embedder.rs:620)."""
        from ..estimators.quality import quality_estimate
        return quality_estimate(self.get_kgraph(), self.embedding,
                                nbng=nbng, knn_params=knn_params,
                                sample_fraction=sample_fraction,
                                seed=self.params.seed,
                                radius_k_compat=radius_k_compat)
