"""Parameter dataclasses of the PyTorch port.

A framework-free copy of ``annembed_tpu/params.py`` (same fields, same
defaults; tests/test_torch_params.py pins them field by field), kept
separate because importing any ``annembed_tpu`` module imports jax.
Mirrors the reference parameter surface:
  - ``EmbedderParams``  (reference: src/embedparams.rs:77-184)
  - ``DiffusionParams`` (reference: src/diffmaps.rs:72-248)
  - ``KnnParams``       (replaces the HNSW construction knobs of
    reference src/bin/embed.rs:52-92 with TPU-native kNN knobs)

Defaults match the reference exactly where a parameter has a direct
counterpart.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

logger = logging.getLogger(__name__)

#: Probability floor used both in graph calibration and in the optimizer
#: (reference: src/embedder.rs:50 ``PROBA_MIN = 1.E-4``).
PROBA_MIN: float = 1.0e-4

#: Dense/sparse representation switch (reference: src/graphlaplace.rs:13).
FULL_MAT_REPR: int = 5000

#: Size limit under which an exact (full) SVD is used
#: (reference: src/graphlaplace.rs:15).
FULL_SVD_SIZE_LIMIT: int = 5000


@dataclasses.dataclass
class EmbedderParams:
    """Hyper-parameters of the cross-entropy embedding optimizer.

    Reference: src/embedparams.rs:77-131.  The edge weight model in the
    original space is ``w_i = exp(-((d_i - d_0)/(S * rho))^beta)`` and the
    embedded-space weight is the Cauchy kernel
    ``1 / (1 + (||x-y||/a_x)^{2b})`` (embedparams.rs:16,46).
    """

    #: Target embedding dimension (reference default 2).
    asked_dim: int = 2
    #: Initialize with diffusion maps (True) or random in a unit box.
    dmap_init: bool = True
    #: Exponent in the original-space edge weight.
    beta: float = 1.0
    #: Exponent of the embedded-space Cauchy kernel.
    b: float = 1.0
    #: Multiplier on the local scale rho.
    scale_rho: float = 1.0
    #: Initial gradient step.
    grad_step: float = 2.0
    #: Number of times each edge is sampled per gradient batch.
    nb_sampling_by_edge: int = 10
    #: Number of gradient batches (the step decays linearly across them).
    nb_grad_batch: int = 20
    #: Multiplier on nb_grad_batch for the first (small-graph) pass of the
    #: hierarchical embedding.
    grad_factor: int = 4
    #: >0 switches to the hierarchical (two-step) embedding.
    hierarchy_layer: int = 0
    #: Use hubness (in-degree) weights for negative-node sampling.
    hubness_weighting: bool = False

    # --- TPU-specific knobs (no reference counterpart) ------------------
    #: Mini-batch size (number of sampled positive edges per fused update).
    #: The reference applies Hogwild updates one sample at a time
    #: (src/embedder.rs:1167-1302); on TPU we apply them in synchronous
    #: mini-batches under ``lax.scan``.  Smaller batches track the
    #: sequential dynamics more closely; larger batches run faster.
    batch_size: int = 16384
    #: PRNG seed for sampling.
    seed: int = 0
    #: "sum": add colliding per-node updates within a batch (closest to
    #: Hogwild; batch auto-capped at ~n/7); "mean": average them,
    #: bounding the per-node step and allowing much larger batches.
    collision_mode: str = "sum"
    #: "dense": closed-form multiplicity sweeps in the (n, k) layout
    #: (TPU-native, ~10-50x faster); "sampling": per-sample batched
    #: updates exactly mirroring the reference's Hogwild step.
    optimizer: str = "dense"
    #: scatter-free attraction in the dense optimizer (each row moves
    #: only its own endpoint; mutual pairs split the move between their
    #: two rows) — removes the reverse segment-sum per sweep.
    dense_scatter_free: bool = True
    #: write a torch.profiler trace (host and card) of each optimization
    #: phase here as a Chrome trace, ``entropy_optimization_n<n>.json``;
    #: None = off.
    trace_dir: Optional[str] = None
    #: dense optimizer: floor of the per-sweep pair closure factor.
    #: 0.02 = one clipped sample's worth ((1-2*0.49); embedder.rs:1228);
    #: deeper single-sweep closed-form closure pushes pair gaps below
    #: f32 resolution — an absorbing exact-coincidence state that
    #: produced >=51-point piles at 2M nodes (see PERF.md).
    dense_f_min: float = 1e-3
    #: dense optimizer: per-sweep bernoulli probability that an edge's
    #: own multiplicity fires (scaled 1/p to preserve expectation).
    #: < 1 reintroduces the per-sample sampling noise the deterministic
    #: sweeps lack; 1.0 disables masking.
    dense_mask_p: float = 1.0
    #: sub-sweeps per gradient batch for the dense optimizer; 60 gives
    #: sync + multiplicity granularity that empirically *beats* the
    #: per-sample optimizer's embedding quality on the bench workload
    #: (see tests + /tmp/dense_tune*.log studies); raise (e.g. 120) for
    #: even finer granularity at proportional cost.
    n_sub: int = 60
    #: optional n_sub SCHEDULE: tuple of (n_batches, n_sub) phases
    #: summing to nb_grad_batch, run under the same global gamma decay
    #: (e.g. ((30, 60), (30, 120)): coarse sub-sweeps while gamma is
    #: large, fine ones late).  Per-sweep cost is granularity-
    #: independent (PERF.md gather floor), so a schedule trades total
    #: sweep count against conservation.  None = flat n_sub.
    n_sub_schedule: Optional[tuple] = None
    #: node-block sub-sweeps: split every sub-sweep into this many
    #: contiguous node blocks (1 = off).  Per-edge visits per batch —
    #: and the per-batch neighbour-gather volume that floors the
    #: large-n optimize wall (PERF.md: 0.22 s/sweep at 11M) — drop to
    #: n_sub / (n_groups * dense_n_blocks), while sync granularity
    #: RISES to n_sub * dense_n_blocks block-updates per batch (each
    #: gathered coordinate is fresher).  n_sub must be divisible by
    #: n_groups * dense_n_blocks.  Only meaningful in the gather-bound
    #: regime (n >~ 10^6); at bench scale the sweep is dispatch-bound
    #: and more, smaller sweeps hurt.
    dense_n_blocks: int = 1
    #: pack the (2, n) coordinate table into one complex64 lane for the
    #: neighbour gather (d=2, transposed path only; BIT-exact — c64 is
    #: exactly two f32s).  Halves the gathered element count; whether
    #: that halves the gather wall depends on whether the chip's gather
    #: is per-element- or per-slice-bound (microbench `gather_packing`
    #: in tools/microbench_tpu.py decides; off until measured).
    dense_packed_gather: bool = False
    #: reject negatives that are neighbours of the kicked node
    #: (reference embedder.rs:1246-1252).  The (n_neg, k, n) membership
    #: compare is the sweep's largest elementwise op; False skips it,
    #: admitting a neighbour as a negative with probability k/n per
    #: kick (an O(k/n) repulsion surplus — measurable only as a wall
    #: lever, see the round-4 sweep study).  True = reference
    #: semantics.
    dense_neighbor_exclusion: bool = True
    #: compute the sweep's n_neg repulsion kicks as ONE stacked
    #: (n_neg, d, n) program against the post-attraction snapshot
    #: (summed) instead of the reference's sequential per-kick chain
    #: (embedder.rs:1244-1299, each kick reading the running yi).
    #: At kernel-count-bound sizes (70k bench point: ~1 ms/sweep vs
    #: ~40 us of modeled HBM traffic) the sequential chain of n_neg
    #: dependent fusions IS the optimize wall; the stacked form is a
    #: granularity change only — same partners, same per-kick caps
    #: (coeff <= 2, pole >= 1/16), same rejection masks.  Off = exact
    #: reference sequencing.
    dense_parallel_kicks: bool = False
    #: reuse one neighbour-coordinate gather for this many consecutive
    #: sweeps of the same column group (transposed path, n_blocks=1).
    #: The (d, kg, n) gather is per-element-bound at ~305M elem/s on
    #: the chip and is 65% of the 11M sweep (PERF.md round-5 sweep
    #: decomposition); reuse=S amortizes it S-fold while the self
    #: position, repulsion pool, RNG stream and step schedule stay
    #: exactly fresh.  Neighbour positions are then <= S-1 sweeps
    #: stale — within the reference's Hogwild staleness envelope
    #: (embedder.rs:873-918 reads positions a full unsynchronised
    #: batch stale).  1 = exact synchronous sweeps (default);
    #: conservation at S>1 is A/B-measured per operating point.
    dense_gather_reuse: int = 1
    #: fraction of the global batch schedule that runs EXACT (fresh
    #: gather every sweep) before stale reuse activates.  Early
    #: batches have large gamma — big per-sweep displacements make
    #: S-sweep-old neighbour positions genuinely wrong and the 20k
    #: manifold A/B shows the conservation cost concentrates there;
    #: late batches polish with tiny steps where staleness is
    #: invisible.  0.0 = stale from the first sweep.
    dense_gather_reuse_after: float = 0.0

    def log(self) -> None:
        logger.info("EmbedderParams: %s", dataclasses.asdict(self))

    # setter-style API mirroring the reference (embedparams.rs:134-180)
    def set_dim(self, dim: int) -> None:
        self.asked_dim = dim

    def set_dmap_init(self, val: bool) -> None:
        self.dmap_init = val

    def set_nb_gradient_batch(self, nb_batch: int) -> None:
        self.nb_grad_batch = nb_batch

    def set_nb_edge_sampling(self, nb_sample_by_edge: int) -> None:
        self.nb_sampling_by_edge = nb_sample_by_edge

    def set_hierarchy_layer(self, layer: int) -> None:
        self.hierarchy_layer = layer

    def get_dimension(self) -> int:
        return self.asked_dim

    def get_hierarchy_layer(self) -> int:
        return self.hierarchy_layer


@dataclasses.dataclass
class DiffusionParams:
    """Parameters of the variable-bandwidth diffusion maps.

    Reference: src/diffmaps.rs:72-248 (Berry--Harlim variable-bandwidth
    kernels).  ``alfa`` is the density-renormalization exponent
    (Coifman--Lafon), ``beta`` the density-to-scale exponent
    (``rho = q^beta``, beta <= 0), ``epsil`` the kernel width and ``t`` the
    diffusion time.
    """

    asked_dim: int = 2
    alfa: float = 0.5
    beta: float = -0.1
    epsil: float = 2.0
    t: Optional[float] = None
    #: Number of neighbours used in the Laplacian graph (None = all of k).
    gnbn: Optional[int] = None
    #: Hierarchical layer (None/0 = embed the full graph).
    h_layer: Optional[int] = None
    #: Subspace iterations of the randomized spectral solve — TPU knob;
    #: default = the reference's 5 (graphlaplace.rs:115).  The init only
    #: seeds the CE optimizer, so fewer iterations can be quality-neutral
    #: (A/B per workload before lowering).
    svd_n_iter: int = 5

    # clamped setters mirroring diffmaps.rs:122-160
    def set_alfa(self, alfa: float) -> None:
        lo, hi = -2.0, 1.0
        if not (lo <= alfa <= hi):
            self.alfa = min(max(alfa, lo), hi)
            logger.warning("alfa clamped to %.3e", self.alfa)
            return
        self.alfa = alfa

    def set_beta(self, beta: float) -> None:
        if -1.01 <= beta <= 0.0:
            self.beta = beta
        else:
            logger.warning("not changing beta; beta should be in [-1, 0]")

    def set_epsil(self, epsil: float) -> None:
        self.epsil = min(max(epsil, 0.5), 4.0)

    def set_gnbn(self, nbn: int) -> None:
        self.gnbn = nbn

    def set_hlayer(self, layer: int) -> None:
        self.h_layer = layer

    def set_embedding_dimension(self, dim: int) -> None:
        self.asked_dim = dim

    def get_hlayer(self) -> int:
        return self.h_layer or 0

    @staticmethod
    def with_variable_bandwidth() -> "DiffusionParams":
        """Reference diffmaps.rs:198-208."""
        return DiffusionParams(asked_dim=2, alfa=0.5, beta=-0.1, epsil=1.5,
                               t=5.0, gnbn=12)

    @staticmethod
    def with_fixed_bandwidth() -> "DiffusionParams":
        """Reference diffmaps.rs:211-221."""
        return DiffusionParams(asked_dim=2, alfa=1.0, beta=0.0, epsil=2.0,
                               t=5.0, gnbn=16)

    @staticmethod
    def reference_default() -> "DiffusionParams":
        """Reference ``Default`` impl (diffmaps.rs:225-237)."""
        return DiffusionParams(asked_dim=2, alfa=1.0, beta=0.0, epsil=2.0,
                               t=5.0, gnbn=12)


@dataclasses.dataclass
class KnnParams:
    """kNN graph construction knobs.

    Replaces the HNSW parameters of the reference CLI
    (src/bin/embed.rs:52-92: max_nb_conn, ef_construction, knbn,
    scale_modification).  The graph is built with tiled distance panels
    + top-k, exactly up to ``brute_force_limit`` rows and above it with
    an IVF coarse quantizer, a cell-blocked local join and NN-descent
    refinement.
    """

    #: Number of neighbours kept per node (reference CLI default knbn=10).
    knbn: int = 10
    #: Distance name: "DistL2" | "DistL1" | "DistCosine" | "DistJeffreys"
    #: | "DistJensenShannon" (reference bin/embed.rs:546-565).
    distance: str = "DistL2"
    #: Row-panel size of the tiled distance computation.
    block_rows: int = 1024
    #: Above this many points, switch from exact brute force to IVF search.
    brute_force_limit: int = 200_000
    #: IVF: number of coarse centroids (0 = auto, 4 sqrt(n)).
    nlist: int = 0
    #: IVF: number of closest centroid cells probed per query.
    #: (at 1M x 28 the defaults give recall@6 0.999 on an H100; at 11M x
    #: 28, nprobe=24 with 4 rounds at rho 0.5 gives 0.983; see PERF.md)
    nprobe: int = 32
    #: Operand dtype of the L2 / cosine panels' cross product ("float32"
    #: or "bfloat16"; accumulated in f32, DistL2 results exact-reranked).
    dtype: str = "float32"
    #: NN-descent refinement rounds applied after IVF (0 = none).
    refine_rounds: int = 3
    #: Enlarged build-k: IVF + NN-descent run at build_k_factor * knbn
    #: neighbours and the final graph truncates to knbn: wider lists
    #: propagate further per NN-descent round.
    build_k_factor: float = 2.0
    #: > 0 selects top-k candidates with the TPU ApproxTopK reduction of
    #: the JAX package; it has no counterpart here and is refused.
    #: 0 = exact.
    topk_recall: float = 0.0
    #: NN-descent candidate sampling fraction (Dong's rho-sampling):
    #: each round joins over an independent per-node random subset of
    #: rho*(k+rc) of the symmetrized neighbourhood, cutting the
    #: dominant candidate-gather volume ~rho^2 per round.  1.0 = full
    #: join.
    nndescent_rho: float = 1.0
    #: IVF join memory layout: "sorted" (corpus reordered by cell once;
    #: queries and candidates are ranges of positions) or "gathered"
    #: (id tables).  Bit-identical results (tests/test_torch_ivf.py).
    ivf_layout: str = "sorted"
    #: IVF coarse quantizer: "kmeans" (any d) or "grid" (d == 2 only;
    #: strip-balanced equal-count cells + ~13 overlap-mapped block
    #: probes, e.g. for an embedded 2-D cloud; no k-means fit needed).
    quantizer: str = "kmeans"
