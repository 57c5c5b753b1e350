"""Multi-device kNN graph construction over the 1-D ``data`` mesh (port
of annembed_tpu/parallel/sharded_knn.py).

The graph build is row-parallel:

  * brute: each rank owns a row block of queries against the replicated
    corpus, the body of knn/brute.py's ``_block_topk`` on the same
    blocks, all five metrics; the (n, k) result is all-gathered;
  * IVF local join: the quantizer, the cell assignment and the tables
    are replicated (rank 0's cells broadcast), and the join's batches of
    virtual query rows are dealt to the ranks;
  * NN-descent: the union tables and their rho-sampling are replicated
    (the same generator on every rank), and the slabs of rows are dealt
    to the ranks.

The batch and slab plans are the single-device ones, built from
replicated counts, so every rank issues the same collectives and every
row is computed by the same call as on one device: the sharded graph
equals the single-device graph.  The join and NN-descent outputs are
merged by one all-reduce of zero-filled (n, k) tables per round (each row
comes from one rank).
"""

from __future__ import annotations

import torch

from ..graph.kgraph import KGraph
from ..knn.brute import _block_topk, _sqnorm, check_knobs
from ..knn.distances import check_distance, panel_rows
from ..knn.ivf import knn_graph_ivf
from ..knn.nndescent import nndescent_refine
from ..params import KnnParams
from ..utils.profiling import PhaseTimer
from .sharded import Mesh


def sharded_knn_graph_brute(x, k: int, mesh: Mesh, distance: str = "DistL2",
                            block_rows: int = 1024, dtype: str = "float32",
                            topk_recall: float = 0.0):
    """Row-sharded exact kNN graph: rank r runs the query blocks of rows
    [r s, (r + 1) s) against the replicated corpus, s a multiple of the
    block height, so the blocks are the single-device ones; the ranks'
    (s, k) results, padded, are all-gathered and the padding cut.
    Returns (indices (n, k) int32, dists (n, k) f32), replicated."""
    check_distance(distance)
    check_knobs(dtype, topk_recall)
    x = torch.as_tensor(x).to(mesh.device, torch.float32)
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    br = panel_rows(n, block_rows)
    shard_rows = -(-n // (mesh.size * br)) * br
    r0 = mesh.rank * shard_rows
    x_sq = _sqnorm(x, distance)
    idx = torch.zeros((shard_rows, k), dtype=torch.int32, device=x.device)
    dist = torch.zeros((shard_rows, k), dtype=torch.float32, device=x.device)
    for b0 in range(r0, min(r0 + shard_rows, n), br):
        b1 = min(b0 + br, n)
        ids = torch.arange(b0, b1, device=x.device)
        idx[b0 - r0:b1 - r0], dist[b0 - r0:b1 - r0] = _block_topk(
            x[b0:b1], x, x_sq, k, distance, self_ids=ids, dtype=dtype)
    return mesh.all_gather_rows(idx)[:n], mesh.all_gather_rows(dist)[:n]


def sharded_knn_graph_ivf(x, k: int, mesh: Mesh, distance: str = "DistL2",
                          nlist: int = 0, nprobe: int = 32,
                          dtype: str = "float32", kmeans_iter: int = 10,
                          seed: int = 0, sample_size: int = 500_000,
                          topk_recall: float = 0.0, quantizer: str = "kmeans",
                          layout: str = "sorted", kmeans_sample_ids=None,
                          kmeans_init_ids=None, timer: PhaseTimer = None):
    """IVF local join with its batches of virtual query rows dealt over
    the mesh: quantizer fit, cell assignment and tables with the
    single-device seeds (rank 0's cells broadcast), both layouts
    ("sorted", "gathered") and both quantizers.  The output equals
    knn/ivf.py::knn_graph_ivf."""
    x = torch.as_tensor(x).to(mesh.device, torch.float32)
    return knn_graph_ivf(x, k, distance=distance, nlist=nlist, nprobe=nprobe,
                         dtype=dtype, kmeans_iter=kmeans_iter, seed=seed,
                         sample_size=sample_size, topk_recall=topk_recall,
                         quantizer=quantizer, layout=layout,
                         kmeans_sample_ids=kmeans_sample_ids,
                         kmeans_init_ids=kmeans_init_ids, timer=timer,
                         mesh=mesh)


def sharded_nndescent_refine(x, indices, dists, mesh: Mesh,
                             n_rounds: int = 2, rev_capacity: int = 0,
                             distance: str = "DistL2", dtype: str = "float32",
                             rho: float = 1.0, seed: int = 0, uniforms=None,
                             timer: PhaseTimer = None):
    """NN-descent with each round's slabs dealt over the mesh: the
    symmetrized-neighbourhood tables and the rho-sampling run replicated
    with the single-device seeds, and the bf16 score path ends in the
    exact rerank, its slabs dealt too.  The output equals
    knn/nndescent.py::nndescent_refine."""
    dev = mesh.device
    return nndescent_refine(
        torch.as_tensor(x).to(dev, torch.float32),
        torch.as_tensor(indices).to(dev), torch.as_tensor(dists).to(dev),
        n_rounds=n_rounds, rev_capacity=rev_capacity, distance=distance,
        dtype=dtype, rho=rho, seed=seed, uniforms=uniforms, timer=timer,
        mesh=mesh)


def sharded_build_kgraph(x, knbn: int, mesh: Mesh, distance: str = "DistL2",
                         params: KnnParams | None = None,
                         timer: PhaseTimer | None = None) -> KGraph:
    """Sharded twin of knn/api.py::build_kgraph: brute up to
    ``brute_force_limit`` rows, IVF + NN-descent above at the enlarged
    build k (``build_k_factor``), cut to ``knbn``; the same seeds and
    the same graph, only the joins distributed.  ``timer`` receives the
    IVF build's phases."""
    if params is None:
        params = KnnParams(knbn=knbn, distance=distance)
    x = torch.as_tensor(x).to(mesh.device, torch.float32)
    if x.shape[0] <= params.brute_force_limit:
        idx, dist = sharded_knn_graph_brute(
            x, knbn, mesh, distance=distance, block_rows=params.block_rows,
            dtype=params.dtype, topk_recall=params.topk_recall)
        return KGraph(indices=idx, dists=dist)
    kb = knbn
    if params.refine_rounds > 0 and params.build_k_factor > 1.0:
        kb = max(knbn + 1, int(round(knbn * params.build_k_factor)))
    idx, dist = sharded_knn_graph_ivf(
        x, kb, mesh, distance=distance, nlist=params.nlist,
        nprobe=params.nprobe, dtype=params.dtype,
        topk_recall=params.topk_recall, quantizer=params.quantizer,
        layout=params.ivf_layout, timer=timer)
    if params.refine_rounds > 0:
        idx, dist = sharded_nndescent_refine(
            x, idx, dist, mesh, n_rounds=params.refine_rounds,
            distance=distance, dtype=params.dtype, rho=params.nndescent_rho,
            timer=timer)
    return KGraph(indices=idx[:, :knbn].contiguous(),
                  dists=dist[:, :knbn].contiguous())
