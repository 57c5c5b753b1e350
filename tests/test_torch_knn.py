"""Parity of the port's kNN modules with the JAX package: brute graph and
search (indices equal, dists rtol 1e-5), the top-1 twin against the
Pallas kernel in interpret mode (indices equal, dists rtol 1e-5), the
hierarchical projection with the JAX sample ids injected, and the CUDA
kernel against its twin on a card (indices outside near-ties, d^2 to
1e-5 of |q|^2 + |c|^2)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from annembed_tpu.knn.brute import (knn_graph_brute as j_graph,
                                    knn_search_brute as j_search)
from annembed_tpu.knn.distances import _l2_pair as j_pair, l2_panel as j_panel
from annembed_tpu.knn.hierarchy import build_projection as j_projection
from annembed_tpu.ops.top1 import top1_l2 as j_top1
from annembed_tpu_torch.knn.api import recall_at_k, sampled_exact_recall
from annembed_tpu_torch.knn.brute import (knn_graph_brute as t_graph,
                                          knn_search_brute as t_search)
from annembed_tpu_torch.knn.distances import corpus_sqnorm, l2_expansion
from annembed_tpu_torch.knn.distances import l2_pair as t_pair
from annembed_tpu_torch.knn.distances import l2_panel as t_panel
from annembed_tpu_torch.knn.hierarchy import build_projection as t_projection
from annembed_tpu_torch.ops.top1 import launch_count as top1_launch_count
from annembed_tpu_torch.ops.top1 import top1_l2, top1_l2_reference
from annembed_tpu_torch.graph.kgraph import KGraph

RTOL = 1e-5


def _check(t_out, j_out, what):
    ti, td = t_out
    ji, jd = j_out
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                  err_msg=f"{what}: indices must be equal")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=1e-6, err_msg=f"{what}: dists rtol 1e-5")


def test_l2_panel_and_pair_match_jax(rng):
    q = rng.normal(size=(40, 7)).astype(np.float32)
    x = rng.normal(size=(90, 7)).astype(np.float32) + 2.0
    np.testing.assert_allclose(
        t_panel(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(j_panel(jnp.asarray(q), jnp.asarray(x))), rtol=RTOL,
        atol=1e-5, err_msg="L2 panel, rtol 1e-5 (atol 1e-5: expansion)")
    np.testing.assert_allclose(
        t_pair(torch.from_numpy(q[:, None]), torch.from_numpy(x[None])).numpy(),
        np.asarray(j_pair(q[:, None], x[None])), rtol=RTOL,
        err_msg="L2 pair form, rtol 1e-5")


@pytest.mark.parametrize("n,d,k", [(300, 10, 7), (64, 3, 5), (12, 4, 11)])
def test_knn_graph_brute_matches_jax(rng, n, d, k):
    x = rng.normal(size=(n, d)).astype(np.float32)
    _check(t_graph(torch.from_numpy(x), k, block_rows=100),
           j_graph(x, k=k, block_rows=100), "knn_graph_brute")


def test_knn_graph_brute_duplicate_points(rng):
    x = rng.normal(size=(50, 3)).astype(np.float32)
    x = np.concatenate([x, x[:10]], axis=0)
    ti, td = t_graph(torch.from_numpy(x), 3)
    _check((ti, td), j_graph(x, k=3), "duplicate points")
    assert not (ti.numpy() == np.arange(60)[:, None]).any()
    assert td.min().item() == 0.0


def test_knn_search_brute_matches_jax(rng):
    corpus = rng.normal(size=(128, 6)).astype(np.float32)
    queries = rng.normal(size=(37, 6)).astype(np.float32)
    _check(t_search(torch.from_numpy(queries), torch.from_numpy(corpus), 4,
                    block_rows=16),
           j_search(queries, corpus, k=4, block_rows=16), "knn_search_brute")


def test_recall_helpers(rng):
    x = rng.normal(size=(200, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    idx, dist = t_graph(xt, 6)
    assert sampled_exact_recall(xt, KGraph(idx, dist), sample=50) == 1.0
    assert recall_at_k(torch.tensor([[1, 2]]), torch.tensor([[2, 3]])) == 0.5


@pytest.mark.parametrize("nq,m,d,shift,block_q,tile_m", [
    (300, 500, 16, 0.0, 128, 256),   # tests/test_ops.py shapes
    (77, 131, 5, 10.0, 32, 64),
])
def test_top1_twin_matches_pallas_interpret(rng, nq, m, d, shift, block_q,
                                            tile_m):
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(m, d)).astype(np.float32) + shift
    j_out = j_top1(q, c, block_q=block_q, tile_m=tile_m, interpret=True)
    before = top1_launch_count()
    t_out = top1_l2(torch.from_numpy(q), torch.from_numpy(c))
    _check(t_out, j_out, "top1_l2 twin vs Pallas interpret")
    assert top1_launch_count() == before, "CPU tensors must not launch"


def test_top1_twin_ties_go_to_lowest_index():
    c = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
                 np.float32)
    q = np.array([[0.0, 0.0], [2.0, 0.0]], np.float32)
    idx, dist = top1_l2_reference(torch.from_numpy(q), torch.from_numpy(c))
    assert idx.tolist() == [0, 0]
    np.testing.assert_allclose(dist.numpy(), [1.0, 1.0])


def test_top1_rejects_bad_inputs():
    with pytest.raises(TypeError):
        top1_l2(torch.zeros(3, 2, dtype=torch.float64), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        top1_l2(torch.zeros(3, 2), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        top1_l2(torch.zeros(2, 3).T, torch.zeros(4, 2))


def test_build_projection_matches_jax(rng):
    x = rng.normal(size=(400, 5)).astype(np.float32)
    jp = j_projection(x, 6, sample_fraction=0.2, seed=5)
    tp = t_projection(torch.from_numpy(x), 6, sample_fraction=0.2,
                      sample_ids=torch.from_numpy(np.array(jp.sample_ids)))
    np.testing.assert_array_equal(tp.sample_ids.numpy(),
                                  np.asarray(jp.sample_ids))
    np.testing.assert_array_equal(tp.proj_small_idx.numpy(),
                                  np.asarray(jp.proj_small_idx),
                                  err_msg="projection indices must be equal")
    np.testing.assert_allclose(tp.proj_dist.numpy(), np.asarray(jp.proj_dist),
                               rtol=RTOL, atol=1e-6,
                               err_msg="projection dists rtol 1e-5")
    for name in ("small_graph", "large_graph"):
        _check((getattr(tp, name).indices, getattr(tp, name).dists),
               (getattr(jp, name).indices, getattr(jp, name).dists), name)
    assert set(tp.timings) == {"small_graph", "large_graph", "projection"}


def test_build_projection_draws_from_generator(rng):
    x = torch.from_numpy(rng.normal(size=(100, 4)).astype(np.float32))
    a = t_projection(x, 4, sample_fraction=0.2, seed=9)
    b = t_projection(x, 4, sample_fraction=0.2, seed=9)
    assert a.sample_ids.tolist() == b.sample_ids.tolist()
    assert a.nb_small == 20
    assert (a.proj_dist[a.sample_ids] == 0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# chip_smoke.py's kernel tolerances: the expansion (|q|^2 + |c|^2) - 2 q.c
# rounds at the scale of |q|^2 + |c|^2, and the kernel's 3xTF32 products
# round in another order than the twin's f32 SGEMM, so indices must agree
# wherever the twin's best and second-best d^2 are further apart than
# TIE_REL of that scale, and squared distances to D2_REL of it.
TIE_REL = 1e-5
D2_REL = 1e-5


def _assert_kernel_matches_twin(q, c, ki, kd):
    ri, rd = top1_l2_reference(q, c)
    c_sq = corpus_sqnorm(c)
    vals, first = torch.topk(l2_expansion(q, c, c_sq), min(2, c.shape[0]),
                             dim=1, largest=False)
    scale = torch.square(q).sum(1) + c_sq[first[:, 0]]
    if c.shape[0] > 1:
        clear = (vals[:, 1] - vals[:, 0]) > TIE_REL * scale
    else:
        clear = torch.ones_like(scale, dtype=torch.bool)
    bad_idx = int(((ki != ri) & clear).sum())
    bad_d2 = int(((kd.square() - rd.square()).abs() > D2_REL * scale).sum())
    assert bad_idx == 0, f"{bad_idx} index mismatches outside near-ties"
    assert bad_d2 == 0, f"{bad_d2} squared distances beyond D2_REL"


@pytest.mark.gpu
@pytest.mark.parametrize("nq,m,d,shift", [
    (4096, 3000, 784, 0.0), (77, 131, 5, 0.0), (5000, 2000, 28, 0.0),
    (77, 131, 5, 10.0),                      # offset corpus
    (300, 257, 1, 0.0), (1000, 129, 31, 0.0), (999, 1000, 33, 0.0),
    (130, 1, 28, 0.0),                       # one corpus row
    (1001, 3001, 784, 0.0),                  # every edge off its tile
])
def test_top1_kernel_matches_twin_on_card(cuda_device, nq, m, d, shift):
    g = torch.Generator().manual_seed(nq + m + d)
    q = torch.randn(nq, d, generator=g).to(cuda_device)
    c = (torch.randn(m, d, generator=g) + shift).to(cuda_device)
    before = top1_launch_count()
    ki, kd = top1_l2(q, c)
    torch.cuda.synchronize()
    assert top1_launch_count() == before + 1
    _assert_kernel_matches_twin(q, c, ki, kd)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [28, 784])
def test_top1_kernel_self_queries_on_card(cuda_device, d):
    """Queries that are corpus rows: d^2 ~ 0, possibly negative before
    the clamp."""
    g = torch.Generator().manual_seed(d)
    c = torch.randn(1500, d, generator=g).to(cuda_device)
    rows = torch.randint(0, 1500, (2000,), generator=g).to(cuda_device)
    q = c[rows].contiguous()
    ki, kd = top1_l2(q, c)
    torch.cuda.synchronize()
    _assert_kernel_matches_twin(q, c, ki, kd)
    assert torch.equal(ki, rows.to(torch.int32))
    assert bool((kd >= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [5, 28, 784])
def test_top1_kernel_duplicates_go_to_lowest_index_on_card(cuda_device, d):
    """The same corpus row at columns in other corpus tiles (tiles of
    128 rows, a ring of 4) and at other lanes of one tile: the lowest
    column wins."""
    g = torch.Generator().manual_seed(d)
    c = torch.randn(2000, d, generator=g)
    copies = [3, 6, 131, 3 + 4 * 128, 1999]
    c[copies] = c[copies[-1]].clone()
    q = c[copies[-1]] + 1e-3 * torch.randn(50, d, generator=g)
    ki, _ = top1_l2(q.to(cuda_device), c.to(cuda_device))
    torch.cuda.synchronize()
    assert ki.tolist() == [3] * 50
