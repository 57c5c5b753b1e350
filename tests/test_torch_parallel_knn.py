"""The port's sharded graph builds (parallel/sharded_knn.py), its sharded
SVD (parallel/sharded_svd.py), ``build_projection(mesh=)`` and the
diffusion maps under a mesh, on gloo ranks of the CPU, against

* the port's single-device functions on the same rows and draws: graphs
  bit for bit, at W = 2 and at W = 3 (ragged shards and slabs); the SVD
  to rtol 2e-4 with leading |u1.u2| > 0.98 (the all-reduce reassociates
  the SpMM's sums); the diffusion coordinates to 1e-4 up to sign;
* the JAX package's sharded functions on ``make_mesh(2)`` of its virtual
  8-device CPU mesh, the JAX draws injected (k-means initialization,
  NN-descent uniforms, the SVD's test matrix): ids equal on AGREE of the
  columns outside near-ties (the port's IVF tests' definition: the last
  bits of a panel depend on the matmul's summation order, so a tie the
  row cannot show may swap) and distances to 1e-6 where the ids agree;
  the SVD as above;
  the diffusion coordinates to 5e-3 up to sign, the tolerance of
  tests/test_parallel.py::test_dmap_embed_mesh_matches_single.

One spawned group of ranks per mesh size serves the whole module, and
every rank's results are held bit-equal to rank 0's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.graph.kgraph import symmetric_coo as j_symmetric_coo
from annembed_tpu.knn.brute import knn_graph_brute as j_brute
from annembed_tpu.knn.ivf import ivf_sizing as j_ivf_sizing
from annembed_tpu.knn.ivf import knn_graph_ivf as j_ivf
from annembed_tpu.params import DiffusionParams as JDP
from annembed_tpu.params import KnnParams as JKnnParams
from annembed_tpu.parallel import sharded_knn as jsk
from annembed_tpu.parallel.sharded import make_mesh as j_make_mesh
from annembed_tpu.parallel.sharded_svd import sharded_randomized_svd_coo \
    as j_sharded_svd
from annembed_tpu.spectral.diffmaps import DiffusionMaps as JDM
from annembed_tpu_torch.interop import kgraph_from_numpy
from annembed_tpu_torch.knn.api import build_kgraph
from annembed_tpu_torch.knn.brute import knn_graph_brute
from annembed_tpu_torch.knn.hierarchy import build_projection
from annembed_tpu_torch.knn.ivf import knn_graph_ivf
from annembed_tpu_torch.knn.nndescent import nndescent_refine
from annembed_tpu_torch.linalg.rsvd import randomized_svd_coo
from annembed_tpu_torch.parallel.calls import call_each
from annembed_tpu_torch.parallel.launch import run_on_ranks
from annembed_tpu_torch.params import DiffusionParams, KnnParams
from annembed_tpu_torch.spectral.diffmaps import DiffusionMaps

MESHES = (2, 3)
TIE_REL = 1e-5
AGREE = 0.999
D_ATOL = 1e-6
P = "annembed_tpu_torch.parallel."
METRICS = ("DistL2", "DistCosine", "DistL1", "DistJeffreys",
           "DistJensenShannon")
DMAP = dict(asked_dim=2, alfa=0.5, beta=-0.1, t=5.0, gnbn=8)
IVF_CASES = {
    "kmeans_sorted": dict(quantizer="kmeans", layout="sorted"),
    "kmeans_gathered": dict(quantizer="kmeans", layout="gathered"),
    "grid_sorted": dict(quantizer="grid", layout="sorted"),
    "grid_gathered": dict(quantizer="grid", layout="gathered"),
}
NND_CASES = {"f32": dict(n_rounds=2), "rho": dict(n_rounds=2, rho=0.5),
             "bf16": dict(n_rounds=1, dtype="bfloat16")}
DISPATCH = {"brute": dict(knbn=6),
            "ivf": dict(knbn=6, brute_force_limit=500, nlist=20, nprobe=5,
                        refine_rounds=2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(rng, n, d, centers=8, spread=4.0, noise=0.5):
    c = rng.normal(size=(centers, d)) * spread
    return (c[rng.integers(0, centers, n)]
            + noise * rng.normal(size=(n, d))).astype(np.float32)


def _jax_choice(seed, n, m):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (m,),
                                        replace=False))


def _jax_uniforms(seed, n_rounds, shape):
    key = jax.random.PRNGKey(seed + 1013)
    out = []
    for _ in range(n_rounds):
        key, k_s = jax.random.split(key)
        out.append(_t(jax.random.uniform(k_s, shape)))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4664397)
    d = {}
    d["x_l2"] = rng.normal(size=(300, 12)).astype(np.float32)
    xp = np.abs(rng.normal(size=(200, 10)).astype(np.float32)) + 0.05
    d["x_pos"] = xp / xp.sum(1, keepdims=True)
    d["x_ivf"] = _clustered(rng, 2000, 8, centers=10)
    d["x_grid"] = _clustered(rng, 4000, 2, centers=6, spread=5.0, noise=0.7)
    d["x_nnd"] = _clustered(rng, 1500, 8)
    d["x_disp"] = _clustered(rng, 1600, 8)
    d["x_svd"] = rng.normal(size=(400, 10)).astype(np.float32)
    # anisotropic, so the leading diffusion coordinates are well apart
    d["x_dmap"] = (rng.normal(size=(5200, 6))
                   * [6.0, 3.0, 1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    # the NN-descent input: the JAX package's low-probe IVF graph
    ai, ad = j_ivf(d["x_nnd"], 6, nlist=20, nprobe=5)
    d["nnd_in"] = (np.asarray(ai), np.asarray(ad))
    d["nnd_uniforms"] = _jax_uniforms(0, 2, (1500 + 1, 12))
    d["init_ids"] = _t(_jax_choice(0, 2000, j_ivf_sizing(2000, 6, 24)[0]))
    # the SVD: the JAX test's COO Laplacian and its Gaussian test matrix
    idx, dist = j_brute(d["x_svd"], k=6)
    rows, cols, vals = j_symmetric_coo(JKGraph(indices=idx, dists=dist),
                                       mode="mean")
    d["coo"] = tuple(np.asarray(a) for a in (rows, cols, vals))
    d["svd_key"] = jax.random.PRNGKey(4664397)
    d["svd_omega"] = np.asarray(jax.random.normal(d["svd_key"], (400, 20),
                                                  jnp.float32))
    idx, dist = j_brute(d["x_dmap"], k=8)
    d["dmap_graph"] = (np.asarray(idx), np.asarray(dist))
    d["dmap_omega"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(4664397), (5200, 30), jnp.float32))
    return d


def _calls(d):
    """name -> (target, args, kwargs) of every sharded call."""
    c = {}
    for metric in METRICS:
        x = d["x_l2"] if metric == "DistL2" else d["x_pos"]
        k, br = (6, 64) if metric == "DistL2" else (5, 32)
        c[f"brute_{metric}"] = (P + "sharded_knn:sharded_knn_graph_brute",
                                (_t(x), k), dict(distance=metric,
                                                 block_rows=br))
    for name, kw in (("bf16", dict(dtype="bfloat16")),
                     ("recall", dict(topk_recall=0.95))):
        c[f"brute_{name}"] = (P + "sharded_knn:sharded_knn_graph_brute",
                              (_t(d["x_l2"]), 6), dict(block_rows=64, **kw))
    for name, kw in IVF_CASES.items():
        if kw["quantizer"] == "kmeans":
            args = (_t(d["x_ivf"]), 6)
            kw = dict(kw, nlist=24, nprobe=6, kmeans_init_ids=d["init_ids"])
        else:
            args = (_t(d["x_grid"]), 8)
        c[f"ivf_{name}"] = (P + "sharded_knn:sharded_knn_graph_ivf", args, kw)
    for name, kw in NND_CASES.items():
        if "rho" in kw:
            kw = dict(kw, uniforms=d["nnd_uniforms"])
        c[f"nnd_{name}"] = (P + "sharded_knn:sharded_nndescent_refine",
                            (_t(d["x_nnd"]), *map(_t, d["nnd_in"])), kw)
    for name, kw in DISPATCH.items():
        c[f"dispatch_{name}"] = (P + "sharded_knn:sharded_build_kgraph",
                                 (_t(d["x_disp"]), 6),
                                 dict(params=KnnParams(**kw)))
    c["projection"] = ("annembed_tpu_torch.knn.hierarchy:build_projection",
                       (_t(d["x_disp"]), 6),
                       dict(sample_fraction=0.25, seed=3,
                            params=KnnParams(knbn=6, brute_force_limit=300)))
    c["svd"] = (P + "sharded_svd:sharded_randomized_svd_coo",
                tuple(map(_t, d["coo"])), dict(n=400, rank=10,
                                               omega=d["svd_omega"]))
    c["dmap"] = (P + "calls:method_call",
                 (DiffusionMaps(params=DiffusionParams(**DMAP)),
                  "embed_from_kgraph", kgraph_from_numpy(*d["dmap_graph"])),
                 dict(omega=d["dmap_omega"]))
    return c


@pytest.fixture(scope="module")
def ranks(data):
    """{W: [each rank's {name: result}]} of one spawned group per W."""
    calls = _calls(data)
    out = {}
    for w in MESHES:
        res = run_on_ranks(call_each, w, (list(calls.values()),),
                           device="cpu")
        out[w] = [dict(zip(calls, r)) for r in res]
    return out


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(2)


def _np(pair):
    return tuple(np.asarray(a) for a in pair)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _clear(dist):
    """Columns whose distance is further than TIE_REL (relative) from
    both row neighbours'."""
    scale = np.maximum(np.abs(dist), 1e-6)
    gap = np.full(dist.shape, np.inf)
    step = np.diff(dist, axis=1)
    gap[:, 1:] = step / scale[:, 1:]
    gap[:, :-1] = np.minimum(gap[:, :-1], step / scale[:, :-1])
    return gap > TIE_REL


def _agrees_with_jax(got, want):
    ti, td = (a.numpy() for a in got)
    ji, jd = _np(want)
    assert ti.shape == ji.shape
    clear = _clear(jd)
    agree = (ti[clear] == ji[clear]).mean()
    assert agree >= AGREE, f"id agreement {agree} with JAX on clear columns"
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=0, atol=D_ATOL)


def _tensors(obj):
    """The tensors of a result: a tensor, a tuple of them, a graph or a
    projection (its graphs' tensors too)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in _tensors(o)]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for f in obj.__dataclass_fields__
                for t in _tensors(getattr(obj, f))]
    return []


def test_ranks_hold_bit_equal_results(ranks):
    for w, per_rank in ranks.items():
        for name, want in per_rank[0].items():
            want_t = _tensors(want)
            assert want_t, name
            for r in range(1, w):
                got_t = _tensors(per_rank[r][name])
                assert len(got_t) == len(want_t), (w, r, name)
                for a, b in zip(got_t, want_t):
                    assert torch.equal(a, b), (w, r, name)


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_brute_matches_single_and_jax(data, ranks, jmesh, metric):
    x = data["x_l2"] if metric == "DistL2" else data["x_pos"]
    k, br = (6, 64) if metric == "DistL2" else (5, 32)
    want = knn_graph_brute(_t(x), k, distance=metric, block_rows=br)
    for w in MESHES:
        _equal(ranks[w][0][f"brute_{metric}"], want)
    jgot = jsk.sharded_knn_graph_brute(jnp.asarray(x), k, jmesh,
                                       distance=metric, block_rows=br)
    _agrees_with_jax(ranks[2][0][f"brute_{metric}"], jgot)


@pytest.mark.parametrize("knob", ["bf16", "recall"])
def test_sharded_brute_knobs(data, ranks, jmesh, knob):
    kw = dict(dtype="bfloat16") if knob == "bf16" else dict(topk_recall=0.95)
    x = data["x_l2"]
    want = knn_graph_brute(_t(x), 6, block_rows=64, **kw)
    for w in MESHES:
        _equal(ranks[w][0][f"brute_{knob}"], want)
    jgot = jsk.sharded_knn_graph_brute(jnp.asarray(x), 6, jmesh,
                                       block_rows=64, **kw)
    _agrees_with_jax(ranks[2][0][f"brute_{knob}"], jgot)


@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_sharded_ivf_matches_single_and_jax(data, ranks, jmesh, case):
    kw = IVF_CASES[case]
    if kw["quantizer"] == "kmeans":
        x, k = data["x_ivf"], 6
        want = knn_graph_ivf(_t(x), k, nlist=24, nprobe=6,
                             kmeans_init_ids=data["init_ids"], **kw)
        jkw = dict(kw, nlist=24, nprobe=6)
    else:
        x, k = data["x_grid"], 8
        want = knn_graph_ivf(_t(x), k, **kw)
        jkw = kw
    for w in MESHES:
        _equal(ranks[w][0][f"ivf_{case}"], want)
    _agrees_with_jax(ranks[2][0][f"ivf_{case}"],
                     jsk.sharded_knn_graph_ivf(x, k, jmesh, **jkw))


@pytest.mark.parametrize("case", sorted(NND_CASES))
def test_sharded_nndescent_matches_single_and_jax(data, ranks, jmesh, case):
    kw = NND_CASES[case]
    x = data["x_nnd"]
    tkw = dict(kw, uniforms=data["nnd_uniforms"]) if "rho" in kw else kw
    want = nndescent_refine(_t(x), *map(_t, data["nnd_in"]), **tkw)
    for w in MESHES:
        _equal(ranks[w][0][f"nnd_{case}"], want)
    _agrees_with_jax(ranks[2][0][f"nnd_{case}"],
                     jsk.sharded_nndescent_refine(x, *data["nnd_in"], jmesh,
                                                  **kw))


@pytest.mark.parametrize("side", sorted(DISPATCH))
def test_sharded_dispatcher_matches_single_and_jax(data, ranks, jmesh, side):
    """Both sides of ``brute_force_limit``.  Above it the two packages
    draw their own k-means starts, so the graphs are held to each other
    as two IVF + NN-descent builds (ids outside near-ties) only there."""
    x = data["x_disp"]
    kp = KnnParams(**DISPATCH[side])
    want = build_kgraph(_t(x), 6, params=kp)
    jg = jsk.sharded_build_kgraph(x, 6, jmesh,
                                  params=JKnnParams(**DISPATCH[side]))
    for w in MESHES:
        got = ranks[w][0][f"dispatch_{side}"]
        _equal((got.indices, got.dists), (want.indices, want.dists))
    _agrees_with_jax((want.indices, want.dists), (jg.indices, jg.dists))


def test_sharded_projection_matches_single(data, ranks):
    want = build_projection(_t(data["x_disp"]), 6, sample_fraction=0.25,
                            seed=3,
                            params=KnnParams(knbn=6, brute_force_limit=300))
    for w in MESHES:
        got = ranks[w][0]["projection"]
        assert set(got.timings) == set(want.timings)
        for f in ("sample_ids", "proj_small_idx", "proj_dist"):
            _equal((getattr(got, f),), (getattr(want, f),))
        for g in ("small_graph", "large_graph"):
            a, b = getattr(got, g), getattr(want, g)
            _equal((a.indices, a.dists), (b.indices, b.dists))


def _svd_agree(got_s, got_u, want_s, want_u):
    np.testing.assert_allclose(got_s, want_s, rtol=2e-4)
    lead = want_s > 0.05 * want_s[0]
    dots = np.abs((got_u * want_u).sum(0))[lead]
    assert (dots > 0.98).all(), dots


def test_sharded_svd_matches_single_and_jax(data, ranks, jmesh):
    coo = tuple(map(_t, data["coo"]))
    want = randomized_svd_coo(*coo, n=400, rank=10, omega=data["svd_omega"])
    jres = j_sharded_svd(*map(jnp.asarray, data["coo"]), data["svd_key"],
                         n=400, rank=10, mesh=jmesh)
    for w in MESHES:
        got = ranks[w][0]["svd"]
        _svd_agree(got.s.numpy(), got.u.numpy(), want.s.numpy(),
                   want.u.numpy())
    got = ranks[2][0]["svd"]
    _svd_agree(got.s.numpy(), got.u.numpy(), np.asarray(jres.s),
               np.asarray(jres.u))


def _up_to_sign(got, want, atol):
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, atol=atol)


def test_sharded_dmap_matches_single_and_jax(data, ranks, jmesh):
    """5,200 nodes: above FULL_SVD_SIZE_LIMIT, the randomized SVD."""
    want = DiffusionMaps(params=DiffusionParams(**DMAP)).embed_from_kgraph(
        kgraph_from_numpy(*data["dmap_graph"]),
        omega=data["dmap_omega"]).numpy()
    idx, dist = map(jnp.asarray, data["dmap_graph"])
    jy = np.asarray(JDM(params=JDP(**DMAP)).embed_from_kgraph(
        JKGraph(indices=idx, dists=dist), mesh=jmesh))
    for w in MESHES:
        _up_to_sign(ranks[w][0]["dmap"].numpy(), want, 1e-4)
    _up_to_sign(ranks[2][0]["dmap"].numpy(), jy, 5e-3)


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA devices (NCCL has no CPU mode)")
    return torch.cuda.device_count()


@pytest.mark.gpu
def test_nccl_builds_and_projection_match_one_card(data, cards):
    """Every card a rank over NCCL (W = 1 too): the brute, IVF (bf16
    panels) and NN-descent builds and the projection, whose top-1 runs
    the CUDA kernel on each rank, bit-equal to one card's and across the
    ranks."""
    x = _t(data["x_disp"])
    kp = KnnParams(knbn=6, brute_force_limit=300, dtype="bfloat16",
                   refine_rounds=2, nndescent_rho=0.5)
    calls = [(P + "sharded_knn:sharded_knn_graph_brute", (x, 6), {}),
             ("annembed_tpu_torch.knn.hierarchy:build_projection", (x, 6),
              dict(sample_fraction=0.25, seed=3, params=kp))]
    res = run_on_ranks(call_each, cards, (calls,), device="cuda")
    xc = x.to("cuda")
    want = [knn_graph_brute(xc, 6),
            build_projection(xc, 6, sample_fraction=0.25, seed=3, params=kp)]
    want = [[t.cpu() for t in _tensors(w)] for w in want]
    for r in range(cards):
        for got, w in zip(res[r], want):
            for a, b in zip(_tensors(got), w):
                assert torch.equal(a, b), r
