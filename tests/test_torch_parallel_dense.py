"""The port's sharded dense optimizer and semantics-check steps
(parallel/sharded.py), the multi-device entry points
(``embed`` / ``dmap_embed(n_devices=)``) and the full-fraction quality
estimate under a mesh, on gloo ranks of the CPU, against

* the JAX package's sharded functions on ``make_mesh(W)`` of its virtual
  8-device CPU mesh with the JAX draws injected (relabel permutation,
  pool offsets over the padded n, the steps' edge draws, negatives and
  permutations): one production sweep to 1e-6 (relative, and absolute
  near 0) at W = 2 and at W = 3 (ragged: inert pad rows), at grad_step
  0.02 (the sweep map is expansive at the default step, where the
  sequential kicks carry the two packages' f32 rounding far past 1e-6;
  see tests/test_torch_dense.py); the semantics-check steps to 1e-5;
* the port's single-device optimizer on the same draws: one sweep at the
  default step to 1e-6; whole runs at grad_step 0.02 with the n_sub
  schedule, the stacked kicks and the stale gather to 1e-4; the packed
  gather bit for bit; separation of two clusters at the default step;
  ``embed(n_devices=2)`` by the quantiles of the JAX package's
  test_api_embed_multichip_parity against a single-device run on one
  thread, as each CPU rank runs (the exact SVD of the initialization
  rounds differently on more threads, and the default step amplifies
  that past the quantiles in four sweeps).

One spawned group of ranks per mesh size serves the optimizer's calls,
and every rank's results are held bit-equal to rank 0's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annembed_tpu_torch as ta
from annembed_tpu.estimators.quality import quality_estimate as j_quality
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.graph.proba import to_proba_edges as j_proba
from annembed_tpu.knn.brute import knn_graph_brute as j_brute
from annembed_tpu.optim.ce import build_edge_set as j_edge_set
from annembed_tpu.params import EmbedderParams as JEP
from annembed_tpu.params import KnnParams as JKnnParams
from annembed_tpu.parallel import sharded as js
from annembed_tpu_torch.estimators.quality import quality_estimate
from annembed_tpu_torch.interop import kgraph_from_numpy, nodeparams_from_numpy
from annembed_tpu_torch.optim import dense as td
from annembed_tpu_torch.optim.ce import NB_NEGATIVE, build_edge_set
from annembed_tpu_torch.parallel.calls import call_each
from annembed_tpu_torch.parallel.launch import run_on_ranks
from annembed_tpu_torch.parallel.sharded import make_mesh
from annembed_tpu_torch.params import EmbedderParams as TEP
from annembed_tpu_torch.params import KnnParams

MESHES = (2, 3)
P = "annembed_tpu_torch.parallel."
OPT = P + "sharded:sharded_dense_optimize"
RUNS = {    # whole runs at a small step, held to the single device
    "schedule": dict(nb_grad_batch=8, n_sub_schedule=((4, 24), (4, 48))),
    "kicks": dict(nb_grad_batch=6, dense_parallel_kicks=True),
    "stale": dict(nb_grad_batch=8, n_sub_schedule=((4, 24), (4, 48)),
                  dense_gather_reuse=4, dense_gather_reuse_after=0.5),
}
PACKED = dict(nb_grad_batch=6, n_sub_schedule=((3, 12), (3, 24)))
QUALITY_KNN = dict(knbn=6, brute_force_limit=1000)
# one sweep of 20 sequential kicks (n_neg = 5 * 1 * k / n_sub)
SWEEP = dict(nb_grad_batch=2, n_sub=1, nb_sampling_by_edge=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graphs(x, k):
    """The JAX brute graph and edge probabilities of ``x``, and the same
    state in the port."""
    idx, dist = j_brute(x, k=k)
    jg = JKGraph(indices=idx, dists=dist)
    jn = j_proba(jg)
    return (jg, jn, kgraph_from_numpy(idx, dist),
            nodeparams_from_numpy(jn.scale, jn.probas))


def _jax_draws(seed, n, ndev, total):
    """The relabel permutation and the pool offsets (over the padded n)
    of one single-phase ``sharded_dense_optimize`` of ``total`` sweeps
    on ``ndev`` devices at the JAX package's segment sizes."""
    key, k_relabel = jax.random.split(jax.random.PRNGKey(seed))
    relabel = np.asarray(jax.random.permutation(k_relabel, n))
    n_pad = n + (-n) % ndev
    if n_pad != n:
        key, _ = jax.random.split(key)
    segments = td._segments(total, n_pad // ndev, 2, 1, 1, 2, 0, 1, 0.0)
    offsets = []
    for seg_key, (_, steps, _) in zip(jax.random.split(key, len(segments)),
                                      segments):
        keys = jax.random.split(seg_key, steps)
        offsets += np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, n_pad))(keys)).tolist()
    return relabel, offsets


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4664397)
    d = {}
    x = rng.normal(size=(256, 16)).astype(np.float32)
    d["sweep"] = _graphs(x, 4)
    d["y0"] = rng.uniform(-5, 5, (256, 2)).astype(np.float32)
    centers = rng.normal(size=(2, 8)) * 12
    d["x2"] = np.concatenate([centers[i] + rng.normal(size=(128, 8))
                              for i in range(2)]).astype(np.float32)
    d["labels2"] = np.repeat(np.arange(2), 128)
    d["two"] = _graphs(d["x2"], 4)
    d["draws"] = {w: _jax_draws(0, 256, w, 1) for w in MESHES}
    # the semantics-check steps: each rank's JAX draws
    key = jax.random.PRNGKey(0)
    train, dense = [], []
    for dev in range(2):
        k_edge, k_neg = jax.random.split(jax.random.fold_in(key, dev))
        train.append((_t(jax.random.uniform(k_edge, (64,))),
                      _t(jax.random.randint(k_neg, (64, NB_NEGATIVE), 0, 256,
                                            dtype=jnp.int32))))
        k_perm, k_off = jax.random.split(jax.random.fold_in(key, dev))
        dense.append((_t(jax.random.permutation(k_perm, 256)),
                      int(jax.random.randint(k_off, (), 0, 256))))
    d["train_draws"], d["dense_draws"] = train, dense
    # the quality estimate's clouds: 3-D through k-means, 2-D through the
    # grid quantizer under a mesh
    d["y3"] = rng.normal(size=(3000, 3)).astype(np.float32)
    d["y2"] = rng.normal(size=(3000, 2)).astype(np.float32)
    d["quality_graph"] = _graphs(rng.normal(size=(3000, 6)).astype(
        np.float32), 6)
    return d


def _calls(d, w):
    """name -> (target, args, kwargs) of the sharded calls at W = w."""
    _, _, tg, tn = d["sweep"]
    y0 = _t(d["y0"])
    relabel, offsets = d["draws"][w]
    c = {"sweep": (OPT, (y0, tg, tn, TEP(**SWEEP)),
                   dict(relabel=relabel, offsets=offsets)),
         "sweep_small": (OPT, (y0, tg, tn, TEP(grad_step=0.02, **SWEEP)),
                         dict(relabel=relabel, offsets=offsets))}
    _, _, tg2, tn2 = d["two"]
    c["separate"] = (OPT, (y0, tg2, tn2, TEP(nb_grad_batch=8)), {})
    if w == 2:
        for name, kw in RUNS.items():
            c[name] = (OPT, (y0, tg2, tn2, TEP(grad_step=0.02, **kw)), {})
        c["plain"] = (OPT, (y0, tg, tn, TEP(**PACKED)), {})
        c["packed"] = (OPT, (y0, tg, tn, TEP(dense_packed_gather=True,
                                             **PACKED)), {})
        c["train_step"] = (P + "calls:train_step_once",
                           (y0, 0, build_edge_set(tg, tn), 1.0),
                           dict(draws=d["train_draws"]))
        c["dense_step"] = (P + "calls:dense_step_once",
                           (y0, 0, tg, tn, TEP(n_sub=10), 1.0),
                           dict(draws=d["dense_draws"]))
    _, _, qg, _ = d["quality_graph"]
    for dim in (2, 3):
        c[f"quality_{dim}"] = (
            "annembed_tpu_torch.estimators.quality:quality_estimate",
            (qg, _t(d[f"y{dim}"])),
            dict(nbng=10, knn_params=KnnParams(**QUALITY_KNN)))
    return c


@pytest.fixture(scope="module")
def ranks(data):
    """{W: [each rank's {name: result}]} of one spawned group per W."""
    out = {}
    for w in MESHES:
        calls = _calls(data, w)
        res = run_on_ranks(call_each, w, (list(calls.values()),),
                           device="cpu")
        out[w] = [dict(zip(calls, r)) for r in res]
    return out


def _y(result):
    """The embedding of a ``sharded_dense_optimize`` result."""
    return result[0] if isinstance(result, tuple) else result


def _accuracy(y, labels):
    mus = np.stack([y[labels == i].mean(0) for i in range(2)])
    return (np.linalg.norm(y[:, None] - mus[None], axis=-1).argmin(1)
            == labels).mean()


def test_ranks_hold_bit_equal_results(ranks):
    for w, per_rank in ranks.items():
        for name, want in per_rank[0].items():
            for r in range(1, w):
                got = per_rank[r][name]
                if hasattr(want, "summary"):
                    assert got.summary() == want.summary(), (w, r, name)
                    assert torch.equal(got.radius, want.radius)
                else:
                    assert torch.equal(_y(got), _y(want)), (w, r, name)


@pytest.mark.parametrize("w", MESHES)
def test_one_sweep_matches_jax_and_single(data, ranks, w):
    jg, jn, tg, tn = data["sweep"]
    got, info = ranks[w][0]["sweep_small"]
    assert info["sweeps"] == 1 and info["n_devices"] == w
    assert np.abs(got.numpy() - data["y0"]).max() > 1e-3, "must move y"
    jy = np.asarray(js.sharded_dense_optimize(
        jnp.asarray(data["y0"]), jg, jn, JEP(grad_step=0.02, **SWEEP),
        js.make_mesh(w)))
    np.testing.assert_allclose(got.numpy(), jy, rtol=1e-6, atol=1e-6,
                               err_msg="one sweep vs JAX sharded, 1e-6")
    if w == 2:   # no pad rows: the single device's pool and draws
        relabel, offsets = data["draws"][w]
        got, _ = ranks[w][0]["sweep"]
        single, _ = td.run_dense_optimization(
            _t(data["y0"]), tg, tn, TEP(**SWEEP), n_sub=1, relabel=relabel,
            offsets=offsets)
        np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-6,
                                   err_msg="one sweep vs single, atol 1e-6")


@pytest.mark.parametrize("w", MESHES)
def test_default_step_separates(data, ranks, w):
    y = ranks[w][0]["separate"][0].numpy()
    assert y.shape == (256, 2) and np.isfinite(y).all()
    assert _accuracy(y, data["labels2"]) > 0.9


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_run_matches_single(data, ranks, run):
    """Same seed, no pad rows: the single device's relabel and offsets.
    Sweep counts and info agree, coordinates to 1e-4 at grad_step 0.02."""
    _, _, tg, tn = data["two"]
    p = TEP(grad_step=0.02, **RUNS[run])
    got, info = ranks[2][0][run]
    want, want_info = td.run_dense_optimization(_t(data["y0"]), tg, tn, p,
                                                n_sub=p.n_sub)
    for key, v in want_info.items():
        assert info[key] == v, key
    assert np.abs(want.numpy() - data["y0"]).max() > 0.1, "must move y"
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_packed_gather_is_bit_identical(ranks):
    assert torch.equal(ranks[2][0]["packed"][0], ranks[2][0]["plain"][0])


def test_semantics_check_steps_match_jax(data, ranks):
    jg, jn, _, _ = data["sweep"]
    mesh = js.make_mesh(2)
    y0 = jnp.asarray(data["y0"])
    step = js.make_sharded_train_step(mesh, b=1.0, batch_size_per_device=64)
    jy = step(y0, jax.random.PRNGKey(0),
              *js.shard_edge_set(j_edge_set(jg, jn), mesh), jnp.float32(1.0))
    got = ranks[2][0]["train_step"].numpy()
    assert np.abs(got - data["y0"]).max() > 0
    np.testing.assert_allclose(got, np.asarray(jy), atol=1e-5)
    step = js.make_sharded_dense_step(mesh, b=1.0, n_neg=5)
    jy = step(y0, jax.random.PRNGKey(0),
              *js.shard_dense_inputs(jg, jn, JEP(n_sub=10), mesh),
              jnp.float32(1.0))
    got = ranks[2][0]["dense_step"].numpy()
    assert np.abs(got - data["y0"]).max() > 0
    np.testing.assert_allclose(got, np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_full_fraction_quality_mesh_route(data, ranks, dim):
    """Under a mesh the full fraction's radius comes from the sharded
    rebuild: the single device's IVF route at d = 3 (the same graph, the
    same estimate), the JAX package's mesh route within 2 nodes
    (test_api_embed_multichip_parity's band) at d = 2 (grid quantizer)
    and d = 3 (each package's own k-means starts)."""
    jg, _, tg, _ = data["quality_graph"]
    y = data[f"y{dim}"]
    for w in MESHES:
        got = ranks[w][0][f"quality_{dim}"]
        assert got.radius_search["route"] == "ivf"
        assert got.radius_search["n_devices"] == w
        if dim == 3:
            want = quality_estimate(tg, _t(y), nbng=10,
                                    knn_params=KnnParams(**QUALITY_KNN))
            assert want.radius_search["route"] == "ivf"
            assert got.summary() == want.summary()
    jq = j_quality(jg, jnp.asarray(y), nbng=10,
                   knn_params=JKnnParams(**QUALITY_KNN),
                   mesh=js.make_mesh(2))
    got = ranks[2][0][f"quality_{dim}"]
    assert abs(got.nb_without_match - jq.nb_without_match) <= 2


def test_embed_n_devices_matches_single():
    """``embed(n_devices=2)`` against the single device by the quantiles
    of test_api_embed_multichip_parity."""
    x = np.random.default_rng(4664397).normal(size=(256, 16)).astype(
        np.float32)
    kw = dict(dim=2, batch=2, nbng=4, params=TEP(n_sub=4), with_quality=True,
              quality_nbng=8, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        y1, info1 = ta.embed(x, **kw)
    finally:
        torch.set_num_threads(threads)
    y2, info2 = ta.embed(x, n_devices=2, **kw)
    assert info2["n_devices"] == 2
    diff = np.abs(y2 - y1)
    assert np.quantile(diff, 0.99) < 2e-2 and diff.max() < 0.5
    assert abs(info2["quality"]["nb_without_match"]
               - info1["quality"]["nb_without_match"]) <= 2


@pytest.mark.parametrize("layer", [0, 1])
def test_embed_n_devices_separates(layer):
    rng = np.random.default_rng(4664397)
    labels = rng.integers(0, 2, 320)
    centers = np.array([[-6.0] * 12, [6.0] * 12], np.float32)
    x = (centers[labels] + rng.normal(size=(320, 12))).astype(np.float32)
    kw = dict(layer=1, hierarchy_fraction=0.25) if layer else {}
    y, info = ta.embed(x, dim=2, batch=4, nbng=4, n_devices=2, device="cpu",
                       **kw)
    assert info["n_devices"] == 2 and np.isfinite(y).all()
    assert _accuracy(y, labels) > 0.95


def test_dmap_embed_n_devices_matches_single():
    """5,200 rows, above FULL_SVD_SIZE_LIMIT: the sharded randomized SVD;
    sign-agnostic at test_dmap_embed_mesh_matches_single's 5e-3.  (The
    JAX package draws another test matrix here; with it injected, the
    sharded diffusion maps meet JAX's in tests/test_torch_parallel_knn.py.)"""
    rng = np.random.default_rng(4664397)
    x = (rng.normal(size=(5200, 6))
         * [6.0, 3.0, 1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    kw = dict(dim=2, nbng=8)
    y1, _ = ta.dmap_embed(x, device="cpu", **kw)
    y2, info = ta.dmap_embed(x, n_devices=2, device="cpu", **kw)
    assert info["nb_embedded"] == 5200 and np.isfinite(y2).all()
    sign = np.sign((y2 * y1).sum(0))
    np.testing.assert_allclose(y2 * sign, y1, atol=5e-3)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)
