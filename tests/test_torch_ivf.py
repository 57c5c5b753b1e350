"""The port's IVF graph build (k-means, row plans, both joins, the grid
quantizer, the fix-up) against annembed_tpu's on the same numpy rows,
with the JAX draws injected.

Integer tables and plans must be equal.  Graphs are compared as
chip_smoke compares them: distances to 1e-5 relative where the ids
agree, and ids equal on the columns whose distance is further than
TIE_REL (relative) from both row neighbours' distances.  A join selects
its candidates from the f32 expansion |q|^2 + |x|^2 - 2 q.x, whose last
bits depend on the matmul's summation order, so a k-th / (k+1)-th
near-tie the row itself cannot show may still swap: AGREE of the clear
columns must match, not all.  Inside the port, the two layouts and any
batching of the join are bit-identical."""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from annembed_tpu.estimators.quality import quality_estimate as j_quality
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.knn import ivf as jivf
from annembed_tpu.knn.api import build_kgraph as j_build_kgraph
from annembed_tpu.knn.api import recall_at_k as j_recall_at_k
from annembed_tpu.knn.brute import knn_graph_brute as j_brute
from annembed_tpu.knn.kmeans import kmeans_fit as j_kmeans_fit
from annembed_tpu.params import KnnParams as JKnnParams
from annembed_tpu_torch.estimators.quality import quality_estimate as t_quality
from annembed_tpu_torch.graph.kgraph import KGraph as TKGraph
from annembed_tpu_torch.knn import ivf as tivf
from annembed_tpu_torch.knn.api import build_kgraph as t_build_kgraph
from annembed_tpu_torch.knn.api import recall_at_k as t_recall_at_k
from annembed_tpu_torch.knn.hierarchy import KGraphProjection
from annembed_tpu_torch.knn.kmeans import kmeans_fit as t_kmeans_fit
from annembed_tpu_torch.params import KnnParams as TKnnParams

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIE_REL = 1e-5
D_RTOL = 1e-5
AGREE = 0.999


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_choice(seed, n, m):
    """``jax.random.choice(PRNGKey(seed), n, (m,), replace=False)``: the
    JAX package's k-means initialization and subsample draws."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (m,),
                                        replace=False))


def _clear_ties(dist):
    """Columns whose distance is further than TIE_REL (relative) from
    both row neighbours' distances."""
    scale = np.maximum(np.abs(dist), 1e-6)
    gap = np.full(dist.shape, np.inf)
    step = np.diff(dist, axis=1)
    gap[:, 1:] = step / scale[:, 1:]
    gap[:, :-1] = np.minimum(gap[:, :-1], step / scale[:, :-1])
    return gap > TIE_REL


def assert_graphs_agree(ti, td, ji, jd, atol=0.0):
    ti, td = ti.numpy(), td.numpy()
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert ti.shape == ji.shape and td.shape == jd.shape
    clear = _clear_ties(jd)
    agree = (ti[clear] == ji[clear]).mean()
    assert agree >= AGREE, f"id agreement {agree} on clear columns"
    same = ti == ji
    np.testing.assert_allclose(td[same], jd[same], rtol=D_RTOL, atol=atol)


def _clustered(rng, n, d, n_centers=12, spread=8.0):
    centers = rng.normal(size=(n_centers, d)) * spread
    return (centers[rng.integers(0, n_centers, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


# --- the port imports neither jax nor the JAX package ----------------------

def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|annembed_tpu)(?:[.\s,]|$)",
                     re.M)
    files = sorted((ROOT / "annembed_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hit = pat.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0).strip()!r}"


# --- sizing, tables, row plans: exact --------------------------------------

@pytest.mark.parametrize("n,k,nlist", [
    (300, 10, 64), (3000, 9, 25), (11_000_000, 12, 0), (440_000, 12, 0),
    (1_000_000, 100, 0), (50, 20, 0)])
def test_ivf_sizing_equal(n, k, nlist):
    assert tivf.ivf_sizing(n, k, nlist) == jivf.ivf_sizing(n, k, nlist)


def _cells(rng, kind):
    if kind == "monster":
        cells = np.concatenate([np.zeros(700, np.int32),
                                rng.integers(1, 12, 150)])
    elif kind == "uniform":
        cells = rng.integers(0, 12, 850)
    else:  # some cells empty
        cells = rng.choice([0, 3, 7], size=850)
    return cells.astype(np.int32)


@pytest.mark.parametrize("kind", ["monster", "uniform", "empty_cells"])
def test_tables_and_rowplan_equal(rng, kind):
    cells = _cells(rng, kind)
    n, nlist, cap, qcap = len(cells), 12, 96, 64
    for a, b in zip(tivf.build_ivf_tables(cells.astype(np.int64), nlist, n,
                                          cap=qcap),
                    jivf.build_ivf_tables(cells.astype(np.int64), nlist, n,
                                          cap=qcap)):
        np.testing.assert_array_equal(a, b)

    v_static = nlist + n // qcap
    jvt, jvp, jct, jv = jivf._ivf_tables_impl(cells, nlist, cap, qcap,
                                              v_static)
    tvt, tvp, tct, tv = tivf._ivf_tables_impl(_t(cells), nlist, cap, qcap)
    assert tv == int(jv) and tvt.shape == (tv, qcap)
    np.testing.assert_array_equal(tvt.numpy(), np.asarray(jvt)[:tv])
    assert (np.asarray(jvt)[tv:] == n).all()
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp)[:tv])
    np.testing.assert_array_equal(tct.numpy(), np.asarray(jct))
    assert tvt.dtype == tvp.dtype == tct.dtype == torch.int32

    jo, js, jc, jp, jq, jv = jivf._ivf_rowplan_impl(cells, nlist, qcap,
                                                    v_static)
    to, ts, tc, tp, tq, tv = tivf._ivf_rowplan_impl(_t(cells), nlist, qcap)
    assert tv == int(jv)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp)[:tv])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq)[:tv])


@pytest.mark.parametrize("n,g", [(4000, 12), (1000, 7), (37, 5)])
def test_strip_grid_equal(rng, n, g):
    y = rng.normal(size=(n, 2)).astype(np.float32)
    y[::17, 1] = y[3, 1]           # ties in the second key
    y[::13, 0] = y[5, 0]           # ties in the first
    jc, jb, jn = jivf._strip_grid_assign(y, g)
    tc, tb, tn = tivf._strip_grid_assign(_t(y), g)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        tivf._strip_cell_neighbors(tb.numpy(), g),
        jivf._strip_cell_neighbors(np.asarray(jb), g))


def test_fixup_underfilled_equal(rng):
    n, k = 40, 6
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    dist = np.sort(rng.random(size=(n, k)).astype(np.float32), axis=1)
    for r, nv in enumerate(rng.integers(0, k + 1, size=n)):
        idx[r, nv:] = n            # nv valid entries, then pads at inf
        dist[r, nv:] = np.inf
    dist[7, 3:] = np.inf           # inf with an in-range id
    ji, jd = jivf._fixup_underfilled(idx, dist, n)
    ti, td = tivf._fixup_underfilled(_t(idx), _t(dist), n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ti.max() < n and torch.isfinite(td).all()


# --- k-means ----------------------------------------------------------------

def test_kmeans_matches_jax(rng):
    """Centroids after 3 Lloyd iterations from the JAX package's own
    initial rows: 1e-5 relative (atol 1e-5: the segment sums add in
    another order), and the same cells."""
    x = _clustered(rng, 2000, 8, n_centers=16)
    jc, jcells = j_kmeans_fit(x, 16, n_iter=3, seed=3)
    init = _jax_choice(3, 2000, 16)
    tc, tcells = t_kmeans_fit(_t(x), 16, n_iter=3, init_ids=_t(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    assert (tcells.numpy() == np.asarray(jcells)).mean() >= AGREE
    assert tcells.dtype == torch.int32
    # without init_ids the draw comes from the seed, reproducibly
    a, _ = t_kmeans_fit(_t(x), 16, n_iter=1, seed=5)
    b, _ = t_kmeans_fit(_t(x), 16, n_iter=1, seed=5)
    c, _ = t_kmeans_fit(_t(x), 16, n_iter=1, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- the join against the JAX package --------------------------------------

def _overflow(rng):
    # one giant cluster: its cell overflows cap and qcap
    return np.concatenate([rng.normal(size=(2500, 5)) * 0.05,
                           rng.normal(size=(500, 5)) + 6.0]
                          ).astype(np.float32)


IVF_CASES = {
    "kmeans_l2": (lambda r: _clustered(r, 3000, 7),
                  dict(k=9, nlist=25, nprobe=6)),
    "kmeans_cosine": (lambda r: np.abs(_clustered(r, 2000, 6, spread=3.0)),
                      dict(k=6, nlist=20, nprobe=5, distance="DistCosine")),
    "overflow_l2": (_overflow, dict(k=5, nlist=9, nprobe=4)),
    "overflow_cosine": (lambda r: np.abs(_overflow(r)),
                        dict(k=5, nlist=9, nprobe=4, distance="DistCosine")),
    "underfilled": (lambda r: r.normal(size=(300, 4)).astype(np.float32) * 50,
                    dict(k=10, nlist=64, nprobe=2)),
    "grid": (lambda r: r.normal(size=(4000, 2)).astype(np.float32),
             dict(k=6, quantizer="grid")),
    "default_sizing": (lambda r: r.normal(size=(3000, 8)).astype(np.float32),
                       dict(k=6, nprobe=8)),
}


@pytest.mark.parametrize("case", sorted(IVF_CASES))
def test_knn_graph_ivf_matches_jax(rng, case):
    make, kw = IVF_CASES[case]
    x = make(rng)
    n = x.shape[0]
    ji, jd = jivf.knn_graph_ivf(x, **kw)
    nlist, _, _ = jivf.ivf_sizing(n, kw["k"], kw.get("nlist", 0))
    init = _t(_jax_choice(0, n, nlist))
    ti, td = tivf.knn_graph_ivf(_t(x), kmeans_init_ids=init, **kw)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert 0 <= int(ti.min()) and int(ti.max()) < n
    assert torch.isfinite(td).all() and (td.diff(dim=1) >= 0).all()
    # cosine is 1 - cos: its rounding is absolute, ~1e-7
    atol = 1e-6 if kw.get("distance") == "DistCosine" else 0.0
    assert_graphs_agree(ti, td, ji, jd, atol=atol)


def test_kmeans_subsample_is_an_argument(rng):
    """Above ``sample_size`` the quantizer fits on a row subsample: the
    JAX package's draw (PRNGKey(seed + 1)) injected gives its graph."""
    x = _clustered(rng, 2000, 6)
    kw = dict(k=6, nlist=16, nprobe=5, sample_size=800, seed=2)
    ji, jd = jivf.knn_graph_ivf(x, **kw)
    ti, td = tivf.knn_graph_ivf(
        _t(x), kmeans_sample_ids=_t(_jax_choice(3, 2000, 800)),
        kmeans_init_ids=_t(_jax_choice(2, 800, 16)), **kw)
    assert_graphs_agree(ti, td, ji, jd)


# --- inside the port: layouts and batching are bit-identical ---------------

@pytest.mark.parametrize("case", ["kmeans_l2", "overflow_l2",
                                  "overflow_cosine", "grid", "underfilled"])
def test_sorted_layout_bit_parity(rng, case):
    make, kw = IVF_CASES[case]
    x = _t(make(rng))
    ig, dg = tivf.knn_graph_ivf(x, layout="gathered", **kw)
    is_, ds = tivf.knn_graph_ivf(x, layout="sorted", **kw)
    assert torch.equal(ig, is_) and torch.equal(dg, ds)


@pytest.mark.parametrize("layout", ["sorted", "gathered"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_batch_and_many_bit_parity(rng, layout, dtype):
    """A small byte budget (many batches, one virtual row each at the
    smallest) must reproduce the one-batch result exactly."""
    x = _t(rng.normal(size=(2000, 6)).astype(np.float32))
    kw = dict(k=7, nlist=16, nprobe=5, layout=layout, dtype=dtype)
    i1, d1 = tivf.knn_graph_ivf(x, **kw)
    for budget in (400_000, 1):
        i2, d2 = tivf.knn_graph_ivf(x, panel_bytes=budget, **kw)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_batches_cover_every_row_within_budget():
    rng = np.random.default_rng(0)
    qn = rng.integers(0, 50, size=200)
    ctot = rng.integers(0, 900, size=200)
    seen = []
    for rows, q, w in tivf._batches(qn, ctot, k=8, panel_bytes=200_000):
        assert q == qn[rows].max() and w == max(ctot[rows].max(), 8)
        assert len(rows) == 1 or 4 * len(rows) * q * w <= 200_000
        seen.extend(rows.tolist())
    assert sorted(seen) == np.flatnonzero(qn > 0).tolist()


def test_unknown_options_raise(rng):
    x = _t(rng.normal(size=(500, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="d == 2"):
        tivf.knn_graph_ivf(x, 5, quantizer="grid")
    with pytest.raises(ValueError, match="quantizer"):
        tivf.knn_graph_ivf(x, 5, quantizer="tree")
    with pytest.raises(ValueError, match="layout"):
        tivf.knn_graph_ivf(x, 5, layout="tiled")
    with pytest.raises(ValueError, match="dtype"):
        tivf.knn_graph_ivf(x, 5, dtype="float16")
    # ApproxTopK's recall target selects exactly off a TPU
    exact = tivf.knn_graph_ivf(x, 5)
    for a, b in zip(tivf.knn_graph_ivf(x, 5, topk_recall=0.95), exact):
        assert torch.equal(a, b)


# --- build_kgraph above a lowered limit: statistical -----------------------

def _metric_rows(rng, metric, n=1500):
    centers = rng.normal(size=(12, 10)) * 3
    x = (centers[rng.integers(0, 12, n)]
         + 0.4 * rng.normal(size=(n, 10))).astype(np.float32)
    if metric in ("DistJeffreys", "DistJensenShannon"):
        x = np.abs(x) + 0.05
        x /= x.sum(1, keepdims=True)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["DistL2", "DistCosine", "DistL1",
                                    "DistJeffreys", "DistJensenShannon"])
def test_build_kgraph_ivf_recall_matches_jax(rng, metric, dtype):
    """Each package builds with its own k-means draw; the recalls
    against the exact graph must lie within 0.02 of each other."""
    x = _metric_rows(rng, metric)
    k = 6
    ei, _ = j_brute(x, k, distance=metric)
    kw = dict(knbn=k, distance=metric, brute_force_limit=500, nlist=32,
              nprobe=8, refine_rounds=2, dtype=dtype)
    jg = j_build_kgraph(x, k, distance=metric, params=JKnnParams(**kw))
    tg = t_build_kgraph(_t(x), k, distance=metric, params=TKnnParams(**kw))
    assert tg.indices.shape == (1500, k)
    assert not (tg.indices == torch.arange(1500)[:, None]).any()
    jr = j_recall_at_k(jg.indices, ei)
    tr = t_recall_at_k(tg.indices, _t(np.asarray(ei)))
    assert abs(tr - jr) <= 0.02, (tr, jr)
    assert tr > 0.9, tr


@pytest.mark.parametrize("knob,value,moves", [
    ("refine_rounds", 0, True), ("build_k_factor", 1.0, True),
    ("nprobe", 2, True), ("nlist", 12, True), ("nndescent_rho", 0.5, True),
    ("quantizer", "grid", True), ("ivf_layout", "gathered", False)])
def test_build_kgraph_knobs_act(rng, knob, value, moves):
    """Every IVF knob of KnnParams reaches the build: changing it changes
    the graph, except the layout, which must not."""
    x = _t(_clustered(rng, 1500, 2, spread=3.0))
    base = dict(knbn=6, brute_force_limit=500, nlist=32, nprobe=4,
                refine_rounds=1)
    g0 = t_build_kgraph(x, 6, params=TKnnParams(**base))
    g1 = t_build_kgraph(x, 6, params=TKnnParams(**{**base, knob: value}))
    assert g1.indices.shape == g0.indices.shape
    assert torch.equal(g0.indices, g1.indices) != moves


def test_recall_at_k_row_chunks(rng):
    a = rng.integers(0, 50, size=(1000, 6))
    e = np.stack([rng.permutation(50)[:6] for _ in range(1000)])
    want = j_recall_at_k(a, e)
    assert t_recall_at_k(_t(a), _t(e)) == pytest.approx(want, abs=1e-12)
    assert t_recall_at_k(_t(a), _t(e), row_chunk=37) == \
        t_recall_at_k(_t(a), _t(e))


# --- the quality estimator's IVF radius route ------------------------------

def test_quality_full_fraction_above_limit_d3_matches_jax(rng):
    """d = 3, full fraction, n above a lowered limit: both packages
    rebuild the embedded graph with IVF (no refinement, f32 panels) and
    read the radius at column radius_k - 1.  nb_without_match within 2%."""
    n, k = 3000, 6
    x = _clustered(rng, n, 10, spread=2.0)
    idx, dist = j_brute(x, k)
    idx, dist = np.asarray(idx), np.asarray(dist)
    y = (x[:, :3] + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    kw = dict(knbn=k, brute_force_limit=1000, refine_rounds=3,
              dtype="bfloat16")
    jq = j_quality(JKGraph(indices=idx, dists=dist), y, nbng=10,
                   knn_params=JKnnParams(**kw))
    tq = t_quality(TKGraph(indices=_t(idx), dists=_t(dist)), _t(y), nbng=10,
                   knn_params=TKnnParams(**kw))
    assert tq.nb_sampled == n and 0 < jq.nb_without_match < n
    rel = abs(tq.nb_without_match - jq.nb_without_match) / jq.nb_without_match
    assert rel <= 0.02, (tq.nb_without_match, jq.nb_without_match)
    np.testing.assert_allclose(tq.mean_nb_matched, jq.mean_nb_matched,
                               rtol=0.02)
    np.testing.assert_allclose(tq.median_ratio, jq.median_ratio, rtol=0.02)


# --- the projection's distance quantiles -----------------------------------

def test_projection_distance_quantiles_match_jax(rng):
    from annembed_tpu.knn.hierarchy import KGraphProjection as JProjection
    d = rng.gamma(2.0, size=5000).astype(np.float32)
    d[::25] = 0.0                  # sampled points project at distance 0
    jp = JProjection(small_graph=None, large_graph=None, sample_ids=None,
                     proj_small_idx=None, proj_dist=jax.numpy.asarray(d))
    tp = KGraphProjection(small_graph=None, large_graph=None,
                          sample_ids=None, proj_small_idx=None,
                          proj_dist=_t(d))
    want = jp.projection_distance_quantiles()
    got = tp.projection_distance_quantiles()
    assert got.keys() == want.keys() == {"q0.05", "q0.5", "q0.95", "q0.99"}
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-6)
