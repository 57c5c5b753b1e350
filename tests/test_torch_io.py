"""The port's IO surface against the JAX package's, on the CPU.

* checkpoints: a kNN graph, a projection and an embedding written by
  either package load in the other (exact); suffixless and legacy
  ``.npz`` paths; the stale-n check;
* ``embed`` with ``graph_cache`` / ``graph_cache_eager`` / ``embed_cache``
  (the run after a save loads instead of building or optimizing and
  gives the same embedding; the JAX package reads the port's caches);
  a stale ``embed_cache`` is rejected with the JAX message;
* ``topk_recall`` > 0: the same ids as the JAX package (exact off a TPU),
  f32 and bf16 panels;
* ``trace_dir`` writes a Chrome trace that parses as JSON;
* the IDX reader (plain, gzip, bad magic), the BSON ``limat`` round trip,
  ``extract_neighbourhood`` under L1 against the JAX package's (atol
  1e-5), the sparse triplet dumps (equal text), dichotomy (1e-6), the
  reservoir (by its distribution: the two packages draw from different
  streams), and the three plots written under Agg.
"""

import gzip
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annembed_tpu as ja
import annembed_tpu_torch as ta
from annembed_tpu.graph.kgraph import KGraph as JKGraph
from annembed_tpu.io import checkpoint as jck
from annembed_tpu.io import mnist_io as jmnist
from annembed_tpu.io import ripser as jrip
from annembed_tpu.knn.brute import knn_graph_brute as j_knn
from annembed_tpu.knn.hierarchy import build_projection as j_proj
from annembed_tpu.utils.dichotomy import dichotomy_solver as j_dich
from annembed_tpu_torch import viz
from annembed_tpu_torch.io import checkpoint as tck
from annembed_tpu_torch.io import mnist_io as tmnist
from annembed_tpu_torch.io import ripser as trip
from annembed_tpu_torch.knn.brute import knn_graph_brute as t_knn
from annembed_tpu_torch.utils.dichotomy import dichotomy_solver as t_dich
from annembed_tpu_torch.utils.reservoir import unweighted_reservoir


def _blobs(rng, n=300, d=6):
    centers = rng.normal(size=(3, d)) * 6.0
    return np.concatenate([c + rng.normal(size=(n // 3, d))
                           for c in centers]).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("suffix", ["g.npz", "gcache"])
def test_kgraph_checkpoint_loads_in_both_packages(tmp_path, rng, writer,
                                                  suffix):
    idx, dist = j_knn(_blobs(rng), k=5)
    p = tmp_path / suffix
    if writer == "jax":
        jck.save_kgraph(p, JKGraph(indices=idx, dists=dist))
    else:
        tck.save_kgraph(p, ta.KGraph(indices=torch.from_numpy(np.array(idx)),
                                     dists=torch.from_numpy(np.array(dist))))
    assert p.exists() and tck.checkpoint_exists(p)
    jg = jck.load_kgraph(p, expect_n=300)
    tg = tck.load_kgraph(p, expect_n=300)
    assert tg.indices.dtype == torch.int32 and tg.dists.dtype == torch.float32
    for got in (jg, tg):
        _eq(got.indices, idx)
        _eq(got.dists, dist)
    with pytest.raises(ValueError, match="stale"):
        tck.load_kgraph(p, expect_n=299)


def test_legacy_npz_suffix_resolves(tmp_path, rng):
    idx = rng.integers(0, 50, (50, 4)).astype(np.int32)
    dst = rng.random((50, 4)).astype(np.float32)
    legacy = tmp_path / "old"
    np.savez_compressed(str(legacy), indices=idx, dists=dst)
    assert not legacy.exists() and tck.checkpoint_exists(legacy)
    _eq(tck.load_kgraph(legacy, expect_n=50).indices, idx)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_projection_and_embedding_checkpoints_cross_load(tmp_path, rng,
                                                         writer):
    x = _blobs(rng)
    jp = j_proj(jnp.asarray(x), 5, sample_fraction=0.2, seed=3)
    arrays = dict(small_indices=jp.small_graph.indices,
                  small_dists=jp.small_graph.dists,
                  large_indices=jp.large_graph.indices,
                  large_dists=jp.large_graph.dists,
                  sample_ids=jp.sample_ids, proj_small_idx=jp.proj_small_idx,
                  proj_dist=jp.proj_dist)
    y = rng.normal(size=(300, 2)).astype(np.float32)
    pp, pe = tmp_path / "proj", tmp_path / "emb"
    if writer == "jax":
        jck.save_projection(pp, jp)
        jck.save_embedding(pe, jnp.asarray(y))
    else:
        from annembed_tpu_torch.interop import projection_from_numpy
        tck.save_projection(pp, projection_from_numpy(
            *[np.asarray(a) for a in arrays.values()]))
        tck.save_embedding(pe, torch.from_numpy(y))
    with np.load(pp) as z:
        assert {k: z[k].dtype for k in z.files} == {
            k: np.asarray(a).dtype for k, a in arrays.items()}
    for got in (jck.load_projection(pp, expect_n=300),
                tck.load_projection(pp, expect_n=300)):
        for key, want in arrays.items():
            part, _, field = key.partition("_")
            a = (getattr(getattr(got, f"{part}_graph"), field)
                 if part in ("small", "large") else getattr(got, key))
            _eq(a, want)
    for got in (jck.load_embedding(pe), tck.load_embedding(pe)):
        _eq(got, y)
    with pytest.raises(ValueError, match="stale"):
        tck.load_projection(pp, expect_n=301)


EMBED_KW = dict(dim=2, nbng=6, batch=3, seed=2, with_quality=True,
                quality_nbng=10)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("eager", [False, True])
def test_embed_graph_cache_then_resume(tmp_path, rng, layer, eager):
    x = _blobs(rng)
    kw = dict(EMBED_KW, layer=layer, hierarchy_fraction=0.2)
    gc, ec = str(tmp_path / "graph"), str(tmp_path / "emb.npz")
    y1, i1 = ta.embed(x, graph_cache=gc, graph_cache_eager=eager,
                      embed_cache=ec, device="cpu", **kw)
    assert set(i1["checkpoints"]) == {"graph_save_s", "embedding_save_s"}
    _, ij = ja.embed(x, **kw)
    assert set(i1) - {"checkpoints"} == set(ij) | (
        {"graph_build_phases", "projection_distance_quantiles"}
        if layer else set())
    # the graph alone: loaded, then optimized again from the same draws
    y2, i2 = ta.embed(x, graph_cache=gc, device="cpu", **kw)
    assert set(i2["checkpoints"]) == {"graph_load_s"}
    np.testing.assert_array_equal(y2, y1)
    # both caches: straight to the quality tail
    y3, i3 = ta.embed(x, graph_cache=gc, embed_cache=ec, device="cpu", **kw)
    assert set(i3["checkpoints"]) == {"graph_load_s", "embedding_load_s"}
    assert "optimize_time" not in i3 and "first_step" not in i3
    np.testing.assert_array_equal(y3, y1)
    assert i3["quality"] == i1["quality"]
    # the JAX package resumes from the port's caches
    yj, ijr = ja.embed(x, graph_cache=gc, embed_cache=ec, **kw)
    np.testing.assert_array_equal(np.asarray(yj), y1)
    assert ijr["quality"]["nb_without_match"] == \
        i1["quality"]["nb_without_match"]


def test_stale_embed_cache_rejected(tmp_path, rng):
    x = _blobs(rng)
    ec = tmp_path / "emb"
    tck.save_embedding(ec, np.zeros((299, 2), np.float32))
    with pytest.raises(ValueError, match="stale checkpoint"):
        ta.embed(x, embed_cache=str(ec), device="cpu", **EMBED_KW)


# --- topk_recall and trace_dir ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_recall_ids_match_jax(rng, dtype):
    x = _blobs(rng, n=600, d=12)
    ji, jd_ = j_knn(x, k=8, dtype=dtype, topk_recall=0.99)
    ti, td_ = t_knn(torch.from_numpy(x), 8, dtype=dtype, topk_recall=0.99)
    _eq(ti, ji)
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=1e-5,
                               atol=1e-5)


def test_trace_dir_writes_a_chrome_trace(tmp_path, rng):
    x = _blobs(rng)
    ta.embed(x, nbng=6, batch=2, device="cpu",
             params=ta.EmbedderParams(trace_dir=str(tmp_path / "tr")))
    files = list((tmp_path / "tr").glob("*.json"))
    assert [f.name for f in files] == ["entropy_optimization_n300.json"]
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]


# --- IDX, BSON, TDA export ------------------------------------------------

def _write_idx(d, stem_img, stem_lab, images, labels, gz):
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with op(d / (stem_img + ext), "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape))
        f.write(images.tobytes())
    with op(d / (stem_lab + ext), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_matches_jax(tmp_path, rng, gz):
    for stem, n in (("train", 5), ("t10k", 3)):
        _write_idx(tmp_path, f"{stem}-images-idx3-ubyte",
                   f"{stem}-labels-idx1-ubyte",
                   rng.integers(0, 256, (n, 4, 3)).astype(np.uint8),
                   rng.integers(0, 10, n).astype(np.uint8), gz)
    for fn in ("load_mnist_train_data", "load_mnist_test_data",
               "load_mnist_full"):
        for a, b in zip(getattr(tmnist, fn)(tmp_path),
                        getattr(jmnist, fn)(tmp_path)):
            _eq(a, b)
    x, y = tmnist.load_mnist_full(tmp_path)
    assert x.shape == (8, 12) and x.dtype == np.float32 and y.shape == (8,)


@pytest.mark.parametrize("magic, reader", [(1234, "read_image_file"),
                                           (2051, "read_label_file")])
def test_idx_bad_magic(tmp_path, magic, reader):
    p = tmp_path / "bad"
    with open(p, "wb") as f:
        f.write(struct.pack(">IIII", magic, 1, 2, 2) + b"\x00" * 4)
    with pytest.raises(ValueError, match="magic"):
        getattr(tmnist, reader)(p)


def test_bson_limat_round_trip_both_ways(tmp_path, rng):
    vals = rng.normal(size=37)
    trip.write_bson_limat(str(tmp_path / "t.bson"), vals)
    jrip.write_bson_limat(str(tmp_path / "j.bson"), vals)
    assert (tmp_path / "t.bson").read_bytes() == \
        (tmp_path / "j.bson").read_bytes()
    _eq(trip.read_bson_limat(str(tmp_path / "j.bson")), vals)
    (tmp_path / "bad.bson").write_bytes(b"\x05\x00\x00\x00\x00")
    with pytest.raises((ValueError, struct.error)):
        trip.read_bson_limat(str(tmp_path / "bad.bson"))


@pytest.mark.parametrize("distance", ["DistL1", "DistL2"])
def test_extract_neighbourhood_matches_jax(tmp_path, rng, distance):
    x = np.abs(rng.normal(size=(60, 6))).astype(np.float32)
    nt = trip.extract_neighbourhood(x, x[3], 9, str(tmp_path / "t.bson"),
                                    distance=distance, device="cpu")
    nj = jrip.extract_neighbourhood(x, x[3], 9, str(tmp_path / "j.bson"),
                                    distance=distance)
    assert nt == nj == 9
    np.testing.assert_allclose(
        trip.read_bson_limat(str(tmp_path / "t.bson")),
        jrip.read_bson_limat(str(tmp_path / "j.bson")), atol=1e-5)


def test_sparse_dumps_match_jax(tmp_path, rng):
    x = _blobs(rng, n=90)
    idx, dist = j_knn(x, k=4)
    jrip.to_ripser_sparse_dist(JKGraph(indices=idx, dists=dist),
                               str(tmp_path / "j.txt"))
    trip.to_ripser_sparse_dist(
        ta.KGraph(indices=torch.from_numpy(np.array(idx)),
                  dists=torch.from_numpy(np.array(dist))),
        str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    q = trip.extract_projection_to_ripserer(x, 4, str(tmp_path / "p.txt"),
                                            sample_fraction=0.3,
                                            device="cpu")
    assert set(q) == {"q0.05", "q0.5", "q0.95", "q0.99"}
    rows = np.loadtxt(tmp_path / "p.txt")
    assert rows.shape == (2 * 27 * 4, 3)


# --- host utilities and plots ---------------------------------------------

@pytest.mark.parametrize("increasing, f, lo, hi, target", [
    (True, lambda v: v * v, 0.0, 5.0, 2.0),
    (False, lambda v: -v, -3.0, 5.0, -2.0),
    (True, np.tanh, -3.0, 3.0, 0.5)])
def test_dichotomy_matches_jax(increasing, f, lo, hi, target):
    got = t_dich(increasing, f, lo, hi, target)
    assert got == j_dich(increasing, f, lo, hi, target)
    assert abs(f(got) - target) < 1e-6
    with pytest.raises(ValueError):
        t_dich(increasing, f, hi, lo, target)


def test_reservoir_is_uniform():
    """Algorithm L's sample: distinct items, short streams whole, and
    every item drawn about as often (chi-square over 400 runs)."""
    gen = torch.Generator().manual_seed(1)
    sample = unweighted_reservoir(100, range(10000), generator=gen)
    assert len(sample) == len(set(sample)) == 100
    assert abs(np.mean(sample) - 5000) < 1200
    assert unweighted_reservoir(10, range(5)) == [0, 1, 2, 3, 4]
    counts = np.zeros(50)
    for _ in range(400):
        for item in unweighted_reservoir(5, range(50), generator=gen):
            counts[item] += 1
    expect = 400 * 5 / 50
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 85.4, chi2      # the 0.999 quantile at 49 dof
    again = unweighted_reservoir(
        100, range(10000), generator=torch.Generator().manual_seed(1))
    assert again == sample


def test_plots_write_pngs(tmp_path, rng):
    coords = torch.from_numpy(rng.normal(size=(200, 2)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, 200))
    ratio = np.abs(rng.normal(size=200))
    outs = [viz.plot_embedding(coords, labels, out=str(tmp_path / "e.png")),
            viz.plot_continuity(coords, ratio, out=str(tmp_path / "c.png")),
            viz.plot_first_dist_density(torch.from_numpy(ratio),
                                        out=str(tmp_path / "d.png"))]
    for p in outs:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
