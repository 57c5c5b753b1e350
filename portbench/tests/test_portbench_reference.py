"""The reference's exact searches and its checks against NumPy brute
force on small data."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import exact
from portbench.reference.judge import Reference


def _np_knn(x, q_rows, k):
    d2 = ((x[q_rows][:, None, :].astype(np.float64)
           - x[None, :, :].astype(np.float64)) ** 2).sum(-1)
    d2[np.arange(len(q_rows)), q_rows] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d2, order, 1)


def test_exact_knn_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 9)).astype(np.float32)
    rows = np.array([0, 5, 77, 699, 350])
    want_i, want_d = _np_knn(x, rows, 6)
    xt = torch.from_numpy(x)
    rt = torch.from_numpy(rows)
    got_i, got_d = exact.exact_knn(xt, xt[rt], 6, exclude=rt)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-12)


def test_nbhd_kept_and_impurity_match_numpy():
    rng = np.random.default_rng(1)
    n, k, rk = 400, 6, 50
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (x[:, :2] + 0.3 * rng.normal(size=(n, 2))).astype(np.float32)
    labels = (x[:, 0] > 0).astype(np.int64)
    rows = np.arange(0, n, 3)
    nbrs, _ = _np_knn(x, rows, k)
    e_order, e_d2 = _np_knn(y, rows, rk)
    radius = e_d2[:, rk - 1]
    d2 = ((y[nbrs] - y[rows][:, None, :]).astype(np.float64) ** 2).sum(-1)
    want_kept = (d2 <= radius[:, None] * (1 + 1e-6)).mean()
    want_imp = (labels[e_order[:, :k]] != labels[rows][:, None]).mean()
    bad, imp, kept = exact.judge_embedding(
        torch.from_numpy(y), torch.from_numpy(labels),
        torch.from_numpy(rows), torch.from_numpy(nbrs), rk, k)
    assert bad == 0
    assert abs(imp - want_imp) < 1e-12
    assert abs(kept - want_kept) < 2.0 / d2.size


def _config():
    return {"embed": {"nbng": 6, "dim": 2, "hierarchy_fraction": 0.1},
            "check": {"recall_rows": 50, "radius_k": 20, "label_k": 6}}


def test_graph_check_counts_misses_ties_and_duplicates():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    rows = torch.arange(0, 300, 2)
    ref = Reference(_config(), x, torch.zeros(300, dtype=torch.int64), rows,
                    "cpu")
    ids, d2 = ref.ex_ids.clone(), ref.ex_d2.clone()
    dists = torch.sqrt(d2).float()
    sound = ref.graph(ids, dists)
    assert sound["knn_miss"] == 0.0 and sound["knn_recall"] == 1.0
    assert sound["knn_dist_err"] < 1e-6
    dup = ids.clone()
    dup[:, -1] = dup[:, -2]
    assert abs(ref.graph(dup, dists)["knn_miss"] - 1 / 6) < 1e-12
    far = ids.clone()
    far[:, 0] = (far[:, 0] + 1) % 300
    r = ref.graph(far, dists)
    assert r["knn_miss"] > 0.1 and r["knn_dist_err"] > 1e-2


def test_projection_check():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    rows = torch.arange(400)
    ref = Reference(_config(), x, torch.zeros(400, dtype=torch.int64), rows,
                    "cpu")
    sample = torch.arange(0, 400, 10)
    xt = torch.from_numpy(x)
    ids, d2 = exact.exact_knn(xt[sample], xt, 1)
    dist = torch.sqrt(d2[:, 0]).float()
    good = ref.projection(sample, ids[:, 0], dist)
    assert good == {"proj_miss": 0.0, "proj_dist_err": good["proj_dist_err"]}
    assert good["proj_dist_err"] < 1e-6
    bad = ref.projection(sample, (ids[:, 0] + 1) % 40, dist)
    assert bad["proj_miss"] > 0.9
    assert ref.projection(sample[:-1], ids[:, 0] % 39, dist)["proj_miss"] \
        == 1.0


def test_lower_precisions_round_the_operands():
    x = torch.tensor([1.0 + 2 ** -12, 255.0, 1.0 / 3.0])
    assert exact.round_operands(x, "float32") is x
    tf = exact.round_operands(x, "tf32")
    assert tf[0] == 1.0 and tf[1] == 255.0
    assert abs(tf[2] - 1 / 3) < 2 ** -11 and tf[2] != x[2]
    assert exact.round_operands(x, "bfloat16")[1] == 255.0
    assert exact.round_operands(x, "fp8")[1] == 256.0
