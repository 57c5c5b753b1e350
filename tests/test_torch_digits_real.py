"""Real data through the port: scikit-learn's bundled handwritten digits
(1797 x 64), the port's counterpart of tests/test_digits_real.py under
that test's thresholds (the JAX package's recorded run: no-match 6.3%,
compat 1.4%, embedded 10-NN label accuracy 0.983 against 0.982 in the
raw space).  The dataset ships inside scikit-learn: nothing is
downloaded."""

import numpy as np
import pytest
import torch

sklearn = pytest.importorskip("sklearn")


def knn_label_accuracy(coords: np.ndarray, labels: np.ndarray,
                       k: int = 10) -> float:
    """Leave-one-out k-NN majority-vote accuracy in ``coords`` space,
    on the port's exact graph."""
    from annembed_tpu_torch.knn.brute import knn_graph_brute
    idx, _ = knn_graph_brute(torch.from_numpy(coords.astype(np.float32)), k)
    votes = labels[idx.numpy()]                      # (n, k)
    counts = np.zeros((len(labels), int(labels.max()) + 1), np.int32)
    for j in range(votes.shape[1]):
        np.add.at(counts, (np.arange(len(labels)), votes[:, j]), 1)
    return float((counts.argmax(axis=1) == labels).mean())


def test_digits_real_pipeline():
    from sklearn.datasets import load_digits
    import annembed_tpu_torch as at
    ds = load_digits()
    x, labels = ds.data.astype(np.float32), ds.target.astype(np.int64)
    y, info = at.embed(x, dim=2, batch=30, nbng=10, with_quality=True,
                       quality_nbng=10, quality_radius_compat=25,
                       return_graph=True, device="cpu")
    n = x.shape[0]
    assert y.shape == (n, 2) and np.isfinite(y).all()
    q = info["quality"]
    assert q["nb_without_match"] / n < 0.15
    assert q["compat_nb_without_match"] / n < 0.05
    assert q["compat_mean_nb_matched"] > 5.0
    assert q["compat_median_ratio"] < 1.2
    acc_emb = knn_label_accuracy(y, labels)
    acc_raw = knn_label_accuracy(x, labels)
    assert acc_emb > acc_raw - 0.02
    assert acc_emb > 0.95
