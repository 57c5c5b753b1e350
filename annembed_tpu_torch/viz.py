"""Visualization of embeddings.

Port of annembed_tpu/viz.py, the replacement for the reference's Julia
layer (Julia/visu.jl: plotCsvLabels, plotCsvContinuity).  Matplotlib on
its Agg backend; every function takes tensors (on any device), arrays or
the CSV files the CLI writes (embedded.csv, continuity_ratio.csv,
first_dist.csv).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def _host(a):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _load_labeled_csv(path):
    raw = np.loadtxt(path, delimiter=",")
    return raw[:, 0], raw[:, 1:]


def plot_embedding(coords, labels=None, out: Optional[str] = None,
                   point_size: float = 1.0, title: str = "embedding"):
    """Scatter plot of a 2D embedding colored by label
    (visu.jl plotCsvLabels).

    ``coords`` may be an array or a CSV path.  The CLI's embedded.csv
    has NO label column (write_csv_array2) — all columns are read as
    coordinates there; pass a label-prefixed file (or a labels= array)
    to color points.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(coords, (str, os.PathLike)):
        raw = np.loadtxt(coords, delimiter=",")
        if labels is None:
            coords = raw          # embedded.csv: unlabeled coordinates
        else:
            coords = raw if raw.shape[1] == 2 else raw[:, 1:]
    coords = _host(coords)
    fig, ax = plt.subplots(figsize=(8, 8))
    if labels is not None:
        sc = ax.scatter(coords[:, 0], coords[:, 1], c=_host(labels),
                        s=point_size, cmap="tab10", linewidths=0)
        fig.colorbar(sc, ax=ax, shrink=0.8)
    else:
        ax.scatter(coords[:, 0], coords[:, 1], s=point_size, linewidths=0)
    ax.set_title(title)
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        logger.info("wrote %s", out)
        return out
    return fig


def plot_continuity(coords, ratio=None, out: Optional[str] = None,
                    point_size: float = 1.0):
    """Embedding colored by the per-node continuity ratio
    (visu.jl plotCsvContinuity; low = well-preserved neighborhood).

    Accepts either (coords_array, ratio_array) or a single
    continuity_ratio.csv path (ratio label column + coordinates, as the
    CLI writes it).  An explicitly passed ``ratio`` always wins; a path
    passed as ``ratio`` is loaded from its label column."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(ratio, (str, os.PathLike)):
        ratio, _ = _load_labeled_csv(ratio)
    if isinstance(coords, (str, os.PathLike)):
        file_ratio, coords = _load_labeled_csv(coords)
        if ratio is None:
            ratio = file_ratio
    if ratio is None:
        raise ValueError("plot_continuity needs a ratio (array, path, or "
                         "a labeled continuity_ratio.csv as coords)")
    coords = _host(coords)
    ratio = _host(ratio)
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(coords[:, 0], coords[:, 1],
                    c=np.clip(ratio, 0, np.quantile(ratio, 0.95)),
                    s=point_size, cmap="viridis", linewidths=0)
    fig.colorbar(sc, ax=ax, shrink=0.8, label="continuity ratio")
    ax.set_title("neighborhood continuity (lower is better)")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_first_dist_density(first_dist, out: Optional[str] = None):
    """Histogram of the distance to the nearest embedded original
    neighbour (visu.jl density transform of first_dist.csv)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(first_dist, (str, os.PathLike)):
        first_dist, _ = _load_labeled_csv(first_dist)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(_host(first_dist), bins=100, density=True)
    ax.set_xlabel("distance to first embedded neighbour")
    ax.set_ylabel("density")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig
