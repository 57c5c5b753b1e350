"""TDA export for Ripserer.jl.

Port of annembed_tpu/io/ripser.py (reference src/fromhnsw/toripserer.rs
and kgraph.rs:354):

  * ``extract_neighbourhood``: the knbn nearest points around a center,
    found by the port's brute kNN on ``device``, dumped as a
    lower-triangular distance matrix in the chosen metric (diagonal
    included, zeros) in a one-field BSON document {"limat": [f64...]};
  * ``extract_projection_to_ripserer``: the hierarchical projection's
    small graph as sparse triplets, with the projection distance
    quantiles;
  * ``to_ripser_sparse_dist``: a kNN graph as "i j dist" text triplets,
    both directions of every edge.

BSON is written by a minimal encoder (one array-of-doubles field).
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..graph.kgraph import KGraph
from ..knn.brute import knn_search_brute
from ..knn.distances import get_panel_fn


def _bson_f64_array(name: str, values: Sequence[float]) -> bytes:
    """BSON array element (type 0x04) of doubles (type 0x01), keys the
    decimal indices; built by one join (``bytes +=`` is quadratic)."""
    items = b"".join(b"\x01" + str(i).encode() + b"\x00"
                     + struct.pack("<d", float(v))
                     for i, v in enumerate(values))
    arr_doc = struct.pack("<i", len(items) + 5) + items + b"\x00"
    return b"\x04" + name.encode() + b"\x00" + arr_doc


def write_bson_limat(path: str, values: Sequence[float]) -> None:
    """Document {"limat": [...f64]} (toripserer.rs:106-113)."""
    body = _bson_f64_array("limat", values)
    doc = struct.pack("<i", len(body) + 5) + body + b"\x00"
    with open(path, "wb") as f:
        f.write(doc)


def read_bson_limat(path: str) -> np.ndarray:
    """Inverse of ``write_bson_limat``; raises ValueError on any other
    document."""
    with open(path, "rb") as f:
        raw = f.read()
    (doc_len,) = struct.unpack_from("<i", raw, 0)
    name_end = raw.index(b"\x00", 5)
    if doc_len != len(raw) or raw[4] != 0x04 or raw[5:name_end] != b"limat":
        raise ValueError(f"{path} is not a limat BSON document")
    pos = name_end + 1
    (arr_len,) = struct.unpack_from("<i", raw, pos)
    end = pos + arr_len - 1
    pos += 4
    out = []
    while pos < end:
        if raw[pos] != 0x01:
            raise ValueError(f"{path}: limat holds a non-double element")
        pos = raw.index(b"\x00", pos + 1) + 1
        out.append(struct.unpack_from("<d", raw, pos)[0])
        pos += 8
    return np.array(out)


def extract_neighbourhood(x, center, knbn: int, outbson: str,
                          distance: str = "DistL2", device="cuda") -> int:
    """Lower-triangular distance matrix of the knbn points nearest to
    ``center``, in the chosen metric, -> BSON (toripserer.rs:45).
    Returns the number of points."""
    dev = resolve_device(device)
    xs = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    c = torch.as_tensor(np.asarray(center, np.float32)).reshape(1, -1)
    idx, _ = knn_search_brute(c.to(dev), xs, min(knbn, xs.shape[0]),
                              distance=distance)
    pts = xs[idx[0].to(torch.int64)]
    # pairwise distances in the chosen metric (toripserer.rs:59-69)
    d = get_panel_fn(distance)(pts, pts).cpu().numpy()
    nb = pts.shape[0]
    rows, cols = np.tril_indices(nb, -1)
    tri = np.zeros(nb * (nb + 1) // 2)
    # row i of the lower triangle holds d[i, :i] then the zero diagonal
    tri[rows * (rows + 1) // 2 + cols] = d[rows, cols]
    write_bson_limat(outbson, tri)
    return nb


def extract_projection_to_ripserer(x, knbn: int, fname: str,
                                   sample_fraction: float = 0.05,
                                   distance: str = "DistL2", seed: int = 0,
                                   device="cuda") -> dict:
    """Persistence input from the coarse (projected) graph
    (toripserer.rs:131, kgproj.rs:413): builds the two-level projection
    on ``device``, dumps its small graph as sparse triplets and returns
    the projection distance quantiles."""
    from ..knn.hierarchy import build_projection
    dev = resolve_device(device)
    xs = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    proj = build_projection(xs, knbn, sample_fraction=sample_fraction,
                            distance=distance, seed=seed)
    to_ripser_sparse_dist(proj.small_graph, fname)
    return proj.projection_distance_quantiles()


def to_ripser_sparse_dist(g: KGraph, path: str) -> None:
    """Text triplets "i j dist" (kgraph.rs:354-369): both directions of
    every edge, so mutual neighbours appear twice each way, as in the
    reference dump."""
    idx = g.indices.cpu().numpy().astype(np.int64)
    dist = g.dists.cpu().numpy().astype(np.float64)
    n, k = idx.shape
    ii = np.repeat(np.arange(n, dtype=np.int64), k)
    jj = idx.reshape(-1)
    dd = dist.reshape(-1)
    rows = np.empty((2 * n * k, 3), np.float64)
    rows[0::2] = np.stack([ii, jj, dd], axis=1)
    rows[1::2] = np.stack([jj, ii, dd], axis=1)
    with open(path, "w") as f:
        np.savetxt(f, rows, fmt="%d %d %.5E")
