"""Single-linkage and HDBSCAN* clustering over the kNN graph.

Port of annembed_tpu/estimators/hdbscan.py (reference src/hdbscan/:
union-find + Kruskal MST, kruskal.rs:19,100, and the single-linkage
dendrogram that sl.rs:149-177 leaves unfinished, carried through to
HDBSCAN* after Campello et al. 2013): mutual-reachability weights on the
graph's device (``mutual_reachability``), then on the host the MST, the
dendrogram, the condensed tree at ``min_cluster_size``, excess-of-mass
or leaf extraction and GLOSH outlier scores.  The sequential stages run
in ``native/mst.cpp`` (``annembed_kruskal``, ``annembed_linkage``,
``annembed_condense``, compiled by ``utils/native.py``) with numpy
copies of the JAX package's loops where there is no g++; which ran is
left in ``utils.native.BACKENDS``.  ``hdbscan`` times its stages into
``HdbscanResult.timings``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..graph.kgraph import KGraph
from ..utils.native import BACKENDS, load_library


class UnionFind:
    """Path-halving union-find (reference hdbscan/kruskal.rs:19)."""

    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.rank = np.zeros(n, np.int32)

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]
            i = p[i]
        return int(i)

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True


@functools.cache
def _native_mst_lib():
    """The native MST library with its symbols typed, or None."""
    lib = load_library("mst")
    if lib is None:
        return None
    lib.annembed_kruskal.restype = ctypes.c_int32
    lib.annembed_kruskal.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.annembed_linkage.restype = ctypes.c_int32
    lib.annembed_linkage.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.annembed_condense.restype = ctypes.c_int32
    lib.annembed_condense.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    return lib


def _host(g: KGraph):
    """(indices, dists) of the graph as host numpy arrays."""
    return g.indices.cpu().numpy(), g.dists.cpu().numpy()


def kruskal_mst(g: KGraph) -> np.ndarray:
    """(m, 3) MST/forest edges [src, dst, weight] of the kNN graph,
    weight-ascending (kruskal.rs:100 ``kruskal_indices``).  Runs in the
    native library when available (the union loop is sequential and
    interpreter-bound in Python); the stable weight sort makes both
    paths bit-identical."""
    idx, dist = _host(g)
    n, k = idx.shape
    # fail loudly on corrupt ids (stale checkpoint): the numpy path
    # would silently WRAP negative ids, the native path rejects with
    # rc=2 — make both surfaces one clear error
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(
            f"kNN graph has out-of-range neighbour ids "
            f"[{idx.min()}, {idx.max()}] for n={n} — corrupt graph?")
    lib = _native_mst_lib()
    if lib is not None:
        idx_c = np.ascontiguousarray(idx, np.int32)
        dist_c = np.ascontiguousarray(dist, np.float32)
        out = np.empty((max(n - 1, 0), 3), np.float64)
        out_m = ctypes.c_int64(0)
        rc = lib.annembed_kruskal(
            idx_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dist_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(out_m))
        if rc == 0:
            BACKENDS["mst"] = "native"
            return out[:out_m.value]
    BACKENDS["mst"] = "numpy"
    src = np.repeat(np.arange(n), k)
    dst = idx.reshape(-1)
    w = dist.reshape(-1)
    order = np.argsort(w, kind="stable")
    uf = UnionFind(n)
    out = []
    for e in order:
        if uf.union(int(src[e]), int(dst[e])):
            out.append((src[e], dst[e], w[e]))
            if len(out) == n - 1:
                break
    return np.array(out, dtype=np.float64).reshape(-1, 3)


@dataclasses.dataclass
class Dendrogram:
    """scipy-style linkage matrix: row i merges clusters
    [cluster_a, cluster_b] at ``distance`` into new cluster
    n_points + i with ``size`` members."""
    linkage: np.ndarray   # (m, 4)
    mst: np.ndarray       # (m, 3) the underlying MST edges
    n_points: int

    def cluster_by_distance(self, threshold: float) -> np.ndarray:
        """Flat clusters by cutting at ``threshold``: connected
        components of MST edges with weight <= threshold (the step the
        reference's cluster() never reached, sl.rs:172-176)."""
        n = self.n_points
        uf = UnionFind(n)
        for a, b, w in self.mst:
            if w <= threshold:
                uf.union(int(a), int(b))
        roots = np.array([uf.find(i) for i in range(n)])
        _, labels = np.unique(roots, return_inverse=True)
        return labels


def boruvka_mst(g: KGraph) -> np.ndarray:
    """(m, 3) MST/forest edges of the kNN graph by vectorized Boruvka.

    Same output contract as ``kruskal_mst`` (weight-ascending rows
    [src, dst, w]) but O(log n) rounds of whole-array numpy ops instead
    of a Python-interpreter loop over all n*k edges.  Each round every component hooks onto its minimum outgoing edge
    (deterministic weight-then-edge-id tie-break), mutual hooks keep
    the lower root, and components contract by pointer jumping.  Ties
    across duplicate undirected edges are safe: an accepted hook
    records exactly one edge."""
    idx, dist = _host(g)
    n, k = idx.shape
    BACKENDS["mst"] = "boruvka"
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = idx.reshape(-1).astype(np.int64)
    w = dist.reshape(-1).astype(np.float64)
    # One upfront weight sort: from here on, edge-list POSITION is the
    # strict tie-break.  Both interleaved directions of an edge share
    # its position (sel >> 1), so every component ranks any edge —
    # including both copies of a duplicate undirected edge — by the
    # same (weight, position) total order; hook cycles longer than the
    # mutual pair are impossible.
    order0 = np.argsort(w)
    src, dst, w = src[order0], dst[order0], w[order0]
    parent = np.arange(n, dtype=np.int64)
    out_s, out_d, out_w = [], [], []
    while src.size:
        rs, rd = parent[src], parent[dst]
        live = rs != rd
        if not live.any():
            break
        # compression preserves relative (weight) order
        src, dst, w = src[live], dst[live], w[live]
        rs, rd = rs[live], rd[live]
        m = src.size
        # every live root picks its min outgoing edge: sort one
        # composed integer key (root in high bits, interleaved position
        # in low bits) in place — no stable argsort, no big gathers
        shift = int(2 * m).bit_length()
        if n.bit_length() + shift >= 63:    # composed key must fit int64
            raise ValueError("graph too large for composed-key Boruvka "
                             f"(n={n}, edges={m})")
        key = np.empty(2 * m, np.int64)
        key[0::2] = rs << shift
        key[1::2] = rd << shift
        key += np.arange(2 * m, dtype=np.int64)
        key.sort()
        first = np.ones(2 * m, bool)
        first[1:] = (key[1:] >> shift) != (key[:-1] >> shift)
        ksel = key[first]
        c_ids = ksel >> shift
        jsel = ksel & ((np.int64(1) << shift) - 1)
        pos = jsel >> 1
        o_ids = np.where(jsel & 1 == 0, rd[pos], rs[pos])
        link = np.arange(n, dtype=np.int64)
        link[c_ids] = o_ids
        # mutual hooks A<->B: the higher root abandons its hook (and
        # its edge — the partner records the shared undirected edge)
        loser = (link[link[c_ids]] == c_ids) & (c_ids > link[c_ids])
        link[c_ids[loser]] = c_ids[loser]
        keep = pos[~loser]
        out_s.append(src[keep])
        out_d.append(dst[keep])
        out_w.append(w[keep])
        # contract: resolve link chains, then re-root every node
        while True:
            nxt = link[link]
            if (nxt == link).all():
                break
            link = nxt
        parent = link[parent]
    if not out_s:
        return np.zeros((0, 3))
    mst = np.stack([np.concatenate(out_s).astype(np.float64),
                    np.concatenate(out_d).astype(np.float64),
                    np.concatenate(out_w)], axis=1)
    return mst[np.argsort(mst[:, 2], kind="stable")]


def mutual_reachability(g: KGraph, min_samples: int) -> KGraph:
    """KGraph with mutual-reachability weights
    d_mreach(i,j) = max(core_i, core_j, d(i,j)), where core_i is the
    distance to i's ``min_samples``-th nearest neighbour counting i
    itself (HDBSCAN* def. 2, sklearn's convention).  The kNN graph
    excludes self, so the column is min_samples - 2 (min_samples == 1:
    core 0).  Elementwise max on the graph's device, then a stable
    per-row re-sort (the neighbours' cores can reorder a row, and a
    KGraph's rows are ascending)."""
    if not 1 <= min_samples <= g.nbng + 1:
        raise ValueError(f"min_samples must be in [1, {g.nbng + 1}]")
    if min_samples == 1:
        core = torch.zeros_like(g.dists[:, 0])
    else:
        core = g.dists[:, min_samples - 2]
    d = torch.maximum(g.dists, torch.maximum(core[:, None],
                                             core[g.indices]))
    d, order = torch.sort(d, dim=1, stable=True)
    return KGraph(indices=torch.gather(g.indices, 1, order), dists=d)


_BORUVKA_EDGE_CUTOVER = 200_000   # n*k above which Kruskal's Python
                                  # union loop is slower than Boruvka


def single_linkage(g: KGraph, mst_method: str = "auto",
                   timings: Optional[dict] = None) -> Dendrogram:
    """Single-linkage dendrogram from the MST (completes sl.rs:109).

    ``mst_method``: 'kruskal' (stable sort + union loop; native C++
    when the native library builds, Python otherwise), 'boruvka'
    (vectorized numpy, no native dependency), or 'auto' (kruskal when
    native or small; boruvka for big pure-Python runs).  The port's
    callers pass 'auto' only; the knob stays so that the exported
    ``single_linkage`` keeps the JAX package's signature.  ``timings``
    receives the MST's and the dendrogram's seconds."""
    if mst_method == "auto":
        big = g.indices.numel() > _BORUVKA_EDGE_CUTOVER
        key_fits = (g.nb_nodes.bit_length()
                    + int(2 * g.indices.numel()).bit_length() < 63)
        mst_method = ("boruvka"
                      if big and key_fits and _native_mst_lib() is None
                      else "kruskal")
    if mst_method not in ("kruskal", "boruvka"):
        raise ValueError(f"unknown mst_method {mst_method!r}")
    t0 = time.perf_counter()
    mst = kruskal_mst(g) if mst_method == "kruskal" else boruvka_mst(g)
    t1 = time.perf_counter()
    dend = _linkage(mst, g.nb_nodes)
    if timings is not None:
        timings["mst"] = t1 - t0
        timings["linkage"] = time.perf_counter() - t1
    return dend


def _linkage(mst: np.ndarray, n: int) -> Dendrogram:
    """The dendrogram of weight-ascending MST rows over n points."""
    m = mst.shape[0]
    lib = _native_mst_lib()
    if lib is not None and m:
        mst_c = np.ascontiguousarray(mst, np.float64)
        linkage = np.empty((m, 4), np.float64)
        rc = lib.annembed_linkage(
            mst_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m, n,
            linkage.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc == 0:
            BACKENDS["linkage"] = "native"
            return Dendrogram(linkage=linkage, mst=mst, n_points=n)
    BACKENDS["linkage"] = "numpy"
    uf = UnionFind(n)
    label_of_root = np.arange(n, dtype=np.int64)    # indexed by root point
    size_of_label = np.ones(n + m, dtype=np.int64)
    linkage = np.zeros((m, 4))
    for row in range(m):
        a, b, w = int(mst[row, 0]), int(mst[row, 1]), mst[row, 2]
        ra, rb = uf.find(a), uf.find(b)
        la, lb = label_of_root[ra], label_of_root[rb]
        new_label = n + row
        size_of_label[new_label] = size_of_label[la] + size_of_label[lb]
        linkage[row] = (la, lb, w, size_of_label[new_label])
        if not uf.union(ra, rb):
            raise ValueError(f"malformed MST: row {row} forms a cycle")
        label_of_root[uf.find(ra)] = new_label
    return Dendrogram(linkage=linkage, mst=mst, n_points=n)


# --------------------------------------------------------------------------
# HDBSCAN* on top of the dendrogram (completes the reference's stub
# beyond sl.rs — condensed tree + excess-of-mass selection)
# --------------------------------------------------------------------------

_MIN_EDGE = 1e-10   # floor on merge distances so lambda = 1/d stays finite


def condensed_tree(dend: Dendrogram, min_cluster_size: int = 5
                   ) -> np.ndarray:
    """Condense the single-linkage dendrogram at ``min_cluster_size``.

    Returns (r, 4) float64 rows ``[parent, child, lambda, size]`` in the
    standard HDBSCAN* encoding: labels < n_points are points, labels
    >= n_points are clusters (root = n_points); ``lambda`` = 1 / merge
    distance at which ``child`` separated from (or fell out of)
    ``parent``.  Splits where a side holds < min_cluster_size points
    shed those points into the parent instead of spawning a cluster.
    """
    if min_cluster_size < 2:
        raise ValueError("min_cluster_size must be >= 2")
    n = dend.n_points
    m = dend.linkage.shape[0]
    if m == 0:
        return np.zeros((0, 4))

    lib = _native_mst_lib()
    if lib is not None:
        link_c = np.ascontiguousarray(dend.linkage, np.float64)
        rows = np.empty((n + 2 * m + 2, 4), np.float64)
        out_r = ctypes.c_int64(0)
        rc = lib.annembed_condense(
            link_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m, n,
            min_cluster_size, _MIN_EDGE,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(out_r))
        if rc == 0:
            BACKENDS["condense"] = "native"
            # copy: the slice view would pin the whole (n+2m+2, 4)
            # scratch buffer (~3x the result, ~1 GB at 11M)
            return rows[:out_r.value].copy()
    BACKENDS["condense"] = "numpy"

    def node_size(v: int) -> int:
        return 1 if v < n else int(dend.linkage[v - n, 3])

    def subtree_points(v: int) -> list:
        out, stack = [], [v]
        while stack:
            u = stack.pop()
            if u < n:
                out.append(u)
            else:
                stack.append(int(dend.linkage[u - n, 0]))
                stack.append(int(dend.linkage[u - n, 1]))
        return out

    rows = []
    next_label = n + 1
    # The kNN graph may be disconnected (unlike a true metric space),
    # making the MST a forest.  Roots = internal nodes never referenced
    # as a child.  A single root is the classic case (it becomes the
    # root cluster n, unselectable unless allow_single_cluster); with
    # several components, each sufficiently large component root hangs
    # off the virtual root n as its own selectable cluster — separate
    # components are genuinely distinct clusters.
    referenced = set(dend.linkage[:, 0].astype(np.int64)) | \
        set(dend.linkage[:, 1].astype(np.int64))
    forest_roots = [n + i for i in range(m) if (n + i) not in referenced]
    # stack of (dendrogram node, condensed cluster label it belongs to)
    if len(forest_roots) == 1:
        stack = [(forest_roots[0], n)]
    else:
        stack = []
        for r in forest_roots:
            if node_size(r) < min_cluster_size:
                continue                      # whole component is noise
            lam_top = 1.0 / max(dend.linkage[r - n, 2], _MIN_EDGE)
            rows.append((n, next_label, lam_top, node_size(r)))
            stack.append((r, next_label))
            next_label += 1
    while stack:
        v, label = stack.pop()
        left = int(dend.linkage[v - n, 0])
        right = int(dend.linkage[v - n, 1])
        lam = 1.0 / max(dend.linkage[v - n, 2], _MIN_EDGE)
        sl, sr = node_size(left), node_size(right)
        if sl >= min_cluster_size and sr >= min_cluster_size:
            for child, size in ((left, sl), (right, sr)):
                rows.append((label, next_label, lam, size))
                stack.append((child, next_label))
                next_label += 1
        else:
            for child, size in ((left, sl), (right, sr)):
                if size >= min_cluster_size:     # cluster continues as-is
                    stack.append((child, label))
                else:                            # points fall out of label
                    for p in subtree_points(child):
                        rows.append((label, p, lam, 1))
    return np.array(rows, dtype=np.float64).reshape(-1, 4)


@dataclasses.dataclass
class HdbscanResult:
    labels: np.ndarray          # (n,) int64, -1 = noise
    probabilities: np.ndarray   # (n,) float64 in [0, 1]
    condensed: np.ndarray       # (r, 4) condensed-tree rows
    stability: dict             # cluster label -> stability
    selected: list              # selected (flat) cluster labels
    #: seconds by stage (``hdbscan`` only): mutual_reachability (device,
    #: synced), mst, linkage, condense, extract
    timings: dict = dataclasses.field(default_factory=dict)


def _ancestors(c, parent_of) -> list:
    out = []
    while c in parent_of:
        c = parent_of[c]
        out.append(c)
    return out


def extract_clusters_eom(cond: np.ndarray, n_points: int,
                         allow_single_cluster: bool = False,
                         cluster_selection_method: str = "eom",
                         cluster_selection_epsilon: float = 0.0
                         ) -> HdbscanResult:
    """Flat extraction from the condensed tree.

    ``cluster_selection_method='eom'`` (Campello et al. 2013 §4.3):
    stability(C) = sum over members (lambda_leave - lambda_birth); a
    cluster is selected iff its stability beats the sum of its
    children's propagated subtree stabilities.  ``'leaf'`` selects the
    finest-grained clusters (leaves of the cluster tree) instead.
    Root is never selected unless ``allow_single_cluster``.

    ``cluster_selection_epsilon`` > 0 applies the Malzer-Baum (2020)
    epsilon search after selection: a selected cluster born below that
    distance (1/birth_lambda < eps) is replaced by its first ancestor
    born at >= eps — a minimum cluster scale that undoes
    over-segmentation (e.g. splits induced by kNN-graph sparsity)."""
    labels = np.full(n_points, -1, dtype=np.int64)
    probs = np.zeros(n_points)
    if cond.shape[0] == 0:
        return HdbscanResult(labels, probs, cond, {}, [])
    parents = cond[:, 0].astype(np.int64)
    children = cond[:, 1].astype(np.int64)
    lams = cond[:, 2]
    sizes = cond[:, 3]

    # cluster rows are the small set; every O(rows) pass is array work
    cm = children >= n_points
    cluster_ids = np.union1d(np.unique(parents), children[cm]).tolist()
    birth = {c: 0.0 for c in cluster_ids}
    kids: dict = {c: [] for c in cluster_ids}
    for p, c, l in zip(parents[cm].tolist(), children[cm].tolist(),
                       lams[cm].tolist()):
        birth[c] = l
        kids[p].append(c)
    birth_arr = np.zeros(max(cluster_ids) + 1)
    birth_arr[children[cm]] = lams[cm]
    stab_arr = np.zeros(max(cluster_ids) + 1)
    np.add.at(stab_arr, parents, (lams - birth_arr[parents]) * sizes)
    stability = {c: float(stab_arr[c]) for c in cluster_ids}

    root = n_points
    if cluster_selection_method == "leaf":
        selected = {c for c in cluster_ids if not kids[c]
                    and (c != root or allow_single_cluster)}
    elif cluster_selection_method == "eom":
        # bottom-up (labels increase with depth by construction)
        subtree = dict(stability)
        selected = set()
        for c in sorted(cluster_ids, reverse=True):
            ks = kids[c]
            kidsum = sum(subtree[k] for k in ks)
            if ks and kidsum > stability[c]:
                subtree[c] = kidsum
            elif c == root and not allow_single_cluster:
                subtree[c] = max(kidsum, stability[c])
            else:
                subtree[c] = stability[c]
                selected.add(c)
                drop = list(ks)
                while drop:                 # deselect all descendants
                    d = drop.pop()
                    selected.discard(d)
                    drop.extend(kids[d])
    else:
        raise ValueError("cluster_selection_method must be 'eom' or 'leaf'")

    parent_up = dict(zip(children[cm].tolist(), parents[cm].tolist()))
    if cluster_selection_epsilon > 0 and selected:
        def climb(c):
            # first ancestor born at distance >= eps (Malzer-Baum
            # traverse_upwards); stop below root unless allowed
            while True:
                p = parent_up.get(c)
                if p is None or p == root:
                    return root if allow_single_cluster else c
                if birth[p] > 0 and 1.0 / birth[p] >= cluster_selection_epsilon:
                    return p
                c = p
        merged = set()
        for c in selected:
            if birth[c] > 0 and 1.0 / birth[c] >= cluster_selection_epsilon:
                merged.add(c)
            else:
                merged.add(climb(c))
        # drop any selection nested under another selection
        selected = {c for c in merged
                    if not any(a in merged for a in _ancestors(c, parent_up))}

    # point rows: nearest selected ancestor, resolved once per CLUSTER
    # (top-down over the small cluster set; labels increase with
    # depth), then vectorized over the O(n) point rows
    parent_of = parent_up
    flat = {c: i for i, c in enumerate(sorted(selected))}
    anc_arr = np.full(max(cluster_ids) + 1, -1, np.int64)
    flat_arr = np.full(max(cluster_ids) + 1, -1, np.int64)
    for c in sorted(cluster_ids):
        if c in selected:
            anc_arr[c] = c
        elif c in parent_of:
            anc_arr[c] = anc_arr[parent_of[c]]
    for c, i in flat.items():
        flat_arr[c] = i
    pt = children < n_points
    P, C, L = parents[pt], children[pt], lams[pt]
    sel_anc = anc_arr[P]
    ok = sel_anc >= 0
    fl = flat_arr[sel_anc[ok]]
    lam_max = np.zeros(max(len(flat), 1))
    np.maximum.at(lam_max, fl, L[ok])
    labels[C[ok]] = fl
    denom = lam_max[fl]
    probs[C[ok]] = np.where(denom > 0,
                            np.minimum(L[ok] / np.where(denom > 0, denom, 1.0),
                                       1.0), 1.0)
    return HdbscanResult(labels, probs, cond, stability,
                         sorted(flat, key=flat.get))


def outlier_scores(cond: np.ndarray, n_points: int) -> np.ndarray:
    """GLOSH outlier scores (Campello et al. 2015 §8) from the
    condensed tree: score(p) = 1 - lambda_p / lambda_max(B(p)), where
    B(p) is the deepest cluster containing p and lambda_max its
    densest level (max lambda anywhere in B(p)'s subtree).  1 = falls
    out immediately (strong outlier), 0 = survives to the densest
    core.  Points absent from the tree (tiny components) score 1."""
    scores = np.ones(n_points)
    if cond.shape[0] == 0:
        return scores
    parents = cond[:, 0].astype(np.int64)
    children = cond[:, 1].astype(np.int64)
    lams = cond[:, 2]
    lam_max = np.zeros(int(parents.max()) + 1)
    np.maximum.at(lam_max, parents, lams)
    # propagate subtree max bottom-up over the small cluster tree
    # (children labels > parent labels by construction)
    cm = children >= n_points
    cluster_edges = sorted(zip(parents[cm].tolist(), children[cm].tolist()),
                           key=lambda e: -e[1])
    for p, c in cluster_edges:
        if c < lam_max.size:
            lam_max[p] = max(lam_max[p], lam_max[c])
    pts = ~cm
    P, C, L = parents[pts], children[pts], lams[pts]
    denom = lam_max[P]
    good = denom > 0
    scores[C[good]] = 1.0 - np.minimum(L[good] / denom[good], 1.0)
    return scores


def hdbscan(g: KGraph, min_cluster_size: int = 5,
            min_samples: int | None = None,
            allow_single_cluster: bool = False,
            cluster_selection_method: str = "eom",
            cluster_selection_epsilon: float = 0.0) -> HdbscanResult:
    """Full HDBSCAN* over the kNN graph: mutual-reachability weights ->
    MST -> single linkage -> condensed tree -> EOM extraction.  The
    graph stands in for the exact metric space (standard for
    approximate-kNN HDBSCAN); ``min_samples`` defaults to the graph's
    neighbour count capped at min_cluster_size, as in common practice."""
    if min_cluster_size < 2:        # fail before the expensive phases
        raise ValueError("min_cluster_size must be >= 2")
    if min_samples is None:
        min_samples = min(min_cluster_size, g.nbng)
    t = {}
    t0 = time.perf_counter()
    gm = mutual_reachability(g, min_samples)
    if gm.dists.is_cuda:
        torch.cuda.synchronize(gm.dists.device)
    t["mutual_reachability"] = time.perf_counter() - t0
    dend = single_linkage(gm, timings=t)
    t0 = time.perf_counter()
    cond = condensed_tree(dend, min_cluster_size)
    t["condense"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = extract_clusters_eom(
        cond, g.nb_nodes, allow_single_cluster=allow_single_cluster,
        cluster_selection_method=cluster_selection_method,
        cluster_selection_epsilon=cluster_selection_epsilon)
    t["extract"] = time.perf_counter() - t0
    res.timings = t
    return res
