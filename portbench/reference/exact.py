"""The plain reference that judges an embed: exact searches in plain
PyTorch, in blocks of rows, and the checks of the graph, the hierarchy's
projection and the embedding that decide ``correct``.

It imports nothing of the program under test: it sees the rows the
benchmark made and the outputs the program returned, and works out
every neighbour and distance again itself.  Squared distances are formed
as |q|^2 + |c|^2 - 2 q.c in float32 with TF32 off to find candidates,
then recomputed directly in float64 to rank them.

``precision`` below float32 ("tf32", "bfloat16", "fp8") rounds the
operands of the search as that format would and keeps float32
arithmetic: the control that puts a lower-precision search in the
program's place.
"""

from __future__ import annotations

import torch

#: a neighbour whose squared distance is within TIE_REL of the row's
#: expansion scale (|q|^2 + |c|^2) of the k-th exact one is a near-tie:
#: float32 arithmetic cannot order such pairs, so either may be returned
TIE_REL = 1e-5
#: bytes of one block's distance panel
PANEL_BYTES = 6 << 30
#: extra candidates ranked again in float64 past the k wanted
MARGIN = 8


def round_operands(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision``'s significand, as float32.
    TF32 keeps 10 explicit bits, rounded to nearest with ties away from
    zero (the card's cvt.rna.tf32.f32)."""
    if precision == "float32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
        return bits.view(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _block_rows(n_corpus: int) -> int:
    return max(1, min(4096, PANEL_BYTES // (4 * max(n_corpus, 1))))


def _f32_candidates(corpus, queries, k, exclude=None,
                    precision: str = "float32"):
    """(ids (s, k) int64, squared distances (s, k) float32) of the k
    smallest float32 expansions of each query row against ``corpus``;
    ``exclude`` (s,) drops one corpus row per query (itself)."""
    c = round_operands(corpus, precision)
    q = round_operands(queries, precision)
    csq = torch.square(c).sum(1)
    s, n = q.shape[0], c.shape[0]
    k = min(k, n - (exclude is not None))
    br = _block_rows(n)
    ids = torch.empty((s, k), dtype=torch.int64, device=q.device)
    d2 = torch.empty((s, k), dtype=torch.float32, device=q.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for r0 in range(0, s, br):
            qb = q[r0:r0 + br]
            panel = torch.addmm(csq[None, :], qb, c.T, alpha=-2.0)
            panel += torch.square(qb).sum(1, keepdim=True)
            if exclude is not None:
                rows = torch.arange(qb.shape[0], device=q.device)
                panel[rows, exclude[r0:r0 + br]] = float("inf")
            v, i = torch.topk(panel, k, dim=1, largest=False)
            ids[r0:r0 + br], d2[r0:r0 + br] = i, v
            del panel
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return ids, d2


def pair_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances in float64 of rows ``a`` (s, d) to the rows
    ``b`` (s, k, d), formed from the differences."""
    diff = b.to(torch.float64) - a.to(torch.float64)[:, None, :]
    return torch.square(diff).sum(-1)


def exact_knn(corpus, queries, k, exclude=None):
    """Exact k nearest corpus rows of each query: (ids (s, k) int64,
    squared distances (s, k) float64), ordered by the float64 distance."""
    ids, _ = _f32_candidates(corpus, queries, k + MARGIN, exclude)
    out_i = torch.empty((queries.shape[0], k), dtype=torch.int64,
                        device=ids.device)
    out_d = torch.empty((queries.shape[0], k), dtype=torch.float64,
                        device=ids.device)
    for r0 in range(0, queries.shape[0], 4096):
        ib = ids[r0:r0 + 4096]
        d = pair_d2(queries[r0:r0 + 4096], corpus[ib])
        d, order = torch.sort(d, dim=1, stable=True)
        out_i[r0:r0 + 4096] = torch.gather(ib, 1, order)[:, :k]
        out_d[r0:r0 + 4096] = d[:, :k]
    return out_i, out_d


def search_at(corpus, queries, k, precision, exclude=None):
    """The control's answer: the k nearest by a search at ``precision``
    alone, with the distances it computed: (ids (s, k), dists (s, k))."""
    ids, d2 = _f32_candidates(corpus, queries, k, exclude, precision)
    return ids, torch.sqrt(d2.clamp_min(0.0))


def judge_graph(x, rows, got_ids, got_dists, exact_ids, exact_d2):
    """The returned graph's rows ``rows`` (ids (s, k), distances (s, k))
    against the exact search.  A returned neighbour is a hit if it is no
    farther than the exact k-th one up to a near-tie; a duplicate id in
    a row counts once.  Returns (miss share, largest distance error
    relative to the pair's expansion scale, plain recall@k)."""
    s, k = got_ids.shape
    n = x.shape[0]
    if s == 0:
        return 0.0, 0.0, 1.0
    valid = (got_ids >= 0) & (got_ids < n)
    ids = torch.where(valid, got_ids, torch.zeros_like(got_ids))
    xq = x[rows]
    nbrs = x[ids]
    d2 = pair_d2(xq, nbrs)
    sq_q = torch.square(xq.to(torch.float64)).sum(1)
    scale = sq_q[:, None] + torch.square(nbrs.to(torch.float64)).sum(-1)
    kth = exact_d2[:, k - 1:k]
    kth_scale = sq_q[:, None] + torch.square(
        x[exact_ids[:, k - 1]].to(torch.float64)).sum(1)[:, None]
    hit = valid & (d2 <= kth + TIE_REL * kth_scale) & (ids != rows[:, None])
    srt, order = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        k, device=ids.device).expand(s, k)), dim=1)
    first = torch.ones_like(hit)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    unique = torch.zeros_like(hit).scatter_(1, order, first)
    miss = 1.0 - float((hit & unique).sum()) / float(s * k)
    err = torch.where(valid, (torch.square(got_dists.to(torch.float64)) - d2)
                      .abs() / scale.clamp_min(1e-300),
                      torch.full_like(d2, float("inf")))
    recall = float((got_ids[:, :, None] == exact_ids[:, None, :]).any(1)
                   .sum()) / float(s * k)
    return miss, float(err.max()), recall


def judge_projection(x, rows, sample_ids, proj_idx, proj_dist,
                     expect_m: int):
    """The hierarchy's projection of rows ``rows``: each must name the
    nearest member of the sample (itself at distance 0 if sampled), up
    to a near-tie, and carry that distance.  ``sample_ids`` must be
    ``expect_m`` distinct sorted row ids.  Returns (miss share, largest
    distance error relative to the pair's expansion scale)."""
    n = x.shape[0]
    m = sample_ids.shape[0]
    if (m != expect_m or m == 0 or int(sample_ids.min()) < 0
            or int(sample_ids.max()) >= n
            or bool((sample_ids[1:] <= sample_ids[:-1]).any())):
        return 1.0, float("inf")
    if bool(((proj_idx < 0) | (proj_idx >= m)).any()):
        return 1.0, float("inf")
    xs = x[sample_ids]
    xq = x[rows]
    _, best = exact_knn(xs, xq, 1)
    got = xs[proj_idx][:, None, :]
    d2 = pair_d2(xq, got)[:, 0]
    sq_q = torch.square(xq.to(torch.float64)).sum(1)
    scale = sq_q + torch.square(got[:, 0].to(torch.float64)).sum(1)
    miss = d2 > best[:, 0] + TIE_REL * scale
    err = (torch.square(proj_dist.to(torch.float64)) - d2).abs() / \
        scale.clamp_min(1e-300)
    return float(miss.double().mean()), float(err.max())


def embedded_neighbours(y, rows, k):
    """Exact k nearest embedded rows of each of ``rows`` (itself
    excluded): (ids (s, k), squared distances (s, k)) in float32,
    formed from the differences."""
    yq = y[rows]
    s, n = yq.shape[0], y.shape[0]
    br = _block_rows(n * y.shape[1])
    ids = torch.empty((s, k), dtype=torch.int64, device=y.device)
    d2 = torch.empty((s, k), dtype=torch.float32, device=y.device)
    for r0 in range(0, s, br):
        qb = yq[r0:r0 + br]
        panel = (qb[:, None, 0] - y[None, :, 0]).square_()
        for c in range(1, y.shape[1]):
            panel += (qb[:, None, c] - y[None, :, c]).square_()
        panel[torch.arange(qb.shape[0], device=y.device),
              rows[r0:r0 + br]] = float("inf")
        v, i = torch.topk(panel, k, dim=1, largest=False)
        ids[r0:r0 + br], d2[r0:r0 + br] = i, v
        del panel
    return ids, d2


def judge_embedding(y, labels, rows, data_nbrs, radius_k: int,
                    label_k: int):
    """The embedding at rows ``rows``: (rows not finite, label impurity,
    neighbourhood kept).  Impurity is the share of each row's
    ``label_k`` nearest embedded neighbours whose source cluster
    differs; neighbourhood kept is the share of the exact data-space
    neighbours ``data_nbrs`` (s, knbn) that lie within the row's
    exact ``radius_k``-NN embedded radius (upstream embedder.rs:620-681,
    with exact searches on both sides)."""
    bad = int((~torch.isfinite(y)).any(1).sum())
    if bad:
        return bad, 1.0, 0.0
    e_ids, e_d2 = embedded_neighbours(y, rows, max(radius_k, label_k))
    impurity = float((labels[e_ids[:, :label_k]] != labels[rows][:, None])
                     .double().mean())
    radius = e_d2[:, radius_k - 1:radius_k]
    d2 = torch.square(y[data_nbrs] - y[rows][:, None, :]).sum(-1)
    kept = float((d2 <= radius).double().mean())
    return 0, impurity, kept



def shared_rows(y: torch.Tensor) -> float:
    """The share of rows of ``y`` (n, d) whose position another row
    takes too, compared exactly."""
    if y.shape[1] == 2:
        # one int64 key a row: the two coordinates' bits
        bits = (y + 0.0).contiguous().view(torch.int32).long()
        key = (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)
        _, inverse, counts = torch.unique(key, return_inverse=True,
                                          return_counts=True)
    else:
        _, inverse, counts = torch.unique(y, dim=0, return_inverse=True,
                                          return_counts=True)
    return float((counts[inverse] > 1).double().mean())
