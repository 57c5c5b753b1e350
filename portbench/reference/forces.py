"""The forces of the cross-entropy objective on an embedding, in plain
PyTorch: whether the embedding the optimizer returned is at rest under
the attraction and repulsion that the configuration states.

The reference cannot follow the optimizer row by row: its sweeps are an
expansive map, so float32 rounding in another order parts the two runs
after a few sweeps.  What it can check is where the run ends.  At the
end of the schedule the step is small, and a row moves by the mean of
its sweeps' pulls, which is nought where it has come to rest:

* attraction, per sweep, along each graph edge i -> j (upstream
  embedder.rs:1216-1239, the sweeps' closed form taken at a small step):
  2 fac (a_f m + a_r m_rev) (y_j - y_i), with a = coeff(d2s) (w -
  (1 - w) rep_att(d2s)) from each endpoint's side, m = nbsample k w /
  n_sub the edge's samples a sweep, fac 1/2 where the pair is mutual;
* repulsion, per sweep, n_neg kicks from partners drawn uniformly over
  all rows (embedder.rs:1241-1290): n_neg E_k[h_k coeff(d2s) rep(d2s)
  (y_i - y_k)], h_k the partner's hubness weight where the
  configuration asks for it, summed exactly over every row.

Edge weights, scales and hubness weights are worked out again from the
returned graph (kdumap.rs:26-235, embedder.rs:823-833, 1356-1373).
Imports nothing of the program under test."""

from __future__ import annotations

import torch

#: upstream's floor on an edge probability (embedder.rs:50)
PROBA_MIN = 1.0e-4
#: upstream's negatives per edge sample (embedder.rs:1241)
NB_NEGATIVE = 5


def proba_edges(dists: torch.Tensor, indices: torch.Tensor,
                scale_rho: float, beta: float = 1.0):
    """(scale (n,), w (n, k)) of the graph's sorted neighbour distances
    (kdumap.rs:26-235): rho = the first distance, scale = scale_rho x
    the mean rho of the row and its neighbours, w = exp(-((d -
    rho)_+ / scale)^beta) floored at PROBA_MIN and normalised a row;
    rows whose distances are all equal take 1/k."""
    n, k = dists.shape
    rho = dists[:, 0]
    scale = scale_rho * (rho[indices].sum(1) + rho) / (k + 1.0)
    shifted = (dists - dists[:, :1]).clamp_min(0.0)
    w = torch.exp(-torch.pow(shifted / scale.clamp_min(1e-30)[:, None],
                             beta)).clamp_min(PROBA_MIN)
    w = torch.where((dists[:, -1] <= dists[:, 0])[:, None],
                    torch.full_like(w, 1.0 / k), w)
    return scale, w / w.sum(1, keepdim=True)


def cauchy_coeff(d2s: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """2 / (1 + d2s) / scale^2: the gradient's common factor at b = 1
    (embedder.rs:1216-1222)."""
    return 2.0 / (1.0 + d2s) / torch.square(scale)


def rest_forces(y: torch.Tensor, indices: torch.Tensor,
                dists: torch.Tensor, rows: torch.Tensor, *,
                scale_rho: float, nbsample: int, n_sub: int,
                hubness: bool):
    """The mean pull of one sweep on each of ``rows`` per unit step:
    (attraction (s, d), repulsion (s, d)) in float64, for the embedding
    ``y`` (n, d) of the graph ``indices``/``dists`` (n, k)."""
    n, k = indices.shape
    idx = indices.long()
    scale, w = proba_edges(dists.float(), idx, scale_rho)
    es = 0.2 * torch.clamp(scale / scale.mean().clamp_min(1e-30), 0.25, 4.0)
    y64 = y.double()
    # attraction along the rows' own edges, from both endpoints' sides
    nb = idx[rows]                                      # (s, k)
    back = idx[nb] == rows[:, None, None]               # (s, k, k)
    w_rev = torch.where(back, w[nb], torch.zeros_like(w[nb])).sum(-1)
    diff = y64[nb] - y64[rows][:, None, :]              # (s, k, d)
    d2 = torch.square(diff).sum(-1)
    s_edge = nbsample * k / n_sub

    def alpha(d2s, sc, we):
        rep_att = 1.0 / torch.square(d2s).clamp_min(1.0 / PROBA_MIN)
        return cauchy_coeff(d2s, sc) * (we - (1.0 - we) * rep_att)

    es_i, es_j = es[rows].double()[:, None], es[nb].double()
    a_f = alpha(d2 / torch.square(es_i), es_i, w[rows].double())
    a_r = alpha(d2 / torch.square(es_j), es_j, w_rev.double())
    fac = torch.where(w_rev > 0.0, 0.5, 1.0).double()
    net = 2.0 * fac * s_edge * (a_f * w[rows].double() + a_r * w_rev.double())
    attraction = (diff * net[..., None]).sum(1)
    # repulsion from every row, in blocks
    n_neg = max(1, round(NB_NEGATIVE * nbsample * k / n_sub))
    h = None
    if hubness:
        deg = torch.bincount(idx.reshape(-1), minlength=n).double()
        h = deg.clamp(1.0, float(n))
        h = torch.clamp(h / h.mean(), 0.25, 4.0)
    repulsion = torch.empty_like(attraction)
    br = max(1, min(4096, (1 << 29) // (4 * n)))
    yf = y.float()
    hf = None if h is None else h.float()[None, :]
    for r0 in range(0, rows.shape[0], br):
        r = rows[r0:r0 + br]
        dx = [yf[r, c][:, None] - yf[None, :, c] for c in range(y.shape[1])]
        d2s = torch.square(dx[0])
        for part in dx[1:]:
            d2s += torch.square(part)
        d2s /= torch.square(es[r])[:, None]
        coeff = cauchy_coeff(d2s, es[r][:, None]) / torch.square(
            d2s).clamp_min(1.0 / 16.0)
        coeff = torch.where(d2s > 0.0, coeff, torch.zeros_like(coeff))
        if hf is not None:
            coeff *= hf
        for c, part in enumerate(dx):
            repulsion[r0:r0 + br, c] = n_neg / n * torch.sum(
                part * coeff, 1, dtype=torch.float64)
        del dx, d2s, coeff
    return attraction, repulsion


def pull(y: torch.Tensor, rows: torch.Tensor, attraction, repulsion,
         labels: torch.Tensor) -> float:
    """The pull's tendency to grow (> 0) or shrink (< 0) each source
    cluster of the embedding about its mean c: sum_i (A_i + R_i) . (y_i -
    c_i) over sum_i |A_i . (y_i - c_i)| + |R_i . (y_i - c_i)|, over
    ``rows``.  Nought at rest, whatever the embedding's size; +-1 where
    one side of the pull alone acts."""
    y64 = y.double()
    lab = labels.long()
    counts = torch.bincount(lab).double().clamp_min(1.0)
    centres = torch.stack([torch.bincount(lab, weights=y64[:, c])
                           for c in range(y.shape[1])], 1) / counts[:, None]
    r = y64[rows] - centres[lab[rows]]
    a_r = (attraction * r).sum(1)
    k_r = (repulsion * r).sum(1)
    return float((a_r + k_r).sum()
                 / (a_r.abs() + k_r.abs()).sum().clamp_min(1e-300))
