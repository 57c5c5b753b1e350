"""The reference's forces (``reference/forces.py``) against the
program's own sweep at a small step: its edge weights and scales are the
program's, its attraction is the mean pull of the program's attraction
sweep over the column groups, and its repulsion the mean of the
program's kicks over every pool offset.  The test imports the program;
the reference does not."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import forces

N, K, D = 300, 6, 2
GAMMA = 1e-9


def _graph(seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, 5), generator=g)
    d2 = torch.cdist(x, x)
    d2.fill_diagonal_(float("inf"))
    dists, ids = torch.topk(d2, K, dim=1, largest=False)
    y = torch.randn((N, D), generator=g) * 0.5
    return ids, dists, y


@pytest.mark.parametrize("hubness", [False, True])
def test_forces_are_the_program_sweeps_mean_pull(hubness):
    from annembed_tpu_torch.graph.kgraph import KGraph
    from annembed_tpu_torch.graph.proba import to_proba_edges
    from annembed_tpu_torch.optim import dense
    from annembed_tpu_torch.optim.embedder import hubness_sampling_weights
    from annembed_tpu_torch.params import EmbedderParams

    ids, dists, y = _graph(3 + hubness)
    g = KGraph(indices=ids.to(torch.int32), dists=dists)
    npar = to_proba_edges(g, 0.75, 1.0)
    scale, w = forces.proba_edges(dists, ids, 0.75)
    assert torch.allclose(scale, npar.scale, rtol=1e-6)
    assert torch.allclose(w, npar.probas, rtol=1e-5, atol=1e-7)

    params = EmbedderParams()
    hub = hubness_sampling_weights(g) if hubness else None
    (y_r, idx_r, w_r, m_visit, w_rev, m_rev, es, nw, n_neg,
     _) = dense.prepare_dense_inputs(y, g, npar, params, 60, 2, hub,
                                     relabel=torch.arange(N).numpy())
    # the program's sweep functions in float64, so that a small step is
    # not lost to rounding
    y_r, w_r, m_visit, w_rev, m_rev, es = (
        t.double() for t in (y_r, w_r, m_visit, w_rev, m_rev, es))
    nw = None if nw is None else nw.double()
    # the attraction: each column group's pull, averaged over the groups
    yT = y_r.T.contiguous()
    pulls = []
    for c in range(2):
        sl = slice(3 * c, 3 * c + 3)
        idxT = idx_r[:, sl].T.long()
        pulls.append(dense._attraction_sweep_sfT(
            yT, idxT, w_r[:, sl].T, m_visit[:, sl].T, w_rev[:, sl].T,
            m_rev[:, sl].T, es[None, :], es[idxT], GAMMA, 1.0))
    att_prog = (torch.stack(pulls).mean(0) / GAMMA).T.double()
    # the kicks, over every pool offset (every partner equally often)
    yT_ext = torch.cat([yT, yT], dim=1)
    nw_ext = None if nw is None else torch.cat([nw, nw])
    kicks = torch.zeros_like(yT, dtype=torch.float64)
    for off in range(N):
        kicks += (dense._repulsion_block_T(
            yT_ext, yT, 0, N, off, idx_r.T.long(), es[None, :], GAMMA, 1.0,
            n_neg, neg_weight_ext=nw_ext, neighbor_exclusion=False)
                  - yT).double()
    rep_prog = (kicks / N / GAMMA).T

    rows = torch.arange(0, N, 7)
    att, rep = forces.rest_forces(y, ids, dists, rows, scale_rho=0.75,
                                  nbsample=10, n_sub=60, hubness=hubness)
    scale_a = att_prog[rows].norm(dim=1).max()
    scale_r = rep_prog[rows].norm(dim=1).max()
    assert (att - att_prog[rows]).norm(dim=1).max() < 1e-5 * scale_a
    assert (rep - rep_prog[rows]).norm(dim=1).max() < 1e-5 * scale_r


def test_pull_sees_a_pull_out_of_balance():
    ids, dists, y = _graph(7)
    rows = torch.arange(N)
    labels = torch.zeros(N, dtype=torch.int64)
    att, rep = forces.rest_forces(y, ids, dists, rows, scale_rho=1.0,
                                  nbsample=10, n_sub=60, hubness=False)
    # the repulsion alone grows the embedding, the attraction alone
    # shrinks it, and a cluster's pull is about its own mean
    assert forces.pull(y, rows, 0 * att, rep, labels) > 0.2
    assert forces.pull(y, rows, att, 0 * rep, labels) < -0.2
    moved = y.clone()
    moved[N // 2:] += 100.0
    two = (rows >= N // 2).long()
    assert forces.pull(moved, rows, att, rep, two) == pytest.approx(
        forces.pull(y, rows, att, rep, two), rel=1e-4)


def test_shared_rows_counts_every_row_of_a_shared_position():
    from portbench.reference import exact
    y = torch.tensor([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0], [2.0, 0.0],
                      [0.0, 1.0], [1.0, 1.0]])
    assert exact.shared_rows(y) == pytest.approx(0.5)
    assert exact.shared_rows(torch.randn(1000, 2)) == 0.0
