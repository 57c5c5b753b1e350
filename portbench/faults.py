"""Faults planted in the program under test, to show that the check
catches them: each is a context manager that patches one place where an
answer is produced, and restores it on exit.

* ``unchanged``: the dense optimizer returns its initial state;
* ``half``: the dense optimizer leaves half of the rows where they
  started;
* ``graph``: the kNN build returns one wrong neighbour a row, with the
  true neighbour's distance;
* ``projection``: the hierarchy projects every row onto the next
  sampled row;
* ``embedding``: the embedding's rows come back shifted by one;
* ``kicks_dropped``: every sweep of the dense optimizer gives each row
  2 of its n_neg repulsion kicks (5 at the configurations' n_sub).

``sweeps_skipped`` (the dense optimizer runs two of every four sweeps,
so that both column groups keep theirs) is planted the same way but is
no fault the check can see: the schedule has come to rest by then, and
every reading of the result stays as a sound run's.

``bf16_sweeps`` is the control of the optimizer, not a fault: the dense
optimizer with its state held in bfloat16, rounded at the start and
after every sweep, as a sweep that stored its coordinates in bfloat16
would leave them.

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half", "graph", "projection", "embedding",
         "kicks_dropped")
#: planted the same way, but the optimizer's control
CONTROLS = ("bf16_sweeps",)


def wrong_neighbour(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Neighbour ids (rows, k) with the last of each row replaced by
    another row."""
    ids = ids.clone()
    ids[:, -1] = (ids[:, -1].long() + 7919 % n + 1).remainder(n).to(
        ids.dtype)
    return ids


def next_sampled(proj_idx: torch.Tensor, m: int) -> torch.Tensor:
    """Each row projected onto the next of the ``m`` sampled rows."""
    return (proj_idx + 1).remainder(m)


def shifted(y: torch.Tensor) -> torch.Tensor:
    """The embedding's rows shifted by one."""
    return torch.roll(y, 1, 0)


def _alter_graph(g):
    return type(g)(indices=wrong_neighbour(g.indices, g.indices.shape[0]),
                   dists=g.dists)


@contextlib.contextmanager
def planted(kind: str):
    """The program with fault ``kind`` planted, for the block's length."""
    import annembed_tpu_torch.api as api
    import annembed_tpu_torch.optim.dense as od
    import annembed_tpu_torch.optim.embedder as em

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, new)

    dense = em.run_dense_optimization
    sweeps = od.dense_sweeps
    build_kgraph, build_projection = api.build_kgraph, api.build_projection
    if kind == "unchanged":
        patch(em, "run_dense_optimization",
              lambda y0, *a, **kw: (y0.clone(), {"optimizer": "dense",
                                                 "sweeps": 0}))
    elif kind == "half":
        def halved(y0, *a, **kw):
            y, info = dense(y0, *a, **kw)
            y = y.clone()
            y[y.shape[0] // 2:] = y0[y.shape[0] // 2:]
            return y, info
        patch(em, "run_dense_optimization", halved)
    elif kind == "graph":
        def projection(*a, **kw):
            p = build_projection(*a, **kw)
            p.large_graph = _alter_graph(p.large_graph)
            return p
        patch(api, "build_kgraph",
              lambda *a, **kw: _alter_graph(build_kgraph(*a, **kw)))
        patch(api, "build_projection", projection)
    elif kind == "projection":
        def projection(*a, **kw):
            p = build_projection(*a, **kw)
            p.proj_small_idx = next_sampled(p.proj_small_idx,
                                            p.sample_ids.shape[0])
            return p
        patch(api, "build_projection", projection)
    elif kind == "embedding":
        embed = em.Embedder.embed
        patch(em.Embedder, "embed", lambda self: shifted(embed(self)))
    elif kind == "kicks_dropped":
        def fewer_kicks(y, y_src, edges, scale, gammas, offsets, groups, b,
                        n_neg, *a, **kw):
            return sweeps(y, y_src, edges, scale, gammas, offsets, groups, b,
                          max(1, n_neg * 2 // 5), *a, **kw)
        patch(od, "dense_sweeps", fewer_kicks)
    elif kind == "sweeps_skipped":
        def fewer_sweeps(y, y_src, edges, scale, gammas, offsets, groups,
                         *a, **kw):
            keep = (torch.arange(gammas.shape[0], device=gammas.device)
                    // 2) % 2 == 0
            return sweeps(y, y_src, edges, scale, gammas[keep],
                          offsets[keep], groups[keep], *a, **kw)
        patch(od, "dense_sweeps", fewer_sweeps)
    elif kind == "bf16_sweeps":
        def rounded(y):
            y.copy_(y.to(torch.bfloat16).to(torch.float32))

        def bf16_sweeps(y, y_src, edges, scale, gammas, offsets, groups,
                        *a, **kw):
            rounded(y)
            for s in range(gammas.shape[0]):
                sweeps(y, y_src, edges, scale, gammas[s:s + 1],
                       offsets[s:s + 1], groups[s:s + 1], *a, **kw)
                rounded(y)
            return y
        patch(od, "dense_sweeps", bf16_sweeps)
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
