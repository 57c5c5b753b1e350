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

On a mesh every rank plants the same fault (each runs the same
calibration, ``mesh.spmd``), and each optimizer fault is planted in the
sharded optimizer too (``parallel/sharded.py``: its result, its kick
rows).  A mesh has one fault of its own:

* ``exchange_dropped``: the sharded dense optimizer's row all-gather
  after each half-sweep hands each rank its own block and leaves the
  other ranks' rows as they were before it.

``sweeps_skipped`` (the dense optimizer runs two of every four sweeps,
so that both column groups keep theirs) is planted the same way but is
no fault the check can see: the schedule has come to rest by then, and
every reading of the result stays as a sound run's.

``bf16_sweeps`` is the control of the optimizer, not a fault: the dense
optimizer with its state held in bfloat16, rounded at the start and
after every sweep, as a sweep that stored its coordinates in bfloat16
would leave them (on a mesh: the start and each rank's kick rows
rounded before they are gathered).

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half", "graph", "projection", "embedding",
         "kicks_dropped")
#: faults only a mesh can have
MESH_KINDS = ("exchange_dropped",)
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


class OwnBlock:
    """The mesh as the sharded dense segment sees it under
    ``exchange_dropped``: its row all-gather hands each rank its own
    block and keeps the other ranks' rows as the previous gather (or the
    segment's start) left them."""

    def __init__(self, mesh):
        self.rank, self.size, self.device = mesh.rank, mesh.size, mesh.device
        self.y = None

    def all_gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        m = rows.shape[0]
        y = self.y.clone()
        y[self.rank * m:(self.rank + 1) * m] = rows
        self.y = y
        return y


def _alter_graph(g):
    return type(g)(indices=wrong_neighbour(g.indices, g.indices.shape[0]),
                   dists=g.dists)


@contextlib.contextmanager
def planted(kind: str):
    """The program with fault ``kind`` planted, for the block's length."""
    import annembed_tpu_torch.api as api
    import annembed_tpu_torch.ops.dense_sweep as ds
    import annembed_tpu_torch.optim.dense as od
    import annembed_tpu_torch.optim.embedder as em
    import annembed_tpu_torch.parallel.sharded as sh

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, new)

    # the one-card optimizer and the sharded one (the embedder's under a
    # mesh), each patched where its caller looks it up
    optimizers = ((em, "run_dense_optimization", em.run_dense_optimization),
                  (sh, "sharded_dense_optimize", sh.sharded_dense_optimize))
    sweeps = od.dense_sweeps
    kick_rows = ds.dense_kick_rows
    build_kgraph, build_projection = api.build_kgraph, api.build_projection
    if kind == "unchanged":
        for obj, name, _ in optimizers:
            patch(obj, name, lambda y0, *a, **kw: (
                y0.clone(), {"optimizer": "dense", "sweeps": 0}))
    elif kind == "half":
        def halved(dense):
            def run(y0, *a, **kw):
                y, info = dense(y0, *a, **kw)
                y = y.clone()
                y[y.shape[0] // 2:] = y0[y.shape[0] // 2:].to(y.device)
                return y, info
            return run
        for obj, name, dense in optimizers:
            patch(obj, name, halved(dense))
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

        def fewer_kick_rows(y, a, lo, offset, idx_full, scale, gamma, b,
                            n_neg, *r, **kw):
            return kick_rows(y, a, lo, offset, idx_full, scale, gamma, b,
                             max(1, n_neg * 2 // 5), *r, **kw)
        patch(ds, "dense_kick_rows", fewer_kick_rows)
    elif kind == "exchange_dropped":
        segment_of = sh.make_sharded_dense_segment

        def own_blocks(mesh, *a, **kw):
            stale = OwnBlock(mesh)
            segment = segment_of(stale, *a, **kw)

            def run(y0, *sa, **skw):
                stale.y = y0.to(torch.float32)
                return segment(y0, *sa, **skw)
            return run
        patch(sh, "make_sharded_dense_segment", own_blocks)
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
        sharded = sh.sharded_dense_optimize

        def bf16_kick_rows(*a, **kw):
            rows = kick_rows(*a, **kw)
            rounded(rows)
            return rows

        def bf16_sharded(y0, *a, **kw):
            return sharded(y0.to(torch.bfloat16).to(torch.float32), *a, **kw)
        patch(ds, "dense_kick_rows", bf16_kick_rows)
        patch(sh, "sharded_dense_optimize", bf16_sharded)
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
