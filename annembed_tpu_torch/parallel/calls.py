"""Rank bodies that ``parallel.launch.run_on_ranks`` can pickle: a list
of calls run in order on every rank, and the composite steps of the
semantics checks.

    run_on_ranks(call_each, 2, ([("annembed_tpu_torch.parallel."
                 "sharded_knn:sharded_knn_graph_brute", (x, 6), {})],),
                 device="cpu")

returns, for each rank, the list of its calls' results, so a caller can
hold a sharded function against its single-device twin and every rank's
result against rank 0's in one spawned group.
"""

from __future__ import annotations

import importlib
from typing import Sequence

from .sharded import (Mesh, make_sharded_dense_step, make_sharded_train_step,
                      shard_dense_inputs, shard_edge_set)


def call_each(mesh: Mesh, calls: Sequence) -> list:
    """Run each (``"module:function"``, args, kwargs) of ``calls`` as
    ``function(*args, mesh=mesh, **kwargs)``; their results in order."""
    out = []
    for target, args, kwargs in calls:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        out.append(fn(*args, mesh=mesh, **kwargs))
    return out


def train_step_once(y, seed: int, es, grad_step: float, draws=None,
                    b: float = 1.0, batch_size: int = 64, *, mesh: Mesh):
    """One ``make_sharded_train_step`` step on ``shard_edge_set(es)``;
    ``draws`` holds each rank's (u, neg)."""
    step = make_sharded_train_step(mesh, b=b, batch_size_per_device=batch_size)
    return step(y.to(mesh.device), seed, *shard_edge_set(es, mesh), grad_step,
                draws=None if draws is None else draws[mesh.rank])


def dense_step_once(y, seed: int, g, npar, params, gamma: float, draws=None,
                    b: float = 1.0, n_neg: int = 5, *, mesh: Mesh):
    """One ``make_sharded_dense_step`` sweep on ``shard_dense_inputs``;
    ``draws`` holds each rank's (perm, offset)."""
    step = make_sharded_dense_step(mesh, b=b, n_neg=n_neg)
    return step(y.to(mesh.device), seed,
                *shard_dense_inputs(g, npar, params, mesh), gamma,
                draws=None if draws is None else draws[mesh.rank])


def method_call(obj, name: str, *args, mesh: Mesh, **kwargs):
    """``obj.name(*args, mesh=mesh, **kwargs)``: a method as a call of
    ``call_each``."""
    return getattr(obj, name)(*args, mesh=mesh, **kwargs)
