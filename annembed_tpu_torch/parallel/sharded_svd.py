"""Sharded randomized SVD of the COO graph Laplacian (port of
annembed_tpu/parallel/sharded_svd.py).

The COO SpMM inside the Halko-Tropp subspace iteration is sharded over
the 1-D ``data`` mesh: each rank scatter-adds its block of the nnz
entries into a local (n, r) panel, and one ``all_reduce`` merges the
panels, so SpMM = gather + segment sum + all-reduce.  The (n, r)
iterate, the QR factorizations and the final small SVD are replicated:
every rank runs them on the same all-reduced panels, from a Gaussian
test matrix drawn alike on every rank.

The ranks' partial sums reassociate the float sums, so the singular
values match the single-device ``randomized_svd_coo`` to f32 roundoff,
not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..linalg.rsvd import SvdResult, randomized_svd_op, spmm_scatter
from .sharded import Mesh


def sharded_randomized_svd_coo(rows, cols, vals, n: int, rank: int,
                               mesh: Mesh, n_iter: int = 5,
                               n_oversample: int = 10, omega=None,
                               generator: Optional[torch.Generator] = None
                               ) -> SvdResult:
    """Sharded twin of ``linalg/rsvd.py::randomized_svd_coo``: the same
    subspace iteration and test matrix (``omega`` or ``generator``, as
    there), each matmat a local SpMM of this rank's entries plus one
    all-reduce.  nnz is padded to a multiple of the mesh size with inert
    entries (value 0 at row and column 0)."""
    dev = mesh.device
    nnz = rows.shape[0]
    pad = (-nnz) % mesh.size
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad)])
        cols = torch.cat([cols, cols.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros(pad)])
    part = (nnz + pad) // mesh.size
    sl = slice(mesh.rank * part, (mesh.rank + 1) * part)
    r_l, c_l, v_l = rows[sl].to(dev), cols[sl].to(dev), vals[sl].to(dev)

    def matmat(x):
        out = spmm_scatter(r_l, c_l, v_l, x, n)
        mesh.all_reduce_sum(out)
        return out

    return randomized_svd_op(matmat, matmat, (n, n), rank, n_iter=n_iter,
                             n_oversample=n_oversample, omega=omega,
                             generator=generator, dtype=v_l.dtype,
                             device=dev)
