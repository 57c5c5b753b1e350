"""Randomized truncated SVD (Halko-Tropp) for dense and COO operators.

Port of the fixed-rank half of annembed_tpu/linalg/rsvd.py (reference
src/tools/svdapprox.rs): QR-stabilized subspace iteration, projection
B = Q^T A, small dense SVD of B.  Operators are matmul closures
``matmat(X: (n, r)) -> (m, r)``, so the same code serves dense matrices
and the COO graph Laplacians (SpMM = gather + ``index_add_``).

The Gaussian test matrix ``omega`` can be passed in (tests feed the JAX
package's draw); otherwise it comes from a ``torch.Generator`` seeded
with the reference's 4664397 (svdapprox.rs:70).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

#: reference seed of the randomized SVD (svdapprox.rs:70)
SVD_SEED = 4664397


class SvdResult(NamedTuple):
    """Left singular vectors U (m, r), singular values s (r,), right
    vectors Vt (r, n)."""
    u: torch.Tensor
    s: torch.Tensor
    vt: torch.Tensor


def _chol_qr_pass(y: torch.Tensor, shift_rel: float) -> torch.Tensor:
    """One CholeskyQR pass: Q = Y (L^T)^-1 with G = Y^T Y = L L^T.  The
    relative diagonal shift keeps G positive-definite in f32 (torch's
    Cholesky raises where JAX's would return NaN)."""
    l = y.shape[1]
    g = y.T @ y
    shift = shift_rel * torch.trace(g) + 1e-20
    g = g + shift * torch.eye(l, dtype=y.dtype, device=y.device)
    r = torch.linalg.cholesky(g)                       # lower, G = R R^T
    qt = torch.linalg.solve_triangular(r, y.T, upper=False)
    return qt.T


def _qr_q(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of a (m, l) panel: shifted CholeskyQR3 for tall
    panels (m >= 4096 and m >= 32 l), double Householder QR otherwise."""
    m, l = y.shape
    if m >= 4096 and m >= 32 * l:
        # the clean passes keep an eps-level shift so an exactly
        # rank-deficient panel yields zero columns instead of a failure
        q = _chol_qr_pass(y, 4e-6)
        q = _chol_qr_pass(q, 1e-7)
        return _chol_qr_pass(q, 1e-7)
    q, _ = torch.linalg.qr(y)
    q, _ = torch.linalg.qr(q)
    return q


def _gaussian(shape, dtype, device, omega, generator):
    if omega is not None:
        return torch.tensor(np.asarray(omega), dtype=dtype, device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(SVD_SEED)
    return torch.randn(shape, generator=generator, dtype=dtype).to(device)


def subspace_range(matmat: Callable, rmatmat: Callable, n_cols: int,
                   rank: int, n_iter: int, omega=None,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Randomized range finder with QR-stabilized power iteration
    (svdapprox.rs:285,343): Y = A Omega; repeat (Q <- qr(Y);
    Y <- A (A^T Q)).  Returns Q (m, rank)."""
    omega = _gaussian((n_cols, rank), dtype, device, omega, generator)
    q = _qr_q(matmat(omega))
    for _ in range(n_iter):
        qz = _qr_q(rmatmat(q))
        q = _qr_q(matmat(qz))
    return q


def randomized_svd_op(matmat: Callable, rmatmat: Callable,
                      shape: tuple[int, int], rank: int, n_iter: int = 5,
                      n_oversample: int = 10, omega=None,
                      generator: Optional[torch.Generator] = None,
                      dtype=torch.float32, device="cpu") -> SvdResult:
    """Truncated SVD of a linear operator given by matmat closures:
    ``rank`` triplets after an oversampled range pass."""
    m, n = shape
    l = min(rank + n_oversample, min(m, n))
    q = subspace_range(matmat, rmatmat, n, l, n_iter, omega=omega,
                       generator=generator, dtype=dtype, device=device)
    b = rmatmat(q).T                                   # (l, n) == Q^T A
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    r = min(rank, l)
    return SvdResult(u=u[:, :r], s=s[:r], vt=vt[:r])


def randomized_svd_dense(a: torch.Tensor, rank: int, n_iter: int = 5,
                         n_oversample: int = 10, omega=None,
                         generator: Optional[torch.Generator] = None
                         ) -> SvdResult:
    """Randomized SVD of a dense matrix."""
    return randomized_svd_op(lambda x: a @ x, lambda x: a.T @ x, a.shape,
                             rank, n_iter, n_oversample, omega=omega,
                             generator=generator, dtype=a.dtype,
                             device=a.device)


def full_svd_dense(a: torch.Tensor) -> SvdResult:
    """Exact SVD (reference svd_f32 -> LAPACK gesdd, graphlaplace.rs:296)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return SvdResult(u=u, s=s, vt=vt)


def spmm_scatter(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """COO SpMM A @ X by gather + ``index_add_`` (replaces sprs
    ``csr_mulacc_dense_rowmaj``, svdapprox.rs:366)."""
    contrib = vals[:, None] * x[cols.to(torch.int64)]
    out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows.to(torch.int64), contrib)


def coo_matmat(rows, cols, vals, n_rows: int):
    """matmat closure computing A @ X for a COO A of shape (n_rows, *)."""
    def matmat(x: torch.Tensor) -> torch.Tensor:
        return spmm_scatter(rows, cols, vals, x, n_rows)
    return matmat


def randomized_svd_coo(rows, cols, vals, n: int, rank: int,
                       n_iter: int = 5, n_oversample: int = 10, omega=None,
                       generator: Optional[torch.Generator] = None
                       ) -> SvdResult:
    """Randomized SVD of a symmetric COO operator."""
    mm = coo_matmat(rows, cols, vals, n)
    return randomized_svd_op(mm, mm, (n, n), rank, n_iter=n_iter,
                             n_oversample=n_oversample, omega=omega,
                             generator=generator, dtype=vals.dtype,
                             device=vals.device)
