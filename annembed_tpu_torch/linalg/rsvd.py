"""Randomized truncated SVD (Halko-Tropp) for dense and COO operators.

Port of annembed_tpu/linalg/rsvd.py (reference src/tools/svdapprox.rs):
QR-stabilized subspace iteration, projection B = Q^T A, small dense SVD
of B; the epsilon-adaptive range finder (Halko-Tropp 4.2) and the SVD on
its basis; the power-iteration estimate of the first singular value.
Operators are matmul closures ``matmat(X: (n, r)) -> (m, r)``, so the
same code serves dense matrices and the COO graph Laplacians (SpMM =
gather + ``index_add_``).

Random draws can be passed in (tests feed the JAX package's): the
Gaussian test matrix ``omega``, the adaptive finder's per-block
``omegas`` and the power iteration's start vector ``v0``.  Otherwise they
come from a ``torch.Generator`` on the operator's device, seeded with
the reference's 4664397 (svdapprox.rs:70), or 0 for the power iteration
as in the JAX package.  The JAX package's choice between a fused and an
eager program for the COO SVD (``_randomized_svd_coo_fused`` /
``_eager``) shapes an XLA program, not a result, and has no counterpart.
"""

from __future__ import annotations

import math
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


def _gaussian(shape, dtype, device, omega, generator, seed=SVD_SEED):
    """``omega`` as a tensor, or a draw on ``device`` (from ``generator``,
    else one seeded with ``seed`` there)."""
    if omega is not None:
        if not isinstance(omega, torch.Tensor):
            omega = np.array(omega)
        return torch.as_tensor(omega, dtype=dtype, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def subspace_range(matmat: Callable, rmatmat: Callable, n_cols: int,
                   rank: int, n_iter: int, omega=None,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32, device="cuda") -> torch.Tensor:
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
                      dtype=torch.float32, device="cuda",
                      epsil: Optional[float] = None) -> SvdResult:
    """Truncated SVD of a linear operator given by matmat closures:
    ``rank`` triplets after an oversampled range pass, on ``device``
    (the closures' device).  With ``epsil``, singular values
    s_i <= epsil * s_0 are zeroed (the fixed-rank stand-in for the
    reference's RangePrecision mode, svdapprox.rs:155,444)."""
    m, n = shape
    l = min(rank + n_oversample, min(m, n))
    q = subspace_range(matmat, rmatmat, n, l, n_iter, omega=omega,
                       generator=generator, dtype=dtype, device=device)
    b = rmatmat(q).T                                   # (l, n) == Q^T A
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    r = min(rank, l)
    s = s[:r]
    if epsil is not None:
        s = torch.where(s > epsil * s[0], s, torch.zeros_like(s))
    return SvdResult(u=u[:, :r], s=s, vt=vt[:r])


def randomized_svd_dense(a: torch.Tensor, rank: int, n_iter: int = 5,
                         n_oversample: int = 10, omega=None,
                         generator: Optional[torch.Generator] = None,
                         epsil: Optional[float] = None) -> SvdResult:
    """Randomized SVD of a dense matrix."""
    return randomized_svd_op(lambda x: a @ x, lambda x: a.T @ x, a.shape,
                             rank, n_iter, n_oversample, omega=omega,
                             generator=generator, dtype=a.dtype,
                             device=a.device, epsil=epsil)


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


def adaptive_range_finder(matmat: Callable, shape: tuple[int, int],
                          epsil: float = 0.05, max_rank: int = 128,
                          block_size: int = 8, omegas=None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda"):
    """Epsilon-adaptive randomized range finder (Halko-Tropp algorithm
    4.2, blocked; reference ``adaptative_range_finder_matrep``,
    svdapprox.rs:444-597).

    Each block draws ``block_size`` Gaussian samples y = A w (block i's
    draw is ``omegas[i]`` (n, block_size) when given), projects out the
    basis twice, and stops when Halko's lemma 4.1 bound
    10 sqrt(2/pi) max_j ||y_j|| falls below ``epsil`` times the operator
    scale (the largest residual norm seen, set by the first block); else
    it appends the block by per-column modified Gram-Schmidt, zeroing
    and not counting directions below 1e-5 of the scale.  One readback a
    block.  Returns (q (m, max_rank) with zero columns past the
    discovered rank, rank)."""
    m, n = shape
    max_rank = min(max_rank, min(m, n))
    nb = -(-max_rank // block_size)
    halko = 10.0 * math.sqrt(2.0 / math.pi)
    if omegas is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(SVD_SEED)
    q = torch.zeros((m, nb * block_size), dtype=torch.float32, device=device)
    scale = torch.zeros((), dtype=torch.float32, device=device)
    kept = []
    for i in range(nb):
        omega = _gaussian((n, block_size), torch.float32, device,
                          None if omegas is None else omegas[i], generator)
        y = matmat(omega)
        # project out the current basis; its zero columns are inert
        y = y - q @ (q.T @ y)
        y = y - q @ (q.T @ y)
        res_max = torch.linalg.norm(y, dim=0).max()
        scale = torch.maximum(scale, res_max)
        if bool(halko * res_max < epsil * scale):
            break
        # QR would complete a rank-deficient block arbitrarily, not
        # orthogonally to q: one column at a time instead
        cols = []
        for j in range(block_size):
            v = y[:, j]
            for u in cols:
                v = v - u * torch.dot(u, v)
            v = v - q @ (q.T @ v)
            nrm = torch.linalg.norm(v)
            ok = nrm > 1e-5 * scale
            cols.append(torch.where(ok, v / nrm.clamp_min(1e-30),
                                    torch.zeros_like(v)))
            kept.append(ok)
        q[:, i * block_size:(i + 1) * block_size] = torch.stack(cols, 1)
    count = int(torch.stack(kept).sum()) if kept else 0
    return q[:, :max_rank], min(count, max_rank)


def randomized_svd_adaptive(matmat: Callable, rmatmat: Callable,
                            shape: tuple[int, int], epsil: float = 0.05,
                            max_rank: int = 128, block_size: int = 8,
                            omegas=None,
                            generator: Optional[torch.Generator] = None,
                            device="cuda") -> SvdResult:
    """Adaptive-precision truncated SVD (the reference's
    RangeApproxMode::EPSIL path, svdapprox.rs:155,721): the rank from
    :func:`adaptive_range_finder`, then B = Q^T A and its SVD.  Columns
    past the discovered rank are zero, so their triplets sit at the tail
    with s zeroed."""
    q, rank = adaptive_range_finder(matmat, shape, epsil=epsil,
                                    max_rank=max_rank,
                                    block_size=block_size, omegas=omegas,
                                    generator=generator, device=device)
    b = rmatmat(q).T                                   # (l, n) == Q^T A
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    keep = torch.arange(s.shape[0], device=s.device) < rank
    return SvdResult(u=q @ ub, s=torch.where(keep, s, torch.zeros_like(s)),
                     vt=vt)


def estimate_first_singular_value(matmat: Callable, rmatmat: Callable,
                                  n_cols: int, n_iter: int = 20, v0=None,
                                  generator: Optional[torch.Generator] = None,
                                  device="cuda") -> torch.Tensor:
    """Power-iteration estimate of sigma_1 (svdapprox.rs:844) from the
    start vector ``v0`` (n_cols, 1), drawn on ``device`` if not given."""
    v = _gaussian((n_cols, 1), torch.float32, device, v0, generator, seed=0)
    v = v / torch.linalg.norm(v)
    for _ in range(n_iter):
        w = rmatmat(matmat(v))
        v = w / torch.linalg.norm(w).clamp_min(1e-30)
    return torch.linalg.norm(matmat(v))
