"""Blocked dense linear algebra for the solver models (EASE and AdmmSLIM).

Counterpart of unirec_tpu/ops/linalg.py, same names and same results: a
right-looking blocked Cholesky, a blocked triangular inverse and the
column-streamed product A^-1 = X^T X with X = L^-1, so that a catalog far
past what one dense factorization handles at once is inverted with panels
of at most ``nb`` columns. Panels use ``torch.linalg.cholesky`` and
``torch.linalg.solve_triangular``; products are ``torch.matmul`` /
``addmm_`` on views.

Every routine works in place on the one [N, N] tensor it is given (slice
assignment and ``addmm_`` on a view write into it): the Cholesky factor
overwrites A, the triangular inverse overwrites the factor, and the
largest temporary is an [N, nb] panel, so the factorization chain peaks at
one [N, N] plus an [N, nb] slab, as the JAX docstring promises. The JAX
package's ``colmajor_format`` has no counterpart: it is a workaround for
XLA's layout assignment, which would otherwise copy the whole matrix
between row- and column-major; torch keeps strides as given. For the same
reason ``spd_inverse_columns`` inverts L itself rather than the JAX
package's transposed view of it (the two give X^T X alike).

The products run in full f32 whatever the process's TF32 setting
(``full_f32``): a TF32 Gram inverse drifts far from the f32 one.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, List, Tuple

import torch


@contextmanager
def full_f32():
    """f32 matmuls on the CUDA card in full precision (no TF32) inside the
    block; the caller's setting is restored after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _block_bounds(N: int, nb: int) -> List[Tuple[int, int]]:
    """[start, end) bounds of nb-sized blocks; the last may be ragged."""
    return [(s, min(s + nb, N)) for s in range(0, N, nb)]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def blocked_cholesky(A: torch.Tensor, nb: int) -> torch.Tensor:
    """Lower Cholesky factor of SPD A, written into A (returned).

    Right-looking: cholesky of each [nb, nb] diagonal panel, the panel
    below it times the inverse of its transpose, then the trailing lower
    trapezoid updated one column block at a time (the largest temporary
    is [N - e, nb]). The strict upper triangle is zeroed at the end."""
    N = A.shape[0]
    bounds = _block_bounds(N, nb)
    with full_f32():
        for k, (s, e) in enumerate(bounds):
            Lkk = torch.linalg.cholesky(A[s:e, s:e])
            A[s:e, s:e] = Lkk
            if e == N:
                continue
            inv_Lkk = torch.linalg.solve_triangular(Lkk, _eye(e - s, A), upper=False)
            A[e:, s:e] = A[e:, s:e] @ inv_Lkk.T
            for js, je in bounds[k + 1:]:
                # A[js:, j] -= panel rows js: times L_jk^T
                A[js:, js:je].addmm_(A[js:, s:e], A[js:je, s:e].T, alpha=-1.0)
    return A.tril_()


def blocked_tri_inv_lower(L: torch.Tensor, nb: int) -> torch.Tensor:
    """X = L^-1 for lower-triangular L, written into L (returned):
        X_ii = L_ii^-1,   X_ij = -X_ii (sum over k of L_ik X_kj),   i > j.

    Row block i reads L's row i (columns not yet overwritten) and X's rows
    < i (already written); its column blocks are written left to right, so
    the products read only what they need. The strict upper triangle is
    zeroed first."""
    bounds = _block_bounds(L.shape[0], nb)
    L.tril_()
    with full_f32():
        for i, (s, e) in enumerate(bounds):
            Xi = torch.linalg.solve_triangular(L[s:e, s:e], _eye(e - s, L), upper=False)
            for cs, ce in bounds[:i]:
                L[s:e, cs:ce] = -(Xi @ (L[s:e, cs:s] @ L[cs:s, cs:ce]))
            L[s:e, s:e] = Xi
    return L


def blocked_tri_inv_upper(U: torch.Tensor, nb: int,
                          assume_triangular: bool = False) -> torch.Tensor:
    """X = U^-1 for upper-triangular U, written into U (returned); the
    transpose of :func:`blocked_tri_inv_lower`. ``assume_triangular`` skips
    zeroing the strict lower triangle."""
    bounds = _block_bounds(U.shape[0], nb)
    if not assume_triangular:
        U.triu_()
    with full_f32():
        for i, (s, e) in enumerate(bounds):
            Xi = torch.linalg.solve_triangular(U[s:e, s:e], _eye(e - s, U), upper=True)
            for cs, ce in bounds[:i]:
                U[cs:ce, s:e] = -((U[cs:ce, cs:s] @ U[cs:s, s:e]) @ Xi)
            U[s:e, s:e] = Xi
    return U


def spd_inverse_columns(A: torch.Tensor, nb: int,
                        out_block: int = 0) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (col_start, [N, cb] slab) of A^-1 for SPD A, on A's device.

    A is overwritten by L and then by X = L^-1; each slab is
    X^T @ X[:, c:c + cb], summed over X's rows from c on (the rows above
    are zero in those columns), so one [N, cb] temporary exists beside A
    (the last slab is ragged when cb does not divide N)."""
    N = A.shape[0]
    cb = min(out_block or nb, N)
    X = blocked_tri_inv_lower(blocked_cholesky(A, nb), nb)
    for c in range(0, N, cb):
        with full_f32():
            slab = X[c:].T @ X[c:, c:c + cb]
        yield c, slab


def spd_inverse(A: torch.Tensor, nb: int) -> torch.Tensor:
    """A^-1 = X^T X as a new [N, N] tensor (A is overwritten by X)."""
    X = blocked_tri_inv_lower(blocked_cholesky(A, nb), nb)
    with full_f32():
        return X.T @ X
