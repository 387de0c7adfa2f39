"""Symmetric-indefinite LDL^T factorization with inertia extraction.

Batch-friendly replacement for the reference's LAPACK Bunch-Kaufman rook path
(reference: src/inertia_correction.jl:257-276, which calls
`LAPACK.sytrf_rook!` and counts eigenvalue signs of the block-diagonal D in
`inertia!` src/inertia_correction.jl:54-205).

Design: the KKT matrices here are tiny (m = nu + nc, <= ~40 for every
reference benchmark) but there are many of them (batch x time). Rook pivoting
is branch-heavy and lane-hostile on a VPU, so instead we use an *unpivoted*
LDL^T:

  * If the factorization completes with healthy pivots, Sylvester's law of
    inertia gives the exact inertia from the signs of D — same information the
    reference extracts from Bunch-Kaufman.
  * Interior-point KKT matrices [H_hat + Sigma, cu'; cu, -delta_c I] become
    quasidefinite as the barrier/regularization terms grow, and quasidefinite
    matrices are strongly factorizable without pivoting (Vanderbei 1995), so
    the unpivoted factorization is reliable exactly in the regime where the
    solver accepts the step. A breakdown (tiny/zero pivot or non-finite fill)
    is reported as a failure, which the caller treats like a wrong-inertia
    result and answers with a regularization bump — the same escape hatch the
    reference uses for singular factorizations (info > 0).
  * Accuracy of the solve is restored with iterative refinement sweeps (the
    factor is reused; each sweep is one small GEMM + two triangular solves).

The factorization loops over m columns with full-width masked rank-1 updates:
under `vmap` over (batch [, time]) every arithmetic op is a large elementwise
op over the batch lanes. The backward-sweep kernel (`backward_pallas.py`)
inlines the same factorization one lane per instance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

Array = jax.Array


class LDLTFactors(NamedTuple):
    ld: Array     # [m, m]: strict lower triangle = L (unit diagonal implied),
                  # diagonal = D. Upper triangle is garbage.
    ok: Array     # scalar bool: finite and no exactly-zero pivot
    n_pos: Array  # scalar int: count of positive pivots (Sylvester inertia)
    n_zero: Array # scalar int: count of exactly-zero pivots (LAPACK info>0 analog)
    perm: Optional[Array] = None  # [m] int: pivot order (None = unpivoted);
                                  # factorization is of A[perm][:, perm]


def ldlt_factor(A: Array, *, atol: float = 0.0, unroll: bool = True) -> LDLTFactors:
    """Unpivoted LDL^T of a symmetric matrix A (uses the lower triangle).

    Returns factors plus the pivot sign counts. By Sylvester's law these are
    the inertia of A whenever the factorization exists; transient small pivots
    do NOT invalidate it (the interior-point KKTs here are graded — barrier
    diagonals span ~1e10 — and unpivoted elimination on them is componentwise
    accurate where eigendecomposition-based solves lose 6+ digits). Breakdown
    manifests as exactly-zero pivots, non-finite fill, or a large residual in
    the subsequent solve — the caller checks the residual (`ldlt_solve_refined`
    with `check_residual`) and treats failure like wrong inertia.

    `atol` mirrors the reference's `inertia!` zero-eigenvalue tolerance
    (reference: src/inertia_correction.jl:266 uses atol=1e-12 on the
    Bunch-Kaufman D); for unpivoted pivots the meaningful analog of LAPACK's
    `info > 0` is an exact zero, so the default is 0.0. `vmap`-compatible.
    """
    m = A.shape[-1]
    if m == 0:
        z = jnp.zeros((), jnp.int32)
        return LDLTFactors(A, jnp.asarray(True), z, z)

    rows = jnp.arange(m)

    def col_step(j, M):
        dj = M[j, j]
        below = rows > j
        # Guard the divide so a zero pivot never produces inf/nan that could
        # poison the rank-1 update through 0 * inf.
        denom = jnp.where(dj == 0, 1.0, dj)
        l = jnp.where(below, M[:, j] / denom, 0.0)
        M = M - dj * l[:, None] * l[None, :]
        # l[j] = 0, so column j and the (j, j) entry were untouched by the
        # update; overwrite the subdiagonal of column j with L and restore D.
        M = M.at[:, j].set(jnp.where(below, l, M[:, j]))
        M = M.at[j, j].set(dj)
        return M

    ld = jax.lax.fori_loop(0, m, col_step, A, unroll=unroll)

    d = jnp.diagonal(ld)
    finite = jnp.all(jnp.isfinite(ld))
    n_zero = jnp.sum(jnp.abs(d) <= atol).astype(jnp.int32)
    n_pos = jnp.sum(d > atol).astype(jnp.int32)
    ok = finite & (n_zero == 0)
    return LDLTFactors(ld=ld, ok=ok, n_pos=n_pos, n_zero=n_zero)


def ldlt_factor_pivoted(A: Array, *, atol: float = 0.0, unroll: bool = True) -> LDLTFactors:
    """LDL^T with symmetric maximum-|diagonal| (greedy 1x1) pivoting.

    The permutation is a congruence, so pivot signs still give the exact
    inertia (Sylvester). Diagonal pivoting bounds element growth on the
    interior-point KKTs here far better than no pivoting, while keeping the
    algorithm branch-free enough to vectorize over a batch (the pivot search
    is a masked argmax over the remaining diagonal — one reduction per column,
    VPU-friendly; contrast with Bunch-Kaufman rook's data-dependent row/column
    scans, the part of the reference's LAPACK path that does not map to lanes,
    reference: src/inertia_correction.jl:261).

    A saddle point with an all-zero remaining diagonal (which genuine
    Bunch-Kaufman covers with 2x2 pivots) surfaces as a zero pivot here; the
    caller treats it like a singular factorization (dual regularization +
    restart), matching the reference's escape hatch for LAPACK info > 0.
    """
    m = A.shape[-1]
    idx = jnp.arange(m)
    if m == 0:
        z = jnp.zeros((), jnp.int32)
        return LDLTFactors(A, jnp.asarray(True), z, z, idx)

    def col_step(j, carry):
        M, pi = carry
        d = jnp.diagonal(M)
        cand = jnp.where(idx >= j, jnp.abs(d), -jnp.inf)
        p = jnp.argmax(cand)
        swap = idx.at[j].set(p).at[p].set(jnp.asarray(j, idx.dtype))
        M = M[swap][:, swap]
        pi = pi[swap]

        dj = M[j, j]
        below = idx > j
        denom = jnp.where(dj == 0, 1.0, dj)
        l = jnp.where(below, M[:, j] / denom, 0.0)
        M = M - dj * l[:, None] * l[None, :]
        M = M.at[:, j].set(jnp.where(below, l, M[:, j]))
        M = M.at[j, j].set(dj)
        return M, pi

    # Tie the initial permutation to the input so its device-variance matches
    # the matrix under shard_map (a constant arange is "unvarying" and trips
    # the scan carry VMA check inside sharded computations).
    idx0 = idx + (A[0, 0] * 0).astype(idx.dtype)
    ld, perm = jax.lax.fori_loop(0, m, col_step, (A, idx0), unroll=unroll)

    d = jnp.diagonal(ld)
    finite = jnp.all(jnp.isfinite(ld))
    n_zero = jnp.sum(jnp.abs(d) <= atol).astype(jnp.int32)
    n_pos = jnp.sum(d > atol).astype(jnp.int32)
    ok = finite & (n_zero == 0)
    return LDLTFactors(ld=ld, ok=ok, n_pos=n_pos, n_zero=n_zero, perm=perm)


def _unit_lower(ld: Array) -> Array:
    m = ld.shape[-1]
    return jnp.tril(ld, -1) + jnp.eye(m, dtype=ld.dtype)


def ldlt_solve(factors: LDLTFactors, b: Array) -> Array:
    """Solve A X = b given P A P^T = L D L^T. b: [m] or [m, k]."""
    m = factors.ld.shape[-1]
    if m == 0:
        return b
    L = _unit_lower(factors.ld)
    d = jnp.diagonal(factors.ld)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if factors.perm is not None:
        b = b[factors.perm]
    y = jax.scipy.linalg.solve_triangular(L, b, lower=True, unit_diagonal=True)
    y = y / d[:, None]
    x = jax.scipy.linalg.solve_triangular(
        L.T, y, lower=False, unit_diagonal=True
    )
    if factors.perm is not None:
        x = jnp.zeros_like(x).at[factors.perm].set(x)
    return x[:, 0] if squeeze else x


def ldlt_solve_refined(
    factors: LDLTFactors, A: Array, b: Array, *, refine_steps: int = 1,
    check_residual: bool = False, residual_rtol: float = 1e-6,
):
    """Solve with iterative refinement: x += A_fact^{-1} (b - A x).

    The unpivoted factorization can lose accuracy when pivots are small
    relative to fill; one or two refinement sweeps with the exact residual
    restore it at negligible cost (A is tiny). With `check_residual`, also
    returns a bool certifying backward-stability of the final solution
    (||A x - b|| <= rtol * (||A|| ||x|| + ||b||)); False means the
    factorization broke down and the caller must regularize and retry.
    """
    x = ldlt_solve(factors, b)
    r = None
    for _ in range(max(refine_steps, 1 if check_residual else 0)):
        r = b - A @ x
        x = x + ldlt_solve(factors, r)
    if not check_residual:
        return x
    r = b - A @ x
    scale = (jnp.linalg.norm(A) * jnp.linalg.norm(x) + jnp.linalg.norm(b))
    ok = jnp.linalg.norm(r) <= residual_rtol * scale
    ok = ok & jnp.all(jnp.isfinite(x))
    return x, ok


def kkt_factor_and_inertia(K: Array, *, atol: float = 1e-12) -> LDLTFactors:
    """Factor a KKT matrix and report inertia.

    Equivalent information to the reference's `sytrf_rook!` + `inertia!`
    (reference: src/inertia_correction.jl:257-266): the caller checks
    n_pos == nu and nonsingularity, exactly like `np == num_controls` and
    `info == 0` there.
    """
    return ldlt_factor(K, atol=atol)


class EighFactors(NamedTuple):
    """Eigendecomposition-backed factorization: exact inertia, robust solve.

    Slower than LDL^T but pivot-free; used as the bit-reliable oracle path
    (options.inertia_method == "eigh") for tests and hard instances."""

    w: Array      # [m] eigenvalues
    v: Array      # [m, m] eigenvectors
    ok: Array
    n_pos: Array
    n_zero: Array


def eigh_factor_and_inertia(K: Array, *, atol: float = 1e-12) -> EighFactors:
    m = K.shape[-1]
    if m == 0:
        z = jnp.zeros((), jnp.int32)
        return EighFactors(jnp.zeros((0,), K.dtype), K,
                           jnp.asarray(True), z, z)
    w, v = jnp.linalg.eigh(K)
    n_pos = jnp.sum(w > atol).astype(jnp.int32)
    n_zero = jnp.sum(jnp.abs(w) <= atol).astype(jnp.int32)
    ok = jnp.all(jnp.isfinite(w)) & (n_zero == 0)
    return EighFactors(w=w, v=v, ok=ok, n_pos=n_pos, n_zero=n_zero)


def eigh_solve(factors: EighFactors, b: Array) -> Array:
    if factors.w.shape[-1] == 0:
        return b
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    w = jnp.where(factors.w == 0, 1.0, factors.w)
    x = factors.v @ ((factors.v.T @ b) / w[:, None])
    return x[:, 0] if squeeze else x
