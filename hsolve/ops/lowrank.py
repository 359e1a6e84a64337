"""Batched low-rank factorization kernels.

Batched replacement for the reference's LowRankApprox.jl surface (SURVEY.md section 2
external-API table): ``pqrfact`` (column-pivoted rank-revealing QR, used at
factorization.jl:172-209) and ``LowRankMatrix`` algebra.  Two factorizers:

- :func:`rand_lowrank`: randomized range finder + small SVD (sampling GEMM,
  tall-skinny QR, tiny SVD); the workhorse for Gauss-transform compression,
- :func:`cpqr`: batched column-pivoted QR *without Q accumulation* - returns the
  pivots/interpolation needed for interpolative decompositions (the row/column
  selection at the heart of the randomized HSS construction).

Static-shape convention: every factor is padded to a static rank cap; the true
numerical rank is returned per batch element and columns at/after it are zeroed, so
``U @ V^T`` is exact regardless of padding.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LowRank(NamedTuple):
    """Batched low-rank factor pair: ``A ~= U @ V^T`` (V stored untransposed)."""

    U: jax.Array     # [..., m, k_cap]
    V: jax.Array     # [..., n, k_cap]
    rank: jax.Array  # [...] actual numerical ranks

    @property
    def k_cap(self) -> int:
        return self.U.shape[-1]

    def matmul(self, X: jax.Array) -> jax.Array:
        return self.U @ (jnp.swapaxes(self.V, -1, -2) @ X)

    def rmatmul(self, X: jax.Array) -> jax.Array:
        """X @ (U V^T)"""
        return (X @ self.U) @ jnp.swapaxes(self.V, -1, -2)

    def todense(self) -> jax.Array:
        return self.U @ jnp.swapaxes(self.V, -1, -2)


def _rank_mask(s: jax.Array, atol: float, rtol: float, cap: int):
    """Rank from singular values: keep sigma_i > max(atol, rtol*sigma_0), capped."""
    s0 = s[..., :1]
    keep = s > jnp.maximum(atol, rtol * s0)
    rank = jnp.minimum(jnp.sum(keep, axis=-1), cap)
    mask = (jnp.arange(s.shape[-1]) < rank[..., None]).astype(s.dtype)
    return rank, mask


@partial(jax.jit, static_argnames=("cap", "oversample"))
def rand_lowrank(A: jax.Array, key: jax.Array, atol: float, rtol: float,
                 cap: int, oversample: int = 8) -> LowRank:
    """Randomized tolerance-truncated low-rank factorization of batched dense A.

    Capability parity with ``pqrfact(...; sketch=:randn, atol, rtol)``
    (factorization.jl:189,202) with a static rank cap: Y = A*Omega; Q = qr(Y);
    svd(Q^T A); truncate at max(atol, rtol*s1).
    """
    m, n = A.shape[-2], A.shape[-1]
    s = min(cap + oversample, n)
    omega = jax.random.normal(key, (n, s), dtype=jnp.real(A).dtype).astype(A.dtype)
    Y = A @ omega                                   # [..., m, s]
    Q, _ = jnp.linalg.qr(Y)                         # reduced: [..., m, s]
    W = jnp.swapaxes(Q, -1, -2).conj() @ A          # [..., s, n]
    Uw, sv, Vh = jnp.linalg.svd(W, full_matrices=False)
    rank, mask = _rank_mask(sv, atol, rtol, cap)
    k = min(cap, s)
    U = (Q @ Uw)[..., :, :k] * (sv[..., None, :k] * mask[..., None, :k])
    # plain-transpose convention: A ~= U @ V^T (so V = Vh^T, NOT conjugated)
    V = jnp.swapaxes(Vh, -1, -2)[..., :, :k] * mask[..., None, :k]
    if k < cap:  # pad factors out to the static cap
        pad = [(0, 0)] * (U.ndim - 1) + [(0, cap - k)]
        U = jnp.pad(U, pad)
        V = jnp.pad(V, pad)
    return LowRank(U=U, V=V, rank=rank)


class CPQR(NamedTuple):
    R: jax.Array     # [..., k_cap, n] upper-trapezoidal factor (pivoted order)
    piv: jax.Array   # [..., k_cap] selected column indices of A
    rank: jax.Array  # [...] numerical rank vs tolerance


@partial(jax.jit, static_argnames=("cap",))
def cpqr(A: jax.Array, atol: float, rtol: float, cap: int) -> CPQR:
    """Batched column-pivoted QR (R and pivots only; Q is never formed).

    Classic Businger-Golub with per-step column-norm downdating, as a fixed-length
    ``fori_loop`` over the static rank cap with masking past the numerical rank.
    Capability parity with ``pqrfact(...; sketch=:none)`` (factorization.jl:172-179)
    and the pivot selection used for interpolative decompositions in the HSS build.
    """
    *batch, m, n = A.shape
    k = min(cap, m, n)
    dtype = A.dtype
    rdtype = jnp.real(A).dtype

    norms2 = jnp.sum(jnp.abs(A) ** 2, axis=-2)          # [..., n]
    norms0 = jnp.sqrt(jnp.max(norms2, axis=-1))         # [...] for rtol reference
    piv = jnp.zeros((*batch, k), dtype=jnp.int32)
    rank = jnp.zeros((*batch,), dtype=jnp.int32)
    col_ids = jnp.arange(n)

    def body(j, carry):
        A, norms2, piv, rank, active = carry
        p = jnp.argmax(norms2, axis=-1)                 # [...] pivot column
        a = jnp.take_along_axis(A, p[..., None, None], axis=-1)[..., 0]  # [..., m]
        # downdated norms2 is only a selection heuristic (it bottoms out at
        # sqrt(eps)*scale from cancellation); the tolerance test uses the exact norm
        nrm = jnp.sqrt(jnp.maximum(jnp.sum(jnp.abs(a) ** 2, -1), 1e-300))
        ok = active & (nrm > jnp.maximum(atol, rtol * norms0))
        piv = piv.at[..., j].set(jnp.where(ok, p, -1).astype(jnp.int32))
        rank = rank + ok.astype(jnp.int32)

        q = a / nrm[..., None]
        q = jnp.where(ok[..., None], q, 0.0)
        # eliminate the pivot direction from every remaining column
        coef = jnp.einsum("...m,...mn->...n", q.conj(), A)               # [..., n]
        A = A - q[..., :, None] * coef[..., None, :]
        norms2 = jnp.maximum(norms2 - jnp.abs(coef) ** 2, 0.0)
        # never re-select a chosen pivot
        norms2 = jnp.where(col_ids == p[..., None], -jnp.inf, norms2)
        return A, norms2, piv, rank, ok

    A0 = A.astype(dtype)
    active0 = jnp.ones((*batch,), dtype=bool)
    _, _, piv, rank, _ = lax.fori_loop(
        0, k, body, (A0, norms2.astype(rdtype), piv, rank, active0))

    # recover R = Q^* A at the selected pivots by re-projecting: cheaper and more
    # stable to re-run a plain QR on the selected columns
    pos = jnp.maximum(piv, 0)
    Asel = jnp.take_along_axis(A, pos[..., None, :], axis=-1)            # [..., m, k]
    mask = (jnp.arange(k) < rank[..., None]).astype(dtype)
    Asel = Asel * mask[..., None, :]
    Q, _ = jnp.linalg.qr(Asel)
    R = jnp.swapaxes(Q, -1, -2).conj() @ A                               # [..., k, n]
    R = R * mask[..., :, None]
    if k < cap:
        R = jnp.pad(R, [(0, 0)] * (R.ndim - 2) + [(0, cap - k), (0, 0)])
        piv = jnp.pad(piv, [(0, 0)] * (piv.ndim - 1) + [(0, cap - k)],
                      constant_values=-1)
    return CPQR(R=R, piv=piv, rank=rank)


@partial(jax.jit, static_argnames=("cap",))
def interp_decomp(A: jax.Array, atol: float, rtol: float, cap: int):
    """Row interpolative decomposition: select rows J and T with ``A ~= T @ A[J, :]``.

    Built on :func:`cpqr` of A^T (column selection there = row selection here).
    Returns (J [..., cap] selected row ids, T [..., m, cap] interpolation, rank).
    Rows of T past the rank are zero; J is -1-padded.
    """
    f = cpqr(jnp.swapaxes(A, -1, -2).conj(), atol, rtol, cap)
    # A^T ~= Q R with pivots J: columns of A^T (= rows of A) selected.
    # T^T solves R[:, J] T^T = R  =>  T = (R11^{-1} R)^T restricted
    k = f.R.shape[-2]
    pos = jnp.maximum(f.piv, 0)
    R11 = jnp.take_along_axis(f.R, pos[..., None, :], axis=-1)           # [..., k, k]
    mask = (jnp.arange(k) < f.rank[..., None]).astype(A.dtype)
    # identity on the masked-out part of R11 keeps the triangular solve well-posed
    eye = jnp.eye(k, dtype=A.dtype)
    R11g = R11 * mask[..., None, :] + eye * (1.0 - mask[..., None, :])
    Tt = jax.scipy.linalg.solve_triangular(R11g, f.R, lower=False)       # [..., k, m]
    T = jnp.swapaxes(Tt, -1, -2).conj() * mask[..., None, :]
    return jnp.where(f.piv >= 0, pos, -1), T, f.rank


def lowrank_recompress(lr: LowRank, atol: float, rtol: float, cap: int) -> LowRank:
    """Re-orthogonalize and re-truncate a (possibly stacked) low-rank pair
    (capability of the reference's ``_recompress!``, factorization.jl:251-259)."""
    Qu, Ru = jnp.linalg.qr(lr.U)
    Qv, Rv = jnp.linalg.qr(lr.V)
    core = Ru @ jnp.swapaxes(Rv, -1, -2)
    Uc, sv, Vh = jnp.linalg.svd(core, full_matrices=False)
    rank, mask = _rank_mask(sv, atol, rtol, cap)
    k = min(cap, core.shape[-1])
    U = (Qu @ Uc)[..., :, :k] * (sv[..., None, :k] * mask[..., None, :k])
    # A ~= U V^T (plain transpose): core = Uc s Vh, V = Qv Vh^T
    V = (Qv @ jnp.swapaxes(Vh, -1, -2))[..., :, :k] * mask[..., None, :k]
    if k < cap:
        pad = [(0, 0)] * (U.ndim - 1) + [(0, cap - k)]
        U = jnp.pad(U, pad)
        V = jnp.pad(V, pad)
    return LowRank(U=U, V=V, rank=rank)
