"""Batched dense kernels (the framework's "native" numerical layer).

The reference reaches LAPACK through Julia's ``/``, ``\\``, ``qr`` on dynamically shaped
matrices (factorization.jl:33-40, blockmatrix.jl:139-142).  Here the same capabilities
are batched, fixed-shape XLA primitives (on the GPU: batched cuSOLVER/cuBLAS calls
and XLA's own fusions):

- :func:`lu_factor` / :func:`lu_solve` / :func:`lu_solve_right`: batched pivoted LU and
  the two-sided triangular solves behind ``D \\ B`` and ``B / D``,
- :func:`schur_complement`: the extend-add Schur update GEMM,
- :func:`permute_sym`: symmetric gather-permutation of a batch of Schur complements into
  ``[int_loc; bnd_loc]`` order (factorization.jl:39-41),
- :func:`scatter`: indexed set/add that stays native on the GPU for complex128.

Padding convention: pivot blocks carry an identity diagonal on padded rows/cols (set by
the planner) so LU, solves and Schur updates are exact on the real sub-blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def lu_factor(D: jax.Array):
    """Batched pivoted LU: returns (lu, perm) with ``D[..., perm, :] = L @ U``."""
    lu, _, perm = lax.linalg.lu(D)
    return lu, perm


def _take_rows(B: jax.Array, perm: jax.Array) -> jax.Array:
    return jnp.take_along_axis(B, perm[..., :, None], axis=-2)


def lu_solve(lu: jax.Array, perm: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``D X = B`` given (lu, perm) from :func:`lu_factor` (batched)."""
    Bp = _take_rows(B, perm)
    Y = lax.linalg.triangular_solve(lu, Bp, left_side=True, lower=True,
                                    unit_diagonal=True)
    return lax.linalg.triangular_solve(lu, Y, left_side=True, lower=False)


def lu_solve_right(lu: jax.Array, perm: jax.Array, B: jax.Array) -> jax.Array:
    """Solve ``X D = B`` given (lu, perm) from :func:`lu_factor` (batched).

    With ``P D = L U`` (rows ``perm``), ``X = ((B / U) / L) P``; the final column
    permutation is ``X[..., :, c] = Z[..., :, invperm[c]]``.
    """
    Z = lax.linalg.triangular_solve(lu, B, left_side=False, lower=False)
    Z = lax.linalg.triangular_solve(lu, Z, left_side=False, lower=True,
                                    unit_diagonal=True)
    inv = jnp.argsort(perm, axis=-1)
    return jnp.take_along_axis(Z, inv[..., None, :], axis=-1)


def lu_inverse(lu: jax.Array, perm: jax.Array) -> jax.Array:
    """Explicit ``D^{-1}`` from (lu, perm) (batched).  Solve sweeps then apply the
    pivot block as one GEMM instead of two triangular solves."""
    n = lu.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=lu.dtype), lu.shape)
    return lu_solve(lu, perm, eye)


def block_inverse(D: jax.Array, base: int = 64):
    """Explicit ``D^{-1}`` by recursive block-Schur inversion (batched).

    Replaces pivoted LU + triangular solves on the explicit-inverse path with
    the 2x2 block identity

        M = [[A, B], [C, D]],  S = D - C A^{-1} B,
        M^{-1} = [[A^{-1} + W XS T, -W XS], [-XS T, XS]],
        T = C A^{-1},  W = A^{-1} B,  XS = S^{-1}

    recursing to ``base``-sized diagonal blocks that use PIVOTED LU (partial
    pivoting confined to the diagonal blocks - the standard incomplete
    pivoting trade: fronts from the identity-padded planner layout are
    nonsingular, and the bench guard ``max_diag_ratio`` reports the base
    pivot-growth proxy).  Sequential depth falls from O(n) full-width steps to
    O(n/base) base factorizations plus O(log(n/base)) GEMM levels.

    Returns ``(inv, ratio)`` where ``ratio [batch]`` is the max base-block
    pivot diagonal ratio (the conditioning proxy of ``cond_report``)."""
    n = D.shape[-1]
    if n <= base:
        lu, perm = lu_factor(D)
        d = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
        ratio = jnp.max(d, -1) / jnp.maximum(jnp.min(d, -1),
                                             jnp.finfo(d.dtype).tiny)
        return lu_inverse(lu, perm), ratio
    h = ((n // 2) + 7) // 8 * 8
    A = D[..., :h, :h]
    B = D[..., :h, h:]
    C = D[..., h:, :h]
    E = D[..., h:, h:]
    X11, r1 = block_inverse(A, base)
    T = C @ X11
    S = E - T @ B
    XS, r2 = block_inverse(S, base)
    W = X11 @ B
    B12 = -(W @ XS)
    B11 = X11 - B12 @ T
    B21 = -(XS @ T)
    top = jnp.concatenate([B11, B12], axis=-1)
    bot = jnp.concatenate([B21, XS], axis=-1)
    return jnp.concatenate([top, bot], axis=-2), jnp.maximum(r1, r2)


def schur_complement(Abb: jax.Array, Abi: jax.Array, R: jax.Array) -> jax.Array:
    """``S = Abb - Abi @ R`` (batched GEMM; the multifrontal hot loop,
    factorization.jl:40 and :72)."""
    return Abb - Abi @ R


def scatter(x: jax.Array, idx, vals, op: str = "set", **kw) -> jax.Array:
    """``x.at[idx].set(vals, **kw)`` (or ``.add`` with ``op="add"``).

    XLA:GPU has no native scatter for elements wider than 64 bits: it rewrites a
    complex128 scatter into a serial loop over the updates.  Such scatters run
    here as two float64 scatters on the real and imaginary parts (exact: set
    and add act on each part alone)."""
    if x.dtype.itemsize <= 8:
        return getattr(x.at[idx], op)(vals, **kw)
    vals = jnp.asarray(vals, x.dtype)
    re = getattr(x.real.at[idx], op)(vals.real, **kw)
    im = getattr(x.imag.at[idx], op)(vals.imag, **kw)
    return lax.complex(re, im)


def permute_sym(S: jax.Array, perm: jax.Array) -> jax.Array:
    """Batched symmetric permutation ``S[perm][:, perm]`` (rows+cols gather)."""
    if S.shape[-1] == 0:
        return S
    S = jnp.take_along_axis(S, perm[..., :, None], axis=-2)
    return jnp.take_along_axis(S, perm[..., None, :], axis=-1)
