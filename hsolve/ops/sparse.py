"""Device-side sparse matvec: ELL (padded-row) and DIA (diagonal-offset) formats.

The reference applies the sparse matrix only inside GMRES (``test/rungmres.jl:47-48``,
via IterativeSolvers) and for sub-block extraction (handled at plan time, see
hsolve.planner).  For the device matvec:

- ELLPACK: rows padded to the max nonzeros-per-row, which turns SpMV into a gather
  plus a small reduction - fully static shapes, trivially shardable by rows.  The
  general-purpose path.
- DIA: for stencil/FEM matrices with few populated diagonals (every generated
  Poisson/Helmholtz problem), SpMV becomes a handful of shifted multiply-adds with
  **no gathers at all**, exactly reproducible in f64.  :func:`spmv_format` picks the
  format automatically.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


class EllMatrix(NamedTuple):
    indices: jax.Array   # [N, w] column ids, sentinel N on padding
    values: jax.Array    # [N, w] matching values, 0 on padding
    shape: tuple


def to_ell(A: sp.spmatrix, dtype=None) -> EllMatrix:
    A = sp.csr_matrix(A)
    N = A.shape[0]
    counts = np.diff(A.indptr)
    w = max(int(counts.max()), 1)
    idx = np.full((N, w), N, dtype=np.int32)
    val = np.zeros((N, w), dtype=A.dtype if dtype is None else dtype)
    for i in range(N):
        lo, hi = A.indptr[i], A.indptr[i + 1]
        idx[i, : hi - lo] = A.indices[lo:hi]
        val[i, : hi - lo] = A.data[lo:hi]
    return EllMatrix(jnp.asarray(idx), jnp.asarray(val), A.shape)


def ell_matvec(A: EllMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for x of shape [N] or [N, k] (padded gather + row reduction)."""
    pad_shape = (1,) + x.shape[1:]
    xp = jnp.concatenate([x, jnp.zeros(pad_shape, dtype=x.dtype)], axis=0)
    gathered = xp[A.indices]                      # [N, w, ...]
    if x.ndim == 1:
        return jnp.sum(A.values * gathered, axis=1)
    return jnp.sum(A.values[..., None] * gathered, axis=1)


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal-offset storage: ``values[k, i] = A[i, i + offsets[k]]`` (0 outside).

    ``offsets`` are static (compile-time) so the matvec lowers to shifted
    multiply-adds with no gather/scatter.
    """

    values: jax.Array          # [ndiag, N]
    offsets: Tuple[int, ...]   # static
    shape: Tuple[int, int]     # static


jax.tree_util.register_dataclass(DiaMatrix, data_fields=["values"],
                                 meta_fields=["offsets", "shape"])


def to_dia(A: sp.spmatrix, dtype=None, max_diags: int = 64):
    """Convert to DIA storage; returns None if A populates more than ``max_diags``
    diagonals (fall back to :func:`to_ell` then)."""
    A = sp.csr_matrix(A)
    N = A.shape[0]
    if A.shape[0] != A.shape[1]:
        return None
    coo = A.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    if len(offs) > max_diags or len(offs) == 0:
        # an all-zero matrix has no populated diagonals; dia_matvec's offset
        # reduction would be ill-defined - let the ELL path handle it
        return None
    vals = np.zeros((len(offs), N), dtype=A.dtype if dtype is None else dtype)
    for k, d in enumerate(offs):
        diag = A.diagonal(int(d))
        if d >= 0:
            vals[k, : N - d] = diag
        else:
            vals[k, -d:] = diag
    return DiaMatrix(values=jnp.asarray(vals),
                     offsets=tuple(int(d) for d in offs), shape=A.shape)


def dia_matvec(A: DiaMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x for x of shape [N] or [N, k]: per-diagonal shifted multiply-adds
    (static slices of a zero-padded buffer - no gathers)."""
    N = A.shape[0]
    M = max(max(abs(d) for d in A.offsets), 1)
    vec = x.ndim == 1
    xc = x[:, None] if vec else x
    k = xc.shape[1]
    xp = jnp.pad(xc, ((M, M), (0, 0)))
    acc = jnp.zeros((N, k), dtype=x.dtype)
    for j, d in enumerate(A.offsets):
        seg = jax.lax.dynamic_slice(xp, (M + d, 0), (N, k))
        acc = acc + A.values[j].astype(x.dtype)[:, None] * seg
    return acc[:, 0] if vec else acc


def spmv(op, x: jax.Array) -> jax.Array:
    """y = A @ x for an operator from :func:`spmv_format` (DIA or ELL); the
    ``mv`` of :func:`hsolve.gmres_compiled` with the operator as ``mv_data``."""
    return dia_matvec(op, x) if isinstance(op, DiaMatrix) else ell_matvec(op, x)


def spmv_format(A: sp.spmatrix, dtype=None, max_diags: int = 64):
    """Pick the device SpMV format for A: (operator_data, matvec_fn).

    DIA when A is few-diagonal (all generated stencil problems), else ELL."""
    dia = to_dia(A, dtype=dtype, max_diags=max_diags)
    if dia is not None:
        return dia, dia_matvec
    return to_ell(A, dtype=dtype), ell_matvec
