"""Numeric factorization: level-synchronous batched multifrontal elimination.

Batched re-design of the reference's recursive ``factor`` (factorization.jl:5-27):
the planner's schedule is executed bottom-up, one *batched* fixed-shape kernel per
height level.  Each level performs, for all fronts at once:

1. extend-add assembly: the padded front buffers are built on device from the
   planner's COO data and the children Schur complements are folded in by masked
   gathers (factorization.jl:115-123 semantics, no device scatters),
2. batched pivoted LU of the pivot block ``D`` (the reference's dense ``D`` /
   ``blockfactor``, factorization.jl:33, blockmatrix.jl:115-120),
3. Gauss transforms ``L = Abi D^-1`` and ``R = D^-1 Aib`` via batched triangular solves
   (factorization.jl:36-37, :70-71),
4. Schur complement ``S = Abb - Abi R`` (GEMM) permuted to ``[int_loc; bnd_loc]`` order
   for the parent (factorization.jl:40, :72-74).

The result mirrors the reference's ``FactorNode`` tree (factornode.jl:7-35) as a flat
list of per-level array stacks (a pytree - checkpointable and shardable).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from hsolve.options import SolverOptions
from hsolve.ops import dense as dk
from hsolve.planner import BatchPlan, Plan, plan_factorization
from hsolve.utils.trees import NDTree


@dataclasses.dataclass
class DenseLevel:
    """Factor data for one height level (all fronts batched)."""

    lu: Optional[jax.Array]    # [B, ni_pad, ni_pad] pivot-block LU (None on the
                               # fast block-inverse path)
    perm: Optional[jax.Array]  # [B, ni_pad] LU row permutation
    L: jax.Array         # [B, nb_pad, ni_pad] left Gauss transform
    R: jax.Array         # [B, ni_pad, nb_pad] right Gauss transform
    int_ids: jax.Array   # [B, ni_pad] gather/scatter map, sentinel N
    bnd_ids: jax.Array   # [B, nb_pad] gather/scatter map, sentinel N
    dinv: Optional[jax.Array] = None  # [B, ni_pad, ni_pad] explicit D^{-1}
                                      # (opts.explicit_inverse: GEMM solve sweeps)
    diag_ratio: Optional[jax.Array] = None  # [B] base pivot-growth proxy
                                            # (block_inverse path)


@dataclasses.dataclass
class RootSolve:
    lu: Optional[jax.Array]    # [nbr, nbr]
    perm: Optional[jax.Array]  # [nbr]
    bnd_ids: jax.Array   # [nbr] sentinel-padded
    inv: Optional[jax.Array] = None   # [nbr, nbr] explicit inverse
    diag_ratio: Optional[jax.Array] = None


@dataclasses.dataclass
class CompressedLevel:
    """Factor data for a compressed height level: the Gauss transforms are stored in
    tolerance-truncated low-rank form (parity with ``_lgauss_transform`` /
    ``_rgauss_transform``, factorization.jl:171-209)."""

    lu: Optional[jax.Array]    # [B, ni_pad, ni_pad]
    perm: Optional[jax.Array]  # [B, ni_pad]
    LU_: jax.Array       # L ~= LU_ @ LV_^T : [B, nb_pad, k]
    LV_: jax.Array       # [B, ni_pad, k]
    RU_: jax.Array       # R ~= RU_ @ RV_^T : [B, ni_pad, k]
    RV_: jax.Array       # [B, nb_pad, k]
    lrank: jax.Array     # [B]
    rrank: jax.Array     # [B]
    int_ids: jax.Array
    bnd_ids: jax.Array
    dinv: Optional[jax.Array] = None
    diag_ratio: Optional[jax.Array] = None


for _cls, _fields in ((DenseLevel, ["lu", "perm", "L", "R", "int_ids", "bnd_ids",
                                    "dinv", "diag_ratio"]),
                      (RootSolve, ["lu", "perm", "bnd_ids", "inv", "diag_ratio"]),
                      (CompressedLevel, ["lu", "perm", "LU_", "LV_", "RU_", "RV_",
                                         "lrank", "rrank", "int_ids", "bnd_ids",
                                         "dinv", "diag_ratio"])):
    jax.tree_util.register_dataclass(_cls, data_fields=_fields, meta_fields=[])


def _precision_ctx(opts: SolverOptions):
    """Matmul-precision + verbose-logging scope for one driver call: with
    ``opts.verbose`` the hsolve logger is lifted to INFO for the duration (the
    reference's progress prints gate the same way, factorization.jl:17,22), so
    per-batch schedule lines and HSS-densify fallbacks actually appear."""
    import contextlib

    from hsolve.utils.logging import verbose_level

    stack = contextlib.ExitStack()
    if opts.matmul_precision:
        stack.enter_context(jax.default_matmul_precision(opts.matmul_precision))
    stack.enter_context(verbose_level(opts.verbose))
    return stack


@dataclasses.dataclass
class Factorization:
    """The assembled preconditioner / direct solver (reference ``FactorNode`` analog).

    ``solve`` applies the inverse in the original DOF ordering; ``apply_permuted``
    works in the planner's post-order permutation (what GMRES-on-A_perm uses).
    Both paths run as a single jitted program over the per-level array stacks.
    """

    N: int
    perm: np.ndarray
    levels: List[DenseLevel]
    root: Optional[RootSolve]
    opts: SolverOptions
    plan: Plan

    def __post_init__(self):
        self._dperm = jnp.asarray(self.perm, dtype=jnp.int32)
        inv = np.empty(len(self.perm), dtype=np.int32)
        inv[self.perm] = np.arange(len(self.perm), dtype=np.int32)
        self._diperm = jnp.asarray(inv)  # un-permute by gather, never by scatter

    def apply_permuted(self, b) -> jax.Array:
        with _precision_ctx(self.opts):
            return _apply_jit(self.levels, self.root, jnp.asarray(b))

    def solve(self, b) -> jax.Array:
        """x = F^{-1} b in the original ordering (parity with ``ldiv!``,
        factornode.jl:62-74)."""
        with _precision_ctx(self.opts):
            return _solve_jit(self.levels, self.root, self._dperm, self._diperm,
                              jnp.asarray(b))

    ldiv = solve

    def maxrank(self) -> int:
        """Max compression rank across the factorization (parity with ``maxrank``,
        factornode.jl:49-57); 0 on the dense path.  Structured levels report the
        *computed* interpolation rank (capped at the planned cap), not the static
        factor width.  Performs a (small) device->host fetch."""
        r = 0
        for lev in self.levels:
            if isinstance(lev, CompressedLevel):
                r = max(r, int(jnp.max(lev.lrank)), int(jnp.max(lev.rrank)))
            elif type(lev).__name__ == "StructuredLevel":
                if lev.rank_maxed is not None:
                    r = max(r, min(int(jnp.max(lev.rank_maxed)), lev.rank_cap))
                else:
                    r = max(r, lev.LU_.shape[-1])
        return r

    def rank_report(self) -> dict:
        """Per-level compression-rank diagnostics: planned cap, computed max rank, and
        whether any node *saturated* its cap (the randomized compression may then have
        silently truncated - the condition ``randcompress_adaptive`` grows its sample
        budget on, factorization.jl:110).  Performs a small device->host fetch."""
        out = {"levels": [], "saturated": False}
        for i, lev in enumerate(self.levels):
            if isinstance(lev, CompressedLevel):
                mr = max(int(jnp.max(lev.lrank)), int(jnp.max(lev.rrank)))
                cap = lev.LU_.shape[-1]
            elif type(lev).__name__ == "StructuredLevel" \
                    and lev.rank_maxed is not None:
                mr = int(jnp.max(lev.rank_maxed))
                cap = lev.rank_cap
            else:
                continue
            sat = mr >= cap
            out["levels"].append({"level": i, "max_rank": mr, "cap": cap,
                                  "saturated": sat})
            out["saturated"] = out["saturated"] or sat
        return out

    def cond_report(self) -> dict:
        """Pivot-block conditioning diagnostics for the explicit-inverse mode.

        ``opts.explicit_inverse`` applies ``D^{-1}`` as one GEMM; its forward
        error grows like ``cond(D) * eps`` per level, while triangular solves
        stay backward stable.  ``diag_ratio`` — ``max_i |U_ii| / min_i |U_ii|``
        of each level's pivot LU — is the standard cheap proxy bounding the
        pivot growth (planner-padded rows carry unit diagonals, which can only
        widen the ratio, so the estimate is conservative).  ``risky`` flags
        levels whose ratio comes within 100x of ``1/eps`` of the factorization
        dtype: there an explicit inverse may start costing GMRES iterations —
        re-factor with ``explicit_inverse=False``.  One device->host fetch.
        """
        ratios, tags = self._cond_device()
        vals = np.asarray(jax.device_get(jnp.stack(ratios))) if ratios else []
        out = {"levels": [], "max_ratio": 0.0, "risky": False,
               "explicit_inverse": bool(self.opts.explicit_inverse)}
        for (tag, eps), v in zip(tags, vals):
            risky = bool(v > 0.01 / eps)
            out["levels"].append({"level": tag, "diag_ratio": float(v),
                                  "risky": risky})
            out["max_ratio"] = max(out["max_ratio"], float(v))
            out["risky"] = out["risky"] or risky
        return out

    def _cond_device(self):
        """Per-level pivot diag ratios as DEVICE scalars + (tag, eps) labels -
        the fetch-free core of :meth:`cond_report`."""
        ratios, tags = [], []
        for i, lev in enumerate(self.levels):
            lu = getattr(lev, "lu", None)
            if lu is not None and lu.shape[-1] > 0:
                d = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
                ratios.append(jnp.max(jnp.max(d, -1) / jnp.min(d, -1)))
                tags.append((i, jnp.finfo(lu.dtype).eps))
            elif getattr(lev, "diag_ratio", None) is not None:
                ratios.append(jnp.max(lev.diag_ratio))
                tags.append((i, jnp.finfo(lev.dinv.dtype).eps))
        if self.root is not None:
            if getattr(self.root, "lu", None) is not None:
                d = jnp.abs(jnp.diagonal(self.root.lu))
                ratios.append(jnp.max(d) / jnp.min(d))
                tags.append(("root", jnp.finfo(self.root.lu.dtype).eps))
            elif getattr(self.root, "diag_ratio", None) is not None:
                ratios.append(jnp.max(self.root.diag_ratio))
                tags.append(("root", jnp.finfo(self.root.inv.dtype).eps))
        return ratios, tags

    def max_diag_ratio_device(self):
        """(device scalar max pivot-diag ratio, risky threshold) - see
        :meth:`cond_report`; no host fetch.  Dispatched as ONE jitted program
        instead of an eager per-level diagonal/max chain of ~40 tiny
        dispatches."""
        # threshold from shapes/dtypes only - no eager device ops here
        epss = []
        for lev in self.levels:
            lu = getattr(lev, "lu", None)
            if lu is not None and lu.shape[-1] > 0:
                epss.append(jnp.finfo(lu.dtype).eps)
            elif getattr(lev, "diag_ratio", None) is not None:
                epss.append(jnp.finfo(lev.dinv.dtype).eps)
        if self.root is not None:
            if getattr(self.root, "lu", None) is not None:
                epss.append(jnp.finfo(self.root.lu.dtype).eps)
            elif getattr(self.root, "diag_ratio", None) is not None:
                epss.append(jnp.finfo(self.root.inv.dtype).eps)
        if not epss:
            return jnp.zeros(()), float("inf")
        thresh = min(0.01 / e for e in epss)
        return _max_diag_ratio_jit(self.levels, self.root), float(thresh)

    @property
    def solve_data(self):
        """Pytree of everything ``solve`` needs - pass as jit operands (with
        :func:`solve_with_data`) so re-factorizations reuse compiled programs."""
        return (self.levels, self.root, self._dperm, self._diperm)


@jax.jit
def _max_diag_ratio_jit(levels, root):
    ratios = []
    for lev in levels:
        lu = getattr(lev, "lu", None)
        if lu is not None and lu.shape[-1] > 0:
            d = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
            ratios.append(jnp.max(jnp.max(d, -1) / jnp.min(d, -1)))
        elif getattr(lev, "diag_ratio", None) is not None:
            ratios.append(jnp.max(lev.diag_ratio))
    if root is not None:
        if getattr(root, "lu", None) is not None:
            d = jnp.abs(jnp.diagonal(root.lu))
            ratios.append(jnp.max(d) / jnp.min(d))
        elif getattr(root, "diag_ratio", None) is not None:
            ratios.append(jnp.max(root.diag_ratio))
    return jnp.max(jnp.stack(ratios)) if ratios else jnp.zeros(())


def solve_with_data(data, b):
    """x = F^{-1} b from a :attr:`Factorization.solve_data` pytree (stable jit key)."""
    levels, root, dperm, diperm = data
    bp = b[dperm] if b.ndim == 1 else b[dperm, :]
    xp = _apply_impl(levels, root, bp)
    return xp[diperm] if xp.ndim == 1 else xp[diperm, :]


def precondition_with_data(data, v):
    """Right preconditioner for :func:`hsolve.gmres_compiled` (its ``M``, with
    :attr:`Factorization.solve_data` as ``M_data``): the factorization's solve
    applied in the factorization's own dtype, cast back to ``v``'s, so an f32
    factor serves f64 Krylov vectors."""
    # the dtype is static under tracing: that of the factor arrays themselves
    fdtype = next(x.dtype for x in jax.tree_util.tree_leaves(data[:2])
                  if jnp.issubdtype(x.dtype, jnp.inexact))
    return solve_with_data(data, v.astype(fdtype)).astype(v.dtype)


# ---------------------------------------------------------------------------
# per-level kernels
# ---------------------------------------------------------------------------

def _factor_front_impl(front: jax.Array, sperm: jax.Array, ni_pad: int,
                       explicit_inv: bool = False, fast_inverse: bool = False):
    D = front[:, :ni_pad, :ni_pad]
    Aib = front[:, :ni_pad, ni_pad:]
    Abi = front[:, ni_pad:, :ni_pad]
    Abb = front[:, ni_pad:, ni_pad:]
    if fast_inverse and explicit_inv:
        # recursive block-Schur inverse: O(n/base) sequential base LUs +
        # O(log) GEMM levels instead of the O(n)-step LU/TRSM loops that made
        # the numeric phase launch-latency-bound (ops/dense.block_inverse)
        dinv, ratio = dk.block_inverse(D)
        R = dinv @ Aib
        L = Abi @ dinv
        S = dk.permute_sym(dk.schur_complement(Abb, Abi, R), sperm)
        return None, None, L, R, S, dinv, ratio
    lu, perm = dk.lu_factor(D)
    R = dk.lu_solve(lu, perm, Aib)
    L = dk.lu_solve_right(lu, perm, Abi)
    S = dk.permute_sym(dk.schur_complement(Abb, Abi, R), sperm)
    if explicit_inv:
        # the solve sweeps use only dinv: dropping lu/perm from the level
        # record halves persistent pivot-block memory (3D 64^3 solve-program
        # compile exceeded HBM by ~1.1G keeping both); the conditioning guard
        # keeps the pivot diag ratio instead
        dinv = dk.lu_inverse(lu, perm)
        d = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
        ratio = jnp.max(d, -1) / jnp.maximum(jnp.min(d, -1),
                                             jnp.finfo(d.dtype).tiny)
        return None, None, L, R, S, dinv, ratio
    return lu, perm, L, R, S, None, None


_factor_front = partial(jax.jit, static_argnames=(
    "ni_pad", "explicit_inv", "fast_inverse"))(_factor_front_impl)


def _factor_front_compressed_impl(front: jax.Array, sperm: jax.Array, key,
                                  ni_pad: int, cap: int, atol: float, rtol: float,
                                  c_tol: float, explicit_inv: bool = False,
                                  fast_inverse: bool = False):
    """Compressed branch kernel (parity with ``_factor_branch`` Val{true},
    factorization.jl:78-112, with the Schur update using the compressed transforms as
    in ``_schur_complement``, :228-235):

    - Gauss transforms from randomized tolerance-truncated factorization of the
      off-diagonal front blocks at ``c_tol * tol`` (the reference hard-codes 0.5,
      factorization.jl:99-100; we honor the declared ``c_tol`` option),
    - ``L = (U_bi) (D^-T V_bi)^T``, ``R = (D^-1 U_ib) V_ib^T`` - the D-solve touches
      only k columns instead of the full boundary,
    - ``S = Abb - (Abi R.U) R.V^T`` (exact Abi, compressed R - matching the
      reference's sampling operator).
    """
    from hsolve.ops.lowrank import rand_lowrank

    D = front[:, :ni_pad, :ni_pad]
    Aib = front[:, :ni_pad, ni_pad:]
    Abi = front[:, ni_pad:, :ni_pad]
    Abb = front[:, ni_pad:, ni_pad:]

    k1, k2 = jax.random.split(key)
    lr_bi = rand_lowrank(Abi, k1, c_tol * atol, c_tol * rtol, cap)
    lr_ib = rand_lowrank(Aib, k2, c_tol * atol, c_tol * rtol, cap)

    if fast_inverse and explicit_inv:
        dinv, ratio = dk.block_inverse(D)
        lu = perm = None
        LV = jnp.swapaxes(dinv, -1, -2) @ lr_bi.V  # D^{-T} V: [B, ni_pad, k]
        RU = dinv @ lr_ib.U
    else:
        lu, perm = dk.lu_factor(D)
        ratio = None
        LV = jnp.swapaxes(
            dk.lu_solve_right(lu, perm, jnp.swapaxes(lr_bi.V, -1, -2)),
            -1, -2)                               # D^{-T}-folded: [B, ni_pad, k]
        RU = dk.lu_solve(lu, perm, lr_ib.U)       # [B, ni_pad, k]
        dinv = None
        if explicit_inv:
            dinv = dk.lu_inverse(lu, perm)
            d = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
            ratio = jnp.max(d, -1) / jnp.maximum(jnp.min(d, -1),
                                                 jnp.finfo(d.dtype).tiny)
            lu = perm = None          # see _factor_front_impl memory note

    S = Abb - (Abi @ RU) @ jnp.swapaxes(lr_ib.V, -1, -2)
    S = dk.permute_sym(S, sperm)
    return (lu, perm, lr_bi.U, LV, RU, lr_ib.V, lr_bi.rank, lr_ib.rank, S,
            dinv, ratio)


_factor_front_compressed = partial(
    jax.jit, static_argnames=("ni_pad", "cap", "atol", "rtol", "c_tol",
                              "explicit_inv",
                              "fast_inverse"))(_factor_front_compressed_impl)


def _extend_add_impl(front: jax.Array, stage: jax.Array, imap: jax.Array) -> jax.Array:
    """Gather-based extend-add: ``front[b,i,j] += stage[b, imap[b,i], imap[b,j]]``
    where imap < 0 marks front positions with no contribution from this child.

    Formulated as a gather (each front entry reads at most one child entry), so
    assembly needs no scatter-add; the child-index map is the inverse of the
    offset-identity placement the ``[int_loc; bnd_loc]`` storage discipline
    guarantees (factorization.jl:115-123)."""
    valid = imap >= 0
    idx = jnp.maximum(imap, 0)
    gathered = jnp.take_along_axis(
        jnp.take_along_axis(stage, idx[:, :, None], axis=1),
        idx[:, None, :], axis=2)
    mask = (valid[:, :, None] & valid[:, None, :]).astype(front.dtype)
    return front + gathered * mask


_extend_add = jax.jit(_extend_add_impl)


def build_front_vals(bp: BatchPlan, vals: Optional[jax.Array],
                     pos: Optional[jax.Array]) -> jax.Array:
    """Scatter a batch's COO data into its padded front buffer (traceable)."""
    B, m = bp.B, bp.m_pad
    flat = jnp.zeros((B * m * m,), dtype=vals.dtype)
    if pos is not None and pos.shape[0]:
        flat = dk.scatter(flat, pos, vals, unique_indices=True,
                          mode="promise_in_bounds")
    return flat.reshape(B, m, m)


def build_front(bp: BatchPlan, dtype) -> jax.Array:
    """Materialize a batch's front buffers on device from the planner's COO data.

    Only the nonzeros (plus identity padding) cross the host->device link - the
    dense [B, m_pad, m_pad] workspace never leaves the device (host->device
    bandwidth is the setup bottleneck at scale)."""
    if not len(bp.front_pos):
        return jnp.zeros((bp.B, bp.m_pad, bp.m_pad), dtype=dtype)
    return build_front_vals(bp, jnp.asarray(bp.front_vals, dtype=dtype),
                            jnp.asarray(bp.front_pos))


def _stage_children(groups, s_stacks, B: int, s_pad: int, dtype) -> jax.Array:
    """Gather the children Schur complements (possibly from several earlier levels)
    into one [B, s_pad, s_pad] staging buffer.  HSS children are densified (fallback
    for parents outside the structured path)."""
    from hsolve.structured import SchurHss, densify_schur
    from hsolve.utils.logging import logger

    stage = jnp.zeros((B, s_pad, s_pad), dtype=dtype)
    for g in groups:
        src = s_stacks[g.src_batch]
        if isinstance(src, SchurHss):
            # planned fallback: the planner only emits HSS where some consumer is
            # structured; remaining HSS-fed dense parents (odd nodes whose sibling
            # is structured-consumed, the root batch) densify here by design
            logger.info(
                "densifying %d HSS child Schur complement(s) from batch %d "
                "(size %d) for a dense-assembly parent",
                len(g.src_rows), g.src_batch, s_pad)
            sel = jax.tree_util.tree_map(lambda a: a[g.src_rows], src)
            dense = densify_schur(sel, s_pad)
            stage = dk.scatter(stage, g.dst_rows, dense)
            continue
        m = min(s_pad, src.shape[-1])
        # gather-select of whole child rows (masked) instead of a row scatter
        src_for_dst = np.zeros(B, dtype=np.int64)
        src_for_dst[g.dst_rows] = g.src_rows
        mask = np.zeros(B, dtype=bool)
        mask[g.dst_rows] = True
        gathered = src[jnp.asarray(src_for_dst)][:, :m, :m]
        if m < s_pad:
            gathered = jnp.pad(gathered, ((0, 0), (0, s_pad - m), (0, s_pad - m)))
        stage = jnp.where(jnp.asarray(mask)[:, None, None], gathered, stage)
    return stage


def _gather_schur(groups, s_stacks, B: int):
    """Select child SchurHss rows for a structured batch.  Children may live in
    several source batches as long as all sources share one cluster plan (the planner
    only marks a batch structured under that condition); the per-group gathers are
    merged with masked selects."""
    from hsolve.structured import SchurHss

    assert groups, "structured batch requires child sources"
    out = None
    covered = np.zeros(B, dtype=bool)
    for g in groups:
        src = s_stacks[g.src_batch]
        assert isinstance(src, SchurHss), \
            "structured batch fed by a non-HSS source (planner invariant)"
        src_for_dst = np.zeros(B, dtype=np.int64)
        src_for_dst[g.dst_rows] = g.src_rows
        idx = jnp.asarray(src_for_dst)
        sel = jax.tree_util.tree_map(lambda a: a[idx], src)
        mask = np.zeros(B, dtype=bool)
        mask[g.dst_rows] = True
        covered |= mask
        if out is None:
            out = sel
            continue
        mj = jnp.asarray(mask)

        def pick(new, old):
            mjb = mj.reshape((B,) + (1,) * (new.ndim - 1))
            return jnp.where(mjb, new, old)

        out = jax.tree_util.tree_map(pick, sel, out)
    # dummy / uncovered rows must stay decoupled: zero their content sizes
    mj = jnp.asarray(covered)
    out.n1 = jnp.where(mj, out.n1, 0)
    out.n2 = jnp.where(mj, out.n2, 0)
    return out


# ---------------------------------------------------------------------------
# solve sweeps
# ---------------------------------------------------------------------------

def _apply_impl(levels: List[DenseLevel], root: Optional[RootSolve],
                b: jax.Array) -> jax.Array:
    """Hierarchical solve (parity with ``ldiv!`` + ``_lsolve!/_dsolve!/_rsolve!``,
    factornode.jl:62-99), as per-level batched GEMM/TRSM sweeps in one jitted program.

    Bottom-up: ``C[bnd] -= L C[int]`` then ``C[int] = D^{-1} C[int]`` (safe to fuse
    because a node's interior only receives updates from strictly deeper nodes);
    root boundary solve; top-down: ``C[int] -= R C[bnd]``.
    """
    N = b.shape[0]
    vec = b.ndim == 1
    C = b[:, None] if vec else b
    k = C.shape[1]
    C = jnp.concatenate([C, jnp.zeros((1, k), dtype=C.dtype)], axis=0)  # sentinel row

    from hsolve.structured import StructuredLevel, d_apply

    for lev in levels:
        x = C[lev.int_ids]                      # [B, ni_pad, k]
        if isinstance(lev, (CompressedLevel, StructuredLevel)):
            y = lev.LU_ @ (jnp.swapaxes(lev.LV_, -1, -2) @ x)
        else:
            y = lev.L @ x
        C = dk.scatter(C, lev.bnd_ids, -y, "add", mode="drop")
        if isinstance(lev, StructuredLevel):
            xd = d_apply(lev, x)
        elif lev.dinv is not None:
            xd = lev.dinv @ x
        else:
            xd = dk.lu_solve(lev.lu, lev.perm, x)
        C = dk.scatter(C, lev.int_ids, xd, mode="drop")

    if root is not None:
        if isinstance(root, RootHss):
            from hsolve.ops.hss import hss_solve

            xr = C[root.ids_pad]
            C = dk.scatter(C, root.ids_pad, hss_solve(root.solver, xr),
                           mode="drop")
        else:
            xr = C[root.bnd_ids]                # [nbr, k]
            xr = root.inv @ xr if root.inv is not None else \
                dk.lu_solve(root.lu, root.perm, xr)
            C = dk.scatter(C, root.bnd_ids, xr, mode="drop")

    for lev in reversed(levels):
        xb = C[lev.bnd_ids]                     # [B, nb_pad, k]
        if isinstance(lev, (CompressedLevel, StructuredLevel)):
            upd = lev.RU_ @ (jnp.swapaxes(lev.RV_, -1, -2) @ xb)
        else:
            upd = lev.R @ xb
        C = dk.scatter(C, lev.int_ids, -upd, "add", mode="drop")

    C = C[:N]
    return C[:, 0] if vec else C


_apply_jit = jax.jit(_apply_impl)


@jax.jit
def _solve_jit(levels, root, dperm, diperm, b):
    return solve_with_data((levels, root, dperm, diperm), b)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def factor_with_plan(plan: Plan, opts: SolverOptions, dtype=None,
                     mesh=None, fuse: Optional[bool] = None) -> Factorization:
    """Execute the planner's schedule on device.

    With ``mesh`` (a ('tree', 'front') jax Mesh), every level stack is sharded over the
    node axis (elimination-tree parallelism) and XLA inserts the inter-level collectives
    - see hsolve.parallel.dist.

    ``fuse`` stages the *entire* numeric phase as one jitted program - the default.
    Structured (HSS) batches fuse too: their randomized sampling is single-shot at
    the planned rank cap, so the whole compressed factorization is one static-shape
    program (running it per-batch costs seconds of device round-trips).  ``fuse=False``
    keeps per-batch dispatches (useful for debugging one level at a time)."""
    if dtype is None:
        dtype = jnp.asarray(np.zeros(1, dtype=plan.A_dtype)).dtype
    if fuse is None:
        fuse = True
    with _precision_ctx(opts):
        if opts.verbose:
            from hsolve.utils.logging import logger

            for i, bp in enumerate(plan.batches):
                logger.info(
                    "batch %d: B=%d ni_pad=%d nb_pad=%d %s%s%snnz=%d", i, bp.B,
                    bp.ni_pad, bp.nb_pad, "leaf " if bp.is_leaf else "",
                    "compressed " if bp.compress else "",
                    "structured " if bp.structured else "", len(bp.front_pos))
        if fuse:
            cache = getattr(plan, "_fused_cache", None)
            if cache is None:
                cache = {}
                object.__setattr__(plan, "_fused_cache", cache)
            if mesh is None:
                # single-device path: the COO positions live on device (cached)
                # and the front scatter + entire numeric phase run as ONE
                # program (one dispatch)
                if "pos" not in cache:
                    cache["pos"] = [jax.device_put(np.asarray(bp.front_pos))
                                    for bp in plan.batches]
                    lens = [len(bp.front_vals) for bp in plan.batches]
                    cache["spans"] = tuple(
                        (int(o), int(n)) for o, n in
                        zip(np.cumsum([0] + lens)[:-1], lens))
                pos_list = cache["pos"]
                spans = cache["spans"]
                # device-resident value source: when the planner emitted
                # A.data source indices for every batch, the front values are
                # re-gathered ON DEVICE from a cached copy of A_perm.data -
                # zero host->device traffic per (re-)factorization.
                use_src = bool(spans) and all(
                    bp.front_src is not None for bp in plan.batches)
                if use_src:
                    if "srcflat" not in cache:
                        cache["srcflat"] = jax.device_put(np.concatenate(
                            [bp.front_src for bp in plan.batches]))
                        cache["adata"] = jnp.asarray(plan.A_raw[2])
                    variant = "src"
                    vals_in = (cache["adata"], cache["srcflat"])

                    def _vals_of(inp):
                        ad, sf = inp
                        ad = ad.astype(dtype)
                        return jnp.where(sf >= 0, ad[jnp.clip(sf, 0)],
                                         jnp.ones((), dtype))
                else:
                    vals_np = np.concatenate(
                        [np.asarray(bp.front_vals, dtype=dtype)
                         for bp in plan.batches]) if spans else \
                        np.zeros((0,), dtype=np.dtype(dtype))
                    variant = "vals"
                    vals_in = (jnp.asarray(vals_np),)

                    def _vals_of(inp):
                        return inp[0]
                chunks = _fuse_chunks(plan)
                if len(chunks) == 1:
                    # the jitted closure bakes in the full opts (tolerances,
                    # seed, ...) - key on all of them so a re-factorization with
                    # different options never reuses a stale program
                    key = (str(dtype), variant, dataclasses.astuple(opts))
                    if key not in cache:
                        def _run(vi, ps):
                            vf = _vals_of(vi)
                            return traced_numeric_phase(
                                plan,
                                [build_front_vals(
                                    bp, jax.lax.slice(vf, (o,), (o + n,)), p)
                                 for bp, (o, n), p in zip(plan.batches, spans,
                                                          ps)],
                                opts)

                        cache[key] = jax.jit(_run)
                    levels, root = cache[key](vals_in, pos_list)
                    return Factorization(N=plan.N, perm=plan.perm, levels=levels,
                                         root=root, opts=opts, plan=plan)
                # chunked fusion: a handful of bounded-size programs with the
                # Schur stacks flowing between them as device residents (the
                # monolithic compressed program OOM-kills the XLA compiler at
                # h>=384) - still zero host<->device data traffic per chunk
                nb_ = len(plan.batches)
                last_use = {}
                for j, bp in enumerate(plan.batches):
                    for g in tuple(bp.groups_l) + tuple(bp.groups_r):
                        last_use[g.src_batch] = max(
                            last_use.get(g.src_batch, -1), j)
                last_use[nb_ - 1] = nb_  # the root solve reads the last stack
                # chunk signatures depend only on the schedule (not on shapes):
                # derive them all up front so missing programs can be compiled
                # AHEAD of the execution chain - and, since the compiles are
                # independent even though the executions are chained, in
                # parallel worker threads (HSOLVE_PARALLEL_COMPILE=1; cuts the
                # cold compressed setup by ~the chunk count)
                specs = []
                live: set = set()
                for lo, hi in chunks:
                    in_keys = tuple(sorted(live))
                    keep = tuple(sorted(
                        src for src, last in last_use.items()
                        if src < hi and last >= hi))
                    key = (str(dtype), variant, lo, hi, in_keys, keep,
                           dataclasses.astuple(opts))
                    specs.append((key, lo, hi, in_keys, keep))
                    live = set(keep)

                def make_chunk(lo, hi, in_keys, keep):
                    def _run_chunk(vi, ps, s_in):
                        vf = _vals_of(vi)
                        fr = [build_front_vals(
                            bp, jax.lax.slice(vf, (o,), (o + n,)), p)
                            for bp, (o, n), p in zip(
                                plan.batches[lo:hi], spans[lo:hi], ps)]
                        levs, s_out = _traced_range(
                            plan, fr, opts, lo, hi,
                            dict(zip(in_keys, s_in)), dtype)
                        outs = tuple(s_out[k] for k in keep)
                        if hi == nb_:
                            return levs, outs, _root_from_stacks(
                                plan, s_out, dtype, opts)
                        return levs, outs
                    return _run_chunk

                if any(key not in cache for key, *_ in specs):
                    # abstract pass: propagate the inter-chunk stack avals and
                    # lower every missing program (tracing stays on this
                    # thread - only the XLA compile below is parallelized)
                    vals_aval = tuple(
                        jax.ShapeDtypeStruct(v.shape, v.dtype)
                        for v in vals_in)
                    pos_avals = [jax.ShapeDtypeStruct(p.shape, p.dtype)
                                 for p in pos_list]
                    aval_stacks: dict = {}
                    pending = {}
                    for key, lo, hi, in_keys, keep in specs:
                        s_in_avals = tuple(aval_stacks[k] for k in in_keys)
                        akey = ("avals", key)
                        if key in cache and akey in cache:
                            aval_stacks = dict(zip(keep, cache[akey]))
                            continue
                        fn = make_chunk(lo, hi, in_keys, keep)
                        out_avals = jax.eval_shape(
                            fn, vals_aval, pos_avals[lo:hi], s_in_avals)
                        cache[akey] = out_avals[1]
                        aval_stacks = dict(zip(keep, out_avals[1]))
                        if key not in cache:
                            pending[key] = jax.jit(fn).lower(
                                vals_aval, pos_avals[lo:hi], s_in_avals)
                    workers = int(os.environ.get("HSOLVE_COMPILE_WORKERS",
                                                 "8"))
                    if (len(pending) > 1 and workers > 1 and
                            os.environ.get("HSOLVE_PARALLEL_COMPILE",
                                           "0") == "1"):
                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(
                                max_workers=min(workers,
                                                len(pending))) as ex:
                            futs = [(k, ex.submit(lw.compile))
                                    for k, lw in pending.items()]
                            for k, fu in futs:
                                cache[k] = fu.result()
                    else:
                        for k, lw in pending.items():
                            cache[k] = lw.compile()
                levels = []
                root = None
                stacks: dict = {}
                for key, lo, hi, in_keys, keep in specs:
                    s_in = tuple(stacks[k] for k in in_keys)
                    res = cache[key](vals_in, pos_list[lo:hi], s_in)
                    levels.extend(res[0])
                    stacks = dict(zip(keep, res[1]))
                    if hi == nb_:
                        root = res[2]
                return Factorization(N=plan.N, perm=plan.perm, levels=levels,
                                     root=root, opts=opts, plan=plan)
            from hsolve.parallel.dist import shard_level_input

            fronts = [shard_level_input(mesh, build_front(bp, dtype))
                      for bp in plan.batches]
            key = (str(dtype), "mesh", dataclasses.astuple(opts))
            if key not in cache:
                cache[key] = jax.jit(lambda fr: traced_numeric_phase(plan, fr, opts))
            levels, root = cache[key](fronts)
            return Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                                 opts=opts, plan=plan)
        levels: List[DenseLevel] = []
        s_stacks = {}
        return _factor_levels(plan, opts, dtype, levels, s_stacks, mesh)


def _batch_kernel(bp: BatchPlan, front: jax.Array, opts: SolverOptions, bidx: int,
                  jitted: bool):
    """Run one batch's numeric kernel; returns (level record, S stack)."""
    sperm = jnp.asarray(bp.sperm)
    int_ids = jnp.asarray(bp.int_ids)
    bnd_ids = jnp.asarray(bp.bnd_ids)
    fastinv = opts.resolve_fast_inverse()
    if bp.compress:
        key = jax.random.fold_in(jax.random.PRNGKey(opts.seed), bidx)
        fn = _factor_front_compressed if jitted else _factor_front_compressed_impl
        lu, perm, LU_, LV_, RU_, RV_, lrank, rrank, S, dinv, ratio = fn(
            front, sperm, key, ni_pad=bp.ni_pad, cap=bp.rank_cap,
            atol=opts.atol, rtol=opts.rtol, c_tol=opts.c_tol,
            explicit_inv=opts.explicit_inverse, fast_inverse=fastinv)
        lev = CompressedLevel(lu=lu, perm=perm, LU_=LU_, LV_=LV_, RU_=RU_, RV_=RV_,
                              lrank=lrank, rrank=rrank,
                              int_ids=int_ids, bnd_ids=bnd_ids, dinv=dinv,
                              diag_ratio=ratio)
    else:
        fn = _factor_front if jitted else _factor_front_impl
        lu, perm, L, R, S, dinv, ratio = fn(front, sperm, ni_pad=bp.ni_pad,
                                            explicit_inv=opts.explicit_inverse,
                                            fast_inverse=fastinv)
        lev = DenseLevel(lu=lu, perm=perm, L=L, R=R,
                         int_ids=int_ids, bnd_ids=bnd_ids, dinv=dinv,
                         diag_ratio=ratio)
    return lev, S


def _factor_levels(plan: Plan, opts: SolverOptions, dtype, levels, s_stacks, mesh):
    from hsolve.parallel.dist import shard_level_input

    def put(arr):
        return shard_level_input(mesh, arr) if mesh is not None else arr

    for bidx, bp in enumerate(plan.batches):
        if bp.structured:
            lev, S = _run_structured(bp, s_stacks, opts, dtype, bidx)
            s_stacks[bidx] = S
            levels.append(lev)
            continue
        front = put(build_front(bp, dtype))
        if not bp.is_leaf:
            if bp.groups_l:
                stage_l = _stage_children(bp.groups_l, s_stacks, bp.B, bp.sl_pad, dtype)
                front = _extend_add(front, put(stage_l), jnp.asarray(bp.map_l))
            if bp.groups_r:
                stage_r = _stage_children(bp.groups_r, s_stacks, bp.B, bp.sr_pad, dtype)
                front = _extend_add(front, put(stage_r), jnp.asarray(bp.map_r))
        lev, S = _batch_kernel(bp, front, opts, bidx, jitted=True)
        if bp.compress and bp.cplan is not None and opts.hss:
            from hsolve.structured import transition_compress

            S = transition_compress(S, jnp.asarray(bp.n1), jnp.asarray(bp.n2),
                                    bp.cplan, opts.atol, opts.rtol, bp.rank_cap)
        s_stacks[bidx] = S
        levels.append(lev)

    root = _root_from_stacks(plan, s_stacks, dtype, opts)
    return Factorization(N=plan.N, perm=plan.perm, levels=levels, root=root,
                         opts=opts, plan=plan)


def _run_structured(bp: BatchPlan, s_stacks, opts: SolverOptions, dtype, bidx: int):
    from hsolve.planner import cross_block_shapes
    from hsolve.structured import structured_factor_batch

    sh1 = _gather_schur(bp.groups_l, s_stacks, bp.B)
    sh2 = _gather_schur(bp.groups_r, s_stacks, bp.B)
    # materialize each cross coupling as its EXACT skinny factorization
    # A_blk = U @ V^T: U is the one-hot selector of the nonzero rows, V^T the
    # value strip scattered from the planner's COO.  Only the junction nonzeros
    # (O(contact) per node) ever exist on device - no dense [B, r, c] buffer.
    cross = {}
    for name in cross_block_shapes(bp.child_cplans):
        spec = bp.cross[name]
        r_, c_, rcap = spec["r"], spec["c"], spec["rcap"]
        flat = jnp.zeros((bp.B * rcap * c_,), dtype=dtype)
        if len(spec["pos"]):
            flat = dk.scatter(
                flat, jnp.asarray(spec["pos"]),
                jnp.asarray(np.asarray(spec["vals"], dtype=dtype)),
                unique_indices=True, mode="promise_in_bounds")
        strip = flat.reshape(bp.B, rcap, c_)
        rows = jnp.asarray(spec["rows"])                      # [B, rcap]
        U = (rows[:, None, :] == jnp.arange(r_)[None, :, None]).astype(dtype)
        cross[name] = (U, jnp.swapaxes(strip, -1, -2))        # V [B, c, rcap]
    key = jax.random.fold_in(jax.random.PRNGKey(opts.seed), 7000 + bidx)
    return structured_factor_batch(
        sh1, sh2, cross, jnp.asarray(bp.smap), bp.cplan,
        jnp.asarray(bp.n1), jnp.asarray(bp.n2),
        jnp.asarray(bp.int_ids), jnp.asarray(bp.bnd_ids), opts, key, bp.rank_cap)


@dataclasses.dataclass
class RootHss:
    """Root boundary solve with an HSS Schur complement (HSS ULV-equivalent of the
    reference's root solve, factornode.jl:72)."""

    solver: object            # HssSolver (unbatched)
    ids_pad: jax.Array        # [n_pad] global dof ids in HSS pad coords, sentinel N


jax.tree_util.register_dataclass(RootHss, data_fields=["solver", "ids_pad"],
                                 meta_fields=[])


def _root_from_stacks(plan: Plan, s_stacks, dtype, opts=None):
    from hsolve.ops.hss import hss_factor
    from hsolve.structured import SchurHss

    if plan.nb_root == 0:
        return None
    last = plan.batches[-1]
    S_root = s_stacks[len(plan.batches) - 1]
    if isinstance(S_root, SchurHss):
        h0 = jax.tree_util.tree_map(lambda a: a[0], S_root.h)
        solver = hss_factor(h0)
        npd = S_root.cplan.n_pad
        nbr = plan.nb_root
        bnd0 = np.asarray(last.bnd_ids[0])
        if last.structured:
            # structured bnd_ids are child-aligned: [bnd1 @ 0, bnd2 @ q1]
            cq1 = last.child_cplans[0].n_pad - last.child_cplans[0].half
            nb1r = int(last.cross["nb1"][0])
            s = np.arange(nbr)
            bnd0 = bnd0[np.where(s < nb1r, s, cq1 + s - nb1r)]
        else:
            bnd0 = bnd0[:nbr]
        ids = np.full((npd,), plan.N, dtype=np.int64)
        ids[:nbr] = bnd0
        return RootHss(solver=solver, ids_pad=jnp.asarray(ids))
    S_root = S_root[0]
    # padded diagonal -> identity so the root LU stays well-defined
    pad = jnp.arange(S_root.shape[0]) >= plan.nb_root
    S_root = S_root + jnp.diag(pad.astype(dtype))
    if opts is None:
        opts = plan.opts or SolverOptions()
    if opts.resolve_fast_inverse():
        inv, ratio = dk.block_inverse(S_root)
        return RootSolve(lu=None, perm=None,
                         bnd_ids=jnp.asarray(last.bnd_ids[0]), inv=inv,
                         diag_ratio=ratio[None] if ratio.ndim == 0 else ratio)
    lu, perm = dk.lu_factor(S_root)
    if opts.explicit_inverse:
        inv = dk.lu_inverse(lu, perm)
        d = jnp.abs(jnp.diagonal(lu))
        ratio = jnp.max(d) / jnp.maximum(jnp.min(d), jnp.finfo(d.dtype).tiny)
        return RootSolve(lu=None, perm=None,
                         bnd_ids=jnp.asarray(last.bnd_ids[0]), inv=inv,
                         diag_ratio=ratio[None])
    return RootSolve(lu=lu, perm=perm, bnd_ids=jnp.asarray(last.bnd_ids[0]),
                     inv=None)


def _traced_range(plan: Plan, fronts: List[jax.Array], opts, lo: int, hi: int,
                  s_stacks: dict, dtype):
    """Traceable numeric phase for batches ``lo..hi`` (``fronts`` indexed locally).

    ``s_stacks`` carries Schur stacks produced by earlier ranges; the returned
    dict includes this range's products (keys = global batch index).  Staging a
    long schedule as a handful of bounded-size programs instead of one monolith
    keeps the XLA compile memory bounded - the monolithic compressed program at
    h>=384 exhausted compiler memory and broke LLVM section allocation on the
    CPU backend."""
    levels: List[DenseLevel] = []
    for bidx in range(lo, hi):
        bp = plan.batches[bidx]
        if bp.structured:
            lev, S = _run_structured(bp, s_stacks, opts, dtype, bidx)
            s_stacks[bidx] = S
            levels.append(lev)
            continue
        front = fronts[bidx - lo]
        if not bp.is_leaf:
            if bp.groups_l:
                stage = _stage_children(bp.groups_l, s_stacks, bp.B, bp.sl_pad, dtype)
                front = _extend_add_impl(front, stage, jnp.asarray(bp.map_l))
            if bp.groups_r:
                stage = _stage_children(bp.groups_r, s_stacks, bp.B, bp.sr_pad, dtype)
                front = _extend_add_impl(front, stage, jnp.asarray(bp.map_r))
        lev, S = _batch_kernel(bp, front, opts, bidx, jitted=False)
        if bp.compress and bp.cplan is not None and opts.hss:
            from hsolve.structured import transition_compress

            S = transition_compress(S, jnp.asarray(bp.n1), jnp.asarray(bp.n2),
                                    bp.cplan, opts.atol, opts.rtol, bp.rank_cap)
        s_stacks[bidx] = S
        levels.append(lev)
    return levels, s_stacks


def traced_numeric_phase(plan: Plan, fronts: List[jax.Array], opts=None):
    """Pure traceable numeric phase: per-batch front buffers in, (levels, root) out.

    Lets the *entire* factorization be staged as one jitted program (the default
    single-device path and the multi-chip dry-run)."""
    dtype = fronts[0].dtype
    if opts is None:
        opts = plan.opts or SolverOptions()
    levels, s_stacks = _traced_range(plan, fronts, opts, 0, len(plan.batches),
                                     {}, dtype)
    root = _root_from_stacks(plan, s_stacks, dtype, opts)
    return levels, root


def _fuse_chunks(plan: Plan) -> List[tuple]:
    """Split the schedule into contiguous ranges whose estimated traced size
    stays under a budget (one jitted program per range).  Weights: structured
    batches trace the full randomized HSS construction (~10x a dense batch),
    compressed-with-dense-children batches the one-shot sampler (~6x)."""
    budget = int(os.environ.get("HSOLVE_FUSE_BUDGET", "24"))
    chunks, lo, acc = [], 0, 0
    for i, bp in enumerate(plan.batches):
        w = 10 if bp.structured else (6 if bp.compress else 1)
        if acc and acc + w > budget:
            chunks.append((lo, i))
            lo, acc = i, 0
        acc += w
    chunks.append((lo, len(plan.batches)))
    return chunks


def factor(A: sp.spmatrix, tree: NDTree, opts: Optional[SolverOptions] = None,
           dtype=None, mesh=None, **overrides) -> Factorization:
    """Top-level entry (parity with ``factor(A, nd, nd_loc, opts; args...)``,
    factorization.jl:5-11).  The symbolic phase (``symfact`` + permutation) runs inside
    the planner, so only (A, tree) are needed.  Pass ``mesh`` (see
    hsolve.parallel.dist.make_mesh) to shard the factorization across devices.

    With ``opts.adaptive`` the computed compression ranks are checked against the
    planned caps after the numeric phase; on saturation the problem is re-planned with
    doubled caps and re-factored (host-loop parity with ``randcompress_adaptive``'s
    sample-budget growth, factorization.jl:110)."""
    opts = (opts or SolverOptions()).replace(**overrides)
    opts.validate()
    batch_multiple = int(mesh.shape["tree"]) if mesh is not None else 1
    for attempt in range(3):
        plan = plan_factorization(A, tree, opts, batch_multiple=batch_multiple)
        F = factor_with_plan(plan, opts, dtype=dtype, mesh=mesh)
        if not opts.adaptive:
            return F
        report = F.rank_report()
        if not report["saturated"]:
            return F
        from hsolve.utils.logging import logger

        new_cap = 2 * max(lv["cap"] for lv in report["levels"] if lv["saturated"])
        logger.warning(
            "compression rank saturated the planned cap on %d level(s) "
            "(report: %s); re-planning with rank_cap=%d (attempt %d)",
            sum(lv["saturated"] for lv in report["levels"]), report["levels"],
            new_cap, attempt + 1)
        opts = opts.replace(rank_cap=new_cap)
    return F
