"""Fully-structured compressed branches: the quasilinear path.

This is the batched, static-shape counterpart of the reference's HSS branch
factorization (``_factor_branch`` Val{true} + ``_assemble_blocks`` for HSS children +
all-HSS ``blockfactor``, factorization.jl:78-140, blockmatrix.jl:121-130).  Children
Schur complements stay in HSS form end-to-end - nothing is densified:

- the pivot block ``D = [[H1, C12],[C21, H2]]`` couples the children's interior HSS
  blocks (``S1.A11``/``S2.A11``) through the separator-to-separator junction
  couplings, which are EXACT skinny factor pairs (one-hot row selectors x
  nonzero-row value strips, planned host-side from the sparse pattern); its inverse
  action is block substitution with two HSS solvers, where the inner Schur
  complement ``S22' = H2 - C21 H1^{-1} C12`` is an HSS-minus-low-rank operator
  rebuilt as HSS by interpolative sampling (the reference's ``recompress!``
  equivalent) - no dense [h, h] matrix is ever formed,
- the off-diagonal front blocks reuse the children's generators (``Uint = U B12`` etc.,
  factorization.jl:129-137); with the exact junction strips the Gauss transforms
  ``L = Abi D^{-1}``, ``R = D^{-1} Aib`` are *exact* skinny factor pairs,
- the parent Schur complement is never formed: it is compressed directly from its
  sampling operator ``S = P(Abb - (Abi R.U) R.V^T)P^T`` (factorization.jl:228-249)
  with selected-entry extraction riding the children's HSS generators.

All per-node work is vmapped over the batch; every inner op is a batched LU, a skinny
GEMM, or an HSS level sweep.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hsolve.ops import dense as dk
from hsolve.ops.hss import (ClusterPlan, Hss, HssSolver, generators,
                            hss_compress_dense, hss_entry_factors,
                            hss_entries_prepared, hss_factor, hss_matvec,
                            hss_randcompress_batched, hss_solve, hss_sub, hss_todense)

# Internal tightening of the HSS compression tolerances relative to the user's
# atol/rtol contract.  The interpolative decompositions deliver ~2-5x the requested
# truncation error (standard ID constants), and pivot-block inversion amplifies
# whatever error the chain carries by cond(D); compressing internally at tol/4 makes
# the *delivered* preconditioner error track the user tolerance (the reference's
# 0.5-factor on the transforms, factorization.jl:99-100, plays the same role).
_SAFETY = 0.25


@dataclasses.dataclass
class SchurHss:
    """A batch of Schur complements in HSS form on a shared cluster plan; node i's
    content occupies ``[0, n1[i])`` (parent-int part) and ``[half, half + n2[i])``
    (parent-bnd part) of the padded index space, identity elsewhere."""

    h: Hss                  # arrays carry a leading batch axis
    n1: jax.Array           # [B]
    n2: jax.Array           # [B]

    @property
    def cplan(self) -> ClusterPlan:
        return self.h.plan


jax.tree_util.register_dataclass(SchurHss, data_fields=["h", "n1", "n2"],
                                 meta_fields=[])


def _embed_idx(cplan: ClusterPlan, n1: jax.Array, n2: jax.Array, width: int):
    """[width] compact position -> HSS pad coordinate (per node; vmap over n1/n2)."""
    t = jnp.arange(width)
    pad = jnp.where(t < n1, t, cplan.half + (t - n1))
    return jnp.where(t < n1 + n2, pad, cplan.n_pad)  # sentinel past content


@partial(jax.jit, static_argnames=("cplan", "atol", "rtol", "cap"))
def transition_compress(S_perm: jax.Array, n1: jax.Array, n2: jax.Array,
                        cplan: ClusterPlan, atol: float, rtol: float,
                        cap: int) -> SchurHss:
    """Dense (already [int_loc; bnd_loc]-permuted) Schur complements -> batched HSS
    (the first compressed level, whose children were dense)."""
    B, w, _ = S_perm.shape
    npd = cplan.n_pad

    def per_node(S, k1, k2):
        emb = _embed_idx(cplan, k1, k2, w)
        Spad = jnp.zeros((npd + 1, npd + 1), dtype=S.dtype)
        Spad = dk.scatter(Spad, (emb[:, None], emb[None, :]), S, mode="drop")
        Spad = Spad[:npd, :npd]
        covered = dk.scatter(jnp.zeros(npd + 1, dtype=S.dtype), emb, 1.0,
                             mode="drop")[:npd]
        Spad = Spad + jnp.diag(1.0 - covered)
        return hss_compress_dense(Spad, cplan, _SAFETY * atol, _SAFETY * rtol,
                                  cap)

    h = jax.vmap(per_node)(S_perm, n1, n2)
    return SchurHss(h=h, n1=n1, n2=n2)


def densify_schur(s: SchurHss, s_pad: int) -> jax.Array:
    """Batched dense compact Schur complements [B, s_pad, s_pad] (fallback for parents
    that consume HSS children densely); padded region is garbage and must be masked by
    the consumer's scatter maps."""
    cplan = s.cplan

    def per_node(h, k1, k2):
        Hd = hss_todense(h)
        emb = jnp.minimum(_embed_idx(cplan, k1, k2, s_pad), cplan.n_pad - 1)
        return Hd[emb[:, None], emb[None, :]]

    return jax.vmap(per_node)(s.h, s.n1, s.n2)


# ---------------------------------------------------------------------------
# the structured factor kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StructuredLevel:
    """Solve-sweep data for a structured level: HSS pivot solvers + exact skinny
    Gauss-transform factors (reference FactorNode with BlockFactorization D +
    LowRankMatrix L/R, factornode.jl:7-35).

    The pivot couplings are stored as skinny factor pairs, never dense:
    ``C12 = U12 V12^T``, ``C21 = U21 V21^T`` (junction couplings, geometrically
    O(1) rank - the reference keeps them structured too, as ``hss(A[int1,int2])``
    at factorization.jl:128), and ``W = H1^{-1} C12 = WU V12^T``."""

    solver1: HssSolver       # child-1 interior HSS solver (batched)
    solver22: HssSolver      # inner Schur complement solver (batched)
    H2: Hss                  # child-2 interior HSS (exact S22' operand, batched)
    WU: jax.Array            # [B, h1, rc] = H1^{-1} U12
    V12: jax.Array           # [B, h2, rc]
    U21: jax.Array           # [B, h2, rc]
    V21: jax.Array           # [B, h1, rc]
    LU_: jax.Array           # [B, q1+q2, kk]
    LV_: jax.Array           # [B, h1+h2, kk]
    RU_: jax.Array           # [B, h1+h2, kk]
    RV_: jax.Array           # [B, q1+q2, kk]
    int_ids: jax.Array       # [B, h1+h2]
    bnd_ids: jax.Array       # [B, q1+q2]
    h1: int
    h2: int
    # [B] largest interpolation rank hit across this batch's randomized HSS
    # compressions; rank_maxed >= rank_cap flags silent-truncation risk (the event
    # randcompress_adaptive grows its budget on, factorization.jl:110)
    rank_maxed: Optional[jax.Array] = None
    rank_cap: int = 0


jax.tree_util.register_dataclass(
    StructuredLevel,
    data_fields=["solver1", "solver22", "H2", "WU", "V12", "U21", "V21",
                 "LU_", "LV_", "RU_", "RV_", "int_ids", "bnd_ids", "rank_maxed"],
    meta_fields=["h1", "h2", "rank_cap"])


def d_apply(lev: StructuredLevel, x: jax.Array, adjoint: bool = False) -> jax.Array:
    """Pivot-block solve D^{-1} x (or D^{-T} x) for x [B, h1+h2, k]: block substitution
    with the two HSS solvers (parity with ``blockldiv!``, blockmatrix.jl:135-144).

    The inner Schur solve is sharpened by one step of iterative refinement against
    the operator ``S22' = H2 - C21 H1^{-1} C12`` (available matrix-free from the
    stored skinny factors): the sampled-HSS approximation of S22' carries the user's
    compression tolerance, and inverting it without refinement amplifies error by
    sigma_0/sigma_min - catastrophic on indefinite (wave) pivot blocks where S22'
    has small singular values.  Refinement squares the effective solve accuracy for
    one extra HSS matvec + solve.  Every coupling product is a pair of skinny GEMMs
    (rank rc), so the apply carries no dense [h, h] work."""
    h1 = lev.h1
    x1, x2 = x[:, :h1], x[:, h1:]
    WUt = jnp.swapaxes(lev.WU, -1, -2)
    V12t = jnp.swapaxes(lev.V12, -1, -2)
    U21t = jnp.swapaxes(lev.U21, -1, -2)
    V21t = jnp.swapaxes(lev.V21, -1, -2)

    def s22_mv(y, adj=False):
        # S22' y = H2 y - U21 (V21^T (WU (V12^T y)))  [C21 W = U21 V21^T WU V12^T]
        if not adj:
            return jax.vmap(hss_matvec)(lev.H2, y) \
                - lev.U21 @ (V21t @ (lev.WU @ (V12t @ y)))
        return jax.vmap(partial(hss_matvec, adjoint=True))(lev.H2, y) \
            - lev.V12 @ (WUt @ (lev.V21 @ (U21t @ y)))

    if not adjoint:
        y1 = jax.vmap(hss_solve)(lev.solver1, x1)
        t = x2 - lev.U21 @ (V21t @ y1)               # C21 y1
        y2 = jax.vmap(hss_solve)(lev.solver22, t)
        y2 = y2 + jax.vmap(hss_solve)(lev.solver22, t - s22_mv(y2))
        y1 = y1 - lev.WU @ (V12t @ y2)               # W y2
    else:
        # D^T = [[H1^T, C21^T],[C12^T, H2'^T]] with W = H1^{-1} C12
        solve1T = jax.vmap(partial(hss_solve, adjoint=True))
        solve22T = jax.vmap(partial(hss_solve, adjoint=True))
        y1 = solve1T(lev.solver1, x1)
        t = x2 - lev.V12 @ (WUt @ x1)                # W^T x1 = C12^T H1^{-T} x1
        y2 = solve22T(lev.solver22, t)
        y2 = y2 + solve22T(lev.solver22, t - s22_mv(y2, adj=True))
        y1 = y1 - solve1T(lev.solver1, lev.V21 @ (U21t @ y2))   # C21^T y2
    return jnp.concatenate([y1, y2], axis=1)


def structured_factor_batch(sh1: SchurHss, sh2: SchurHss, cross: dict,
                            smap: jax.Array, cplan: ClusterPlan, n1: jax.Array,
                            n2: jax.Array, int_ids, bnd_ids, opts, key,
                            rank_cap: int) -> Tuple[StructuredLevel, SchurHss]:
    """Factor one structured batch; returns the solve-sweep record and the parent
    Schur complements in HSS form.  ``cross`` holds the 8 junction couplings as
    EXACT skinny factor pairs ``(U, V)`` with ``A_blk = U V^T`` (one-hot row
    selectors x nonzero-row value strips, planned host-side).  Dispatches to one
    jitted program per batch shape (the whole structured kernel - generator
    algebra, HSS solvers, randomized sampling - is static-shape, so running it
    eagerly would cost hundreds of device round-trips)."""
    return _structured_factor_jit(
        sh1, sh2, cross, smap, n1, n2, int_ids, bnd_ids, key, cplan=cplan,
        rank_cap=rank_cap, atol=opts.atol, rtol=opts.rtol,
        kest=opts.kest, stepsize=opts.stepsize,
        sprec=opts.structured_precision)


@partial(jax.jit, static_argnames=("cplan", "rank_cap", "atol", "rtol",
                                   "kest", "stepsize", "sprec"))
def _structured_factor_jit(sh1: SchurHss, sh2: SchurHss, cross: dict,
                           smap: jax.Array, n1: jax.Array, n2: jax.Array,
                           int_ids, bnd_ids, key, *, cplan: ClusterPlan,
                           rank_cap: int, atol: float, rtol: float,
                           kest: int, stepsize: int,
                           sprec: Optional[str] = None
                           ) -> Tuple[StructuredLevel, SchurHss]:
    if sprec:
        # structured-only precision override: bind every matmul traced in this
        # kernel to ``sprec`` (e.g. 'high' = 3-pass bf16) while the dense path
        # keeps the global opts.matmul_precision
        with jax.default_matmul_precision(sprec):
            return _structured_factor_body(
                sh1, sh2, cross, smap, n1, n2, int_ids, bnd_ids, key,
                cplan=cplan, rank_cap=rank_cap, atol=atol, rtol=rtol,
                kest=kest, stepsize=stepsize)
    return _structured_factor_body(
        sh1, sh2, cross, smap, n1, n2, int_ids, bnd_ids, key, cplan=cplan,
        rank_cap=rank_cap, atol=atol, rtol=rtol, kest=kest, stepsize=stepsize)


def _structured_factor_body(sh1: SchurHss, sh2: SchurHss, cross: dict,
                            smap: jax.Array, n1: jax.Array, n2: jax.Array,
                            int_ids, bnd_ids, key, *, cplan: ClusterPlan,
                            rank_cap: int, atol: float, rtol: float,
                            kest: int,
                            stepsize: int) -> Tuple[StructuredLevel, SchurHss]:
    cpl, cpr = sh1.cplan, sh2.cplan
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    dtype = sh1.h.D.dtype

    A11_1 = jax.vmap(partial(hss_sub, side=0))(sh1.h)
    A11_2 = jax.vmap(partial(hss_sub, side=0))(sh2.h)
    A22_1 = jax.vmap(partial(hss_sub, side=1))(sh1.h)
    A22_2 = jax.vmap(partial(hss_sub, side=1))(sh2.h)

    # children generators and root couplings (factorization.jl:129-132)
    U1a, V1a, U1b, V1b = jax.vmap(generators)(sh1.h)   # child1: (int side, bnd side)
    U2a, V2a, U2b, V2b = jax.vmap(generators)(sh2.h)
    B12r1, B21r1 = sh1.h.B12s[-1][:, 0], sh1.h.B21s[-1][:, 0]
    B12r2, B21r2 = sh2.h.B12s[-1][:, 0], sh2.h.B21s[-1][:, 0]
    Ui1 = U1a @ B12r1        # [B, h1, r] int->bnd coupling row factor (child 1)
    Ub1 = U1b @ B21r1        # [B, q1, r] bnd->int
    Ui2 = U2a @ B12r2
    Ub2 = U2b @ B21r2

    # exact junction couplings: every cross block is U @ V^T EXACTLY (planner
    # strips), so Gauss transforms and pivot algebra carry no coupling-compression
    # error (the reference keeps them structured too: hss(A[int1,int2]),
    # factorization.jl:128)
    Ui12, Vi12 = cross["ci12"]     # [B, h1, r12], [B, h2, r12]
    Ui21, Vi21 = cross["ci21"]
    Uib12, Vib12 = cross["cib12"]
    Uib21, Vib21 = cross["cib21"]
    Ubi12, Vbi12 = cross["cbi12"]
    Ubi21, Vbi21 = cross["cbi21"]
    Ubb12, Vbb12 = cross["cbb12"]
    Ubb21, Vbb21 = cross["cbb21"]

    # pivot block factor: H1 solver + skinny coupling algebra
    solver1 = jax.vmap(hss_factor)(A11_1)
    WU = jax.vmap(hss_solve)(solver1, Ui12)            # [B, h1, r12]

    # inner Schur complement S22' = H2 - C21 H1^{-1} C12 = H2 - G21 V12^T with
    # G21 = U21 (V21^T WU): an HSS-minus-low-rank operator, rebuilt as HSS by the
    # partially-matrix-free interpolative compressor (the reference's
    # ``recompress!`` of the inner Schur, blockmatrix.jl:121-130).  No dense
    # [h2, h2] matrix and no O(h^3) GEMM is ever formed (round-2 verdict #3);
    # the dense construction survives under HS_DEBUG_DENSE_S for bisection.
    G21 = Ui21 @ (jnp.swapaxes(Vi21, -1, -2) @ WU)     # [B, h2, r12]
    if os.environ.get("HS_DEBUG_DENSE_S"):
        S22d = jax.vmap(hss_todense)(A11_2) - G21 @ jnp.swapaxes(Vi12, -1, -2)
        hssS22 = jax.vmap(
            lambda M: hss_compress_dense(M, A11_2.plan, _SAFETY * atol,
                                         _SAFETY * rtol, rank_cap))(S22d)
        maxed22 = jnp.zeros((sh1.n1.shape[0],), jnp.int32)
    else:
        # entry factors hoisted ONCE per operand: the interpolative construction
        # extracts O(depth * rank) blocks of the same matrix, and re-deriving the
        # generator products per block dominated trace size and device FLOPs
        ef2 = jax.vmap(hss_entry_factors)(A11_2)

        def s22_sample(op, X, adjoint):
            H2n, Gn, Vn, _ = op
            if not adjoint:
                return hss_matvec(H2n, X) - Gn @ (Vn.T @ X)
            return hss_matvec(H2n, X, adjoint=True) - Vn @ (Gn.T @ X)

        def s22_blocks(op, rows_, cols_):
            _, Gn, Vn, efn = op
            return hss_entries_prepared(efn, rows_, cols_) - Gn[rows_] @ Vn[cols_].T

        hssS22, maxed22 = hss_randcompress_batched(
            s22_sample, s22_blocks, (A11_2, G21, Vi12, ef2), A11_2.plan,
            jax.random.fold_in(key, 203), _SAFETY * atol, _SAFETY * rtol,
            rank_cap, kest=kest, stepsize=max(stepsize, 8))
    solver22 = jax.vmap(hss_factor)(hssS22)

    lev = StructuredLevel(
        solver1=solver1, solver22=solver22, H2=A11_2,
        WU=WU, V12=Vi12, U21=Ui21, V21=Vi21,
        LU_=None, LV_=None, RU_=None, RV_=None,
        int_ids=int_ids, bnd_ids=bnd_ids, h1=h1, h2=h2)

    # --- exact skinny Gauss transforms ---
    # the two children's generator widths may differ (their cluster plans and
    # rank caps do): each gets its own column group
    w1, w2 = Ui1.shape[-1], Ui2.shape[-1]
    B = sh1.n1.shape[0]
    rib12, rib21 = Uib12.shape[-1], Uib21.shape[-1]
    rbi12, rbi21 = Ubi12.shape[-1], Ubi21.shape[-1]
    kk_ib = w1 + w2 + rib12 + rib21
    kk_bi = w1 + w2 + rbi12 + rbi21

    def scat(A, rows_off, col_off, total_rows, kk):
        out = jnp.zeros((B, total_rows, kk), dtype=dtype)
        return out.at[:, rows_off: rows_off + A.shape[1],
                      col_off: col_off + A.shape[2]].set(A)

    # Aib = AibU @ AibV^T : groups [child1-gen, child2-gen, cross i1b2, cross i2b1]
    AibU = (scat(Ui1, 0, 0, h1 + h2, kk_ib) + scat(Ui2, h1, w1, h1 + h2, kk_ib)
            + scat(Uib12, 0, w1 + w2, h1 + h2, kk_ib)
            + scat(Uib21, h1, w1 + w2 + rib12, h1 + h2, kk_ib))
    AibV = (scat(V1b, 0, 0, q1 + q2, kk_ib) + scat(V2b, q1, w1, q1 + q2, kk_ib)
            + scat(Vib12, q1, w1 + w2, q1 + q2, kk_ib)
            + scat(Vib21, 0, w1 + w2 + rib12, q1 + q2, kk_ib))
    # Abi = AbiU @ AbiV^T
    AbiU = (scat(Ub1, 0, 0, q1 + q2, kk_bi) + scat(Ub2, q1, w1, q1 + q2, kk_bi)
            + scat(Ubi12, 0, w1 + w2, q1 + q2, kk_bi)
            + scat(Ubi21, q1, w1 + w2 + rbi12, q1 + q2, kk_bi))
    AbiV = (scat(V1a, 0, 0, h1 + h2, kk_bi) + scat(V2a, h1, w1, h1 + h2, kk_bi)
            + scat(Vbi12, h1, w1 + w2, h1 + h2, kk_bi)
            + scat(Vbi21, 0, w1 + w2 + rbi12, h1 + h2, kk_bi))

    RU = d_apply(lev, AibU)                 # R = (D^{-1} AibU) AibV^T
    LV = d_apply(lev, AbiV, adjoint=True)   # L = AbiU (D^{-T} AbiV)^T
    lev = dataclasses.replace(lev, LU_=AbiU, LV_=LV, RU_=RU, RV_=AibV)

    # --- parent Schur complement via sampling ---
    # corr = Abi @ R = KU @ RV^T with KU = AbiU (AbiV^T RU)
    KU = AbiU @ (jnp.swapaxes(AbiV, -1, -2) @ RU)        # [B, q1+q2, kk_ib]
    RV = AibV
    nq = q1 + q2

    efb1 = jax.vmap(hss_entry_factors)(A22_1)
    efb2 = jax.vmap(hss_entry_factors)(A22_2)
    s_ops = (A22_1, A22_2, Ubb12, Vbb12, Ubb21, Vbb21, KU, RV, smap, efb1, efb2)

    def s_sample(op, X, adjoint):
        A1, A2, Ub12, Vb12, Ub21, Vb21, KUn, RVn, sm = op[:9]
        s = X.shape[-1]
        Xb = jnp.zeros((nq + 1, s), dtype=X.dtype)
        Xb = dk.scatter(Xb, sm, X, "add")               # pad -> bnd layout
        Xb = Xb[:nq]
        x1, x2 = Xb[:q1], Xb[q1:]
        if not adjoint:
            y1 = hss_matvec(A1, x1) + Ub12 @ (Vb12.T @ x2)
            y2 = hss_matvec(A2, x2) + Ub21 @ (Vb21.T @ x1)
            Yb = jnp.concatenate([y1, y2]) - KUn @ (jnp.swapaxes(RVn, 0, 1) @ Xb)
        else:
            y1 = hss_matvec(A1, x1, adjoint=True) + Vb21 @ (Ub21.T @ x2)
            y2 = hss_matvec(A2, x2, adjoint=True) + Vb12 @ (Ub12.T @ x1)
            Yb = jnp.concatenate([y1, y2]) - RVn @ (jnp.swapaxes(KUn, 0, 1) @ Xb)
        Yb = jnp.concatenate([Yb, jnp.zeros((1, s), dtype=X.dtype)])
        Y = Yb[sm]
        return jnp.where((sm < nq)[:, None], Y, X)       # identity on padding

    def s_blocks(op, rows, cols):
        _, _, Ub12, Vb12, Ub21, Vb21, KUn, RVn, sm, ef1, ef2_ = op
        rb = sm[rows]
        cb = sm[cols]
        rv, cv = rb < nq, cb < nq
        r1, c1 = rb < q1, cb < q1
        rbc = jnp.minimum(rb, nq - 1)
        cbc = jnp.minimum(cb, nq - 1)
        e11 = hss_entries_prepared(ef1, jnp.minimum(rbc, q1 - 1),
                                   jnp.minimum(cbc, q1 - 1))
        e22 = hss_entries_prepared(ef2_, jnp.maximum(rbc - q1, 0),
                                   jnp.maximum(cbc - q1, 0))
        e12 = Ub12[jnp.minimum(rbc, q1 - 1)] @ Vb12[jnp.maximum(cbc - q1, 0)].T
        e21 = Ub21[jnp.maximum(rbc - q1, 0)] @ Vb21[jnp.minimum(cbc, q1 - 1)].T
        both1 = r1[:, None] & c1[None, :]
        both2 = (~r1)[:, None] & (~c1)[None, :]
        val = jnp.where(both1, e11, jnp.where(both2, e22,
                        jnp.where(r1[:, None], e12, e21)))
        val = val - KUn[rbc] @ jnp.swapaxes(RVn[cbc], 0, 1)
        valid = rv[:, None] & cv[None, :]
        pad_diag = ((~rv)[:, None] & (~cv)[None, :]
                    & (rows[:, None] == cols[None, :])).astype(val.dtype)
        return jnp.where(valid, val, pad_diag)

    if os.environ.get("HS_DEBUG_DENSE_S"):
        # debug bisect: exact dense parent Schur + deterministic compression
        eyeS = jnp.eye(cplan.n_pad, dtype=dtype)
        Sd = jax.vmap(lambda op: s_sample(op, eyeS, False))(s_ops)
        hssS = jax.vmap(
            lambda M: hss_compress_dense(M, cplan, _SAFETY * atol, _SAFETY * rtol,
                                         rank_cap))(Sd)
        maxedS = jnp.zeros((sh1.n1.shape[0],), jnp.int32)
    else:
        hssS, maxedS = hss_randcompress_batched(
            s_sample, s_blocks, s_ops, cplan, jax.random.fold_in(key, 202),
            _SAFETY * atol, _SAFETY * rtol, rank_cap, kest=kest,
            stepsize=max(stepsize, 8))
    lev = dataclasses.replace(lev, rank_maxed=jnp.maximum(maxed22, maxedS),
                              rank_cap=rank_cap)
    return lev, SchurHss(h=hssS, n1=n1, n2=n2)
