"""HSS (hierarchically semi-separable) matrices as static level arrays.

Static-shape re-design of the reference's HssMatrices.jl dependency surface (SURVEY.md
section 2, external-API table): the pointer-based recursive ``HssMatrix`` becomes flat
per-level array stacks over a *perfect* binary cluster tree planned statically:

- ``D [nleaves, ls, ls]``, leaf bases ``U, V [nleaves, ls, r]``,
- per internal level: translations ``R, W [nnodes*2, r, r]`` and sibling couplings
  ``B12, B21 [nnodes, r, r]``,

with one uniform static rank cap ``r`` (true ranks masked by zero columns).  The root
split sits exactly between the two halves, matching the reference's pinned int/bnd split
(``bisection_cluster((ni, n))``, factorization.jl:56,109): interior DOFs live in the
left half (padded), boundary DOFs in the right half.

Capabilities and their reference counterparts:

- :func:`hss_compress_dense`       <-> ``compress`` (direct dense compression)
- :func:`hss_randcompress`         <-> ``randcompress_adaptive`` (matrix-free randomized
                                      construction with interpolative bases + entry
                                      extraction, the STRUMPACK/Martinsson scheme)
- :func:`hss_matvec`               <-> ``*`` (fast telescoped matvec)
- :func:`hss_factor`/:func:`hss_solve` <-> ULV ``\\`` - implemented as a telescoping
  block-Woodbury factorization (recursive-skeletonization-style): every level adds a
  rank-2r Woodbury correction around the block-diagonal inverse, so factor and solve
  are batched LU + skinny GEMMs + basis sweeps (MXU-shaped), with identical
  O(n r^2 log n) / O(n r log n) complexity to ULV.
- :func:`generators` / :func:`hss_sub` <-> ``generators`` / ``.A11``/``.A22`` access
- :func:`hss_rank`                 <-> ``hssrank``
- cluster equilibration (``prune_leaves!``/``compatible``, factorization.jl:143-168) is
  replaced by static planning: all cluster trees are perfect and depth-matched by
  construction.

All functions operate on a single HSS matrix; batch across fronts with ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hsolve.ops import dense as dk
from hsolve.ops.lowrank import interp_decomp


# ---------------------------------------------------------------------------
# cluster planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Static symmetric cluster tree: ``nleaves`` (power of two) leaves of uniform
    padded size ``ls``; the root splits between leaves nleaves/2-1 and nleaves/2."""

    ls: int
    depth: int          # number of internal levels (>= 1); nleaves = 2**depth
    n1: int             # actual size of the left half (interior DOFs)
    n2: int             # actual size of the right half (boundary DOFs)

    @property
    def nleaves(self) -> int:
        return 1 << self.depth

    @property
    def half(self) -> int:
        return (self.nleaves // 2) * self.ls

    @property
    def n_pad(self) -> int:
        return self.nleaves * self.ls

    def level_nodes(self, lev: int) -> int:
        """Internal level ``lev`` in 1..depth has this many nodes."""
        return self.nleaves >> lev

    def embed(self) -> np.ndarray:
        """Map padded HSS index -> position in the compact [0, n1+n2) ordering
        (the Schur complement's [int_loc; bnd_loc] order); sentinel n1+n2 on padding."""
        n = self.n1 + self.n2
        idx = np.full(self.n_pad, n, dtype=np.int64)
        idx[: self.n1] = np.arange(self.n1)
        idx[self.half: self.half + self.n2] = self.n1 + np.arange(self.n2)
        return idx


def plan_cluster(n1: int, n2: int, leafsize: int, min_depth: int = 1) -> ClusterPlan:
    """Choose a perfect symmetric cluster tree covering (n1 | n2) with root split
    pinned at the boundary (parity with ``bisection_cluster((n1, n1+n2))``)."""
    side = max(n1, n2, 1)
    # leaves per side: power of two, aiming at ~leafsize DOFs per leaf
    per_side = max(1, -(-side // max(leafsize, 1)))
    per_side = 1 << max((per_side - 1).bit_length(), max(min_depth - 1, 0))
    ls = -(-side // per_side)
    ls = max(ls, 1)
    depth = per_side.bit_length()  # per_side = 2**(depth-1); total depth adds the root
    return ClusterPlan(ls=ls, depth=depth, n1=n1, n2=n2)


# ---------------------------------------------------------------------------
# representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Hss:
    """Telescoped HSS form.  ``Rs[i]/Ws[i]/B12s[i]/B21s[i]`` describe internal level
    ``i+1`` (level 1 = parents of leaves, level ``depth`` = root):

    - ``Rs[i] [2*m, r, r]``: row-basis translations, children of node j at rows
      ``2j, 2j+1`` (``Uhat_parent = [Uhat_l @ R_l; Uhat_r @ R_r]``),
    - ``B12s[i] [m, r, r]``: coupling ``A[I_left, I_right] = Uhat_l B12 Vhat_r^T``.
    """

    D: jax.Array                 # [nleaves, ls, ls]
    U: jax.Array                 # [nleaves, ls, r]
    V: jax.Array                 # [nleaves, ls, r]
    Rs: List[jax.Array]
    Ws: List[jax.Array]
    B12s: List[jax.Array]
    B21s: List[jax.Array]
    plan: ClusterPlan

    @property
    def r(self) -> int:
        return self.U.shape[-1]


jax.tree_util.register_dataclass(
    Hss, data_fields=["D", "U", "V", "Rs", "Ws", "B12s", "B21s"], meta_fields=["plan"])


def hss_rank(h: Hss) -> int:
    """Max true rank across generators (parity with ``hssrank``): the number of
    not-identically-zero columns."""
    r = 0
    for arr in [h.U, h.V] + h.Rs + h.Ws:
        nz = np.asarray(jnp.any(jnp.abs(arr) > 0, axis=tuple(range(arr.ndim - 1))))
        r = max(r, int(nz.sum()))
    return r


# ---------------------------------------------------------------------------
# materialized bases (downward products) - used by generators, entries, Woodbury
# ---------------------------------------------------------------------------

def materialize_bases(h: Hss) -> Tuple[List[jax.Array], List[jax.Array]]:
    """Per-level full bases ``Ubig[lev] [n_pad, r]``: rows of node j at level ``lev``
    hold its materialized ``Uhat_j`` (lev = 0 are the leaves)."""
    p = h.plan
    Ubig = [h.U.reshape(p.n_pad, -1)]
    Vbig = [h.V.reshape(p.n_pad, -1)]
    sz = p.ls
    for i in range(p.depth - 1):  # bases needed for levels 0..depth-1
        R, W = h.Rs[i], h.Ws[i]
        r = R.shape[-1]
        Uprev = Ubig[-1].reshape(-1, sz, r)          # [2m, sz, r] children stacked
        Vprev = Vbig[-1].reshape(-1, sz, r)
        Ubig.append((Uprev @ R).reshape(p.n_pad, r))
        Vbig.append((Vprev @ W).reshape(p.n_pad, r))
        sz *= 2
    return Ubig, Vbig


def generators(h: Hss) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Materialized row/col bases of the two root children (parity with
    ``generators(S.A11)`` usage at factorization.jl:129-132): returns
    (U1, V1, U2, V2) with U1 [half, r] etc."""
    Ubig, Vbig = materialize_bases(h)
    half = h.plan.half
    Ut, Vt = Ubig[-1], Vbig[-1]
    return Ut[:half], Vt[:half], Ut[half:], Vt[half:]


def hss_sub(h: Hss, side: int) -> Hss:
    """The root child as an HSS matrix (parity with ``S.A11``/``S.A22`` access):
    side 0 = left (interior block), 1 = right (boundary block).  Requires depth >= 2."""
    p = h.plan
    if p.depth < 2:
        raise ValueError("depth-1 HSS has dense root children")
    m = p.nleaves // 2
    sl = slice(0, m) if side == 0 else slice(m, 2 * m)
    n_half = p.n1 if side == 0 else p.n2
    # the half keeps a pinned split at its own midpoint; actual content size n_half
    sub_plan = ClusterPlan(ls=p.ls, depth=p.depth - 1,
                           n1=min(n_half, p.half // 2),
                           n2=max(n_half - p.half // 2, 0))
    Rs, Ws, B12s, B21s = [], [], [], []
    for i in range(p.depth - 1):
        mm = p.level_nodes(i + 1) // 2  # nodes of this level inside one half
        slc = slice(0, mm) if side == 0 else slice(mm, 2 * mm)
        slc2 = slice(0, 2 * mm) if side == 0 else slice(2 * mm, 4 * mm)
        Rs.append(h.Rs[i][slc2])
        Ws.append(h.Ws[i][slc2])
        B12s.append(h.B12s[i][slc])
        B21s.append(h.B21s[i][slc])
    return Hss(D=h.D[sl], U=h.U[sl], V=h.V[sl], Rs=Rs, Ws=Ws, B12s=B12s, B21s=B21s,
               plan=sub_plan)


# ---------------------------------------------------------------------------
# matvec / dense reconstruction
# ---------------------------------------------------------------------------

def hss_matvec(h: Hss, x: jax.Array, adjoint: bool = False) -> jax.Array:
    """y = A x (or A^T x) for x [n_pad, k]: telescoped upsweep/downsweep,
    one batched GEMM pair per level (parity with HssMatrices ``*``)."""
    p = h.plan
    r = h.r
    k = x.shape[-1]
    Vl, Ul = (h.V, h.U) if not adjoint else (h.U, h.V)
    B12s = h.B12s if not adjoint else [jnp.swapaxes(B, -1, -2) for B in h.B21s]
    B21s = h.B21s if not adjoint else [jnp.swapaxes(B, -1, -2) for B in h.B12s]
    Ws = h.Ws if not adjoint else h.Rs
    Rs = h.Rs if not adjoint else h.Ws

    xl = x.reshape(p.nleaves, p.ls, k)
    # upsweep: xi[lev] holds V_hat^T x per node at that level
    xi = [jnp.swapaxes(Vl, -1, -2) @ xl]                       # [m0, r, k]
    for i in range(p.depth - 1):
        W = Ws[i]
        prev = xi[-1]
        comb = jnp.swapaxes(W, -1, -2) @ prev                  # [2m, r, k]
        xi.append(comb.reshape(-1, 2, r, k).sum(axis=1))       # [m, r, k]
    # couplings: eta at child level per internal level
    etas = []
    for lev in range(1, p.depth + 1):
        B12, B21 = B12s[lev - 1], B21s[lev - 1]
        ch = xi[lev - 1].reshape(-1, 2, r, k)                  # [m, 2, r, k]
        e_l = B12 @ ch[:, 1]                                   # to left child
        e_r = B21 @ ch[:, 0]                                   # to right child
        etas.append(jnp.stack([e_l, e_r], axis=1).reshape(-1, r, k))
    # downsweep: accumulate eta to leaf level through R translations
    acc = etas[-1]                                             # [2, r, k] at root kids
    for lev in range(p.depth - 1, 0, -1):
        R = Rs[lev - 1]                                        # [2m, r, r]
        acc = R @ jnp.repeat(acc, 2, axis=0) + etas[lev - 1]
    y = h.D @ xl if not adjoint else jnp.swapaxes(h.D, -1, -2) @ xl
    y = y + Ul @ acc
    return y.reshape(p.n_pad, k)


def hss_todense(h: Hss) -> jax.Array:
    """Dense reconstruction (tests / small blocks)."""
    p = h.plan
    n = p.n_pad
    Ubig, Vbig = materialize_bases(h)
    A = jnp.zeros((n, n), dtype=h.D.dtype)
    sz = p.ls
    for li in range(p.nleaves):
        A = jax.lax.dynamic_update_slice(A, h.D[li], (li * p.ls, li * p.ls))
    for lev in range(1, p.depth + 1):
        m = p.level_nodes(lev)
        Ub = Ubig[lev - 1]
        Vb = Vbig[lev - 1]
        blk = p.n_pad // (2 * m)  # child block size at this level
        for j in range(m):
            la, lb = 2 * j * blk, (2 * j + 1) * blk
            Ua = Ub[la: la + blk]
            Va = Vb[la: la + blk]
            Uc = Ub[lb: lb + blk]
            Vc = Vb[lb: lb + blk]
            A = jax.lax.dynamic_update_slice(
                A, Ua @ h.B12s[lev - 1][j] @ Vc.T, (la, lb))
            A = jax.lax.dynamic_update_slice(
                A, Uc @ h.B21s[lev - 1][j] @ Va.T, (lb, la))
    return A


def hss_entry_factors(h: Hss):
    """Precompute per-level entry-evaluation factors for :func:`hss_entries_prepared`.

    Entry ``S[i, j]`` whose (i, j) leaf-pair LCA sits at level ``lev`` equals
    ``U_i B V_j^T`` = ``T[lev][i] . Vbig[lev][j]`` where ``T[lev][i]`` folds the row
    basis and the B generator of i's node (picking B12/B21 by which child i sits
    in).  Computing ``T``/``Vbig`` ONCE per matrix makes every subsequent entry
    extraction two gathers and a dot - the randomized interpolative construction
    evaluates O(depth * rank) blocks of the same operand, and re-materializing
    bases per call dominated both trace size and device FLOPs."""
    p = h.plan
    Ubig, Vbig = materialize_bases(h)
    li = jnp.arange(p.n_pad) // p.ls
    T = []
    for lev in range(1, p.depth + 1):
        node_r = li >> lev
        left_first = ((li >> (lev - 1)) & 1) == 0     # row sits in the left child
        t12 = jnp.einsum("ik,ikl->il", Ubig[lev - 1], h.B12s[lev - 1][node_r])
        t21 = jnp.einsum("ik,ikl->il", Ubig[lev - 1], h.B21s[lev - 1][node_r])
        T.append(jnp.where(left_first[:, None], t12, t21))
    return (h.D, tuple(T), tuple(Vbig))


def hss_entries_prepared(ef, rows: jax.Array, cols: jax.Array) -> jax.Array:
    """Entry extraction ``S[rows[i], cols[j]] -> [len(rows), len(cols)]`` from
    :func:`hss_entry_factors` result (the device equivalent of HssMatrices
    ``getindex`` via generator products)."""
    D, T, V = ef
    ls = D.shape[-1]
    li = rows // ls                                   # leaf of each row
    lj = cols // ls
    out = jnp.zeros((rows.shape[0], cols.shape[0]), dtype=D.dtype)
    # same-leaf pairs: D entries, as two flat gathers (row slab, then column)
    same = li[:, None] == lj[None, :]
    dvals = D.reshape(-1, ls)[rows][:, cols % ls]
    # mask to same-leaf (gathered D is only meaningful there)
    out = jnp.where(same, dvals, out)
    x = (li[:, None] ^ lj[None, :])
    lca = jnp.where(x > 0, jnp.ceil(jnp.log2(x + 1)).astype(jnp.int32), 0)  # 1..depth
    for lev in range(1, len(T) + 1):
        val = T[lev - 1][rows] @ V[lev - 1][cols].T
        out = jnp.where(lca == lev, val, out)
    return out


def hss_entries(h: Hss, rows: jax.Array, cols: jax.Array) -> jax.Array:
    """One-shot entry extraction; for repeated extraction from the same matrix,
    hoist :func:`hss_entry_factors` and call :func:`hss_entries_prepared`."""
    return hss_entries_prepared(hss_entry_factors(h), rows, cols)


# ---------------------------------------------------------------------------
# direct compression of a dense (padded) matrix
# ---------------------------------------------------------------------------

def hss_compress_dense(A: jax.Array, plan: ClusterPlan, atol: float, rtol: float,
                       cap: int) -> Hss:
    """Direct HSS compression with interpolative bases (parity with ``compress``).

    Bottom-up: row/column IDs of the off-diagonal block rows/cols; because the bases
    are interpolative, every coupling block is literally a submatrix of A
    (``B12 = A[J_l, K_r]``), which keeps the scheme identical to the sampling-based
    constructor.
    """
    p = plan
    n = p.n_pad
    nl = p.nleaves
    ls = p.ls
    eye_mask = jnp.eye(nl, dtype=A.dtype)

    # --- leaves ---
    Arows = A.reshape(nl, ls, n)
    blocked = Arows.reshape(nl, ls, nl, ls)
    blocked = blocked * (1.0 - eye_mask[:, None, :, None])     # zero own diag block
    rows_work = blocked.reshape(nl, ls, n)
    J_loc, U, _ = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(rows_work)

    Acols = jnp.swapaxes(A, 0, 1).reshape(nl, ls, n)           # A^T block rows
    blockedc = Acols.reshape(nl, ls, nl, ls) * (1.0 - eye_mask[:, None, :, None])
    cols_work = blockedc.reshape(nl, ls, n)
    K_loc, V, _ = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(cols_work)

    offs = (jnp.arange(nl) * ls)[:, None]
    Jg = jnp.where(J_loc >= 0, J_loc, 0) + offs                # [nl, r] global rows
    Kg = jnp.where(K_loc >= 0, K_loc, 0) + offs
    D = jnp.stack([A[i * ls:(i + 1) * ls, i * ls:(i + 1) * ls] for i in range(nl)])

    Rs, Ws, B12s, B21s = [], [], [], []
    r = U.shape[-1]
    for lev in range(1, p.depth + 1):
        m = p.nleaves >> lev
        Ja = Jg.reshape(m, 2, r)[:, 0]
        Jb = Jg.reshape(m, 2, r)[:, 1]
        Ka = Kg.reshape(m, 2, r)[:, 0]
        Kb = Kg.reshape(m, 2, r)[:, 1]
        B12s.append(A[Ja[:, :, None], Kb[:, None, :]])
        B21s.append(A[Jb[:, :, None], Ka[:, None, :]])
        if lev == p.depth:
            Rs.append(jnp.zeros((2, r, r), dtype=A.dtype))
            Ws.append(jnp.zeros((2, r, r), dtype=A.dtype))
            break
        blk = n // (2 * m)
        # stacked selected rows of the two children, own-node columns zeroed
        rows_sel = A[Jg.reshape(m, 2 * r), :]                   # [m, 2r, n]
        node_col0 = jnp.arange(m) * (2 * blk)
        cmask = (jnp.arange(n)[None, :] >= node_col0[:, None]) & \
                (jnp.arange(n)[None, :] < (node_col0[:, None] + 2 * blk))
        rows_sel = rows_sel * (1.0 - cmask[:, None, :].astype(A.dtype))
        Jsel, T, _ = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(rows_sel)
        Rs.append(T.reshape(m, 2, r, r).reshape(2 * m, r, r))
        Jg = jnp.take_along_axis(Jg.reshape(m, 2 * r), jnp.where(Jsel >= 0, Jsel, 0),
                                 axis=1)

        cols_sel = jnp.swapaxes(A, 0, 1)[Kg.reshape(m, 2 * r), :]
        cols_sel = cols_sel * (1.0 - cmask[:, None, :].astype(A.dtype))
        Ksel, Tw, _ = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(cols_sel)
        Ws.append(Tw.reshape(m, 2, r, r).reshape(2 * m, r, r))
        Kg = jnp.take_along_axis(Kg.reshape(m, 2 * r), jnp.where(Ksel >= 0, Ksel, 0),
                                 axis=1)
    return Hss(D=D, U=U, V=V, Rs=Rs, Ws=Ws, B12s=B12s, B21s=B21s, plan=p)


# ---------------------------------------------------------------------------
# randomized (matrix-free) compression
# ---------------------------------------------------------------------------

class SampleOps(NamedTuple):
    """Matrix-free access to the operator being compressed (the reference's
    ``LinearMap`` closures, factorization.jl:228-235): ``sample(X, adjoint)`` computes
    S@X / S^T@X; ``blocks(rows [p], cols [q]) -> [p, q]`` extracts entries (1-D index
    vectors; batched extraction is vmapped internally)."""

    sample: Callable
    blocks: Callable


def _hss_randcompress_once(ops: SampleOps, plan: ClusterPlan, key, s: int,
                           atol: float, rtol: float, cap: int):
    """One pass of the randomized telescoping interpolative HSS construction
    (parity with HssMatrices ``randcompress``, the reference's compressor at
    factorization.jl:110).

    Leaf bases come from interpolative decomposition of the sketch residual
    ``Y - D Om`` (exact diagonal blocks).  Upper levels run the standard
    telescoping recursion: the candidate row panel of a node is its children's
    *selected sketch-residual rows* minus the (just-extracted, exact)
    sibling-coupling action ``Uloc B12 (V^T Om)`` - all r x s / r x r algebra,
    never an exact n-wide panel.  Couplings ``B12/B21`` are still extracted
    exactly through ``ops.blocks``.  Per-node cost is O(r^2 s) at every level,
    making the whole construction O(n r s) - the previous exact-panel variant
    extracted ``[2r, n]`` blocks per node per level, an O(n^2 r^2 / ls) term
    that grew the compressed factorization back to dense-path scaling
    (round-5 scaling fix; model mirror: profiling._randcompress_flops)."""
    p = plan
    nl, ls, n = p.nleaves, p.ls, p.n_pad
    kO, kP = jax.random.split(key)
    # probe dtype via a tiny block
    probe = ops.blocks(jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    dtype = probe.dtype
    rdt = jnp.real(probe).dtype
    Om = jax.random.normal(kO, (n, s), dtype=rdt).astype(dtype)
    Ps = jax.random.normal(kP, (n, s), dtype=rdt).astype(dtype)
    Y = ops.sample(Om, False)
    Z = ops.sample(Ps, True)

    leaf_rows = jnp.arange(n).reshape(nl, ls)
    D = jax.vmap(lambda rw: ops.blocks(rw, rw))(leaf_rows)      # [nl, ls, ls]

    Oml = Om.reshape(nl, ls, s)
    Psl = Ps.reshape(nl, ls, s)
    Yl = Y.reshape(nl, ls, s) - D @ Oml
    Zl = Z.reshape(nl, ls, s) - jnp.swapaxes(D, -1, -2) @ Psl

    J_loc, U, rku = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(Yl)
    K_loc, V, rkv = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(Zl)
    r = U.shape[-1]
    maxed = jnp.maximum(jnp.max(rku), jnp.max(rkv))

    offs = (jnp.arange(nl) * ls)[:, None]
    Jc = jnp.where(J_loc >= 0, J_loc, 0)
    Kc = jnp.where(K_loc >= 0, K_loc, 0)
    Jg = Jc + offs
    Kg = Kc + offs

    # telescoped per-node state ([m, ...] at the current level):
    # Ysel/Zsel: sketch residual restricted to the selected rows/cols;
    # Uloc/Vloc: the telescoped basis restricted to the selected rows/cols;
    # OmP/PsP:   V^T Om / U^T Ps over the node's span
    Ysel = jnp.take_along_axis(Yl, Jc[:, :, None], axis=1)       # [nl, r, s]
    Zsel = jnp.take_along_axis(Zl, Kc[:, :, None], axis=1)
    Uloc = jnp.take_along_axis(U, Jc[:, :, None], axis=1)        # [nl, r, r]
    Vloc = jnp.take_along_axis(V, Kc[:, :, None], axis=1)
    OmP = jnp.swapaxes(V, -1, -2) @ Oml                   # [nl, r, s]
    PsP = jnp.swapaxes(U, -1, -2) @ Psl

    Rs, Ws, B12s, B21s = [], [], [], []
    for lev in range(1, p.depth + 1):
        m = nl >> lev
        Ja, Jb = Jg.reshape(m, 2, -1)[:, 0], Jg.reshape(m, 2, -1)[:, 1]
        Ka, Kb = Kg.reshape(m, 2, -1)[:, 0], Kg.reshape(m, 2, -1)[:, 1]
        B12 = jax.vmap(ops.blocks)(Ja, Kb)                       # [m, r, r]
        B21 = jax.vmap(ops.blocks)(Jb, Ka)
        B12s.append(B12)
        B21s.append(B21)
        if lev == p.depth:
            Rs.append(jnp.zeros((2, r, r), dtype=dtype))
            Ws.append(jnp.zeros((2, r, r), dtype=dtype))
            break
        pair = lambda A: A.reshape(m, 2, *A.shape[1:])
        Y1, Y2 = pair(Ysel)[:, 0], pair(Ysel)[:, 1]
        Z1, Z2 = pair(Zsel)[:, 0], pair(Zsel)[:, 1]
        U1, U2 = pair(Uloc)[:, 0], pair(Uloc)[:, 1]
        V1, V2 = pair(Vloc)[:, 0], pair(Vloc)[:, 1]
        O1, O2 = pair(OmP)[:, 0], pair(OmP)[:, 1]
        P1, P2 = pair(PsP)[:, 0], pair(PsP)[:, 1]
        B12t = jnp.swapaxes(B12, -1, -2)
        B21t = jnp.swapaxes(B21, -1, -2)
        # candidate panels = selected child residuals minus the (exact)
        # sibling-coupling action: what remains is this node's off-diagonal
        # row/column space sampled by the sketch
        Yp = jnp.concatenate([Y1 - U1 @ (B12 @ O2),
                              Y2 - U2 @ (B21 @ O1)], axis=1)     # [m, 2r, s]
        Zp = jnp.concatenate([Z1 - V1 @ (B21t @ P2),
                              Z2 - V2 @ (B12t @ P1)], axis=1)
        Jsel, T, rkt = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(Yp)
        Ksel, Tw, rkw = jax.vmap(lambda M: interp_decomp(M, atol, rtol, cap))(Zp)
        maxed = jnp.maximum(maxed, jnp.maximum(jnp.max(rkt), jnp.max(rkw)))
        Rs.append(T.reshape(m, 2, r, r).reshape(2 * m, r, r))
        Ws.append(Tw.reshape(m, 2, r, r).reshape(2 * m, r, r))
        Jsc = jnp.where(Jsel >= 0, Jsel, 0)
        Ksc = jnp.where(Ksel >= 0, Ksel, 0)
        Jg = jnp.take_along_axis(Jg.reshape(m, 2 * r), Jsc, axis=1)
        Kg = jnp.take_along_axis(Kg.reshape(m, 2 * r), Ksc, axis=1)
        # parent state: candidate-row basis blockdiag(U1, U2) @ T restricted to
        # the selection; projections combine through the new translations
        Tt, Tb = T[:, :r, :], T[:, r:, :]
        Wt, Wb = Tw[:, :r, :], Tw[:, r:, :]
        Ucand = jnp.concatenate([U1 @ Tt, U2 @ Tb], axis=1)      # [m, 2r, r]
        Vcand = jnp.concatenate([V1 @ Wt, V2 @ Wb], axis=1)
        Uloc = jnp.take_along_axis(Ucand, Jsc[:, :, None], axis=1)
        Vloc = jnp.take_along_axis(Vcand, Ksc[:, :, None], axis=1)
        Ysel = jnp.take_along_axis(Yp, Jsc[:, :, None], axis=1)
        Zsel = jnp.take_along_axis(Zp, Ksc[:, :, None], axis=1)
        OmP = jnp.swapaxes(Wt, -1, -2) @ O1 + jnp.swapaxes(Wb, -1, -2) @ O2
        PsP = jnp.swapaxes(Tt, -1, -2) @ P1 + jnp.swapaxes(Tb, -1, -2) @ P2

    h = Hss(D=D, U=U, V=V, Rs=Rs, Ws=Ws, B12s=B12s, B21s=B21s, plan=p)
    return h, maxed


def hss_randcompress(ops: SampleOps, plan: ClusterPlan, key, atol: float, rtol: float,
                     cap: int, kest: int = -1, stepsize: int = 16,
                     max_tries: int = 3) -> Hss:
    """Adaptive randomized HSS construction (parity with ``randcompress_adaptive``,
    factorization.jl:110): sample with s columns, rebuild with more if any node's
    interpolation rank saturates the sample budget.

    This is the standalone single-operator API (host-driven growth loop; used for
    direct HSS compression and as the correctness oracle in tests).  The fused
    factorization cannot call it - a host-synchronizing retry loop cannot live
    inside one traced program - so structured batches use the one-shot
    :func:`hss_randcompress_batched` at the planned cap and recover the same
    adaptivity at whole-factorization granularity (``SolverOptions.adaptive``:
    replan with doubled caps on reported saturation, factor.py)."""
    s = (kest if kest > 0 else max(cap // 2, 16)) + stepsize
    h = None
    for t in range(max_tries):
        s_eff = min(s, plan.n_pad)
        h, maxed = _hss_randcompress_once(ops, plan, jax.random.fold_in(key, t),
                                          s_eff, atol, rtol, cap)
        if int(maxed) < min(s_eff - stepsize // 2, cap) or s_eff >= plan.n_pad \
                or int(maxed) >= cap:
            break
        s = 2 * s
    return h


def hss_randcompress_batched(sample: Callable, blocks: Callable, operands, plan, key,
                             atol: float, rtol: float, cap: int, kest: int = -1,
                             stepsize: int = 16, max_tries: int = 3):
    """Batched adaptive randomized construction: ``operands`` is a pytree with leading
    batch dim B; ``sample(op_slice, X, adjoint)`` / ``blocks(op_slice, rows, cols)``
    receive one un-batched slice.  Returns ``(Hss, maxed [B])`` where the Hss arrays
    carry a leading B axis (use with vmapped hss_* ops) and ``maxed`` is each node's
    largest interpolation rank - ``maxed >= cap`` flags rank saturation (the event
    the reference's ``randcompress_adaptive`` growth loop reacts to,
    factorization.jl:110); callers surface it for the host-side replan-with-larger-cap
    loop (hsolve.factor.factor with adaptive=True)."""
    from functools import partial

    # sample once with s >= cap + slack: interpolation ranks are capped at ``cap``
    # anyway, so growing s past that cannot reveal more - the reference's
    # kest/stepsize adaptivity folds into the planner's static cap choice (each
    # extra sample-width here is one more whole-program compile, which dominates)
    slack = max(stepsize, 8)
    s = max(kest + slack if kest > 0 else 0, cap + slack)
    s_eff = min(s, plan.n_pad)
    B = len(jax.tree_util.tree_leaves(operands)[0])
    keys = jax.random.split(key, B)

    def once(op, k):
        ops = SampleOps(sample=partial(sample, op), blocks=partial(blocks, op))
        return _hss_randcompress_once(ops, plan, k, s_eff, atol, rtol, cap)

    h, maxed = jax.vmap(once)(operands, keys)
    return h, maxed


# ---------------------------------------------------------------------------
# telescoping Woodbury factorization (the ULV-solve equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HssSolver:
    """Factored form of an HSS matrix: leaf LU + one rank-2r Woodbury correction per
    level.  ``solve`` costs one batched GEMM pair per level (parity with the
    reference's ULV ``\\`` at blockmatrix.jl:139-142, factornode.jl:72)."""

    h: Hss
    D_lu: jax.Array
    D_piv: jax.Array
    Phis: List[jax.Array]        # level l: [n_pad, r]  (A_child^{-1} Uhat_child)
    cores_lu: List[jax.Array]    # level l: [m, 2r, 2r]
    cores_piv: List[jax.Array]
    # adjoint-solve data
    PhisT: List[jax.Array]
    coresT_lu: List[jax.Array]
    coresT_piv: List[jax.Array]


jax.tree_util.register_dataclass(
    HssSolver,
    data_fields=["h", "D_lu", "D_piv", "Phis", "cores_lu", "cores_piv",
                 "PhisT", "coresT_lu", "coresT_piv"],
    meta_fields=[])


def _upsweep(h: Hss, Y: jax.Array, to_level: int, adjoint: bool) -> jax.Array:
    """V_hat^T Y (or U_hat^T Y) per node at ``to_level``: [m, r, k]."""
    p = h.plan
    k = Y.shape[-1]
    base = h.V if not adjoint else h.U
    Ws = h.Ws if not adjoint else h.Rs
    xi = jnp.swapaxes(base, -1, -2) @ Y.reshape(p.nleaves, p.ls, k)
    for i in range(to_level):
        W = Ws[i]
        comb = jnp.swapaxes(W, -1, -2) @ xi
        xi = comb.reshape(-1, 2, *comb.shape[1:]).sum(axis=1)
    return xi


def _leaf_solve(sol: "HssSolver", X: jax.Array, adjoint: bool) -> jax.Array:
    p = sol.h.plan
    k = X.shape[-1]
    Xl = X.reshape(p.nleaves, p.ls, k)
    if not adjoint:
        Yl = dk.lu_solve(sol.D_lu, sol.D_piv, Xl)
    else:
        Yl = jnp.swapaxes(
            dk.lu_solve_right(sol.D_lu, sol.D_piv, jnp.swapaxes(Xl, -1, -2)), -1, -2)
    return Yl.reshape(p.n_pad, k)


def _apply_level_correction(sol: "HssSolver", Y: jax.Array, lev: int,
                            adjoint: bool) -> jax.Array:
    """One Woodbury correction: Y <- Y - Phi (Btilde M^{-1} (Vtilde^T Y))."""
    h = sol.h
    p = h.plan
    r = h.r
    k = Y.shape[-1]
    m = p.level_nodes(lev)
    xi = _upsweep(h, Y, lev - 1, adjoint)                   # [2m, r, k]
    xi2 = xi.reshape(m, 2, r, k)
    if not adjoint:
        B12, B21 = h.B12s[lev - 1], h.B21s[lev - 1]
        eta = jnp.concatenate([B12 @ xi2[:, 1], B21 @ xi2[:, 0]], axis=1)  # [m,2r,k]
        w = dk.lu_solve(sol.cores_lu[lev - 1], sol.cores_piv[lev - 1], eta)
        Phi = sol.Phis[lev - 1]
    else:
        B12t = jnp.swapaxes(h.B12s[lev - 1], -1, -2)
        B21t = jnp.swapaxes(h.B21s[lev - 1], -1, -2)
        eta = jnp.concatenate([B21t @ xi2[:, 1], B12t @ xi2[:, 0]], axis=1)
        w = dk.lu_solve(sol.coresT_lu[lev - 1], sol.coresT_piv[lev - 1], eta)
        Phi = sol.PhisT[lev - 1]
    blk = p.n_pad // (2 * m)
    Yb = Y.reshape(2 * m, blk, k)
    Phib = Phi.reshape(2 * m, blk, r)
    w2 = w.reshape(2 * m, r, k)
    return (Yb - Phib @ w2).reshape(p.n_pad, k)


def _solve_upto(sol: "HssSolver", X: jax.Array, upto: int, adjoint: bool) -> jax.Array:
    Y = _leaf_solve(sol, X, adjoint)
    for lev in range(1, upto + 1):
        Y = _apply_level_correction(sol, Y, lev, adjoint)
    return Y


def hss_factor(h: Hss) -> HssSolver:
    """Build the telescoping Woodbury factorization, bottom-up: at each level, apply
    the already-built lower solver to the materialized child bases, then LU the 2r x 2r
    Woodbury cores."""
    p = h.plan
    r = h.r
    D_lu, D_piv = dk.lu_factor(h.D)
    sol = HssSolver(h=h, D_lu=D_lu, D_piv=D_piv, Phis=[], cores_lu=[], cores_piv=[],
                    PhisT=[], coresT_lu=[], coresT_piv=[])
    Ubig, Vbig = materialize_bases(h)
    eye = jnp.eye(2 * r, dtype=h.D.dtype)
    for lev in range(1, p.depth + 1):
        m = p.level_nodes(lev)
        Phi = _solve_upto(sol, Ubig[lev - 1], lev - 1, adjoint=False)
        PhiT = _solve_upto(sol, Vbig[lev - 1], lev - 1, adjoint=True)
        G = _upsweep(h, Phi, lev - 1, adjoint=False)        # [2m, r, r] V^T Phi
        GT = _upsweep(h, PhiT, lev - 1, adjoint=True)       # [2m, r, r] U^T PhiT
        G2 = G.reshape(m, 2, r, r)
        GT2 = GT.reshape(m, 2, r, r)
        B12, B21 = h.B12s[lev - 1], h.B21s[lev - 1]
        # apply uses w = (I + Btilde G)^{-1} (Btilde xi), so the core is
        # M = I + Btilde G = I + [[0, B12 G_b],[B21 G_a, 0]]
        top = jnp.concatenate([jnp.zeros((m, r, r), h.D.dtype), B12 @ G2[:, 1]], -1)
        bot = jnp.concatenate([B21 @ G2[:, 0], jnp.zeros((m, r, r), h.D.dtype)], -1)
        M = eye + jnp.concatenate([top, bot], axis=-2)
        # adjoint core: N = I + Btilde^T GT = I + [[0, B21^T GT_b],[B12^T GT_a, 0]]
        topT = jnp.concatenate([jnp.zeros((m, r, r), h.D.dtype),
                                jnp.swapaxes(B21, -1, -2) @ GT2[:, 1]], -1)
        botT = jnp.concatenate([jnp.swapaxes(B12, -1, -2) @ GT2[:, 0],
                                jnp.zeros((m, r, r), h.D.dtype)], -1)
        N = eye + jnp.concatenate([topT, botT], axis=-2)
        M_lu, M_piv = dk.lu_factor(M)
        N_lu, N_piv = dk.lu_factor(N)
        sol.Phis.append(Phi)
        sol.cores_lu.append(M_lu)
        sol.cores_piv.append(M_piv)
        sol.PhisT.append(PhiT)
        sol.coresT_lu.append(N_lu)
        sol.coresT_piv.append(N_piv)
    return sol


def hss_solve(sol: HssSolver, b: jax.Array, adjoint: bool = False) -> jax.Array:
    """x = A^{-1} b (or A^{-T} b) for b [n_pad, k]."""
    return _solve_upto(sol, b, sol.h.plan.depth, adjoint)
