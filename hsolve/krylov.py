"""Restarted GMRES with right preconditioning.

Capability parity with the reference's Krylov integration
(``IterativeSolvers.gmres(A, b; Pr=F, reltol, restart, maxiter, log)`` at
``/root/reference/test/rungmres.jl:47-48``): restarted GMRES(restart) whose right
preconditioner is applied as a callable (our :class:`hsolve.factor.Factorization`),
with a per-iteration residual-norm history.

Implementation: modified Gram-Schmidt Arnoldi + Givens rotations, so the residual norm
is tracked without extra matvecs.  The O(n) work (matvec, preconditioner, MGS) runs on
device; the O(restart^2) Hessenberg bookkeeping is a host loop on tiny arrays.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np


def _givens(a, b):
    """Complex-safe Givens pair (cs, sn) zeroing b: apply as
    [cs, sn; -conj(sn), cs] @ [a; b] = [r; 0]."""
    denom = np.sqrt(abs(a) ** 2 + abs(b) ** 2)
    if denom == 0.0:
        return 1.0, 0.0 * a
    if abs(a) == 0.0:
        return 0.0, b / abs(b) if abs(b) else 0.0
    cs = abs(a) / denom
    sn = (a * np.conj(b)) / (abs(a) * denom)
    return cs, sn


def gmres(matvec: Callable, b: jax.Array, M: Optional[Callable] = None,
          x0: Optional[jax.Array] = None, reltol: float = 1e-9, abstol: float = 0.0,
          restart: int = 30, maxiter: Optional[int] = None):
    """Solve ``A x = b`` with right-preconditioned restarted GMRES.

    matvec: ``v -> A v``; M: ``v -> M^{-1} v`` (right preconditioner).
    Returns ``(x, info)``: ``info['resnorm']`` holds the initial residual norm followed
    by one entry per inner iteration; ``info['iters']``; ``info['converged']``.
    """
    b = jnp.asarray(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = restart
    if M is None:
        M = lambda v: v
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    have_x = x0 is not None

    scalar = np.complex128 if jnp.iscomplexobj(b) else np.float64
    bnorm = float(jnp.linalg.norm(b))
    tol = max(reltol * bnorm, abstol)
    history: List[float] = []
    iters = 0
    converged = False

    while iters < maxiter and not converged:
        r = b - matvec(x) if (have_x or iters > 0) else b
        beta = float(jnp.linalg.norm(r))
        if iters == 0:
            history.append(beta)
        if beta <= tol:
            converged = True
            break
        m = min(restart, maxiter - iters)
        V = jnp.zeros((m + 1, n), dtype=b.dtype).at[0].set(r / beta)
        H = np.zeros((m + 1, m), dtype=scalar)
        cs = np.ones(m, dtype=np.float64)
        sn = np.zeros(m, dtype=scalar)
        g = np.zeros(m + 1, dtype=scalar)
        g[0] = beta
        j_done = 0
        for j in range(m):
            w = matvec(M(V[j]))
            w, hcol = _mgs(V, w, j)
            hj = np.asarray(hcol).astype(scalar)
            hnorm = float(jnp.linalg.norm(w))
            H[: j + 1, j] = hj[: j + 1]
            H[j + 1, j] = hnorm
            if hnorm > 0:
                V = V.at[j + 1].set(w / hnorm)
            for i in range(j):  # apply accumulated rotations
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            cs[j], sn[j] = _givens(H[j, j], H[j + 1, j])
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = cs[j] * g[j]
            j_done = j + 1
            res = abs(g[j + 1])
            history.append(float(res))
            if res <= tol:
                break
        if j_done:
            y = np.linalg.solve(H[:j_done, :j_done], g[:j_done])
            upd = jnp.tensordot(jnp.asarray(y, dtype=b.dtype), V[:j_done], axes=1)
            x = x + M(upd)
            have_x = True
        iters += j_done
        # the Givens estimate drifts when M is applied in lower precision; declare
        # convergence only on the true residual (this also makes restarted cycles act
        # as iterative refinement around a reduced-precision preconditioner)
        true_res = float(jnp.linalg.norm(b - matvec(x)))
        history[-1] = true_res
        converged = bool(true_res <= tol)

    info = {"resnorm": np.asarray(history, dtype=np.float64), "iters": iters,
            "converged": converged}
    return x, info


_IDENTITY_M = lambda data, v: v


def gmres_compiled(matvec: Callable, M: Optional[Callable], b: jax.Array,
                   reltol: float = 1e-9, restart: int = 30,
                   maxiter: Optional[int] = None, M_data=None, mv_data=None,
                   m_eps: float = 0.0, inner_dtype=None, mv_data_inner=None,
                   fetch_info: bool = True, escalate: bool = True):
    """Fully-jitted restarted GMRES: the entire solve (restart cycles, Arnoldi, Givens
    bookkeeping, convergence tests) runs as one device program - no host round-trips
    per iteration.  Semantics match :func:`gmres` (right preconditioning, true-residual
    restart checks); returns (x, info dict with 'iters', 'resnorm', 'converged').

    The *functions* ``matvec``/``M`` are static jit keys - keep them stable across
    calls and pass varying operator state through ``mv_data``/``M_data`` (the callables
    then take ``(data, v)``), so re-solving with a new factorization reuses the
    compiled program.

    Mixed precision (optional): pass ``inner_dtype='float32'`` (+ an f32
    ``mv_data_inner``) to run the Arnoldi cycles - basis, orthogonalization, inner
    matvecs - in f32 while the solution update, residual and convergence test stay
    in ``b.dtype`` (f64).  The inner cycles then move half the bytes.  The
    true-residual restart check makes the outer loop behave as iterative
    refinement, so reltol ~1e-9 targets are still reached; with ``escalate`` an
    outer-precision phase finishes what the f32 cycles cannot.  Set ``m_eps``
    around the inner dtype's epsilon (e.g. 1e-6) so a cycle restarts once its
    Givens estimate falls below what the reduced-precision basis can deliver.
    """
    if maxiter is None:
        maxiter = restart
    mv_fn = matvec if mv_data is not None else (lambda _d, v: matvec(v))
    if M is None:
        m_fn = _IDENTITY_M
    elif M_data is not None:
        m_fn = M
    else:
        m_fn = lambda _d, v: M(v)
    # the Givens estimate can stop an inner cycle early (it drifts when M runs in
    # reduced precision); the outer true-residual loop then restarts - budget up to
    # maxiter cycles (a done flag makes finished cycles free), so the total work is
    # still capped at ~maxiter preconditioned matvecs
    ncycles = int(maxiter)
    idt = None if inner_dtype is None else jnp.dtype(inner_dtype).name
    # trace at full f32 matmul accuracy: at default precision the f32 sweeps and
    # CGS2 orthogonalization may run in TF32 on the GPU and lose further digits
    with jax.default_matmul_precision("highest"):
        if idt is not None and escalate:
            x, iters, hist, res, bnorm = _gmres_escalated(
                mv_fn, m_fn, mv_data, M_data, jnp.asarray(b), float(reltol),
                restart, int(ncycles), int(maxiter), float(m_eps),
                mv_data_inner, idt)
        else:
            x, iters, hist, res, bnorm = _gmres_cycles(
                mv_fn, m_fn, mv_data, M_data, jnp.asarray(b), float(reltol),
                restart, int(ncycles), int(maxiter), float(m_eps),
                mv_data_inner, idt)
    if not fetch_info:
        # deferred-fetch mode: x and the raw device scalars come back immediately;
        # the caller blocks on x (the solve result) and fetches diagnostics later,
        # outside whatever it times
        return x, {"_device": (iters, hist, res, bnorm), "reltol": reltol}
    # one consolidated device->host fetch (dispatch round-trips dominate small solves)
    iters, hist, res, bnorm = jax.device_get((iters, hist, res, bnorm))
    iters = int(iters)
    info = {"resnorm": np.asarray(hist)[: iters + 1], "iters": iters,
            "converged": bool(res <= max(reltol * float(bnorm), 0.0))}
    return x, info


def fetch_gmres_info(info: dict) -> dict:
    """Resolve a ``fetch_info=False`` result from :func:`gmres_compiled` into the
    standard info dict (performs the deferred device->host fetch)."""
    if "_device" not in info:
        return info
    iters, hist, res, bnorm = jax.device_get(info["_device"])
    iters = int(iters)
    return {"resnorm": np.asarray(hist)[: iters + 1], "iters": iters,
            "converged": bool(res <= max(info["reltol"] * float(bnorm), 0.0))}


@partial(jax.jit, static_argnames=("mv_fn", "m_fn", "restart", "ncycles", "maxiter",
                                   "inner_dtype"))
def _gmres_cycles(mv_fn, m_fn, mv_data, M_data, b, reltol, restart, ncycles, maxiter,
                  m_eps=0.0, mv_data_inner=None, inner_dtype=None):
    # m_eps: trust floor for the in-cycle Givens residual estimate, relative to the
    # cycle's starting residual.  With a reduced-precision preconditioner the estimate
    # keeps dropping below what the computed basis can actually deliver; restarting at
    # the floor turns the outer loop into iterative refinement instead of burning the
    # iteration budget inside one fictitious cycle.
    matvec = lambda v: mv_fn(mv_data, v)
    mv_in = mv_data if mv_data_inner is None else mv_data_inner
    matvec_i = lambda v: mv_fn(mv_in, v)
    M = lambda v: m_fn(M_data, v)
    from jax import lax

    n = b.shape[0]
    odtype = b.dtype                      # outer: solution, residuals, tolerances
    dtype = odtype if inner_dtype is None else jnp.dtype(inner_dtype)
    rdtype = jnp.zeros((), dtype).real.dtype
    ordtype = jnp.zeros((), odtype).real.dtype
    m = restart
    bnorm = jnp.linalg.norm(b)
    tol = (reltol * bnorm).astype(ordtype)

    def inner_body(st):
        V, H, cs, sn, g, j, res, it = st
        w = matvec_i(M(V[j]))
        mask = (jnp.arange(m + 1) <= j).astype(dtype)

        # CGS2 (classical Gram-Schmidt, twice): two GEMV pairs instead of a
        # sequential MGS scan - the orthogonalization runs as matrix-vector
        # products and keeps MGS-grade orthogonality (Giraud et al.)
        h1 = (jnp.conj(V) @ w) * mask
        w = w - V.T @ h1
        h2 = (jnp.conj(V) @ w) * mask
        w = w - V.T @ h2
        hcol = h1 + h2

        hnorm = jnp.linalg.norm(w).astype(rdtype)
        V = V.at[j + 1].set(w / jnp.where(hnorm > 0, hnorm, 1.0).astype(dtype))
        hcol = hcol.at[j + 1].set(hnorm.astype(dtype))

        def rot(hc, i):
            apply = (i < j)
            t = cs[i] * hc[i] + sn[i] * hc[i + 1]
            lo = -jnp.conj(sn[i]) * hc[i] + cs[i] * hc[i + 1]
            hc = hc.at[i].set(jnp.where(apply, t, hc[i]))
            hc = hc.at[i + 1].set(jnp.where(apply, lo, hc[i + 1]))
            return hc, None

        hcol, _ = lax.scan(rot, hcol, jnp.arange(m))
        a_, b_ = hcol[j], hcol[j + 1]
        denom = jnp.sqrt(jnp.abs(a_) ** 2 + jnp.abs(b_) ** 2)
        safe = denom > 0
        absa = jnp.abs(a_)
        cs_j = jnp.where(safe, jnp.where(absa > 0, absa / denom, 0.0), 1.0)
        sn_j = jnp.where(
            safe & (absa > 0),
            (a_ * jnp.conj(b_)) / jnp.maximum(absa * denom,
                                              jnp.finfo(rdtype).tiny),
            jnp.where(safe, 1.0, 0.0).astype(dtype))
        hcol = hcol.at[j].set(cs_j * a_ + sn_j * b_).at[j + 1].set(0.0)
        H = H.at[:, j].set(hcol)
        cs = cs.at[j].set(cs_j.astype(rdtype))
        sn = sn.at[j].set(sn_j)
        gj1 = -jnp.conj(sn_j) * g[j]
        g = g.at[j + 1].set(gj1).at[j].set(cs_j * g[j])
        res_new = jnp.abs(gj1)
        return V, H, cs, sn, g, j + 1, res_new, it

    def make_inner_cond(floor):
        def inner_cond(st):
            _, _, _, _, _, j, res, it = st
            return (j < m) & (res > floor) & (it + j < maxiter)
        return inner_cond

    def cycle(carry):
        x, r, beta, it, hist, done, cyc = carry

        def run(carry):
            x, r, beta, it, hist, _, cyc = carry
            # r, beta carried from the previous cycle's true-residual check: one
            # outer-precision matvec per cycle, not two
            beta_i = beta.astype(rdtype)
            V = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(
                (r / jnp.where(beta > 0, beta, 1.0)).astype(dtype))
            H = jnp.zeros((m + 1, m), dtype=dtype)
            cs = jnp.ones((m,), dtype=rdtype)
            sn = jnp.zeros((m,), dtype=dtype)
            g = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta_i.astype(dtype))
            st = (V, H, cs, sn, g, 0, beta_i, it)
            floor = jnp.maximum(tol.astype(rdtype), m_eps * beta_i)
            V, H, cs, sn, g, j, res, _ = lax.while_loop(
                make_inner_cond(floor), inner_body, st)
            # y = H[:m,:m]^{-1} g ; mask columns past j with identity
            colmask = (jnp.arange(m) < j)
            Hm = jnp.where(colmask[None, :], H[:m, :m], 0.0)
            Hm = Hm + jnp.diag(jnp.where(colmask, 0.0, 1.0).astype(dtype))
            gm = jnp.where(colmask, g[:m], 0.0)
            y = jax.scipy.linalg.solve_triangular(Hm, gm, lower=False)
            upd = jnp.tensordot(y, V[:m], axes=1)
            x = x + M(upd).astype(odtype)
            it = it + j
            r_new = b - matvec(x)
            beta_new = jnp.linalg.norm(r_new)
            hist = hist.at[it].set(beta_new.astype(ordtype))
            return x, r_new, beta_new, it, hist, \
                (beta_new <= tol) | (it >= maxiter) | (j == 0), cyc + 1

        return run(carry)

    hist0 = jnp.zeros((maxiter + 1,), dtype=ordtype).at[0].set(bnorm.astype(ordtype))
    carry0 = (jnp.zeros_like(b), b, bnorm, 0, hist0, bnorm <= tol, 0)
    # while-loop over restart cycles: converged solves never touch the remaining
    # cycle budget (a scan-of-conds pays per skipped cycle; measured ~40us each)
    x, r, beta, it, hist, done, _ = lax.while_loop(
        lambda c: (~c[5]) & (c[6] < ncycles), cycle, carry0)
    return x, it, hist, beta.astype(ordtype), bnorm


@partial(jax.jit, static_argnames=("mv_fn", "m_fn", "restart", "ncycles",
                                   "maxiter", "inner_dtype"))
def _gmres_escalated(mv_fn, m_fn, mv_data, M_data, b, reltol, restart, ncycles,
                     maxiter, m_eps, mv_data_inner, inner_dtype):
    """Reduced-precision cycles + outer-precision residual phase, as ONE program.

    Precision escalation: reduced-precision Arnoldi cycles have a true-residual
    floor set by the inner dtype's rounding - near-resonant systems (helmholtz
    h=512, k=40) stall around 5e-2 in f32 no matter the preconditioner quality,
    while the SAME f32 preconditioner converges in ~26 outer-precision
    iterations (measured; an earlier bf16-matmul-precision theory did not
    survive a CPU reproduction with exact f32 matmuls).  Phase 2 solves the
    residual system in outer precision; when phase 1 already converged its
    cycle loop exits on the initial done flag, so the escalation costs one
    matvec.  Fused into one jitted program (one dispatch per solve)."""
    x, iters, hist, res, bnorm = _gmres_cycles(
        mv_fn, m_fn, mv_data, M_data, b, reltol, restart, ncycles, maxiter,
        m_eps, mv_data_inner, inner_dtype)
    r1 = b - mv_fn(mv_data, x)
    beta1 = jnp.linalg.norm(r1)
    reltol2 = (reltol * bnorm) / jnp.where(beta1 > 0, beta1, 1.0)
    x2, it2, hist2, res2, _ = _gmres_cycles(
        mv_fn, m_fn, mv_data, M_data, r1, reltol2, restart, ncycles, maxiter,
        0.0, None, None)
    x = x + x2.astype(x.dtype)
    # history: phase-2 entries appended after the phase-1 block (entry indices
    # restart at the block boundary; iters remains the true count); res2 is the
    # absolute final residual on the same scale as phase 1
    return x, iters + it2, jnp.concatenate([hist, hist2[1:]]), res2, bnorm


@jax.jit
def _mgs_step(V, w, mask):
    """Masked modified Gram-Schmidt of w against the rows of V."""
    def body(carry, vm):
        w = carry
        v, mk = vm
        h = jnp.vdot(v, w) * mk
        return w - h * v, h

    w, h = jax.lax.scan(body, w, (V, mask))
    return w, h


def _mgs(V: jax.Array, w: jax.Array, j: int):
    """Orthogonalize w against V[0..j] on device; returns (w_orth, coefficients)."""
    mask = (jnp.arange(V.shape[0]) <= j).astype(jnp.real(w).dtype)
    return _mgs_step(V, w, mask)
