"""Fully-structured quasilinear path: HSS Schur complements end-to-end.

Checks that deep compression actually routes through the structured extend-add
(children kept in HSS form, no densification) and that the resulting preconditioner
reaches the reference's accuracy model (GMRES iteration counts track the compression
tolerance; test/rungmres.jl semantics)."""

import numpy as np
import pytest

import hsolve
from hsolve import (SolverOptions, ell_matvec, factor, gmres, helmholtz2d,
                    nested_dissection, poisson2d, to_ell)
from hsolve.planner import plan_factorization


def _setup(n=65, leafmax=60, **kw):
    A, b, shape = poisson2d(n)
    tree = nested_dissection(shape, leafmax=leafmax)
    opts = SolverOptions(**kw)
    plan = plan_factorization(A, tree, opts)
    return A, b, tree, opts, plan


def test_structured_batches_planned():
    A, b, tree, opts, plan = _setup(swlevel=-4, swsize=8, atol=1e-6, rtol=1e-6,
                                    leafsize=16)
    kinds = [(bp.compress, bp.structured) for bp in plan.batches]
    assert any(c and not s for c, s in kinds)   # transition level exists
    assert any(s for _, s in kinds)             # structured levels exist


def test_structured_solve_accuracy():
    A, b, tree, opts, plan = _setup(swlevel=-4, swsize=8, atol=1e-8, rtol=1e-8,
                                    leafsize=16)
    from hsolve.factor import factor_with_plan

    F = factor_with_plan(plan, opts)
    x = np.asarray(F.solve(b))
    import scipy.sparse.linalg as spla

    x_ref = spla.spsolve(A.tocsc(), b)
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-5


def test_structured_preconditioner_gmres_iters():
    A, b, shape = helmholtz2d(65, k=15.0)
    tree = nested_dissection(shape, leafmax=60)
    F = factor(A, tree, swlevel=-4, swsize=8, atol=1e-4, rtol=1e-4, leafsize=16)
    assert any(getattr(lev, "h1", None) is not None and
               type(lev).__name__ == "StructuredLevel" for lev in F.levels)
    ell = to_ell(A)
    x, info = gmres(lambda v: ell_matvec(ell, v), np.asarray(b), M=F.solve,
                    reltol=1e-9, restart=30, maxiter=90)
    res = np.linalg.norm(A @ np.asarray(x) - np.asarray(b)) / np.linalg.norm(b)
    assert info["converged"] and res < 1e-9
    assert info["iters"] <= 20


def test_structured_planner_pooled_matches_fallback(monkeypatch):
    """The vectorized pooled structured-batch planner must produce exactly the
    same batch data as the per-node fallback loop (which runs when symfact's
    native pooled path is unavailable)."""
    import numpy as np
    import hsolve
    from hsolve.planner import plan_factorization
    from hsolve.utils import trees as trees_mod

    A, b, shape = hsolve.helmholtz2d(48, k=15.0)
    opts = hsolve.SolverOptions(swlevel=-3, swsize=1, atol=1e-4, rtol=1e-4)

    def build():
        tree = hsolve.nested_dissection(shape, leafmax=60)
        return plan_factorization(A, tree, opts)

    plan_pooled = build()
    monkeypatch.setattr(trees_mod, "_symfact_native",
                        lambda *a, **k: None)
    plan_loop = build()

    sb_p = [bp for bp in plan_pooled.batches if bp.structured]
    sb_l = [bp for bp in plan_loop.batches if bp.structured]
    assert sb_p and len(sb_p) == len(sb_l)
    for bp, bl in zip(sb_p, sb_l):
        np.testing.assert_array_equal(bp.int_ids, bl.int_ids)
        np.testing.assert_array_equal(bp.bnd_ids, bl.bnd_ids)
        np.testing.assert_array_equal(bp.smap, bl.smap)
        for k in ("ni1", "ni2", "nb1", "nb2"):
            np.testing.assert_array_equal(bp.cross[k], bl.cross[k])
        for name in ("ci12", "ci21", "cib12", "cib21",
                     "cbi12", "cbi21", "cbb12", "cbb21"):
            sp, sl = bp.cross[name], bl.cross[name]
            assert (sp["rcap"], sp["r"], sp["c"]) == (sl["rcap"], sl["r"], sl["c"])
            np.testing.assert_array_equal(sp["rows"], sl["rows"])
            op, ol = np.argsort(sp["pos"]), np.argsort(sl["pos"])
            np.testing.assert_array_equal(sp["pos"][op], sl["pos"][ol])
            np.testing.assert_allclose(sp["vals"][op], sl["vals"][ol], rtol=1e-15)


def test_structured_siblings_with_unequal_generator_widths():
    """At h=96 with swsize=64, leafsize=32 some structured batches join children
    whose HSS generator widths differ (their clusters differ in size); each
    child keeps its own column group in the Gauss transforms, and the
    preconditioner converges."""
    import jax.numpy as jnp

    A, b, shape = helmholtz2d(96, k=40.0)
    b = np.asarray(b)
    tree = nested_dissection(shape, leafmax=100)
    F = factor(A, tree, swlevel=-2, swsize=64, atol=1e-2, rtol=1e-2, kest=200,
               stepsize=100, leafsize=32)
    assert any(type(lev).__name__ == "StructuredLevel" for lev in F.levels)
    op = hsolve.spmv_format(A)[0]
    x, info = hsolve.gmres_compiled(
        hsolve.spmv, hsolve.precondition_with_data, jnp.asarray(b),
        reltol=1e-9, restart=30, maxiter=60, mv_data=op, M_data=F.solve_data)
    relres = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert info["converged"] and info["iters"] <= 15 and relres < 1e-9
