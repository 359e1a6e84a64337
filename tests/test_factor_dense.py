"""Dense exact multifrontal path: factorization must be a direct solver.

Parity model: the reference's exact mode (``factor(A, nd, nd_loc; swlevel=0)``,
test/rungmres.jl:32) applied via ``ldiv!`` must reproduce ``A \\ b``."""

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from hsolve import (SolverOptions, factor, gmres, helmholtz2d, nested_dissection,
                    poisson2d, poisson3d, to_ell, ell_matvec)


@pytest.mark.parametrize("n,leafmax", [(9, 12), (17, 20), (33, 40)])
def test_exact_factor_matches_direct_solve(n, leafmax):
    A, b, shape = poisson2d(n)
    tree = nested_dissection(shape, leafmax=leafmax)
    F = factor(A, tree, swlevel=0)
    x = np.asarray(F.solve(b))
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_exact_factor_helmholtz():
    A, b, shape = helmholtz2d(33, k=20.0)
    tree = nested_dissection(shape, leafmax=40)
    F = factor(A, tree, swlevel=0)
    x = np.asarray(F.solve(b))
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-9


def test_exact_factor_3d():
    A, b, shape = poisson3d(9)
    tree = nested_dissection(shape, leafmax=40)
    F = factor(A, tree, swlevel=0)
    x = np.asarray(F.solve(b))
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_multiple_rhs():
    A, b, shape = poisson2d(17)
    tree = nested_dissection(shape, leafmax=20)
    F = factor(A, tree, swlevel=0)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((A.shape[0], 3))
    X = np.asarray(F.solve(B))
    X_ref = spla.spsolve(A.tocsc(), B)
    assert np.linalg.norm(X - X_ref) / np.linalg.norm(X_ref) < 1e-10


def test_single_leaf_tree():
    """A tree with a single (root) leaf: the whole matrix is one front."""
    A, b, shape = poisson2d(7)
    tree = nested_dissection(shape, leafmax=10_000)
    assert tree.nnodes == 1
    F = factor(A, tree, swlevel=0)
    x = np.asarray(F.solve(b))
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_factor_twice_same_tree():
    """Planning must not mutate the caller's tree (regression: re-factoring with the
    same tree object corrupted the second plan)."""
    A, b, shape = poisson2d(17)
    tree = nested_dissection(shape, leafmax=20)
    x1 = np.asarray(factor(A, tree, swlevel=0).solve(b))
    x2 = np.asarray(factor(A, tree, swlevel=0).solve(b))
    assert np.allclose(x1, x2)


def test_gmres_with_exact_preconditioner():
    """Parity with rungmres.jl:47: an exact factorization as right preconditioner
    converges in ~1 iteration."""
    A, b, shape = poisson2d(17)
    tree = nested_dissection(shape, leafmax=20)
    F = factor(A, tree, swlevel=0)
    ell = to_ell(A)
    x, info = gmres(lambda v: ell_matvec(ell, v), np.asarray(b),
                    M=F.solve, reltol=1e-9, restart=30, maxiter=30)
    assert info["converged"]
    assert info["iters"] <= 2
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-9


def test_gmres_compiled_matches_host_gmres():
    from hsolve import gmres_compiled

    A, b, shape = poisson2d(17)
    tree = nested_dissection(shape, leafmax=20)
    F = factor(A, tree, swlevel=0)
    ell = to_ell(A)
    mv = jax.jit(lambda v: ell_matvec(ell, v))
    x, info = gmres_compiled(mv, F.solve, np.asarray(b), reltol=1e-9, restart=30,
                             maxiter=30)
    assert info["converged"] and info["iters"] <= 2
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-9
    # unpreconditioned, multiple restart cycles
    x2, info2 = gmres_compiled(mv, None, np.asarray(b), reltol=1e-8, restart=20,
                               maxiter=100)
    res2 = np.linalg.norm(A @ np.asarray(x2) - b) / np.linalg.norm(b)
    assert res2 < 1e-6


def test_gmres_unpreconditioned_logs_history():
    A, b, shape = poisson2d(9)
    ell = to_ell(A)
    x, info = gmres(lambda v: ell_matvec(ell, v), np.asarray(b),
                    reltol=1e-8, restart=30, maxiter=90)
    assert info["resnorm"][0] > info["resnorm"][-1]
    res = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert res < 1e-6


def test_regular_planner_consolidated_matches_fallback(monkeypatch):
    """The consolidated native batch planner (gather.cpp plan_batch: segment
    table + masked front gather + identity padding + device-map fills in one
    call) must produce exactly the same batch data as the numpy fallback path
    (which runs when symfact's native pooled layout is unavailable)."""
    import hsolve
    from hsolve.planner import plan_factorization
    from hsolve.utils import trees as trees_mod

    A, b, shape = hsolve.helmholtz2d(48, k=15.0)
    opts = hsolve.SolverOptions(swlevel=0, swsize=1)

    def build():
        tree = hsolve.nested_dissection(shape, leafmax=60)
        return plan_factorization(A, tree, opts)

    plan_fast = build()
    monkeypatch.setattr(trees_mod, "_symfact_native", lambda *a, **k: None)
    plan_ref = build()

    assert len(plan_fast.batches) == len(plan_ref.batches)
    for bp, br in zip(plan_fast.batches, plan_ref.batches):
        assert (bp.ni_pad, bp.nb_pad, bp.B, bp.sl_pad, bp.sr_pad) == \
            (br.ni_pad, br.nb_pad, br.B, br.sl_pad, br.sr_pad)
        np.testing.assert_array_equal(bp.int_ids, br.int_ids)
        np.testing.assert_array_equal(bp.bnd_ids, br.bnd_ids)
        np.testing.assert_array_equal(bp.sperm, br.sperm)
        for f in ("map_l", "map_r"):
            a_, b_ = getattr(bp, f), getattr(br, f)
            assert (a_ is None) == (b_ is None)
            if a_ is not None:
                np.testing.assert_array_equal(a_, b_)
        # COO entry order may differ between the paths; compare as sets
        op, orf = np.argsort(bp.front_pos, kind="stable"), \
            np.argsort(br.front_pos, kind="stable")
        np.testing.assert_array_equal(
            np.asarray(bp.front_pos)[op], np.asarray(br.front_pos)[orf])
        np.testing.assert_allclose(bp.front_vals[op], br.front_vals[orf],
                                   rtol=1e-15)


def test_front_src_device_resident_gather():
    """The planner's ``front_src`` indices must reproduce ``front_vals`` from
    the permuted CSR data (identity padding marked -1), and the numeric phase's
    device-resident value-gather fast path (zero host->device value traffic per
    re-factorization) must produce the same factorization as a direct solve."""
    import hsolve
    from hsolve.planner import plan_factorization

    A, b, shape = hsolve.helmholtz2d(48, k=15.0)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    opts = hsolve.SolverOptions(swlevel=0)
    plan = plan_factorization(A, tree, opts)
    data = plan.A_raw[2]
    n_src = 0
    for bp in plan.batches:
        assert bp.front_src is not None
        s = np.asarray(bp.front_src)
        v = np.asarray(bp.front_vals)
        np.testing.assert_array_equal(v[s >= 0], data[s[s >= 0]])
        assert np.all(v[s < 0] == 1.0)
        n_src += int((s >= 0).sum())
    assert n_src == A.nnz  # every stored entry of A is sourced exactly once

    F = hsolve.factor_with_plan(plan, opts, dtype=np.float64)
    x = np.asarray(F.solve(b))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    # re-factorization exercises the cached device-resident program
    x2 = np.asarray(hsolve.factor_with_plan(plan, opts,
                                            dtype=np.float64).solve(b))
    np.testing.assert_allclose(x2, x, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", ["float64", "complex64", "complex128"])
@pytest.mark.parametrize("op", ["set", "add"])
def test_scatter_matches_native(dtype, op):
    """``ops.dense.scatter`` (real and imaginary halves for complex128) gives
    what ``x.at[idx].set/add`` gives, duplicates and dropped indices included."""
    import jax.numpy as jnp

    from hsolve.ops.dense import scatter

    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 3)) + 1j * rng.standard_normal((9, 3))
    x = jnp.asarray(x if "complex" in dtype else x.real, dtype)
    # 'add' sums a duplicate; 'set' gets unique rows (duplicate order is
    # unspecified).  Index 11 is out of range and dropped.
    idx = jnp.asarray([4, 0, 4, 11, 7] if op == "add" else [4, 0, 11, 7])
    v = rng.standard_normal((len(idx), 3)) * (1 - 2j)
    v = jnp.asarray(v if "complex" in dtype else v.real, dtype)
    got = jax.jit(lambda a, i, b: scatter(a, i, b, op, mode="drop"))(x, idx, v)
    want = getattr(x.at[idx], op)(v, mode="drop")
    assert got.dtype == x.dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("fdtype", ["float64", "float32"])
def test_precondition_with_data_casts(fdtype):
    """``precondition_with_data`` applies the factor in its own dtype and returns
    the Krylov vector's; ``spmv`` dispatches on the operator format."""
    import jax.numpy as jnp

    import hsolve

    A, b, shape = poisson2d(17)
    F = factor(A, nested_dissection(shape, leafmax=20), swlevel=0, dtype=fdtype)
    v = jnp.asarray(b, jnp.float64)
    y = hsolve.precondition_with_data(F.solve_data, v)
    assert y.dtype == jnp.float64
    x_ref = spla.spsolve(A.tocsc(), b)
    tol = 1e-10 if fdtype == "float64" else 1e-4
    assert np.linalg.norm(np.asarray(y) - x_ref) / np.linalg.norm(x_ref) < tol
    for fmt in (hsolve.to_dia(A), hsolve.to_ell(A)):
        np.testing.assert_allclose(np.asarray(hsolve.spmv(fmt, v)), A @ b,
                                   rtol=1e-12)
