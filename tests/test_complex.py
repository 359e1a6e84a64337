"""Complex (damped Helmholtz) end-to-end coverage.

The reference's wave use case is complex impedance Helmholtz (README.md:7; the
``helmholtz2d`` damping term mirrors ``K - k^2 M - i k damping M``).  Exercises
complex factorization (exact + compressed) and complex GMRES, host and compiled,
with native complex arithmetic throughout.
"""

import numpy as np
import pytest

import hsolve


@pytest.fixture(scope="module")
def problem():
    A, b, shape = hsolve.helmholtz2d(48, k=25.0, damping=0.1)
    tree = hsolve.nested_dissection(shape, leafmax=60)
    return A, np.asarray(b), tree


def test_complex_exact_direct(problem):
    A, b, tree = problem
    assert np.iscomplexobj(A.data)
    F = hsolve.factor(A, tree, swlevel=0)
    x = np.asarray(F.solve(b))
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-11


def test_complex_exact_gmres_one_iter(problem):
    A, b, tree = problem
    F = hsolve.factor(A, tree, swlevel=0)
    ell = hsolve.to_ell(A)
    x, info = hsolve.gmres(lambda v: hsolve.ell_matvec(ell, v), b, M=F.solve,
                           reltol=1e-9, restart=30, maxiter=30)
    assert info["iters"] == 1 and info["converged"]


def test_complex_compressed_gmres(problem):
    A, b, tree = problem
    F = hsolve.factor(A, tree, swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4)
    assert F.maxrank() > 0
    ell = hsolve.to_ell(A)
    x, info = hsolve.gmres(lambda v: hsolve.ell_matvec(ell, v), b, M=F.solve,
                           reltol=1e-9, restart=30, maxiter=30)
    relres = np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b)
    assert info["converged"] and relres < 1e-8


@pytest.mark.parametrize("fdtype,inner", [("complex128", None),
                                          ("complex64", "complex64")])
def test_native_complex_gmres_compiled(problem, fdtype, inner):
    """Damped Helmholtz through the compiled path: native complex ``spmv`` and
    ``precondition_with_data`` inside ``gmres_compiled`` (c128 throughout, or a
    c64 factor with c64 Arnoldi cycles and c128 escalation), against scipy's
    spsolve."""
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    A, b, tree = problem
    F = hsolve.factor(A, tree, swlevel=-2, swsize=1, atol=1e-4, rtol=1e-4,
                      dtype=fdtype)
    op = hsolve.spmv_format(A, dtype=np.complex128)[0]
    op_in = None if inner is None else hsolve.spmv_format(A, dtype=inner)[0]
    x, info = hsolve.gmres_compiled(
        hsolve.spmv, hsolve.precondition_with_data, jnp.asarray(b),
        reltol=1e-9, restart=30, maxiter=60, mv_data=op, M_data=F.solve_data,
        inner_dtype=inner, mv_data_inner=op_in,
        m_eps=0.0 if inner is None else 1e-6)
    assert x.dtype == jnp.complex128 and info["converged"]
    x_ref = spla.spsolve(A.tocsc(), b)
    assert np.linalg.norm(np.asarray(x) - x_ref) / np.linalg.norm(x_ref) < 1e-7
