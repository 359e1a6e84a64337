"""Low-rank kernel tests: randomized factorization, CPQR, interpolative decomposition,
recompression (the reference's LowRankApprox.jl capability surface)."""

import jax
import jax.numpy as jnp
import numpy as np

from hsolve.ops.lowrank import LowRank, cpqr, interp_decomp, lowrank_recompress, \
    rand_lowrank


def _random_lowrank_batch(key, B, m, n, r, decay=1e-8):
    ks = jax.random.split(key, 3)
    U = jax.random.normal(ks[0], (B, m, r))
    V = jax.random.normal(ks[1], (B, n, r))
    s = jnp.logspace(0, np.log10(decay), r)
    return (U * s) @ jnp.swapaxes(V, -1, -2)


def test_rand_lowrank_exact_rank():
    key = jax.random.PRNGKey(0)
    A = _random_lowrank_batch(key, 4, 60, 40, 10, decay=1.0)  # flat spectrum rank 10
    lr = rand_lowrank(A, jax.random.PRNGKey(1), atol=1e-10, rtol=1e-10, cap=20)
    err = jnp.linalg.norm(lr.todense() - A) / jnp.linalg.norm(A)
    assert err < 1e-10
    assert np.all(np.asarray(lr.rank) == 10)


def test_rand_lowrank_tolerance_truncation():
    key = jax.random.PRNGKey(2)
    A = _random_lowrank_batch(key, 2, 50, 50, 30, decay=1e-12)
    lr = rand_lowrank(A, jax.random.PRNGKey(3), atol=0.0, rtol=1e-4, cap=40)
    rel = jnp.linalg.norm(lr.todense() - A, axis=(-2, -1)) / \
        jnp.linalg.norm(A, axis=(-2, -1))
    assert np.all(np.asarray(rel) < 1e-3)
    assert np.all(np.asarray(lr.rank) < 30)  # truncated below exact rank


def test_cpqr_rank_and_residual():
    key = jax.random.PRNGKey(4)
    A = _random_lowrank_batch(key, 3, 30, 45, 8, decay=1.0)
    f = cpqr(A, atol=1e-9, rtol=1e-9, cap=16)
    assert np.all(np.asarray(f.rank) == 8)
    # the selected columns must span the column space: project A onto them
    for b in range(3):
        Ab = np.asarray(A[b])
        cols = np.asarray(f.piv[b][:8])
        Q, _ = np.linalg.qr(Ab[:, cols])
        res = Ab - Q @ (Q.T @ Ab)
        assert np.linalg.norm(res) / np.linalg.norm(Ab) < 1e-8


def test_interp_decomp_reconstruction():
    key = jax.random.PRNGKey(5)
    A = _random_lowrank_batch(key, 3, 40, 25, 6, decay=1.0)
    J, T, rank = interp_decomp(A, atol=1e-9, rtol=1e-9, cap=12)
    assert np.all(np.asarray(rank) == 6)
    for b in range(3):
        rows = np.asarray(J[b][:6])
        rec = np.asarray(T[b][:, :6]) @ np.asarray(A[b])[rows, :]
        assert np.linalg.norm(rec - A[b]) / np.linalg.norm(A[b]) < 1e-8


def test_recompress_tightens_rank():
    key = jax.random.PRNGKey(6)
    B, m, n = 2, 40, 30
    U = jax.random.normal(key, (B, m, 20))
    # duplicate columns -> true rank 10 inside a rank-20 representation
    U = jnp.concatenate([U[..., :10], U[..., :10]], axis=-1)
    V = jax.random.normal(jax.random.PRNGKey(7), (B, n, 20))
    lr = LowRank(U=U, V=V, rank=jnp.full((B,), 20))
    lr2 = lowrank_recompress(lr, atol=1e-12, rtol=1e-12, cap=20)
    err = jnp.linalg.norm(lr2.todense() - lr.todense()) / jnp.linalg.norm(lr.todense())
    assert err < 1e-10
    assert np.all(np.asarray(lr2.rank) <= 20)


def test_complex_support():
    key = jax.random.PRNGKey(8)
    U = jax.random.normal(key, (2, 30, 5)) + 1j * jax.random.normal(key, (2, 30, 5))
    V = jax.random.normal(jax.random.PRNGKey(9), (2, 20, 5))
    A = U @ jnp.swapaxes(V, -1, -2)
    lr = rand_lowrank(A.astype(jnp.complex128), jax.random.PRNGKey(10),
                      atol=1e-10, rtol=1e-10, cap=10)
    err = jnp.linalg.norm(lr.todense() - A) / jnp.linalg.norm(A)
    assert err < 1e-9
