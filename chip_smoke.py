"""Proof that the solver's main path runs on a GPU at the size its users solve.

Drives the public API - ``hsolve.factor`` then ``hsolve.gmres_compiled`` with
GMRES(30), reltol 1e-9 - on 2D Helmholtz h=512, k=40 (N = 261,121) in six phases:

- exact: f64 multifrontal factor; ``F.solve`` against scipy's SuperLU,
- compressed: the reference's canonical configuration (test/rungmres.jl:21-22,39),
- complex: the damped system in native complex128,
- mixed: f32 factor, f32 Arnoldi cycles with f64 escalation, plus a check that
  f32 products at ``highest`` precision do not run in TF32,
- inverse modes: triangular-solve sweeps against explicit-inverse GEMM sweeps
  (LU-based and block-Schur), factor and solve times side by side,
- barrier: ``block_until_ready`` against a host fetch on a known matmul chain.

Every answer is checked on the host against SuperLU (f64/c128); a failed check
raises and the process exits nonzero.  Each phase prints one ``phase <name>:`` JSON
line (iterations, true residual, error against SuperLU, plan/factor/solve times
cold and warm, compile time, fused-program chunk count, peak device memory).  The
last line is one JSON object naming the device.

``--devices 4`` runs only the sharded path: a ('tree', 'front') mesh over four
GPUs, exact on helmholtz2d h=1024 and canonical compressed on h=512, each compared
with a one-GPU run of the same plan in the same process.  (The mesh path
compiles all batches as one program: 17 for the canonical plan at h=512, whose
sharded cold factor takes about 140 s on four H100s, and 30 at h=1024, whose
sharded cold factor had not finished after 180 s.)

Usage: python chip_smoke.py [--n 512] [--devices 1|4]
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

RELTOL = 1e-9
RESTART = 30
WARM_REPS = 3
# the reference's canonical compressed configuration (BASELINE.md:19)
CANONICAL = dict(swlevel=-2, swsize=480, atol=1e-2, rtol=1e-2, kest=200,
                 stepsize=100, leafsize=120)
# CPU f64 parity at h=512 (PARITY.md): 18 iterations, maxrank 24.  Reductions run
# in another order on the card, so the count gets a band.
CANONICAL_ITERS_H512 = (15, 21)
CANONICAL_MAXRANK_H512 = 24
# grid sizes of the four-GPU cases (exact, canonical compressed) and of the f32
# products behind the precision and barrier checks
SHARDED_N = 1024
SHARDED_COMPRESSED_N = 512
MATMUL_N = 4096


class SmokeFailure(RuntimeError):
    """A phase's answer failed its check."""


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


@dataclasses.dataclass
class Problem:
    """One matrix with its nested-dissection tree and host reference solution."""

    name: str
    A: object
    b: np.ndarray
    tree: object
    x_ref: np.ndarray
    ref_s: float


def make_problem(n, damping=0.0, leafmax=100):
    """helmholtz2d(n, k=40) and its SuperLU solution (f64, or c128 when damped)."""
    import scipy.sparse.linalg as spla

    import hsolve

    A, b, shape = hsolve.helmholtz2d(n, k=40.0, damping=damping)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=leafmax)
    t0 = time.perf_counter()
    x_ref = spla.splu(A.tocsc()).solve(b)
    return Problem(f"helmholtz2d_h{n}" + (f"_damp{damping:g}" if damping else ""),
                   A, b, tree, x_ref, time.perf_counter() - t0)


def _best(fn, reps=WARM_REPS):
    t, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        t = min(t, time.perf_counter() - t0)
    return t, out


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _rel(x, y):
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def run_case(prob, opts, dtype, inner_dtype=None, direct=False, maxiter=RESTART):
    """Factor ``prob`` and solve it with GMRES through the public API.

    Cold times are the first calls (trace, compile, run); warm times are the best
    of WARM_REPS on the plan the cold call made.  Every device phase ends in
    ``block_until_ready``.  Returns the measurements and the factorization."""
    import jax
    import jax.numpy as jnp

    import hsolve
    from hsolve.factor import _fuse_chunks
    from hsolve.planner import plan_factorization

    gdtype = np.complex128 if np.iscomplexobj(prob.A.data) else np.float64
    op = jax.device_put(hsolve.spmv_format(prob.A, dtype=gdtype)[0])
    op_in = None if inner_dtype is None else jax.device_put(
        hsolve.spmv_format(prob.A, dtype=inner_dtype)[0])
    bj = jnp.asarray(prob.b, gdtype)

    def factor_warm():
        F = hsolve.factor_with_plan(plan, F0.opts, dtype=dtype)
        jax.block_until_ready((F.levels, F.root))
        return F

    def solve():
        x, info = hsolve.gmres_compiled(
            hsolve.spmv, hsolve.precondition_with_data, bj, reltol=RELTOL,
            restart=RESTART, maxiter=maxiter,
            mv_data=op, M_data=F.solve_data, inner_dtype=inner_dtype,
            mv_data_inner=op_in, m_eps=0.0 if inner_dtype is None else 1e-6)
        return jax.block_until_ready(x), info

    t0 = time.perf_counter()
    F0 = hsolve.factor(prob.A, prob.tree, opts, dtype=dtype)
    jax.block_until_ready((F0.levels, F0.root))
    plan_factor_cold = time.perf_counter() - t0
    plan = F0.plan
    plan_s, _ = _best(lambda: plan_factorization(prob.A, prob.tree, F0.opts))
    factor_s, F = _best(factor_warm)
    t0 = time.perf_counter()
    solve()
    solve_cold = time.perf_counter() - t0
    solve_s, (x, info) = _best(solve)

    xh = np.asarray(x)
    r = {
        "problem": prob.name, "N": int(prob.A.shape[0]),
        "dtype": np.dtype(dtype).name, "inner_dtype": inner_dtype,
        "iters": int(info["iters"]), "converged": bool(info["converged"]),
        "relres": float(np.linalg.norm(prob.A @ xh - prob.b)
                        / np.linalg.norm(prob.b)),
        "err_vs_splu": _rel(xh, prob.x_ref),
        "plan_s": plan_s, "plan_factor_cold_s": plan_factor_cold,
        "factor_s": factor_s,
        "solve_cold_s": solve_cold, "solve_s": solve_s,
        "compile_s": (plan_factor_cold - plan_s - factor_s)
        + (solve_cold - solve_s),
        "chunks": len(_fuse_chunks(plan)), "splu_s": prob.ref_s,
    }
    if direct:
        t0 = time.perf_counter()
        xd = np.asarray(jax.block_until_ready(F.solve(prob.b)))
        r["direct_cold_s"] = time.perf_counter() - t0
        r["direct_s"], _ = _best(lambda: jax.block_until_ready(F.solve(prob.b)))
        r["direct_err_vs_splu"] = _rel(xd, prob.x_ref)
    r["peak_bytes_in_use"] = _peak_bytes()
    return r, F


def _check_exact(r, label):
    check(r["direct_err_vs_splu"] <= 1e-8,
          f"{label}: F.solve vs splu rel. error {r['direct_err_vs_splu']:.3e} > 1e-8")
    check(r["iters"] <= 2, f"{label}: {r['iters']} GMRES iterations > 2")
    check(r["relres"] <= RELTOL, f"{label}: relres {r['relres']:.3e} > {RELTOL}")


def phase_exact(prob, opts=None):
    import jax.numpy as jnp

    import hsolve

    r, _ = run_case(prob, opts or hsolve.SolverOptions(swlevel=0), jnp.float64,
                    direct=True)
    _check_exact(r, "exact")
    return r


def phase_compressed(prob, iters_band=CANONICAL_ITERS_H512,
                     maxrank_ref=CANONICAL_MAXRANK_H512):
    """The canonical configuration; ``iters_band`` None checks convergence only
    (the band and the rank hold at h=512, where the swsize=480 gate engages)."""
    import jax.numpy as jnp

    import hsolve

    r, F = run_case(prob, hsolve.SolverOptions(**CANONICAL), jnp.float64)
    r["maxrank"] = F.maxrank()
    r["maxrank_ref"] = maxrank_ref
    check(r["converged"] and r["relres"] <= RELTOL,
          f"compressed: not converged (relres {r['relres']:.3e}, "
          f"{r['iters']} iterations)")
    if iters_band is not None:
        lo, hi = iters_band
        check(lo <= r["iters"] <= hi,
              f"compressed: {r['iters']} iterations outside [{lo}, {hi}]")
    return r


def phase_complex(prob):
    import jax.numpy as jnp

    import hsolve

    check(np.iscomplexobj(prob.A.data), "complex: the problem is not complex")
    r, _ = run_case(prob, hsolve.SolverOptions(swlevel=0), jnp.complex128,
                    direct=True)
    _check_exact(r, "complex")
    return r


def matmul_precision_errors(n=MATMUL_N, seed=0):
    """Relative error of an f32 [n, n] product against numpy f64 on the same f32
    inputs, at precision 'highest' and at 'default'.  IEEE f32 errs by ~1e-6;
    TF32 (10-bit mantissa) by ~1e-3."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    c = rng.standard_normal((n, n)).astype(np.float32)
    ref = a.astype(np.float64) @ c.astype(np.float64)
    out = {}
    for prec in ("highest", "default"):
        f = jax.jit(lambda x, y, p=prec: jnp.matmul(x, y, precision=p))
        out[prec] = _rel(np.asarray(f(a, c)).astype(np.float64), ref)
    return out


def phase_mixed(prob, matmul_n=MATMUL_N):
    import jax.numpy as jnp

    import hsolve

    r, _ = run_case(prob, hsolve.SolverOptions(swlevel=0), jnp.float32,
                    inner_dtype="float32", maxiter=2 * RESTART)
    check(r["relres"] <= RELTOL, f"mixed: relres {r['relres']:.3e} > {RELTOL}")
    errs = matmul_precision_errors(matmul_n)
    r["f32_matmul_err_highest"] = errs["highest"]
    r["f32_matmul_err_default"] = errs["default"]
    r["f32_highest_is_ieee"] = errs["highest"] <= 1e-5
    check(r["f32_highest_is_ieee"],
          f"mixed: f32 product at 'highest' errs {errs['highest']:.2e} (> 1e-5, "
          "TF32-like)")
    return r


def phase_inverse_modes(prob, exact=None):
    """All three pivot-block solve modes on the exact problem.  ``exact`` is the
    exact phase's result; it stands for the mode it ran (the library default)."""
    import jax.numpy as jnp

    import hsolve

    def mode(o):
        return o.explicit_inverse, o.resolve_fast_inverse()

    modes = {"trsm": dict(explicit_inverse=False, fast_inverse=False),
             "explicit_lu": dict(explicit_inverse=True, fast_inverse=False),
             "explicit_block": dict(explicit_inverse=True, fast_inverse=True)}
    out = {}
    for name, kw in modes.items():
        if exact is not None and \
                mode(hsolve.SolverOptions(**kw)) == mode(hsolve.SolverOptions()):
            r = dict(exact, reused_from="exact")
        else:
            r, _ = run_case(prob, hsolve.SolverOptions(swlevel=0, **kw),
                            jnp.float64, direct=True)
        _check_exact(r, f"inverse {name}")
        out[name] = {k: r[k] for k in ("factor_s", "solve_s", "direct_s", "iters",
                                       "relres", "direct_err_vs_splu",
                                       "compile_s", "peak_bytes_in_use")}
        if "reused_from" in r:
            out[name]["reused_from"] = r["reused_from"]
    return out


def phase_barrier(n=MATMUL_N, chain=8, reps=5, tol=0.10):
    """A jitted chain of ``chain`` [n, n] f32 products at 'highest', timed with
    ``block_until_ready`` and with a host fetch of one entry of the result (a
    result of the same program, so no extra dispatch is timed).  If the two
    agree, ``block_until_ready`` waits for the device and is the barrier every
    timing in this repository uses."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((n, n)) / np.sqrt(n), jnp.float32)

    @jax.jit
    def run(x, w):
        for _ in range(chain):
            x = jnp.matmul(x, w, precision="highest")
        return x, x[0, 0]

    jax.block_until_ready(run(x, w))
    # alternate the two so clock drift under a power cap hits both alike
    t_ready = t_fetch = float("inf")
    for _ in range(reps):
        t_ready = min(t_ready, _best(lambda: jax.block_until_ready(run(x, w)),
                                     1)[0])
        t_fetch = min(t_fetch, _best(lambda: float(run(x, w)[1]), 1)[0])
    r = {"n": n, "chain": chain, "flops": 2.0 * chain * n ** 3,
         "block_until_ready_s": t_ready, "fetch_s": t_fetch,
         "ratio": t_ready / t_fetch}
    check(abs(r["ratio"] - 1.0) <= tol,
          f"barrier: block_until_ready {t_ready:.4e}s vs fetch {t_fetch:.4e}s "
          f"differ by more than {tol:.0%}")
    return r


def phase_sharded(n, ndev, opts_kw):
    """Factor + GMRES of helmholtz2d(n, k=40) over a ('tree', 'front') mesh of
    ``ndev`` devices, against a one-device run of the same plan in the same
    process: the leaf stacks must sit on ``ndev`` devices, and both runs must
    converge in the same number of iterations to solutions within 1e-8."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import hsolve
    from hsolve.parallel.dist import make_mesh

    mesh = make_mesh(ndev, front=1)
    A, b, shape = hsolve.helmholtz2d(n, k=40.0)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    op = hsolve.spmv_format(A, dtype=np.float64)[0]
    # the matvec operand and right-hand side are replicated over the mesh for
    # the sharded run and committed to device 0 for the one-device run
    places = {"sharded": NamedSharding(mesh, P()), "one_device": jax.devices()[0]}
    res = {}
    F = None
    for where, place in places.items():
        opd = jax.device_put(op, place)
        bj = jax.device_put(jnp.asarray(b), place)
        t0 = time.perf_counter()
        if F is None:
            F = hsolve.factor(A, tree, hsolve.SolverOptions(**opts_kw), mesh=mesh)
        else:
            F = hsolve.factor_with_plan(F.plan, F.opts)
        jax.block_until_ready((F.levels, F.root))
        t_factor = time.perf_counter() - t0
        # progress for a long compile: which half got how far
        print(f"sharded h={n} {where}: factor cold {t_factor:.1f}s",
              file=sys.stderr, flush=True)

        def solve():
            x, info = hsolve.gmres_compiled(
                hsolve.spmv, hsolve.precondition_with_data, bj,
                reltol=RELTOL, restart=RESTART, maxiter=RESTART, mv_data=opd, M_data=F.solve_data)
            return jax.block_until_ready(x), info

        t0 = time.perf_counter()
        solve()
        t_solve_cold = time.perf_counter() - t0
        t_solve, (x, info) = _best(solve, 2)
        leaf = F.levels[0]
        arr = leaf.lu if leaf.lu is not None else leaf.L
        xh = np.asarray(x)
        res[where] = {
            "factor_cold_s": t_factor, "solve_cold_s": t_solve_cold,
            "solve_s": t_solve, "iters": int(info["iters"]),
            "relres": float(np.linalg.norm(A @ xh - b) / np.linalg.norm(b)),
            "leaf_devices": len(arr.devices()), "x": xh}
    s, o = res["sharded"], res["one_device"]
    diff = _rel(s.pop("x"), o.pop("x"))
    out = {"problem": f"helmholtz2d_h{n}", "N": int(A.shape[0]),
           "mesh": dict(mesh.shape), "opts": opts_kw, "sharded": s,
           "one_device": o, "rel_diff": diff, "peak_bytes_in_use": _peak_bytes()}
    check(s["leaf_devices"] == ndev,
          f"sharded: leaf stacks on {s['leaf_devices']} devices, not {ndev}")
    check(s["relres"] <= RELTOL and o["relres"] <= RELTOL,
          f"sharded: relres {s['relres']:.3e} / {o['relres']:.3e}")
    check(s["iters"] == o["iters"],
          f"sharded: {s['iters']} iterations vs {o['iters']} on one device")
    check(diff <= 1e-8, f"sharded: solutions differ by {diff:.3e}")
    return out


def emit(name, r):
    print(f"phase {name}: {json.dumps(r)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512, help="grid size of the phases")
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the sharded path over four GPUs")
    args = ap.parse_args(argv)

    import jax

    from hsolve.utils.runtime import (configure_compile_cache,
                                      gpu_name_and_power_limit, require_gpu)

    devs = require_gpu()
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    import hsolve.native

    print(gpu_name_and_power_limit(), flush=True)
    print(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}; "
          f"jax {jax.__version__}", flush=True)
    check(hsolve.native.available(),
          "the native planner library did not build or load")
    if len(devs) < args.devices:
        raise SmokeFailure(f"--devices {args.devices} needs {args.devices} GPUs, "
                           f"found {len(devs)}")

    if args.devices > 1:
        emit("sharded_exact", phase_sharded(SHARDED_N, args.devices,
                                            dict(swlevel=0)))
        emit("sharded_compressed", phase_sharded(SHARDED_COMPRESSED_N,
                                                 args.devices, CANONICAL))
    else:
        prob = make_problem(args.n)
        exact = phase_exact(prob)
        emit("exact", exact)
        # the iteration band and the rank hold at h=512 (CPU f64 parity)
        at512 = args.n == 512
        emit("compressed", phase_compressed(
            prob, CANONICAL_ITERS_H512 if at512 else None,
            CANONICAL_MAXRANK_H512 if at512 else None))
        emit("complex", phase_complex(make_problem(args.n, damping=0.1)))
        emit("mixed", phase_mixed(prob))
        emit("inverse_modes", phase_inverse_modes(prob, exact))
        emit("barrier", phase_barrier())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
