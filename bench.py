"""Benchmark: one problem through plan -> factor -> GMRES solve, printed as one
JSON line.

Protocol parity with the reference (test/rungmres.jl:32,39,47-48 and
benchmark/runbenchmarks.jl:37-41): time the factorization setup and the
right-preconditioned GMRES(30) solve to reltol.  The reference publishes no numbers
(BASELINE.md), so ``vs_baseline`` is measured against a single-core scipy SuperLU
factor+solve of the same system run in-process - a *conservative* proxy for the
reference's single-core Julia CPU solver.

Runs on the GPU and fails without one; ``--cpu`` runs on the CPU instead, and then
prints no roofline.  ``--inner`` picks the arithmetic on either: ``f64`` (default)
factors and iterates in f64/c128, the library's and the reference's arithmetic;
``f32`` factors in f32/c64 and runs f32 Arnoldi cycles with an f64 escalation
phase.  Every device phase is timed with ``block_until_ready``.

Usage: python bench.py [--n 128] [--k 40] [--leafmax 100] [--reps 10] [--swlevel 0]
                       [--inner f64|f32] [--cpu]
"""

import argparse
import gc
import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="helmholtz2d",
                    choices=["helmholtz2d", "poisson2d", "helmholtz3d", "poisson3d"])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--leafmax", type=int, default=100)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--swlevel", type=int, default=0)
    ap.add_argument("--swsize", type=int, default=1)
    ap.add_argument("--atol", type=float, default=None,
                    help="compression tolerance (default: SolverOptions default)")
    ap.add_argument("--kest", type=int, default=None,
                    help="rank estimate (reference kest, rungmres.jl:21): sets the "
                         "planner's static rank caps to kest + stepsize")
    ap.add_argument("--rank-cap", type=int, default=None,
                    help="hard static rank cap override")
    ap.add_argument("--level-caps", default=None,
                    help="comma-separated per-tree-level rank caps, root first "
                         "(from scripts/rankcal.py); last entry extends deeper")
    ap.add_argument("--sprec", default=None,
                    choices=["default", "high", "highest"],
                    help="matmul precision for the structured (HSS) kernels "
                         "(default: inherit matmul_precision, 'highest')")
    ap.add_argument("--reltol", type=float, default=1e-9)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--damping", type=float, default=0.0,
                    help="impedance damping for helmholtz2d (complex problem)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (no roofline); without it a GPU is "
                         "required")
    ap.add_argument("--explicit-inverse", default=None, choices=["0", "1"],
                    help="override the explicit-inverse solve mode")
    ap.add_argument("--inner", default="f64", choices=["f32", "f64"],
                    help="f64: f64/c128 factor and GMRES; f32: f32/c64 factor, "
                         "f32 Arnoldi cycles with f64 escalation")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hsolve.utils.runtime import (configure_compile_cache,
                                      gpu_name_and_power_limit, require_gpu)

    if not args.cpu:
        require_gpu()
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    import jax.numpy as jnp

    import hsolve
    from hsolve.planner import plan_factorization

    devs = jax.devices()
    dev = devs[0]
    power = None if args.cpu else gpu_name_and_power_limit()
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}"
        + (f"; nvidia-smi: {power}" if power else ""))

    gen = {"helmholtz2d": lambda: hsolve.helmholtz2d(args.n, k=args.k,
                                                     damping=args.damping),
           "poisson2d": lambda: hsolve.poisson2d(args.n),
           "helmholtz3d": lambda: hsolve.helmholtz3d(args.n, k=args.k),
           "poisson3d": lambda: hsolve.poisson3d(args.n)}[args.problem]
    A, b, shape = gen()
    b = np.asarray(b)
    iscomplex = np.iscomplexobj(A.data)
    log(f"{args.problem} n={args.n}: N={A.shape[0]}, nnz={A.nnz} dtype={A.dtype}")

    inner_f32 = args.inner == "f32"
    gdtype = np.dtype(np.complex128 if iscomplex else np.float64)
    fdtype = np.dtype(np.complex64 if iscomplex else np.float32) if inner_f32 \
        else gdtype
    opts = hsolve.SolverOptions(swlevel=args.swlevel, swsize=args.swsize)
    if args.atol is not None:
        opts = opts.replace(atol=args.atol, rtol=args.atol)
    if args.kest is not None:
        opts = opts.replace(kest=args.kest)
    if args.rank_cap is not None:
        opts = opts.replace(rank_cap=args.rank_cap)
    if args.level_caps is not None:
        opts = opts.replace(level_caps=tuple(
            int(c) for c in args.level_caps.split(",")))
    if args.sprec is not None:
        opts = opts.replace(structured_precision=args.sprec)
    if args.explicit_inverse is not None:
        opts = opts.replace(explicit_inverse=args.explicit_inverse == "1")

    # tree construction runs once per problem (the reference builds its tree in
    # MATLAB offline and loads it, rungmres.jl:15)
    tree = hsolve.nested_dissection(shape, leafmax=args.leafmax)
    # warm the planner code paths (numpy/ctypes dispatch caches) on a tiny problem,
    # mirroring how the cold rep warms the device programs
    _Aw, _, _sw = hsolve.poisson2d(8)
    plan_factorization(_Aw, hsolve.nested_dissection(_sw, leafmax=16), opts)
    gc.freeze()  # keep gen-2 scans of the jax/module heap out of the hot host loops

    # the matvec operands and the right-hand side go to the device once (set-up)
    op_outer = jax.device_put(hsolve.spmv_format(A, dtype=gdtype)[0])
    op_inner = jax.device_put(hsolve.spmv_format(A, dtype=fdtype)[0]) \
        if inner_f32 else None
    bj = jnp.asarray(b, dtype=gdtype)

    # Phase split per the reference's protocol boundary: rungmres.jl times
    # `factor` (rungmres.jl:32,39) AFTER symfact/postorder/permute ran outside
    # the timer (rungmres.jl:16-19).  Our 'symbolic' half is the work the
    # reference excludes; the 'schedule' half (batch building + the A[I,J]
    # gather maps) replaces work its timed factor redoes per call, so it counts
    # toward the headline.  The cold evaluation of each device phase carries
    # jit compilation and is reported separately.
    t_sym = t_sched = float("inf")
    plan = None
    first = {}
    for _ in range(args.reps):
        t0 = time.perf_counter()
        p = plan_factorization(A, tree, opts)
        dt = time.perf_counter() - t0
        first.setdefault("plan", dt)
        t_sym = min(t_sym, p.timings["symbolic_s"])
        t_sched = min(t_sched, dt - p.timings["symbolic_s"])
        if plan is None:
            # factor with ONE plan object: the plan is a static jit key, so a
            # fresh object per call would re-trace the fused factor program
            plan = p
    log(f"  plan: sym={t_sym*1e3:.1f}ms sched={t_sched*1e3:.1f}ms")

    def run_factor():
        F = hsolve.factor_with_plan(plan, opts, dtype=fdtype)
        jax.block_until_ready((F.levels, F.root))
        return F

    def run_solve(F):
        x, info = hsolve.gmres_compiled(
            hsolve.spmv, hsolve.precondition_with_data, bj,
            reltol=args.reltol, restart=30,
            maxiter=args.maxiter, mv_data=op_outer, M_data=F.solve_data,
            inner_dtype=fdtype.name if inner_f32 else None,
            mv_data_inner=op_inner, m_eps=1e-6 if inner_f32 else 0.0,
            fetch_info=False)
        jax.block_until_ready(x)
        return x, info

    def best(fn):
        t = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn()
            t = min(t, time.perf_counter() - t0)
        return t, out

    t0 = time.perf_counter()
    F = run_factor()
    first["factor"] = time.perf_counter() - t0
    log(f"  factor cold (compile): {first['factor']:.3f}s")
    t0 = time.perf_counter()
    run_solve(F)
    first["solve"] = time.perf_counter() - t0
    log(f"  solve cold (compile): {first['solve']:.3f}s")

    t_factor, F = best(run_factor)
    log(f"  factor(numeric): {t_factor*1e3:.2f}ms")
    t_solve, (x, info) = best(lambda: run_solve(F))
    log(f"  solve: {t_solve*1e3:.2f}ms")

    # diagnostics (outside the timers): iterations, the true residual on the
    # host in f64/c128, and the explicit-inverse conditioning guard
    iters = hsolve.fetch_gmres_info(info)["iters"]
    xh = np.asarray(x)
    res = float(np.linalg.norm(A @ xh - b) / np.linalg.norm(b))
    cond = F.cond_report()
    log(f"best: plan={t_sym + t_sched:.4f}s factor={t_factor:.4f}s "
        f"solve={t_solve:.4f}s iters={iters} relres={res:.2e} "
        f"max_diag_ratio={cond['max_ratio']:.2e}")

    # baseline proxy: single-core scipy SuperLU direct solve, after our reps (its
    # large fill-in allocations fragment the allocator and would inflate our
    # host planning times); same best-of-reps treatment as our own timings
    import scipy.sparse.linalg as spla

    Ac = A.tocsc()
    nbase = min(args.reps, 3)
    t_base = float("inf")
    for _ in range(nbase):
        t0 = time.perf_counter()
        lu = spla.splu(Ac)
        lu.solve(b)
        t_base = min(t_base, time.perf_counter() - t0)
    del lu
    log(f"baseline proxy (scipy splu factor+solve, 1 CPU core, best of {nbase}): "
        f"{t_base:.3f}s")

    # headline = sched + factor + solve (see the protocol note above)
    best_total = t_sched + t_factor + t_solve
    detail = {
        "setup_s": round(t_sched + t_factor, 6),
        "solve_s": round(t_solve, 6),
        "factor_s": round(t_factor, 6),
        "plan_s": round(t_sym + t_sched, 6),
        # symbolic work the reference runs OUTSIDE its timed factor
        # (rungmres.jl:16-19): excluded from the headline, reported here and
        # in the all-inclusive ratio below
        "plan_symbolic_s": round(t_sym, 6),
        "plan_schedule_s": round(t_sched, 6),
        "total_incl_symbolic_s": round(t_sym + best_total, 6),
        "vs_baseline_incl_symbolic": round(t_base / (t_sym + best_total), 3),
        "gmres_iters": iters, "relres": res,
        "factor_dtype": fdtype.name,
        "max_diag_ratio": cond["max_ratio"], "cond_risky": cond["risky"],
        "baseline_proxy": "scipy_splu_1core_seconds",
        "baseline_proxy_s": round(t_base, 6),
        # cold wall times include jit compilation (a warm persistent compile
        # cache skips most of it)
        "first_rep_setup_s": round(first["plan"] + first["factor"], 6),
        "first_rep_solve_s": round(first["solve"], 6),
    }
    if not args.cpu:
        from hsolve.utils.profiling import roofline_report

        roofline = roofline_report(plan, measured_factor_s=t_factor,
                                   device_kind=dev.device_kind, dtype=fdtype)
        log("roofline: " + json.dumps({k: v for k, v in roofline.items()
                                       if k != "per_level"}))
        if roofline["sol_violation"]:
            log("ERROR: roofline physics violation - measured factor time is "
                "faster than the model's speed-of-light bound (or achieved "
                "GF/s exceeds the chip peak); this row is NOT a valid result")
        for k in ("factor_gflops", "achieved_gflop_s", "nnz_per_s",
                  "speed_of_light_s", "sol_fraction", "sol_violation"):
            detail[k] = roofline[k]

    tag = f"_damp{args.damping:g}" if args.damping else ""
    if args.swlevel != 0:
        tag += f"_sw{args.swlevel}"
        if args.atol is not None:
            tag += f"_tol{args.atol:g}"
        if args.kest is not None:
            tag += f"_k{args.kest}"
        if args.rank_cap is not None:
            tag += f"_cap{args.rank_cap}"
        if args.level_caps is not None:
            tag += "_lc" + args.level_caps.replace(",", "-")
        if args.sprec is not None:
            tag += f"_{args.sprec}"
    if inner_f32:
        tag += "_f32"
    result = {
        "metric": f"{args.problem}_h{args.n}{tag}_setup_plus_gmres_solve",
        "value": round(best_total, 6),
        "unit": "seconds",
        "vs_baseline": round(t_base / best_total, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
        # "name, power.limit" from nvidia-smi (None on --cpu)
        "power_limit": power,
        "detail": detail,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
