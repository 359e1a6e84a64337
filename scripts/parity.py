"""Reference-protocol parity runs (the BASELINE.md acceptance configs).

Reproduces ``/root/reference/test/rungmres.jl`` semantics on the four shipped
problem configs (Poisson/Helmholtz 2D P1, h in {1/64, 1/128}, elimination trees
with leaf cap 100 — rungmres.jl:15,21-22,32,39,47-48):

- exact factorization: ``swlevel=0`` (rungmres.jl:32),
- compressed: ``swlevel=-2, swsize=480, atol=rtol=1e-2, kest=200, stepsize=100,
  leafsize=120`` (rungmres.jl:21-22,39),
- right-preconditioned GMRES(30), ``reltol=1e-9``, ``maxiter=30`` (rungmres.jl:47-48).

Runs in f64 on CPU (the reference's arithmetic), records per-config GMRES iteration
counts / relres / maxrank into PARITY.md + parity.json.  The reference's .mat test
matrices are absent from its repo (.MISSING_LARGE_BLOBS), so the problems are
regenerated natively with the same discretization and tree leaf cap; Julia is not
installed here, so the parity criterion asserted by tests/test_parity.py is the
*stability band* of iteration counts (exact preconditioning converges in 1
iteration; compressed stays within the recorded band).

Usage: python scripts/parity.py   (runs on the CPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


CONFIGS = [
    ("poisson2d", 64), ("poisson2d", 128),
    ("helmholtz2d", 64), ("helmholtz2d", 128),
    # scale configs where the canonical swsize=480 gate ENGAGES (top-level
    # boundaries exceed 480 DOFs at h >= 1/256): the canonical compressed
    # config exercises real compression here (round-4 verdict missing #2)
    ("helmholtz2d", 256), ("helmholtz2d", 512),
]

COMPRESSED_OPTS = dict(swlevel=-2, swsize=480, atol=1e-2, rtol=1e-2,
                       kest=200, stepsize=100, leafsize=120)
# the canonical swsize=480 is a scale gate: boundaries of ANY nested-dissection
# tree of these meshes are O(h) < 480 at h <= 1/128 (tests/test_parity.py), so
# "compressed" is identical to exact at the shipped sizes - faithful to the
# config but uninformative; the "active" variant drops the size gate to the
# reference default swsize=1 (HierarchicalSolvers.jl:45) so compression engages,
# with adaptive=True (the randcompress_adaptive growth loop analog: saturated
# interpolation ranks trigger a replan with doubled caps)
ACTIVE_OPTS = dict(COMPRESSED_OPTS, swsize=1, adaptive=True)


def run_config(problem, n):
    import numpy as np
    import hsolve

    gen = {"poisson2d": hsolve.poisson2d,
           "helmholtz2d": hsolve.helmholtz2d}[problem]
    A, b, shape = gen(n)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    ell = hsolve.to_ell(A)
    mv = lambda v: hsolve.ell_matvec(ell, v)

    out = {}
    modes = [("exact", dict(swlevel=0)), ("compressed", COMPRESSED_OPTS)]
    if n <= 128:
        # at h <= 1/128 the canonical swsize=480 gates compression OFF; the
        # "active" variant (swsize=1) keeps a compression-engaged row at the
        # shipped sizes.  At h >= 256 the canonical gate itself engages, so
        # the canonical row IS the compressed row.
        modes.append(("compressed_active", ACTIVE_OPTS))
    for mode, opts in modes:
        hsolve.factor(A, tree, **opts)  # warm-up: jit compiles excluded from timing
        t0 = time.perf_counter()
        F = hsolve.factor(A, tree, **opts)
        t_factor = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = hsolve.gmres(mv, b, M=F.solve, reltol=1e-9, restart=30,
                               maxiter=30)
        t_solve = time.perf_counter() - t0
        relres = float(np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b))
        out[mode] = {
            "iters": int(info["iters"]), "converged": bool(info["converged"]),
            "relres": relres, "maxrank": int(F.maxrank()),
            "factor_s": round(t_factor, 3), "solve_s": round(t_solve, 3),
        }
        print(f"{problem} h={n} {mode}: iters={out[mode]['iters']} "
              f"relres={relres:.2e} maxrank={out[mode]['maxrank']} "
              f"factor={t_factor:.2f}s", flush=True)
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from hsolve.utils.runtime import configure_compile_cache

    configure_compile_cache()

    results = {}
    for problem, n in CONFIGS:
        results[f"{problem}_h{n}"] = run_config(problem, n)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "parity.json"), "w") as f:
        json.dump(results, f, indent=1)

    lines = [
        "# PARITY — reference-protocol GMRES iteration counts",
        "",
        "Protocol: `/root/reference/test/rungmres.jl` — exact (`swlevel=0`) and",
        "compressed (`swlevel=-2, swsize=480, atol=rtol=1e-2, kest=200, "
        "stepsize=100, leafsize=120`)",
        "factorizations as right preconditioners in GMRES(30), reltol=1e-9, "
        "maxiter=30; f64 CPU",
        "(the reference's arithmetic).  Problems regenerated natively (2D P1, tree "
        "leaf cap 100;",
        "the reference's .mat blobs are absent from its repo).  Acceptance: exact "
        "converges in 1",
        "iteration (direct-solver quality); compressed iteration counts stay in the "
        "band asserted",
        "by `tests/test_parity.py`.",
        "",
        "| config | mode | iters | relres | maxrank | factor s | solve s |",
        "|---|---|---|---|---|---|---|",
    ]
    for cfg, modes in results.items():
        for mode, r in modes.items():
            lines.append(
                f"| {cfg} | {mode} | {r['iters']} | {r['relres']:.2e} | "
                f"{r['maxrank']} | {r['factor_s']} | {r['solve_s']} |")
    lines.append("")
    with open(os.path.join(root, "PARITY.md"), "w") as f:
        f.write("\n".join(lines))
    print("wrote PARITY.md + parity.json")


if __name__ == "__main__":
    main()
