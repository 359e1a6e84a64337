"""Tolerance-vs-iterations sweep (round-4 verdict task 4): for each atol,
factor the compressed configuration and record GMRES iteration counts,
computed max ranks, and (CPU) factor wall time.

Usage: python scripts/tolsweep.py [--n 384 512] [--k 40] [--atols 1e-3 1e-4 1e-5]
       (runs on the CPU)
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# kest per tolerance: looser tolerance -> smaller interaction ranks; values
# from rankcal.py calibration at h=512, k=40 (+margin)
KEST = {1e-3: 32, 1e-4: 48, 1e-5: 64}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[384, 512])
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--atols", type=float, nargs="+",
                    default=[1e-3, 1e-4, 1e-5])
    ap.add_argument("--reltol", type=float, default=1e-9)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import hsolve
    from hsolve.utils.runtime import configure_compile_cache

    configure_compile_cache()

    rows = []
    for n in args.n:
        A, b, shape = hsolve.helmholtz2d(n, k=args.k)
        b = np.asarray(b)
        tree = hsolve.nested_dissection(shape, leafmax=100)
        ell = hsolve.to_ell(A)
        mv = lambda v: hsolve.ell_matvec(ell, v)
        for atol in args.atols:
            kest = KEST.get(atol, 48)
            t0 = time.perf_counter()
            F = hsolve.factor(A, tree, swlevel=-2, swsize=1, atol=atol,
                              rtol=atol, kest=kest)
            t_factor = time.perf_counter() - t0
            x, info = hsolve.gmres(mv, b, M=F.solve, reltol=args.reltol,
                                   restart=30, maxiter=120)
            relres = float(np.linalg.norm(A @ np.asarray(x) - b)
                           / np.linalg.norm(b))
            rep = F.rank_report()
            row = {"n": n, "atol": atol, "kest": kest,
                   "iters": int(info["iters"]),
                   "converged": bool(info["converged"]),
                   "relres": relres, "maxrank": int(F.maxrank()),
                   "saturated": bool(rep["saturated"]),
                   "factor_cpu_s": round(t_factor, 2)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(os.path.join(ROOT, "tolsweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote tolsweep.json")


if __name__ == "__main__":
    main()
