"""Rank-cap calibration: factor once with generous caps, read the computed
interpolation ranks per tree level, and print a tight ``--level-caps`` string
(the per-problem analog of the reference's kest knob, rungmres.jl:21).

Every structured-kernel shape scales with cap^2, so running production
factorizations at calibrated per-level caps instead of the dim//4
over-provision is the difference between quasilinear and dense-path scaling.

Usage (runs on the CPU):
  python scripts/rankcal.py --problem helmholtz2d --n 512 --k 40 --atol 1e-4 \
      [--swlevel -2] [--dtype float64|float32]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="helmholtz2d")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--k", type=float, default=40.0)
    ap.add_argument("--leafmax", type=int, default=100)
    ap.add_argument("--swlevel", type=int, default=-2)
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--margin", type=int, default=8,
                    help="headroom added to each level's measured max rank")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"],
                    help="factorization dtype the caps are calibrated for")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import hsolve
    from hsolve.utils.runtime import configure_compile_cache

    configure_compile_cache()

    gen = {"helmholtz2d": lambda: hsolve.helmholtz2d(args.n, k=args.k),
           "poisson2d": lambda: hsolve.poisson2d(args.n),
           "helmholtz3d": lambda: hsolve.helmholtz3d(args.n, k=args.k),
           "poisson3d": lambda: hsolve.poisson3d(args.n)}[args.problem]
    A, b, shape = gen()
    tree = hsolve.nested_dissection(shape, leafmax=args.leafmax)
    dtype = np.dtype(args.dtype)
    opts = hsolve.SolverOptions(swlevel=args.swlevel, swsize=1,
                                atol=args.atol, rtol=args.atol)
    from hsolve.planner import plan_factorization

    plan = plan_factorization(A, tree, opts)
    F = hsolve.factor_with_plan(plan, opts, dtype=dtype)
    rep = F.rank_report()
    # aggregate computed max ranks per reference recursion level (root = 1)
    by_level = {}
    for row in rep["levels"]:
        bp = plan.batches[row["level"]]
        lev = int(bp.levels[: len(bp.node_ids)].min())
        by_level[lev] = max(by_level.get(lev, 0), row["max_rank"])
    if not by_level:
        print("no compressed levels in this configuration", file=sys.stderr)
        return
    deepest = max(by_level)
    caps = []
    for lev in range(1, deepest + 1):
        mr = by_level.get(lev, 0)
        # unseen level (dense at this config): inherit the neighbor below
        if mr == 0:
            mr = max((by_level.get(l2, 0) for l2 in range(lev, deepest + 1)),
                     default=16)
        caps.append(int(-(-(mr + args.margin) // 8) * 8))
    out = {"problem": args.problem, "n": args.n, "k": args.k,
           "atol": args.atol, "swlevel": args.swlevel,
           "max_rank_by_level": {str(k): v for k, v in sorted(by_level.items())},
           "saturated": rep["saturated"],
           "level_caps": caps,
           "flag": "--level-caps " + ",".join(str(c) for c in caps)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
