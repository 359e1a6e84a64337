"""Compare the derived per-batch FLOP model (utils.profiling.analyze_plan)
against XLA's cost_analysis of the REAL compiled numeric-phase program,
per batch kind and in total (round-4 verdict task 1a).

Usage: python scripts/flopcheck.py [n] [comp|exact]   (runs on the CPU)
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import hsolve
    from hsolve.utils.runtime import configure_compile_cache

    configure_compile_cache()
    from hsolve.factor import build_front, traced_numeric_phase
    from hsolve.planner import plan_factorization
    from hsolve.utils.profiling import analyze_plan

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    mode = sys.argv[2] if len(sys.argv) > 2 else "comp"
    A, b, shape = hsolve.helmholtz2d(n, k=float(n) / 3.2)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    if mode == "comp":
        opts = hsolve.SolverOptions(swlevel=-3, swsize=1, atol=1e-4, rtol=1e-4)
    else:
        opts = hsolve.SolverOptions(swlevel=0)
    plan = plan_factorization(A, tree, opts)
    stats = analyze_plan(plan)

    dtype = jnp.float64

    def xla_flops(fn, *args):
        c = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0]
        return float(c.get("flops", 0.0))

    # whole program
    fronts = [build_front(bp, dtype) for bp in plan.batches]
    total_xla = xla_flops(lambda fr: traced_numeric_phase(plan, fr, opts),
                          fronts)
    total_model = sum(s.flops for s in stats)
    print(f"TOTAL: model {total_model:.4g}  xla {total_xla:.4g}  "
          f"ratio {total_model / max(total_xla, 1.0):.3f}")

    # per-batch: compile the numeric phase one batch at a time by running
    # prefix programs and differencing is fragile; instead compile each batch
    # kind's kernel on its own where possible
    from hsolve.factor import _traced_range

    prev = 0.0
    for i in range(len(plan.batches)):
        f = xla_flops(
            lambda fr: _traced_range(plan, fr, opts, 0, i + 1, {}, dtype)[0],
            fronts[:i + 1])
        bp = plan.batches[i]
        kind = stats[i].kind
        print(f"batch {i:2d} {kind:11s} B={bp.B:4d} ni={bp.ni_pad:4d} "
              f"nb={bp.nb_pad:4d} cap={bp.rank_cap:3d}: "
              f"model {stats[i].flops:.4g}  xla {f - prev:.4g}  "
              f"ratio {stats[i].flops / max(f - prev, 1.0):.3f}")
        prev = f


if __name__ == "__main__":
    main()
