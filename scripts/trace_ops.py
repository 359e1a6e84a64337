"""Device time by operation for the exact factor and solve, from a profiler trace.

Factors helmholtz2d(n, k=40) (``--damping`` makes it complex) with ``swlevel=0``
in ``--dtype``, times the warm factor and ``F.solve`` with ``block_until_ready``,
then traces one more factor + solve with ``jax.profiler`` and sums the device
events of each trace line by name.  Prints one JSON line: the warm times and,
per device line (the streams), its total and its TOP heaviest events.  The
trace is written under ``traces/``.

Runs on the GPU and fails without one; ``--cpu`` reduces the host plane instead,
to rehearse the script (its numbers are then no device times).

Usage: python scripts/trace_ops.py [--n 128] [--damping 0] [--dtype float64]
                                   [--cpu]
"""

import argparse
import collections
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TOP = 12


def reduce_trace(path, plane_prefix, top):
    """{plane/line: {"total_s", "events", "top": [[name, count, seconds]]}}
    for every line of the planes whose name starts with ``plane_prefix``."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            acc = collections.defaultdict(lambda: [0, 0.0])
            for ev in line.events:
                a = acc[ev.name[:120]]
                a[0] += 1
                a[1] += ev.duration_ns * 1e-9
            if not acc:
                continue
            ranked = sorted(acc.items(), key=lambda kv: -kv[1][1])
            out[f"{plane.name}/{line.name}"] = {
                "total_s": sum(v[1] for v in acc.values()),
                "events": sum(v[0] for v in acc.values()),
                "top": [[k, v[0], v[1]] for k, v in ranked[:top]]}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--damping", type=float, default=0.0)
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "complex128", "float32", "complex64"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hsolve.utils.runtime import configure_compile_cache, require_gpu

    if not args.cpu:
        require_gpu()
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    import numpy as np

    import hsolve

    A, b, shape = hsolve.helmholtz2d(args.n, k=40.0, damping=args.damping)
    b = np.asarray(b)
    tree = hsolve.nested_dissection(shape, leafmax=100)
    F = hsolve.factor(A, tree, swlevel=0, dtype=args.dtype)
    jax.block_until_ready(F.solve(b))

    def run():
        G = hsolve.factor_with_plan(F.plan, F.opts, dtype=args.dtype)
        jax.block_until_ready((G.levels, G.root))
        t1 = time.perf_counter()
        x = jax.block_until_ready(G.solve(b))
        return t1, x

    t0 = time.perf_counter()
    t1, x = run()
    times = {"factor_s": t1 - t0, "solve_s": time.perf_counter() - t1}
    xh = np.asarray(x)
    relres = float(np.linalg.norm(A @ xh - b) / np.linalg.norm(b))
    tag = f"h{args.n}_{args.dtype}"
    tdir = os.path.join(ROOT, "traces", tag)
    with jax.profiler.trace(tdir):
        run()
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    lines = reduce_trace(path, "/host:CPU" if args.cpu else "/device:GPU",
                         TOP)
    dev = jax.devices()[0]
    print(json.dumps({"problem": f"helmholtz2d_{tag}", "N": int(A.shape[0]),
                      "device_kind": dev.device_kind, "relres": relres,
                      **times, "trace": path, "lines": lines}), flush=True)


if __name__ == "__main__":
    main()
