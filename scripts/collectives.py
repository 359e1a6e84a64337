"""Collective accounting for the sharded factorization (round-3 verdict item 5).

Compiles the FULL numeric phase (traced_numeric_phase) over an n-device
('tree', 'front') virtual CPU mesh, dumps the optimized (post-partitioning) HLO,
and tabulates every collective XLA inserted - op kind, operand shape, bytes.
Alongside, prints the host-side per-level byte model
(hsolve.utils.profiling.collective_estimate), so the model can be compared with
what the partitioner actually emitted.  Writes COLLECTIVES.md at the repo root.

Usage (runs on the CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/collectives.py [--n 33] [--devices 8] [--front 2]
"""

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "collective-permute", "all-to-all")

_SHAPE_BYTES = {"f32": 4, "f64": 8, "c64": 8, "c128": 16, "s32": 4, "s64": 8,
                "bf16": 2, "u32": 4, "u64": 8, "pred": 1}


def shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO shape string like 'f32[8,128,128]' (tuples summed)."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _SHAPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _SHAPE_BYTES[dt]
    return total


def _plan_for(n, leafmax, swlevel, ntree):
    import hsolve
    from hsolve.planner import plan_factorization

    A, b, shape = hsolve.helmholtz2d(n, k=10.0)
    opts = hsolve.SolverOptions(swlevel=swlevel, swsize=1,
                                **({"atol": 1e-3, "rtol": 1e-3, "leafsize": 16}
                                   if swlevel else {}))
    plan = plan_factorization(A, tree=hsolve.nested_dissection(
        shape, leafmax=leafmax), opts=opts, batch_multiple=ntree)
    return plan, opts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=33)
    ap.add_argument("--leafmax", type=int, default=24)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--front", type=int, default=2)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from hsolve.utils.runtime import configure_compile_cache

    configure_compile_cache()

    import jax.numpy as jnp
    from hsolve.factor import build_front, traced_numeric_phase
    from hsolve.parallel.dist import make_mesh, shard_batch_spec
    from hsolve.utils.profiling import collective_estimate

    mesh = make_mesh(args.devices, front=args.front)
    ntree = mesh.shape["tree"]

    md = ["# COLLECTIVES — what the partitioner inserts for the sharded "
          "factorization", ""]
    meshes = [(args.devices, args.front)]
    if args.front != 1:
        # pure tree sharding: the apples-to-apples case for the panel model
        # (the front axis adds partial-sum all-reduces of sharded GEMMs,
        # which the tree-panel model deliberately does not book)
        meshes.append((args.devices, 1))
    for ndev, front in meshes:
        mesh = make_mesh(ndev, front=front)
        ntree = mesh.shape["tree"]
        for swlevel in (0, -2):
            plan, opts = _plan_for(args.n, args.leafmax, swlevel, ntree)
            fronts = [jax.device_put(build_front(bp, jnp.float32),
                                     shard_batch_spec(mesh, bp.B, 3))
                      for bp in plan.batches]
            hlo = jax.jit(lambda fr: traced_numeric_phase(plan, fr, opts)) \
                .lower(fronts).compile().as_text()
            hist = {}
            for line in hlo.splitlines():
                m = re.match(r"%?[\w.\-]+ = (\([^=]*\)|[^ ]+) (all-gather|"
                             r"all-reduce|reduce-scatter|collective-permute|"
                             r"all-to-all)", line.strip())
                if m:
                    h = hist.setdefault(m.group(2), {"count": 0, "bytes": 0})
                    h["count"] += 1
                    h["bytes"] += shape_bytes(m.group(1))
            model = collective_estimate(plan, ntree)
            actual = sum(h["bytes"] for h in hist.values())
            pred = model["total_comm_bytes"]

            print(f"mesh={dict(mesh.shape)} batches={len(plan.batches)} "
                  f"swlevel={swlevel}")
            print("collectives in optimized HLO:")
            for op, h in sorted(hist.items()):
                print(f"  {op:20s} x{h['count']:3d}  {h['bytes']/1e6:8.3f} MB")
            if not hist:
                print("  (none - every level stayed node-local on this mesh)")
            print(f"model {pred/1e6:.3f} MB vs actual {actual/1e6:.3f} MB "
                  f"(ratio {actual/max(pred,1):.2f})")

            md += [f"## mesh {dict(mesh.shape)}, swlevel={swlevel} "
                   f"(helmholtz2d n={args.n}, {len(plan.batches)} level "
                   "batches)", "",
                   "| collective | count | bytes |", "|---|---|---|"]
            for op, h in sorted(hist.items()):
                md.append(f"| {op} | {h['count']} | {h['bytes']:,} |")
            if not hist:
                md.append("| (none) | 0 | 0 |")
            md += ["",
                   f"**Predicted (tree-panel model) {pred/1e6:.3f} MB vs "
                   f"actual {actual/1e6:.3f} MB (actual/model "
                   f"{actual/max(pred,1):.2f})**.",
                   "",
                   f"per-level comm model (bytes): "
                   f"`{json.dumps(model['per_level'])}`", ""]
    md += ["## Observed lowering vs the model", "",
           "The partitioner turns the cross-batch child gathers of "
           "`_stage_children` into dynamic-slice + collective-permute "
           "pairs (the neighbor/halo pattern SURVEY section 5.8 predicted "
           "for the extend-add) - that part the tree-panel model "
           "(`hsolve.utils.profiling.collective_estimate`) books.  The "
           "HLO can carry more: all-reduces of the batched front buffers "
           "from the COO scatter assembly (`build_front_vals` scatters "
           "replicated values into a tree-sharded buffer), and with a "
           "`front>1` axis partial-sum all-reduces of front-sharded GEMMs, "
           "which the tree-panel model deliberately does not book.  The "
           "model is therefore a lower bound on the bytes moved.", ""]
    with open(os.path.join(ROOT, "COLLECTIVES.md"), "w") as f:
        f.write("\n".join(md))
    print("wrote COLLECTIVES.md")


if __name__ == "__main__":
    main()
