"""Two-process ``jax.distributed`` smoke test (CPU, single host).

The standard JAX recipe for multi-host-without-a-cluster: two processes join a
coordinator, form one global mesh over their CPU devices, and run a collective plus a
sharded batched-LU level kernel.  Validates the process-level plumbing a multi-process
deployment relies on (SURVEY.md section 5.8); the multi-GPU path itself is checked by
``chip_smoke.py --devices 4``.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

devs = jax.devices()  # global device list across both processes
assert len(devs) == 2, f"expected 2 global devices, got {len(devs)}"
mesh = Mesh(np.asarray(devs).reshape(2), axis_names=("tree",))

# a [2, n, n] level stack sharded one front per process; batched LU + solve
rng = np.random.default_rng(0)
Dn = rng.standard_normal((2, 8, 8)).astype(np.float32) + 8 * np.eye(8, dtype=np.float32)
bn = rng.standard_normal((2, 8, 1)).astype(np.float32)
pid = int(sys.argv[2])
sh = NamedSharding(mesh, P("tree"))
# each process contributes its own shard of the global [2, 8, 8] level stack
D = jax.make_array_from_process_local_data(sh, Dn[pid: pid + 1])
b = jax.make_array_from_process_local_data(sh, bn[pid: pid + 1])

@jax.jit
def level_solve(D, b):
    lu, piv = jax.lax.linalg.lu(D)[:2]
    x = jax.scipy.linalg.lu_solve((lu, piv), b)
    return jnp.sum(x * x)  # cross-process reduction

out = float(level_solve(D, b))
ref = 0.0
for i in range(2):
    ref += float(np.sum(np.linalg.solve(Dn[i], bn[i]) ** 2))
assert abs(out - ref) / abs(ref) < 1e-4, (out, ref)
print(f"proc {sys.argv[2]} ok {out:.6f}", flush=True)
"""


def test_two_process_distributed_cpu(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    addr = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} ok" in out
