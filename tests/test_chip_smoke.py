"""chip_smoke.py on the CPU: its phase functions and checks at h=33, and its refusal
to run - printing no result - where there is no GPU.  The card-only run is
``python chip_smoke.py`` on the GPU machine (README)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def prob():
    return cs.make_problem(33)


def _has_times(r):
    for k in ("plan_s", "plan_factor_cold_s", "factor_s", "solve_cold_s",
              "solve_s"):
        assert np.isfinite(r[k]) and r[k] > 0, k


def test_phase_exact(prob):
    r = cs.phase_exact(prob)
    assert r["iters"] == 1 and r["relres"] < 1e-12
    assert r["direct_err_vs_splu"] < 1e-12 and r["chunks"] == 1
    _has_times(r)
    json.dumps(r)


def test_phase_compressed(prob):
    """At h=33 the canonical swsize=480 gate keeps every front dense; the
    iteration band applies only at h=512 and is checked when given."""
    r = cs.phase_compressed(prob, None, None)
    assert r["converged"] and r["maxrank"] == 0
    with pytest.raises(cs.SmokeFailure, match="outside"):
        cs.phase_compressed(prob, (15, 21), 24)


def test_phase_complex():
    r = cs.phase_complex(cs.make_problem(33, damping=0.1))
    assert r["dtype"] == "complex128" and r["direct_err_vs_splu"] < 1e-12


def test_phase_complex_rejects_real(prob):
    with pytest.raises(cs.SmokeFailure, match="not complex"):
        cs.phase_complex(prob)


def test_phase_mixed(prob):
    r = cs.phase_mixed(prob, matmul_n=128)
    assert r["dtype"] == "float32" and r["relres"] <= cs.RELTOL
    assert r["f32_highest_is_ieee"] and r["f32_matmul_err_highest"] < 1e-5


def test_phase_inverse_modes(prob):
    exact = cs.phase_exact(prob)
    out = cs.phase_inverse_modes(prob, exact)
    assert set(out) == {"trsm", "explicit_lu", "explicit_block"}
    # the library default (triangular solves) is the exact phase's own run
    assert out["trsm"]["reused_from"] == "exact"
    assert "reused_from" not in out["explicit_lu"]
    for r in out.values():
        assert r["iters"] == 1 and r["direct_err_vs_splu"] < 1e-10


def test_phase_barrier_fields():
    # a CPU timing check says nothing about the card: only the fields and a
    # loose agreement are checked here
    r = cs.phase_barrier(n=128, chain=2, reps=2, tol=10.0)
    assert r["flops"] == 2.0 * 2 * 128 ** 3 and r["ratio"] > 0


def test_check_raises():
    cs.check(True, "unused")
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")


def test_matmul_precision_errors_small():
    errs = cs.matmul_precision_errors(n=64)
    assert errs["highest"] < 1e-5 and set(errs) == {"highest", "default"}


def test_main_requires_gpu(capsys):
    """The device check comes first and raises where JAX finds no GPU; nothing
    reaches stdout, least of all the result line."""
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_fails_without_gpu(script):
    """Run as scripts on a machine without a GPU, the entry points exit nonzero
    and print no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script, "--n", "8"], cwd=ROOT, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                       text=True, timeout=240)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"metric"' not in p.stdout


def test_trace_ops_reduces_a_trace():
    """scripts/trace_ops.py rehearsed on the CPU (``--cpu``): it traces a factor
    and solve and sums each trace line's events by name, heaviest first."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "scripts/trace_ops.py", "--cpu", "--n",
                        "12", "--dtype", "complex128", "--damping", "0.1"],
                       cwd=ROOT, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["relres"] < 1e-12 and r["lines"]
    for v in r["lines"].values():
        secs = [t[2] for t in v["top"]]
        assert secs == sorted(secs, reverse=True)
        assert v["events"] >= sum(t[1] for t in v["top"])
