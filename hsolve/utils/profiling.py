"""Observability: FLOP accounting, per-level stats, roofline (speed-of-light) analysis.

The reference has no profiling beyond ad-hoc ``@timed`` calls (SURVEY.md section 5.1);
this module provides the per-kernel accounting: factorization GFLOP/s and nnz/s with
per-level speed-of-light bounds against the published peaks of the device the
factorization ran on (:data:`DEVICE_PEAKS`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

# Published peaks, keyed by ``jax.Device.device_kind``.  Source: NVIDIA H100 SXM
# data sheet, dense rates without sparsity, at the full 700 W power limit:
# 67 TFLOP/s f64 (tensor core), 67 TFLOP/s f32, 495 TFLOP/s TF32, 3.35 TB/s HBM3.
# A card set below 700 W (nvidia-smi power.limit) cannot hold these rates.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f64_flops": 67e12, "f32_flops": 67e12,
                              "tf32_flops": 495e12, "hbm_bytes_s": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """Peaks of ``device_kind``; a kind missing from the table is an error."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add them to "
            "hsolve.utils.profiling.DEVICE_PEAKS with their source") from None


@dataclasses.dataclass
class LevelStats:
    kind: str
    B: int
    ni_pad: int
    nb_pad: int
    flops: float          # factor-time floating point ops
    bytes_moved: float    # rough HBM traffic of the factor kernels
    solve_flops: float    # per right-hand side application
    # share of ``flops`` spent in LU / triangular-solve kernels.  XLA's
    # cost_analysis reports 0 flops for the LAPACK (CPU) and cuSOLVER/cuBLAS
    # (GPU) custom calls these lower to, so model-vs-XLA validation compares
    # ``flops - lapack_flops`` (tests/test_aux.py).
    lapack_flops: float = 0.0


def _dense_level_flops(B, ni, nb):
    lu = 2.0 / 3.0 * ni ** 3
    trsm = 2.0 * ni * ni * nb * 2          # L and R solves
    schur = 2.0 * nb * nb * ni
    return B * (lu + trsm + schur)


def _compressed_level_flops(B, ni, nb, k):
    lu = 2.0 / 3.0 * ni ** 3
    sample = 2.0 * nb * ni * (k + 8) * 2    # randomized range finding both sides
    fold = 2.0 * ni * ni * k * 2            # D-solves on k columns
    schur = 2.0 * nb * ni * k + 2.0 * nb * nb * k
    return B * (lu + sample + fold + schur)


# ---------------------------------------------------------------------------
# Derived HSS / structured kernel FLOP model (round-3 verdict item 6).
#
# Each helper mirrors the loop structure of the kernel it models (ops/hss.py,
# structured.py) and sums GEMM (2mnk) / LU (2/3 n^3) / triangular-solve (2n^2 k)
# costs level by level - no hand-waved constants.  Validated against XLA's
# cost_analysis of the compiled structured batch in tests/test_aux.py.
# ---------------------------------------------------------------------------

def _gemm(b, m, n, k):
    return 2.0 * b * m * n * k


def _lu(b, n):
    return 2.0 / 3.0 * b * n ** 3


def _lu_solve(b, n, k):
    return 2.0 * b * n * n * k             # two triangular solves


def _hss_upsweep_flops(n, ls, r, to_level, k):
    """_upsweep (ops/hss.py): leaf V^T Y + to_level W-translations."""
    nl = max(n // max(ls, 1), 1)
    f = _gemm(nl, r, ls, k)
    m2 = nl
    for _ in range(to_level):
        f += _gemm(m2, r, r, k)
        m2 = max(m2 // 2, 1)
    return f


def _hss_matvec_flops(n, ls, r, d, k):
    """hss_matvec: upsweep + per-level couplings + downsweep + D x + U acc."""
    nl = max(n // max(ls, 1), 1)
    f = _hss_upsweep_flops(n, ls, r, d - 1, k)
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += 2 * _gemm(m, r, r, k)          # B12 / B21
    for lev in range(d - 1, 0, -1):
        f += _gemm(max(nl >> (lev - 1), 1), r, r, k)   # R downsweep
    f += _gemm(nl, ls, ls, k)               # D @ x
    f += _gemm(nl, ls, r, k)                # U @ acc
    return f


def _hss_solve_flops(n, ls, r, d, k, upto=None):
    """_solve_upto: leaf LU solve + one Woodbury correction per level."""
    nl = max(n // max(ls, 1), 1)
    f = _lu_solve(nl, ls, k)
    for lev in range(1, (d if upto is None else upto) + 1):
        m = max(nl >> lev, 1)
        f += _hss_upsweep_flops(n, ls, r, lev - 1, k)
        f += 2 * _gemm(m, r, r, k)          # eta = B @ xi
        f += _lu_solve(m, 2 * r, k)         # Woodbury core solve
        f += _gemm(1, n, r, k)              # Phi correction (2m x blk x r, k)
    return f


def _hss_factor_flops(n, ls, r, d):
    """hss_factor: leaf LU + per level (2 partial solves + 2 upsweeps on r columns,
    core assembly, 2 core LUs) + materialize_bases."""
    nl = max(n // max(ls, 1), 1)
    f = _lu(nl, ls)
    f += 2 * _gemm(1, n, r, r) * max(d - 1, 0)          # materialize_bases (U and V)
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += _hss_solve_flops(n, ls, r, d, r, upto=lev - 1) * 2
        f += _hss_upsweep_flops(n, ls, r, lev - 1, r) * 2
        f += 4 * _gemm(m, r, r, r)          # B @ G core assembly (M and N)
        f += 2 * _lu(m, 2 * r)
    return f


def _hss_entry_factors_flops(n, ls, r, d):
    """hss_entry_factors: materialize_bases + per-level T einsum."""
    return 2 * _gemm(1, n, r, r) * max(d - 1, 0) + _gemm(1, n, r, r) * d


def _hss_entries_flops(a, b, r, d):
    """hss_entries_prepared on an [a, b] block: one T @ V^T product per level
    (computed for every level, then masked by LCA)."""
    return _gemm(1, a, r, b) * d


def _interp_decomp_flops(a, b, cap):
    """interp_decomp of [a, b] truncated at cap: CPQR sweep + T solve."""
    return 4.0 * a * b * min(cap, a, b)


def _randcompress_flops(n, ls, r, d, s, sample_flops, entry_flops):
    """_hss_randcompress_once (telescoping sketch-residual scheme): 2 sketches,
    leaf D extraction + leaf IDs, then per level exact [r, r] couplings +
    r x s / r x r panel algebra + interpolative decomposition of [2r, s]
    candidate panels (O(n r s) total - no n-wide panels)."""
    nl = max(n // max(ls, 1), 1)
    f = 2 * sample_flops(s)
    f += nl * entry_flops(ls, ls)                    # leaf D blocks
    f += 2 * _gemm(nl, ls, ls, s)                    # Y -= D Om (both sides)
    f += 2 * nl * _interp_decomp_flops(ls, s, r)
    f += 2 * _gemm(nl, r, ls, s)                     # leaf OmP / PsP projections
    for lev in range(1, d + 1):
        m = max(nl >> lev, 1)
        f += 2 * m * entry_flops(r, r)               # B12/B21 exact blocks
        if lev == d:
            break
        # candidate panels (8 r x r x s GEMMs), projection updates (4), basis
        # updates (4 r x r x r), two [2r, s] IDs
        f += m * (12 * _gemm(1, r, r, s) + 4 * _gemm(1, r, r, r))
        f += 2 * m * _interp_decomp_flops(2 * r, s, r)
    return f


def _structured_batch_flops(bp, child_rank: int, opts) -> tuple:
    """Mirror of _structured_factor_jit + d_apply (structured.py): returns
    (factor_flops, solve_flops_per_rhs) for ONE node; multiply by B outside."""
    cpl, cpr = bp.child_cplans
    h1, h2 = cpl.half, cpr.half
    q1, q2 = cpl.n_pad - cpl.half, cpr.n_pad - cpr.half
    r = child_rank
    ls1, d1 = cpl.ls, cpl.depth - 1          # hss_sub plans of the child halves
    ls2, d2 = cpr.ls, cpr.depth - 1
    cr = bp.cross
    r12 = cr["ci12"]["rcap"]
    rib = cr["cib12"]["rcap"] + cr["cib21"]["rcap"]
    rbi = cr["cbi12"]["rcap"] + cr["cbi21"]["rcap"]
    kk_ib = 2 * r + rib
    kk_bi = 2 * r + rbi
    stepsize = max(opts.stepsize, 8) if opts else 16
    kest = opts.kest if opts else -1
    cap = bp.rank_cap
    s = min((kest if kest > 0 else max(cap // 2, 16)) + stepsize, bp.cplan.n_pad)

    def solve1(k):
        return _hss_solve_flops(h1, ls1, r, d1, k)

    def solve22(k):
        return _hss_solve_flops(h2, ls2, cap, d2, k)

    def mv2(k):
        return _hss_matvec_flops(h2, ls2, r, d2, k)

    def d_apply_flops(k):
        # solve1 + C21 skinny + 2x solve22 (refinement) + s22_mv + WU correction
        f = solve1(k)
        f += _gemm(1, r12, h1, k) + _gemm(1, h2, r12, k)        # C21 y1
        f += 2 * solve22(k)
        f += mv2(k) + _gemm(1, r12, h2, k) + _gemm(1, h1, r12, k) \
            + _gemm(1, r12, h1, k) + _gemm(1, h2, r12, k)       # s22_mv skinny
        f += _gemm(1, r12, h2, k) + _gemm(1, h1, r12, k)        # WU (V12^T y2)
        return f

    f = 0.0
    # generators: materialize_bases per child + root coupling folds
    f += 2 * (2 * _gemm(1, cpl.n_pad, r, r) * max(cpl.depth - 1, 0))
    f += _gemm(1, h1, r, r) + _gemm(1, q1, r, r) \
        + _gemm(1, h2, r, r) + _gemm(1, q2, r, r)               # U @ B12 root folds
    # pivot: hss_factor(H1) + WU + G21
    f += _hss_factor_flops(h1, ls1, r, d1)
    f += solve1(r12)                                            # WU
    f += _gemm(1, r12, h1, r12) + _gemm(1, h2, r12, r12)        # G21
    # S22' recompression: entry factors + randomized interpolative build + factor
    f += _hss_entry_factors_flops(h2, ls2, r, d2)
    f += _randcompress_flops(
        h2, ls2, cap, d2, s,
        sample_flops=lambda k: mv2(k) + _gemm(1, r12, h2, k) + _gemm(1, h2, r12, k),
        entry_flops=lambda a, b: _hss_entries_flops(a, b, r, d2)
        + _gemm(1, a, r12, b))
    f += _hss_factor_flops(h2, ls2, cap, d2)
    # Gauss transforms: R = D^{-1} AibU, L^T = D^{-T} AbiV
    f += d_apply_flops(kk_ib) + d_apply_flops(kk_bi)
    # KU = AbiU (AbiV^T RU)
    h = h1 + h2
    q = q1 + q2
    f += _gemm(1, kk_bi, h, kk_ib) + _gemm(1, q, kk_bi, kk_ib)
    # parent S sampling: 2 boundary-half matvecs + couplings + KU/RV correction
    rbb = cr["cbb12"]["rcap"] + cr["cbb21"]["rcap"]

    def s_sample(k):
        return (_hss_matvec_flops(q1, ls1, r, d1, k)
                + _hss_matvec_flops(q2, ls2, r, d2, k)
                + _gemm(1, rbb, q, k) + _gemm(1, q, rbb, k)
                + _gemm(1, kk_ib, q, k) + _gemm(1, q, kk_ib, k))

    f += _hss_entry_factors_flops(q1, ls1, r, d1) \
        + _hss_entry_factors_flops(q2, ls2, r, d2)
    f += _randcompress_flops(
        bp.cplan.n_pad, bp.cplan.ls, cap, bp.cplan.depth, s,
        sample_flops=s_sample,
        entry_flops=lambda a, b: _hss_entries_flops(a, b, r, max(d1, d2))
        + _gemm(1, a, rbb + kk_ib, b))

    # solve sweep per rhs: skinny L/R (rank kk) + pivot block substitution
    solve = d_apply_flops(1) + 2 * (_gemm(1, kk_bi, h, 1) + _gemm(1, q, kk_bi, 1))
    return f, solve


def analyze_plan(plan, dtype_bytes: int = 4) -> List[LevelStats]:
    """Static per-batch accounting from the planner's schedule."""
    out = []
    for idx, bp in enumerate(plan.batches):
        ni, nb, B = bp.ni_pad, bp.nb_pad, bp.B
        if bp.structured:
            # derived per-kernel model (mirrors _structured_factor_jit level by
            # level; validated against XLA cost_analysis in tests/test_aux.py).
            # The child generator rank is the SOURCE batch's planned cap.
            child_rank = max((plan.batches[g.src_batch].rank_cap
                              for g in bp.groups_l + bp.groups_r), default=16)
            f1, s1 = _structured_batch_flops(bp, child_rank,
                                             getattr(plan, "opts", None))
            flops = B * f1
            solve = B * s1
            kind = "structured"
            # LU work on the structured path happens in [m, ls, ls] / [m, 2r, 2r]
            # leaf blocks - a small share (the measured whole-program ratio vs
            # XLA:CPU is ~1.0 with lapack=0 here)
            lapack = 0.0
        elif bp.compress:
            flops = _compressed_level_flops(B, ni, nb, bp.rank_cap)
            solve = B * (2.0 * ni * ni + 4.0 * (ni + nb) * bp.rank_cap)
            kind = "compressed"
            lapack = B * (_lu(1, ni) + 2.0 * ni * ni * bp.rank_cap * 2)
        else:
            flops = _dense_level_flops(B, ni, nb)
            solve = B * (2.0 * ni * ni + 4.0 * ni * nb)
            kind = "leaf" if bp.is_leaf else "dense"
            lapack = B * (_lu(1, ni) + 2.0 * ni * ni * nb * 2)
        m = ni + nb
        if bp.structured:
            # no dense [m, m] buffer exists on the structured path: traffic is
            # linear in the HSS representations (leaf D blocks + generators +
            # level translations), a few passes each
            cpl, cpr = bp.child_cplans
            r = bp.rank_cap
            rep = (cpl.n_pad * (cpl.ls + 6 * r) + cpr.n_pad * (cpr.ls + 6 * r))
            bytes_moved = B * 4.0 * rep * dtype_bytes
        else:
            bytes_moved = B * (3.0 * m * m) * dtype_bytes
        out.append(LevelStats(kind=kind, B=B, ni_pad=ni, nb_pad=nb, flops=flops,
                              bytes_moved=bytes_moved, solve_flops=solve,
                              lapack_flops=lapack))
    return out


def factor_flops(plan, dtype_bytes: int = 4) -> float:
    return float(sum(s.flops for s in analyze_plan(plan, dtype_bytes)))


def solve_flops(plan, dtype_bytes: int = 4) -> float:
    return float(sum(s.solve_flops for s in analyze_plan(plan, dtype_bytes)))


def roofline_report(plan, measured_factor_s: float, device_kind: str,
                    dtype="float64") -> dict:
    """Speed-of-light accounting: achieved GFLOP/s + nnz/s vs the per-level roofline
    bound (max of compute-limit and bandwidth-limit times, summed over levels)
    against the peaks of ``device_kind``.  ``dtype`` is the factorization dtype:
    f64/c128 levels are bound by the f64 peak, f32/c64 levels by the f32 peak, or
    by the TF32 peak where their matmul precision lets f32 products run in TF32.
    Complex levels count real-equivalent GEMM flops (2mnk), a lower bound."""
    peaks = device_peaks(device_kind)
    dt = np.dtype(dtype)
    f32 = np.zeros((), dt).real.dtype == np.float32
    stats = analyze_plan(plan, dt.itemsize)
    total_flops = sum(s.flops for s in stats)
    bw = peaks["hbm_bytes_s"]
    opts = getattr(plan, "opts", None)
    mprec = getattr(opts, "matmul_precision", None)
    sprec = getattr(opts, "structured_precision", None) or mprec

    def lvl_peak(s):
        prec = sprec if s.kind == "structured" else mprec
        if f32 and prec in ("default", "high"):
            return peaks["tf32_flops"]
        return peaks["f32_flops" if f32 else "f64_flops"]

    sol_time = sum(max(s.flops / lvl_peak(s), s.bytes_moved / bw)
                   for s in stats)
    per_level = [{
        "kind": s.kind, "B": s.B, "front": [s.ni_pad, s.nb_pad],
        "gflops": round(s.flops / 1e9, 3),
        "sol_ms": round(max(s.flops / lvl_peak(s), s.bytes_moved / bw) * 1e3,
                        3),
    } for s in stats]
    sol_fraction = sol_time / max(measured_factor_s, 1e-12)
    achieved = total_flops / max(measured_factor_s, 1e-12)
    # physics guard: a measurement faster than the model's own speed-of-light
    # bound (sol_fraction > 1) or above the chip's peak means the FLOP model
    # over-counts or the timing under-measures - either way the row is not a
    # result and must be flagged, never published as-is
    peak_eff = max((lvl_peak(s) for s in stats), default=0.0)
    violation = bool(sol_fraction > 1.0 or achieved > peak_eff)
    return {
        "device_kind": device_kind,
        "factor_gflops": round(total_flops / 1e9, 3),
        "achieved_gflop_s": round(achieved / 1e9, 2),
        "speed_of_light_s": round(sol_time, 6),
        "sol_fraction": round(sol_fraction, 4),
        "sol_violation": violation,
        "nnz_per_s": round(plan.nnz / max(measured_factor_s, 1e-12), 1),
        "per_level": per_level,
    }


def collective_estimate(plan, ntree: int, dtype_bytes: int = 4) -> dict:
    """Per-level estimate of the bytes XLA's partitioner must move between devices
    for a tree-sharded run (SURVEY section 5.8).

    The communication pattern of the level-synchronous schedule is exactly the
    cross-batch child gather (_stage_children): a parent batch sharded over the
    ``tree`` axis consumes rows of an earlier (also tree-sharded) Schur stack,
    which the partitioner lowers to per-panel dynamic-slice +
    collective-permute exchanges (observed in the compiled HLO,
    scripts/collectives.py).  With contiguous block sharding most panels stay
    on their consumer's device; this model counts exactly the panels whose
    owner shard differs from the consumer shard (from the plan's
    src_rows/dst_rows maps).  The solve sweeps move the same panels once per
    application.  Everything else (front build, LU, GEMMs, compression) is
    node-local by construction.

    Returns per-level bytes and total bytes.
    """
    per_level = []
    total_comm = 0.0
    for i, bp in enumerate(plan.batches):
        gathered = 0.0
        dst_sharded = bp.B % ntree == 0 and ntree > 1
        for g in (tuple(bp.groups_l) + tuple(bp.groups_r)):
            src = plan.batches[g.src_batch]
            if src.cplan is not None and getattr(src, "compress", False):
                # HSS child panel: leaf blocks + generators, linear in n_pad
                npd, ls, r = src.cplan.n_pad, src.cplan.ls, max(src.rank_cap, 1)
                panel = npd * (ls + 4.0 * r) * dtype_bytes
            else:
                s_pad = src.nb_pad if src.nb_pad else src.ni_pad
                panel = float(s_pad) * s_pad * dtype_bytes
            src_sharded = src.B % ntree == 0 and ntree > 1
            srows = np.asarray(g.src_rows)
            drows = np.asarray(g.dst_rows)
            if src_sharded and dst_sharded:
                # contiguous-block shard mapping: a panel moves between devices
                # only when its owner shard differs from the consumer's (child
                # row 2j lands on parent row j's shard for balanced trees, so
                # most panels are LOCAL - exactly the dynamic-slice +
                # collective-permute pattern the partitioner emits)
                sdev = (srows * ntree) // src.B
                ddev = (drows * ntree) // bp.B
                gathered += panel * float(np.sum(sdev != ddev))
            elif src_sharded and not dst_sharded:
                # replicated consumer: every other device needs each panel
                gathered += panel * len(srows) * (ntree - 1) / ntree
            # replicated source -> any consumer: no movement
        per_level.append({"batch": i, "comm_bytes": round(gathered, 0)})
        total_comm += gathered
    return {"ntree": ntree, "per_level": per_level,
            "total_comm_bytes": round(total_comm, 0)}


class Timer:
    """Minimal wall-clock scope timer collecting named spans (verbose-mode analog of
    the reference's opts.verbose prints, factorization.jl:17,22)."""

    def __init__(self):
        self.spans = {}

    def span(self, name):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                timer.spans[name] = timer.spans.get(name, 0.0) + \
                    (time.perf_counter() - self.t0)

        return _Ctx()


def trace(logdir: str):
    """jax.profiler trace context for device timeline capture."""
    import jax

    return jax.profiler.trace(logdir)
