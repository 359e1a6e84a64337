"""Solver options.

Capability parity with the reference options struct
(``/root/reference/src/HierarchicalSolvers.jl:30-79``): the nine reference fields
(``swlevel, swsize, atol, rtol, c_tol, leafsize, kest, stepsize, verbose``) keep their
names, defaults and validation semantics.  The extensions control static-shape
planning (padding granularity, rank caps), precision and the pivot-block solve mode,
which have no counterpart in the reference's dynamically-shaped Julia code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SolverOptions:
    # --- reference-parity fields (defaults: HierarchicalSolvers.jl:43-59) ---
    swlevel: int = 5          # switching level at which to start compression
    swsize: int = 1           # minimum boundary size for compression
    atol: float = 1e-6        # absolute compression tolerance
    rtol: float = 1e-6        # relative compression tolerance
    c_tol: float = 0.5        # low-rank tol relative to HSS tol (ref declares but hard-codes 0.5)
    leafsize: int = 32        # HSS leaf size
    kest: int = -1            # initial rank estimate for randomized HSS sampling
    stepsize: int = 10        # rank-growth step for adaptive sampling
    verbose: bool = False

    # --- extensions (static-shape planning, precision, solve mode) ---
    pad: int = 8              # pad front dims (ni, nb) up to multiples of this
    rank_cap: int = 0         # static max rank for low-rank/HSS blocks (0 = planner
                              # decides: from kest when kest > 0 - the reference's
                              # user-provided rank estimate (factorization.jl:102-104,
                              # rungmres.jl:21 kest=200) - else boundary/4)
    rank_pad: int = 8         # pad ranks up to multiples of this
    # Per-tree-level rank caps, indexed by reference recursion level (root = 1,
    # level_caps[0] caps the root level; the LAST entry extends to all deeper
    # levels).  Overrides rank_cap/kest where set.  Separator interaction ranks
    # fall quickly below the top levels, and every structured-kernel shape
    # scales with cap^2 - calibrate with scripts/rankcal.py (the per-problem
    # analog of the reference's kest knob, rungmres.jl:21).
    level_caps: Optional[tuple] = None
    dtype: Optional[str] = None  # "float32" | "float64" | "complex64" | "complex128" | None (infer)
    # Matmul precision of the factor and solve programs.  It matters only for
    # f32/c64 data: on the GPU, "default" and "high" let f32 products run in
    # TF32 (about three decimal digits), "highest" keeps IEEE f32.  f64/c128
    # products are exact at every setting.
    matmul_precision: str = "highest"
    # Matmul precision for the STRUCTURED (HSS) kernels only; None inherits
    # matmul_precision.  TF32 ("default"/"high", f32 data only) errs by about
    # 1e-3 relative, so it suits only compression tolerances well above that;
    # the exact/dense path keeps matmul_precision.
    structured_precision: Optional[str] = None
    seed: int = 123           # PRNG seed for randomized compression (rungmres.jl:7)
    hss: bool = True          # emit HSS Schur complements on compressed levels
                              # (False = low-rank Gauss transforms only, dense S)
    explicit_inverse: bool = False  # store D^{-1} (and the root inverse) so
                              # every solve sweep is a GEMM instead of a pair of
                              # triangular solves.  On one H100 at helmholtz2d
                              # h=512 that makes the preconditioner apply ~3x
                              # faster but factor+solve only ties (PERF.md), and
                              # it trades backward stability: forward error
                              # ~cond(D)*eps per level, enough to stall f32
                              # escalation on a near-singular system.  Guard:
                              # Factorization.cond_report() flags levels whose
                              # pivot growth approaches 1/eps.
    fast_inverse: bool = False  # compute D^{-1} by recursive block-Schur
                              # inversion (pivoting confined to base diagonal
                              # blocks) instead of full pivoted LU + triangular
                              # solves: O(n/base) base LUs + O(log) GEMM levels.
                              # Only takes effect with explicit_inverse.
    adaptive: bool = False    # after a compressed factorization, check the computed
                              # interpolation ranks against the planned caps and
                              # re-factor with doubled caps on saturation (host-loop
                              # parity with randcompress_adaptive,
                              # factorization.jl:110).  Costs one small device->host
                              # fetch per factorization.

    def replace(self, **kwargs) -> "SolverOptions":
        """Kwarg-override copy (parity with ``copy(opts; args...)``,
        HierarchicalSolvers.jl:62-71)."""
        return dataclasses.replace(self, **kwargs)

    def validate(self) -> None:
        """Parity with ``chkopts!`` (HierarchicalSolvers.jl:73-79)."""
        if self.swsize < 1:
            raise ValueError("swsize must be >= 1")
        if self.atol < 0.0:
            raise ValueError("atol must be >= 0")
        if self.rtol < 0.0:
            raise ValueError("rtol must be >= 0")
        if not (0.0 < self.c_tol <= 1.0):
            raise ValueError("c_tol must be in (0, 1]")
        if self.leafsize < 1:
            raise ValueError("leafsize must be >= 1")
        if self.pad < 1:
            raise ValueError("pad must be >= 1")

    def resolve_fast_inverse(self) -> bool:
        """Block-Schur inversion runs only on the explicit-inverse path."""
        return bool(self.explicit_inverse and self.fast_inverse)

    def resolve_swlevel(self, tree_depth: int) -> int:
        """Negative swlevel counts from the bottom: ``max(depth + swlevel, 0)``
        (parity with factorization.jl:8)."""
        if self.swlevel < 0:
            return max(tree_depth + self.swlevel, 0)
        return self.swlevel
