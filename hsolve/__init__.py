"""hsolve: a hierarchical approximate sparse direct solver in JAX.

Built with the capabilities of bonevbs/HierarchicalSolvers.jl: nested-dissection
multifrontal factorization with low-rank / HSS compression, applied as a direct solver
or as a right preconditioner inside restarted GMRES, on one GPU or a mesh of them.
See SURVEY.md for the layer map of the reference.
"""

from hsolve.options import SolverOptions
from hsolve.utils.trees import (NDTree, parse_elimtree, serialize_elimtree, symfact,
                                postorder, permuted, contiguous)
from hsolve.models.problems import (poisson2d, helmholtz2d, poisson3d, helmholtz3d,
                                    p1_fem_2d)
from hsolve.models.dissect import nested_dissection
from hsolve.models.matio import read_problem, write_problem
from hsolve.planner import plan_factorization, Plan
from hsolve.factor import (factor, factor_with_plan, Factorization,
                           precondition_with_data)
from hsolve.krylov import fetch_gmres_info, gmres, gmres_compiled
from hsolve.ops.sparse import (to_ell, ell_matvec, to_dia, dia_matvec, spmv,
                               spmv_format)

__all__ = [
    "SolverOptions", "NDTree", "parse_elimtree", "serialize_elimtree", "symfact",
    "postorder", "permuted", "contiguous", "poisson2d", "helmholtz2d", "poisson3d",
    "helmholtz3d", "p1_fem_2d", "nested_dissection", "read_problem", "write_problem",
    "plan_factorization", "Plan", "factor", "factor_with_plan", "Factorization",
    "precondition_with_data", "gmres", "gmres_compiled", "fetch_gmres_info",
    "to_ell", "ell_matvec", "to_dia", "dia_matvec", "spmv", "spmv_format",
]

__version__ = "0.1.0"
