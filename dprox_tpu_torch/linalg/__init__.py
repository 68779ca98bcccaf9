from .solvers import (SOLVERS, bdot, cg, cg2, cg_pallas, cg_unrolled, minres, pcg, plss, plssw)
from .solve import LinearSolveConfig, linear_solve, pcg_solve
