from .solvers import (SOLVERS, bdot, cg, cg2, cg_pallas, cg_unrolled, minres, pcg, plss, plssw)
from .solve import LinearSolveConfig, linear_solve, pcg_solve

LinearSolve = linear_solve  # the reference's name (its torch.autograd.Function)
