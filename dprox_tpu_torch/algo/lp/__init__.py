from .consensus import ConsensusLPSolver, ScenarioLP, solve_consensus_lp
from .solvers import LPProblem, LPSolverADMM, LPConvergenceLoss, solve_lp
from .utils import (BSRMat, bsr_from_numpy, lp_params_from_numpy,
                    ruiz_equilibration_sparse, scipy_to_bcoo, scipy_to_device_op)
