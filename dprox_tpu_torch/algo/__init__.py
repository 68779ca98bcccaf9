from . import lp
from .base import Algorithm
from .admm import ADMM, ADMM_vxu, LinearizedADMM
from .cadmm import ConsensusADMM
from .hqs import HQS
from .pc import PockChambolle
from .pgd import ProximalGradientDescent
from .problem import Problem, LPProblem
from .primitives import SOLVERS, compile, specialize, optimize, train, visualize
from .tune import log_descent, get_rho_sigma_admm
from .absorb import absorb_all_linops
from .equil import stochastic_equilibrate
from . import special
from .special import AutoTuneSolver, DEQSolver, UnrolledSolver

specialization = special  # the reference's name (dprox.algo.specialization)
