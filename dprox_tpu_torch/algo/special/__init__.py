from .deq import DEQSolver, deq_fixed_point, train_deq
from .fixed_point import FIXED_POINT_SOLVERS, anderson, broyden
from .rl import AutoTuneSolver
from .training import load_checkpoint, save_checkpoint, train_supervised
from .unroll import UnrolledSolver, build_unrolled_solver

SPECIALIZATIONS = {
    "unroll": build_unrolled_solver,
    "deq": DEQSolver,
    "rl": AutoTuneSolver,
}
