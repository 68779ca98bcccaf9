from . import lp
from .base import Algorithm
from .admm import ADMM
from .primitives import compile, SOLVERS
from .tune import log_descent
