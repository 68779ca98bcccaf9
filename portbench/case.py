"""What a configuration hands the harness for one run of one cell."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class Case:
    #: the timed path on the pool's j-th input: the port's entry point, as a
    #: user calls it, returning the answer on the device; it holds the
    #: program's state, which the harness drops before the check
    call: Callable[[int], torch.Tensor]
    #: the plain reference's answer for the j-th input; ``control=True``
    #: computes it in the precision below the configuration's
    reference: Callable[..., torch.Tensor]
    images_per_call: int
    #: ADMM iterations a call
    iterations: int
    #: ``work(traffic)`` of the configuration: operations per call and each
    #: kernel launch's bound
    counts: dict
    #: the data term's forward model, where the check compares what the
    #: answer and the reference predict for the observation
    observe: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
