"""Train state and optimizer (counterpart of ``honk_tpu.train.state``).

Optimizer parity with reference ``utils/train.py::train`` (SGD, momentum
0.9, weight decay 1e-5, lr ladder stepped on a global-step schedule), in
the order of the JAX package's optax chain ``add_decayed_weights ->
sgd(momentum)``: the decay is added to the gradient BEFORE the momentum,
on every parameter including the Dense bias; the momentum buffer starts at
zero, so the first update is the gradient itself. The learning rate of
update ``k`` (counted from 0) is ``lr_ladder(...)(k)``, read from
``state.step`` on each update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    """Updates made so far, the model (params and BN buffers) and its optimizer (momentum buffers)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.SGD


def lr_ladder(lrs: Sequence[float], boundaries: Sequence[int]) -> Callable[[int], float]:
    """Piecewise-constant lr: lrs[i] between boundaries[i-1] and boundaries[i].

    Equal, as float32, to ``optax.piecewise_constant_schedule`` as the JAX
    package builds it: the value switches when the update count EQUALS a
    boundary, and is the float32 product of ``lrs[0]`` and the ratios
    ``lrs[i+1] / lrs[i]`` passed so far: the second rung of (0.1, 0.01) is
    float32(float32(0.01 / 0.1) * float32(0.1)), which need not be
    float32(0.01).
    """
    lrs = list(lrs)
    boundaries = [int(b) for b in boundaries]
    if len(lrs) == 1:
        value = float(np.float32(lrs[0]))
        return lambda count: value
    if len(boundaries) < len(lrs) - 1:
        raise ValueError(f"need a boundary per lr step: lrs {lrs}, boundaries {boundaries}")
    steps = sorted({b: lrs[i + 1] / lrs[i] for i, b in enumerate(boundaries[: len(lrs) - 1])}.items())

    def schedule(count: int) -> float:
        v = np.float32(lrs[0])
        for b, scale in steps:
            if count >= b:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """The optax chain as ``torch.optim.SGD`` (whose weight decay is added to
    the gradient before the momentum) with the lr read from the ladder."""

    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-5
    nesterov: bool = False

    def init(self, model: nn.Module) -> torch.optim.SGD:
        opt = torch.optim.SGD(model.parameters(), lr=self.schedule(0), momentum=self.momentum,
                              weight_decay=self.weight_decay, nesterov=self.nesterov)
        # Zero buffers up front, as optax's trace: a fresh state's state_dict
        # then has the shapes a resume payload is checked against.
        for p in model.parameters():
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt

    def apply(self, state: TrainState) -> None:
        """One update from the params' ``.grad``; advances ``state.step``."""
        for group in state.optimizer.param_groups:
            group["lr"] = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1


def make_optimizer(
    lrs: Sequence[float] = (0.1, 0.01, 0.001),
    boundaries: Sequence[int] = (3000, 6000),
    momentum: float = 0.9,
    weight_decay: float = 1e-5,
    nesterov: bool = False,
) -> SGD:
    return SGD(lr_ladder(lrs, boundaries), momentum, weight_decay, nesterov)


def create_train_state(model: nn.Module, tx: SGD) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.init(model))
