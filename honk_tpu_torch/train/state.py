"""Train state and optimizer (counterpart of ``honk_tpu.train.state``).

Optimizer parity with reference ``utils/train.py::train`` (SGD, momentum
0.9, weight decay 1e-5, lr ladder stepped on a global-step schedule), in
the order of the JAX package's optax chain ``add_decayed_weights ->
sgd(momentum)``: the decay is added to the gradient BEFORE the momentum,
on every parameter including the Dense bias; the momentum buffer starts at
zero, so the first update is the gradient itself. The learning rate of
update ``k`` (counted from 0) is ``lr_ladder(...)(k)``, read from
``state.step`` on each update.

``AdamW`` is the Keyword Transformer's recipe (Berg, O'Connor & Cruz,
Interspeech 2021, arXiv:2104.00769, the training table), which the port
alone has: ``torch.optim.AdamW`` (decoupled weight decay 0.1, multiplied by
the learning rate as PyTorch and optax do; betas (0.9, 0.999), eps 1e-8)
with a peak lr of 1e-3 reached by a linear warm-up over 10 epochs, then a
cosine decay to 0 at the run's last update (``warmup_cosine``), and label
smoothing 0.1 in the loss. Each optimizer carries the label smoothing its
recipe puts into the loss (``train.steps``): SGD's is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    """Updates made so far, the model (params and BN buffers) and its optimizer (momentum buffers)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


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


def warmup_cosine(peak: float, warmup: int, total: int) -> Callable[[int], float]:
    """The lr of update ``k`` (from 0): ``peak * (k + 1) / warmup`` for ``k < warmup``, so that update 0
    moves the weights; then ``peak * (1 + cos(pi * (k - warmup) / (total - warmup))) / 2``; 0 from
    ``total`` on."""

    def schedule(count: int) -> float:
        if count >= total:
            return 0.0
        if count < warmup:
            return peak * (count + 1) / warmup
        return 0.5 * peak * (1.0 + math.cos(math.pi * (count - warmup) / (total - warmup)))

    return schedule


class _Optimizer:
    """What the recipes share: one update from the params' ``.grad`` at the schedule's lr."""

    def apply(self, state: TrainState) -> None:
        """One update from the params' ``.grad``; advances ``state.step``."""
        for group in state.optimizer.param_groups:
            group["lr"] = self.schedule(state.step)
        state.optimizer.step()
        state.step += 1


@dataclasses.dataclass(frozen=True)
class SGD(_Optimizer):
    """The optax chain as ``torch.optim.SGD`` (whose weight decay is added to
    the gradient before the momentum) with the lr read from the ladder."""

    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-5
    nesterov: bool = False
    label_smoothing: float = 0.0

    def init(self, model: nn.Module) -> torch.optim.SGD:
        opt = torch.optim.SGD(model.parameters(), lr=self.schedule(0), momentum=self.momentum,
                              weight_decay=self.weight_decay, nesterov=self.nesterov)
        # Zero buffers up front, as optax's trace: a fresh state's state_dict
        # then has the shapes a resume payload is checked against.
        for p in model.parameters():
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        return opt


@dataclasses.dataclass(frozen=True)
class AdamW(_Optimizer):
    """``torch.optim.AdamW`` with the lr read from ``schedule``, and the loss's label smoothing."""

    schedule: Callable[[int], float]
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.1
    label_smoothing: float = 0.1

    def init(self, model: nn.Module) -> torch.optim.AdamW:
        opt = torch.optim.AdamW(model.parameters(), lr=self.schedule(0), betas=self.betas, eps=self.eps,
                                weight_decay=self.weight_decay)
        # Zero moments up front, as SGD's buffers: a fresh state's state_dict has a resume payload's shapes.
        for p in model.parameters():
            opt.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
        return opt


def make_optimizer(
    lrs: Sequence[float] = (0.1, 0.01, 0.001),
    boundaries: Sequence[int] = (3000, 6000),
    momentum: float = 0.9,
    weight_decay: float = 1e-5,
    nesterov: bool = False,
) -> SGD:
    return SGD(lr_ladder(lrs, boundaries), momentum, weight_decay, nesterov)


def make_adamw(steps_per_epoch: int, n_epochs: int) -> AdamW:
    """KWT's recipe for a run of ``n_epochs`` epochs of ``steps_per_epoch`` updates: the lr's warm-up to
    1e-3 over 10 epochs, its cosine decay to 0 at the run's last update."""
    return AdamW(warmup_cosine(1e-3, 10 * steps_per_epoch, n_epochs * steps_per_epoch))


def create_train_state(model: nn.Module, tx: SGD | AdamW) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.init(model))
