"""The Honk recipe (a training traffic's ``"recipe": "honk_sgd"``): forward, mean cross-entropy, autograd, SGD.

SGD with momentum 0.9 and weight decay 1e-5 added to the gradient before
the momentum (optax's ``add_decayed_weights -> sgd(momentum)``, also
``torch.optim.SGD``'s order); the momentum buffer starts as the first
step's decayed gradient; the learning rate of update ``k`` (from 0) is the
ladder's, 0.1 / 0.01 / 0.001 switching at 3,000 and 6,000 updates.

``rows`` and ``divisor`` plant what a step would do with part of its
batch: the rows it reads and what its cross-entropy sum is divided by.
A sound step reads every row and divides by the batch.

The port's side: ``make_optimizer()`` with its defaults, the same recipe,
and the first gradient read back from its momentum after one step (the
buffer starts at zero, so it holds the decayed gradient).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from .precision import Rounding, no_tf32

PORT_OPTIMIZER = "honk_tpu_torch.train.state:SGD"


def port_optimizer(port):
    """The port's optimizer of this recipe (``port`` resolves a ``module:attribute`` name of the port)."""
    return port("honk_tpu_torch.train:make_optimizer")()


def first_gradient(optimizer, param: torch.Tensor, param0: torch.Tensor) -> torch.Tensor:
    """``param``'s first gradient as ``optimizer`` (the port's ``torch.optim.SGD``, after one step) got it: its
    momentum less the decay of ``param0``, the value before the step."""
    return optimizer.state[param]["momentum_buffer"] - optimizer.param_groups[0]["weight_decay"] * param0


def ladder(step: int, lrs=(0.1, 0.01, 0.001), boundaries=(3000, 6000)) -> float:
    lr = lrs[0]
    for b, nxt in zip(boundaries, lrs[1:]):
        if step >= b:
            lr = nxt
    return lr


def steps(params0: dict, config: dict, batches: Iterable[tuple[torch.Tensor, torch.Tensor]], feats_of, forward,
          momentum: float = 0.9, weight_decay: float = 1e-5, rounding: Rounding = None,
          rows: slice | None = None, divisor: int | None = None) -> dict:
    """Run one step per batch from ``params0`` (float32 leaves, not changed).

    ``feats_of(audio)`` is the frontend and ``forward`` the family's. Returns ``losses`` (one float per
    step), ``grads1`` (the first step's gradient of each leaf, before the
    decay) and ``params`` (each leaf after the last step).
    """
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    bufs: dict[str, torch.Tensor] = {}
    losses, grads1 = [], None
    with no_tf32():
        for k, (audio, labels) in enumerate(batches):
            if rows is not None:
                audio, labels = audio[rows], labels[rows]
            logits = forward(params, config, feats_of(audio), rounding=rounding)
            loss = F.cross_entropy(logits, labels, reduction="sum") / (divisor or labels.shape[0])
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = {name: g.detach().clone() for name, g in zip(params, grads)}
            with torch.no_grad():
                lr = ladder(k)
                for (name, p), g in zip(params.items(), grads):
                    d = g + weight_decay * p
                    bufs[name] = d.clone() if name not in bufs else momentum * bufs[name] + d
                    p -= lr * bufs[name]
    return {"losses": losses, "grads1": grads1, "params": {k: v.detach() for k, v in params.items()}}
