"""KWT's recipe (a training traffic's ``"recipe": "kwt_adamw"``; Berg, O'Connor & Cruz, Interspeech 2021,
arXiv:2104.00769, its table of training hyperparameters): forward, label-smoothed cross-entropy, autograd,
AdamW.

AdamW as ``torch.optim.AdamW`` computes it, written out: the decoupled
decay ``p *= 1 - lr * 0.1`` first, then the moments with betas (0.9,
0.999) and their bias corrections, ``p -= lr * m_hat / (sqrt(v_hat) + 1e-8)``.
The learning rate of update ``k`` (from 0) warms up linearly to the peak
1e-3 over 10 epochs, ``1e-3 * (k + 1) / 1,010``, so that update 0 moves the
weights, an epoch being 101 updates (51,781 clips at 512 a batch); the
port's schedule then decays as a cosine to 0 at 140 epochs (14,140
updates), which the reference's first steps do not reach. The loss is the
cross-entropy with label smoothing 0.1: ``(1 - 0.1) * -log p[label] + 0.1 *
the mean over the labels of -log p``, summed over the rows and divided by
the batch.

``rows`` and ``divisor`` plant what a step would do with part of its batch:
the rows it reads and what its loss sum is divided by. A sound step reads
every row and divides by the batch.

The port's side: ``make_adamw`` at the same epoch and length, and the
first gradient read back from its first moment after one step,
``exp_avg / (1 - beta1)``.
"""

from __future__ import annotations

from typing import Iterable

import torch

from .precision import Rounding, no_tf32

PORT_OPTIMIZER = "honk_tpu_torch.train.state:AdamW"
PEAK_LR, WEIGHT_DECAY, BETAS, EPS, SMOOTHING = 1e-3, 0.1, (0.9, 0.999), 1e-8, 0.1
STEPS_PER_EPOCH, WARMUP_EPOCHS, EPOCHS = 101, 10, 140


def port_optimizer(port):
    """The port's optimizer of this recipe (``port`` resolves a ``module:attribute`` name of the port)."""
    return port("honk_tpu_torch.train.state:make_adamw")(STEPS_PER_EPOCH, EPOCHS)


def first_gradient(optimizer, param: torch.Tensor, param0: torch.Tensor) -> torch.Tensor:
    """``param``'s first gradient as ``optimizer`` (the port's ``torch.optim.AdamW``, after one step) got it: its
    first moment over ``1 - beta1``."""
    return optimizer.state[param]["exp_avg"] / (1.0 - optimizer.param_groups[0]["betas"][0])


def lr(step: int) -> float:
    """The warm-up's learning rate of update ``step``: the reference follows the first updates alone."""
    warmup = WARMUP_EPOCHS * STEPS_PER_EPOCH
    if step >= warmup:
        raise ValueError(f"update {step} is past the warm-up's {warmup}: the reference follows the first steps")
    return PEAK_LR * (step + 1) / warmup


def smoothed_loss(logits: torch.Tensor, labels: torch.Tensor, divisor: int) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    per_row = (1.0 - SMOOTHING) * -logp.gather(1, labels[:, None])[:, 0] + SMOOTHING * -logp.mean(dim=-1)
    return per_row.sum() / divisor


def steps(params0: dict, config: dict, batches: Iterable[tuple[torch.Tensor, torch.Tensor]], feats_of, forward,
          rounding: Rounding = None, rows: slice | None = None, divisor: int | None = None) -> dict:
    """Run one step per batch from ``params0`` (float32 leaves, not changed).

    ``feats_of(audio)`` is the frontend and ``forward`` the family's. Returns ``losses`` (one float per
    step), ``grads1`` (the first step's gradient of each leaf) and ``params`` (each leaf after the last
    step).
    """
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads1 = [], None
    with no_tf32():
        for k, (audio, labels) in enumerate(batches):
            if rows is not None:
                audio, labels = audio[rows], labels[rows]
            logits = forward(params, config, feats_of(audio), rounding=rounding)
            loss = smoothed_loss(logits, labels, divisor or labels.shape[0])
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = {name: g.detach().clone() for name, g in zip(params, grads)}
            with torch.no_grad():
                rate, t = lr(k), k + 1
                for (name, p), g in zip(params.items(), grads):
                    p.mul_(1.0 - rate * WEIGHT_DECAY)
                    m[name] = BETAS[0] * m[name] + (1.0 - BETAS[0]) * g
                    v2[name] = BETAS[1] * v2[name] + (1.0 - BETAS[1]) * g * g
                    m_hat, v_hat = m[name] / (1.0 - BETAS[0] ** t), v2[name] / (1.0 - BETAS[1] ** t)
                    p -= rate * m_hat / (v_hat.sqrt() + EPS)
    return {"losses": losses, "grads1": grads1, "params": {k: v.detach() for k, v in params.items()}}
