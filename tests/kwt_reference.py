"""A plain Keyword Transformer (Berg, O'Connor & Cruz, Interspeech 2021, arXiv:2104.00769) for the port's
tests: the forward, the label-smoothed loss and AdamW, written out in float32 PyTorch with TF32 off. Imports
neither JAX nor the port.

The forward is the paper's section 2: each MFCC frame a token (Dense
``n_mfcc -> dim``), a class token first, learned positions added, ``depth``
PostNorm blocks ``x = LN(x + MHSA(x))``, ``x = LN(x + MLP(x))`` (MHSA: a fused
QKV Dense, ``heads`` heads of ``head_dim``, softmax of ``q k^T / sqrt(head_dim)``,
an output Dense; MLP: Dense, GELU with erf, Dense), then a Dense of the class
token. Departures from the paper, as the port's: 101 frames (the paper's
frontend gives 98), 12 labels on this corpus, LayerNorm's eps 1e-5, no
dropout; the batches, the honk assembly's time shift and noise, are not the
paper's SpecAugment and resampling.

``rounding``, when given, rounds a tensor at each point where the port's bf16
model rounds: each Dense's input, weight, bias, product and output, and the
attention's output (``bf16``, or ``int8`` below it for the control; the
gradient passes unrounded).

``adamw_steps`` is ``torch.optim.AdamW``'s arithmetic by hand: the decay
``p *= 1 - lr * wd`` first, then the bias-corrected moments.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
Rounding = Callable[[torch.Tensor], torch.Tensor] | None


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to symmetric int8 under a per-tensor scale, its largest magnitude at 127."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    return t + (torch.round(t.detach() * (127.0 / amax)).clamp(-127, 127) * (amax / 127.0) - t.detach())


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


def forward(params: dict, config: dict, feats: torch.Tensor, rounding: Rounding = None) -> torch.Tensor:
    """Logits of (B, frames, n_mfcc) features from float32 ``params`` in the port's names."""
    q = rounding or (lambda t: t)
    heads, hd = config["heads"], config["head_dim"]

    def dense(name, x):
        return q(q(F.linear(q(x), q(params[f"{name}.weight"]))) + q(params[f"{name}.bias"]))

    def norm(name, x):
        return F.layer_norm(x, x.shape[-1:], params[f"{name}.weight"], params[f"{name}.bias"], LN_EPS)

    b = feats.shape[0]
    x = dense("embed", feats.float())
    x = torch.cat([params["class_token"].expand(b, 1, -1), x], dim=1) + params["positions"]
    n = x.shape[1]
    for i in range(config["depth"]):
        p = f"blocks.{i}"
        qh, kh, vh = dense(f"{p}.qkv", x).view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
        a = q(torch.softmax(scores, dim=-1) @ vh).transpose(1, 2).reshape(b, n, heads * hd)
        x = norm(f"{p}.norm1", x + dense(f"{p}.proj", a))
        x = norm(f"{p}.norm2", x + dense(f"{p}.fc2", F.gelu(dense(f"{p}.fc1", x))))
    return F.linear(x[:, 0], params["output.weight"], params["output.bias"])


def loss(logits: torch.Tensor, labels: torch.Tensor, smoothing: float, divisor: int | None = None) -> torch.Tensor:
    """The label-smoothed cross-entropy summed over the rows, over ``divisor`` (the batch by default):
    ``(1 - s) * -log p[label] + s * mean over the labels of -log p``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    per_row = (1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)
    return per_row.sum() / (divisor or labels.shape[0])


def adamw_steps(params0: dict, config: dict, batches, lrs, smoothing: float = 0.1, weight_decay: float = 0.1,
                betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """One AdamW step per ``(features, labels)`` batch at ``lrs[k]``: each step's loss, the first step's
    gradients and the parameters after the last."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads1 = [], None
    with no_tf32():
        for t, ((feats, labels), lr) in enumerate(zip(batches, lrs), start=1):
            value = loss(forward(params, config, feats), labels, smoothing)
            grads = torch.autograd.grad(value, list(params.values()))
            losses.append(float(value.detach()))
            grads1 = grads1 or {k: g.detach().clone() for k, g in zip(params, grads)}
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    p.mul_(1.0 - lr * weight_decay)
                    m[k] = betas[0] * m[k] + (1.0 - betas[0]) * g
                    v2[k] = betas[1] * v2[k] + (1.0 - betas[1]) * g * g
                    m_hat, v_hat = m[k] / (1.0 - betas[0] ** t), v2[k] / (1.0 - betas[1] ** t)
                    p -= lr * m_hat / (v_hat.sqrt() + eps)
    return {"losses": losses, "grads1": grads1, "params": {k: v.detach() for k, v in params.items()}}
