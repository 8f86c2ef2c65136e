"""Plain res8 / res15 (Tang & Lin, ICASSP 2018, arXiv:1710.10361, Table 1 and section 3).

Layer ``i`` of ``0 .. n_layers``: a 3x3 bias-free conv (res15: dilation
``2 ** ((i - 1) // 3)`` on layer ``i >= 1``, padding equal to it), ReLU;
after conv0 the optional average pool (res8: 4x3); an identity residual on
every even ``i >= 2`` (``x = y + old``); then, for ``i >= 1``, an
affine-free BatchNorm after the add. Then the mean over time and frequency
and a Dense to the labels.

BatchNorm in training takes the biased batch variance ``E[x^2] - E[x]^2``
clipped at 0 with eps 1e-5; in eval the running statistics. Float32, TF32
off (``no_tf32``). ``rounding``, when given, rounds a tensor to a lower
precision at each point where a low-precision model rounds (the conv
operands and output, the pool, the residual sum, BN's output), and the
gradient flowing back through each such point: the control of the
comparison (``rounding("fp8")``, ``rounding("int8")``), or, with
``rounding("bf16")``, the bf16 model's own rounding alone, the witness
that a gap of the program's is its precision's.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
Rounding = Callable[[torch.Tensor], torch.Tensor] | None


@contextlib.contextmanager
def no_tf32():
    """cuDNN and cuBLAS float32 products outside TF32 inside the block, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    """``t`` rounded to ``fmt``: ``bf16``, to nearest bfloat16; under a per-tensor scale, ``fp8``, float8 e4m3
    with the largest magnitude at 448, and ``int8``, symmetric integers with it at 127."""
    if fmt == "bf16":
        return t.to(torch.bfloat16).float()
    amax = t.abs().amax().clamp_min(1e-30)
    if fmt == "fp8":
        return (t * (448.0 / amax)).to(torch.float8_e4m3fn).float() * (amax / 448.0)
    if fmt == "int8":
        return torch.round(t * (127.0 / amax)).clamp(-127, 127) * (amax / 127.0)
    raise ValueError(f"no rounding {fmt!r}")


class _Rounded(torch.autograd.Function):
    """A value rounded to ``fmt`` going forward, and its gradient rounded to ``fmt`` going back."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return _round(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def rounding(fmt: str | None) -> Rounding:
    """The control's rounding below bf16 (``fp8`` or ``int8``), bf16's own (``bf16``), or None for the reference
    itself."""
    if fmt is None:
        return None
    _round(torch.zeros(1), fmt)  # refuses an unknown format now, not in the middle of a forward
    return lambda t: _Rounded.apply(t, fmt)


def dilation(config: dict, i: int) -> int:
    return 2 ** ((i - 1) // 3) if config.get("use_dilation") and i >= 1 else 1


def param_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """The model's parameters in the port's state-dict names."""
    c, n = config["n_feature_maps"], config["n_labels"]
    shapes = {"conv0.weight": (c, 1, 3, 3)}
    for i in range(1, config["n_layers"] + 1):
        shapes[f"conv{i}.weight"] = (c, c, 3, 3)
    shapes["output.weight"] = (n, c)
    shapes["output.bias"] = (n,)
    return shapes


def forward(params: dict, config: dict, feats: torch.Tensor, bn: dict | None = None,
            rounding: Rounding = None, stats: list | None = None) -> torch.Tensor:
    """Logits of (B, frames, 40) features.

    ``bn`` None: training mode (batch statistics; each layer's batch mean and
    biased variance appended to ``stats`` when given). Otherwise eval mode,
    ``bn[i] = (running_mean, running_var)`` of layer ``i``.
    """
    q = rounding or (lambda t: t)

    def conv(x, i):
        d = dilation(config, i)
        return q(F.conv2d(q(x), q(params[f"conv{i}.weight"]), None, 1, d, d))

    y = F.relu(conv(feats[:, None].float(), 0))
    if "res_pool" in config:
        y = q(F.avg_pool2d(y, tuple(config["res_pool"])))
    x = old = y
    for i in range(1, config["n_layers"] + 1):
        y = F.relu(conv(x, i))
        if i % 2 == 0:
            x = old = q(y + old)
        else:
            x = y
        if bn is None:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            if stats is not None:
                stats.append((mean.detach(), var.detach()))
        else:
            mean, var = bn[i]
        x = q((x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None])
    return F.linear(x.mean(dim=(2, 3)), params["output.weight"], params["output.bias"])
