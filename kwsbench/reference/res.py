"""The res family: plain res8 / res15 (Tang & Lin, ICASSP 2018, arXiv:1710.10361, Table 1 and section 3).

Layer ``i`` of ``0 .. n_layers``: a 3x3 bias-free conv (res15: dilation
``2 ** ((i - 1) // 3)`` on layer ``i >= 1``, padding equal to it), ReLU;
after conv0 the optional average pool (res8: 4x3); an identity residual on
every even ``i >= 2`` (``x = y + old``); then, for ``i >= 1``, an
affine-free BatchNorm after the add. Then the mean over time and frequency
and a Dense to the labels.

BatchNorm in training takes the biased batch variance ``E[x^2] - E[x]^2``
clipped at 0 with eps 1e-5; in eval the running statistics. Float32, TF32
off (``precision.no_tf32``). ``rounding``, when given, rounds a tensor at
each point where a low-precision model rounds (the conv operands and
output, the pool, the residual sum, BN's output), and the gradient flowing
back through each such point (``precision.rounding``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import frontend
from .precision import Rounding, no_tf32

PORT_MODEL = "honk_tpu_torch.models.res:SpeechResModel"
BN_EPS = 1e-5


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


def init(name: str, u: torch.Tensor, gain: float, shapes: dict) -> torch.Tensor:
    """Every conv and Dense weight uniform in +-gain/sqrt(fan_in) (the port's and flax's initialiser), the Dense
    bias 0."""
    if name.endswith("bias"):
        return torch.zeros(u.shape, device=u.device)
    return u * (gain / math.sqrt(u.numel() / u.shape[0]))


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


def eval_state(params: dict, config: dict, feats: torch.Tensor) -> dict:
    """BN's running statistics as a trained model holds them: each layer's batch mean and biased variance over
    ``feats`` in the training forward (so the folded BN of the eval forward normalises)."""
    stats: list = []
    with no_tf32(), torch.no_grad():
        forward(params, config, feats, stats=stats)
    return {i + 1: s for i, s in enumerate(stats)}


def stack_geometry(config: dict) -> tuple[int, int, int, int, int, tuple[int, int]]:
    """(C, H, W, L, n_labels, pool) of a res configuration on 101 x 40 features."""
    ph, pw = tuple(config.get("res_pool", (1, 1)))
    return (config["n_feature_maps"], frontend.WINDOW_FRAMES // ph, frontend.N_DCT // pw, config["n_layers"],
            config["n_labels"], (ph, pw))


def model_flops(config: dict) -> float:
    """2 x the multiply-adds of every conv and Dense of one utterance's forward (101 x 40 features)."""
    C, H, W, L, n_lab, _ = stack_geometry(config)
    conv0 = 2 * frontend.WINDOW_FRAMES * frontend.N_DCT * 9 * C  # before the pool
    # Every conv of the stack pads to SAME (a dilated one by its dilation): H x W outputs.
    return conv0 + L * 2 * H * W * 9 * C * C + 2 * C * n_lab
