"""The kwt family: a plain Keyword Transformer (Berg, O'Connor & Cruz, "Keyword Transformer: A Self-Attention
Model for Keyword Spotting", Interspeech 2021, arXiv:2104.00769, section 2 and the table of model sizes).

Each MFCC frame (``n_mfcc`` coefficients) is a token, projected by a Dense
to ``dim``; a learned class token comes first and learned positions are
added; then ``depth`` PostNorm blocks, ``x = LN(x + MHSA(x))`` and
``x = LN(x + MLP(x))``: MHSA is a fused QKV Dense (``dim -> 3 * heads *
head_dim``), softmax of ``q k^T / sqrt(head_dim)`` per head, and a Dense
back to ``dim``; the MLP a Dense to ``mlp_dim``, GELU (erf) and a Dense back;
then a Dense of the class token to the labels, with no final LayerNorm.

Departures from the paper: 101 frames (the port's frontend; the paper's
gives 98), so 102 tokens; 12 labels on this corpus; LayerNorm's eps 1e-5;
no dropout; the batches carry the honk assembly's time shift and noise,
not the paper's SpecAugment and resampling.

Float32, TF32 off (``precision.no_tf32``, set by the recipe's steps).
``rounding``, when given, rounds a tensor at each point where the port's
bf16 model rounds, forward and back: each Dense's input, weight, bias,
product and output, and the attention's output (``precision.rounding``).
No BN: ``eval_state`` is None.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import Rounding

PORT_MODEL = "honk_tpu_torch.models.kwt:KeywordTransformer"
LN_EPS = 1e-5
EMBEDDING_STD = 0.02  # the class token's and the positions' draw: uniform with ViT's standard deviation


def param_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """The model's parameters in the port's names and order."""
    d, f, inner, mlp = config["dim"], config["n_mfcc"], config["heads"] * config["head_dim"], config["mlp_dim"]
    shapes = {"class_token": (d,), "positions": (config["frames"] + 1, d), "embed.weight": (d, f),
              "embed.bias": (d,)}
    for i in range(config["depth"]):
        p = f"blocks.{i}"
        shapes.update({f"{p}.qkv.weight": (3 * inner, d), f"{p}.qkv.bias": (3 * inner,),
                       f"{p}.proj.weight": (d, inner), f"{p}.proj.bias": (d,),
                       f"{p}.norm1.weight": (d,), f"{p}.norm1.bias": (d,),
                       f"{p}.fc1.weight": (mlp, d), f"{p}.fc1.bias": (mlp,),
                       f"{p}.fc2.weight": (d, mlp), f"{p}.fc2.bias": (d,),
                       f"{p}.norm2.weight": (d,), f"{p}.norm2.bias": (d,)})
    shapes["output.weight"] = (config["n_labels"], d)
    shapes["output.bias"] = (config["n_labels"],)
    return shapes


def init(name: str, u: torch.Tensor, gain: float, shapes: dict) -> torch.Tensor:
    """Every Dense weight uniform in +-gain/sqrt(fan_in) (the port's initialiser), every bias 0, LayerNorm's
    gains 1, the class token and the positions uniform with standard deviation ``EMBEDDING_STD``."""
    if name.endswith(("norm1.weight", "norm2.weight")):
        return torch.ones(u.shape, device=u.device)
    if name in ("class_token", "positions"):
        return u * (EMBEDDING_STD * math.sqrt(3.0))
    if name.endswith("bias"):
        return torch.zeros(u.shape, device=u.device)
    return u * (gain / math.sqrt(u.shape[1]))


def forward(params: dict, config: dict, feats: torch.Tensor, bn: dict | None = None,
            rounding: Rounding = None, stats: list | None = None) -> torch.Tensor:
    """Logits of (B, frames, n_mfcc) features. ``bn`` and ``stats`` are the res family's: the model has none,
    and its training and eval forwards are one."""
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
        weights = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        a = q(weights @ vh).transpose(1, 2).reshape(b, n, heads * hd)
        x = norm(f"{p}.norm1", x + dense(f"{p}.proj", a))
        x = norm(f"{p}.norm2", x + dense(f"{p}.fc2", F.gelu(dense(f"{p}.fc1", x))))
    return F.linear(x[:, 0], params["output.weight"], params["output.bias"])


def eval_state(params: dict, config: dict, feats: torch.Tensor) -> None:
    """Nothing: the family has no running statistics."""
    return None


def model_flops(config: dict) -> float:
    """2 x the multiply-adds of one clip's forward: every Dense (the embedding over the frames, each block's
    QKV, output projection and MLP over the tokens, the head over the class token) and each block's
    ``q k^T`` and ``weights v`` at ``frames + 1`` tokens."""
    d, f, t = config["dim"], config["n_mfcc"], config["frames"] + 1
    inner, mlp = config["heads"] * config["head_dim"], config["mlp_dim"]
    per_token = d * 3 * inner + inner * d + 2 * d * mlp
    attention = 2 * t * t * inner
    return 2 * (config["frames"] * f * d + config["depth"] * (t * per_token + attention) + d * config["n_labels"])
