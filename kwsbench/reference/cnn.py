"""The cnn family: plain Sainath & Parada CNNs (Interspeech 2015), castorini/honk's ``SpeechModel``.

``conv1`` (with bias, VALID, stride ``conv1_stride``), ReLU, a max pool of
window and stride ``conv1_pool`` (floor; none at (1, 1)); the same again
as ``conv2`` where the configuration has ``n_feature_maps2``; flatten in
NCHW order; then, each where the configuration sizes it, ``lin`` (no
activation), ``dnn1`` (ReLU unless ``tf_variant``) and ``dnn2`` (no
activation); then the float32 ``output`` Dense. Parameters in the port's
names. Float32, TF32 off (``precision.no_tf32``).

No dropout: the reference follows a training step only at ``dropout_prob``
0, and refuses another (the masks would be the program's draws). No BN:
``eval_state`` is empty and the eval forward is the training one.
``rounding``, when given, rounds each conv's and hidden Dense's operands
and output, forward and back (``precision.rounding``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import frontend
from .precision import Rounding

PORT_MODEL = "honk_tpu_torch.models.cnn:SpeechModel"
HIDDEN = ("lin", "dnn1", "dnn2")


def convs(config: dict) -> list[str]:
    return ["1", "2"] if "n_feature_maps2" in config else ["1"]


def geometry(config: dict) -> tuple[list[tuple[int, int, int, int, int]], int]:
    """(C_in, C_out, T_out, F_out, kernel taps) of each conv on 101 x 40 features, and the width flattened
    after the last pool."""
    t, f, c_in, out = frontend.WINDOW_FRAMES, frontend.N_DCT, 1, []
    for k in convs(config):
        (kh, kw), (sh, sw) = config[f"conv{k}_size"], config[f"conv{k}_stride"]
        t, f = (t - kh) // sh + 1, (f - kw) // sw + 1
        c = config[f"n_feature_maps{k}"]
        out.append((c_in, c, t, f, kh * kw))
        ph, pw = config[f"conv{k}_pool"]
        t, f, c_in = t // ph, f // pw, c
    return out, t * f * c_in


def param_shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """The model's parameters in the port's state-dict names."""
    shapes = {}
    maps, width = geometry(config)
    for k, (c_in, c, _, _, _) in zip(convs(config), maps):
        shapes[f"conv{k}.weight"] = (c, c_in, *config[f"conv{k}_size"])
        shapes[f"conv{k}.bias"] = (c,)
    for name in HIDDEN:
        if f"{name}_size" in config:
            shapes[f"{name}.weight"] = (config[f"{name}_size"], width)
            shapes[f"{name}.bias"] = (config[f"{name}_size"],)
            width = config[f"{name}_size"]
    shapes["output.weight"] = (config["n_labels"], width)
    shapes["output.bias"] = (config["n_labels"],)
    return shapes


def init(name: str, u: torch.Tensor, gain: float, shapes: dict) -> torch.Tensor:
    """Every weight and bias uniform in +-gain/sqrt(fan_in of its layer) (PyTorch's ``Conv2d`` and ``Linear``
    bounds), the ``output`` bias 0."""
    if name == "output.bias":
        return torch.zeros(u.shape, device=u.device)
    weight = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return u * (gain / math.sqrt(math.prod(weight[1:])))


def forward(params: dict, config: dict, feats: torch.Tensor, bn: dict | None = None,
            rounding: Rounding = None, stats: list | None = None) -> torch.Tensor:
    """Logits of (B, frames, 40) features; ``bn`` None is a training forward, which needs ``dropout_prob`` 0.
    ``stats`` is the res family's and stays empty."""
    if bn is None and config.get("dropout_prob", 0.5) != 0:
        raise ValueError(f"the cnn reference has no dropout: a training forward needs dropout_prob 0, "
                         f"not {config.get('dropout_prob', 0.5)}")
    q = rounding or (lambda t: t)
    x = feats[:, None].float()
    for k in convs(config):
        w, b = params[f"conv{k}.weight"], params[f"conv{k}.bias"]
        x = F.relu(q(F.conv2d(q(x), q(w), q(b), tuple(config[f"conv{k}_stride"]))))
        if tuple(config[f"conv{k}_pool"]) != (1, 1):
            x = F.max_pool2d(x, tuple(config[f"conv{k}_pool"]))
    x = x.flatten(1)
    for name in HIDDEN:
        if f"{name}_size" in config:
            x = q(F.linear(q(x), q(params[f"{name}.weight"]), q(params[f"{name}.bias"])))
            if name == "dnn1" and not config.get("tf_variant", False):
                x = F.relu(x)
    return F.linear(x, params["output.weight"], params["output.bias"])


def eval_state(params: dict, config: dict, feats: torch.Tensor) -> dict:
    """Nothing: the family has no running statistics."""
    return {}


def model_flops(config: dict) -> float:
    """2 x the multiply-adds of every conv and Dense of one utterance's forward (101 x 40 features)."""
    maps, width = geometry(config)
    flops = sum(2 * c_in * c * t * f * taps for c_in, c, t, f, taps in maps)
    for name in HIDDEN:
        if f"{name}_size" in config:
            flops += 2 * width * config[f"{name}_size"]
            width = config[f"{name}_size"]
    return flops + 2 * width * config["n_labels"]
