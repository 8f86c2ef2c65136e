"""Checkpoint loading: honk ``.pt`` files and JAX (flax) variable trees.

Counterpart of ``honk_tpu.models.torch_compat``. The port's modules use
honk's own state-dict names, so a honk ``.pt`` loads straight in. Name
mapping from the JAX package's flax trees (the inverse of
``honk_tpu.models.torch_compat.torch_state_dict_to_flax``):

    params/conv{i}/kernel (KH,KW,I,O)  -> conv{i}.weight (O,I,KH,KW)
    params/<dense>/kernel (in,out)     -> <dense>.weight (out,in)
    params/<name>/bias                 -> <name>.bias
    batch_stats/bn{i}/mean|var         -> bn{i}.running_mean|running_var
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn as nn

# BatchNorm's step counter: honk's committed .pt files (zoo/*.pt) do not
# carry it, and eval never reads it.
_OPTIONAL_SUFFIX = ".num_batches_tracked"


def load_state_dict(model: nn.Module, state_dict: dict[str, torch.Tensor]) -> nn.Module:
    """Load `state_dict` into `model`, strictly except for ``num_batches_tracked``.

    Raises ``KeyError`` for any other missing key or for an unexpected
    key; a shape mismatch raises in ``nn.Module.load_state_dict``.
    """
    expected = set(model.state_dict())
    missing = sorted(k for k in expected - set(state_dict) if not k.endswith(_OPTIONAL_SUFFIX))
    unexpected = sorted(set(state_dict) - expected)
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing {missing}, unexpected {unexpected}")
    model.load_state_dict(state_dict, strict=False)
    return model


def load_honk_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a honk ``.pt`` state dict file into `model` (weights only, no pickled code)."""
    return load_state_dict(model, torch.load(path, map_location="cpu", weights_only=True))


def from_flax_variables(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` trees of arrays -> the port's state dict."""
    sd: dict[str, torch.Tensor] = {}
    for mod, leaves in variables["params"].items():
        for leaf, v in leaves.items():
            v = np.asarray(v)
            if leaf == "kernel":
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
                sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(v))
            else:
                sd[f"{mod}.{leaf}"] = torch.from_numpy(v.copy())
    for mod, stats in variables.get("batch_stats", {}).items():
        sd[f"{mod}.running_mean"] = torch.from_numpy(np.array(stats["mean"]))
        sd[f"{mod}.running_var"] = torch.from_numpy(np.array(stats["var"]))
    return sd
