"""Checkpoints on ``torch.save`` (counterpart of ``honk_tpu.ckpt.checkpoint``).

Equivalent of reference ``utils/model.py::SerializableModule.save/load``
(torch.save of a state dict, keeping the best-dev model), plus what the
JAX package adds: step-indexed checkpoints with the optimizer state, the
step, the epoch, best-dev bookkeeping and the run's key, and resume from
the latest. Files in a checkpoint directory:

- ``step_XXXXXXXX.pt``: a resume payload. Written to a temporary name and
  renamed, so a half-written file is never taken for the latest.
- ``best.pt``: a honk state dict (res: ``conv{i}.weight``,
  ``bn{i}.running_*``, ``output.*``; cnn: ``conv1.*``, ``conv2.*``,
  ``lin.*``, ``dnn1.*``, ``dnn2.*``, ``output.*``, weights and biases, no
  BN), which ``LabelService`` and ``--input_file`` load.

Everything is saved from CPU copies and loaded with ``weights_only=True``
(tensors, numbers, strings and dicts; no pickled code). The port writes
only ``.pt`` files. ``read_state_dict`` also reads a JAX run's Orbax
weights (``best/``, through ``ckpt.orbax``, which needs ``tensorstore``);
a directory of Orbax *step* checkpoints (a JAX run's resume payload) is
refused as a resume source.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

ORBAX_MESSAGE = (
    "holds Orbax step checkpoints of the JAX package; a run of the port resumes only "
    "from its own .pt step checkpoints (a JAX run's best/ weights load with --input_file)"
)


def to_cpu(tree: Any) -> Any:
    """A copy of a nested dict / list of tensors and numbers with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _mismatched(tree: Any, template: Any, path: str = "") -> list[str]:
    if isinstance(template, torch.Tensor):
        if not isinstance(tree, torch.Tensor):
            return [f"{path}: ckpt {type(tree).__name__} != expected a tensor"]
        if tuple(tree.shape) != tuple(template.shape):
            return [f"{path}: ckpt {tuple(tree.shape)} != expected {tuple(template.shape)}"]
        return []
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            return [f"{path}: ckpt keys {got} != expected {sorted(template)}"]
        return [m for k in template for m in _mismatched(tree[k], template[k], f"{path}/{k}")]
    return []


class Checkpointer:
    """Save / restore dicts of tensors as ``<name>.pt`` in one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def save(self, name: str, tree: Any) -> None:
        """Write ``<name>.pt`` atomically (temporary file, then rename)."""
        path = self._path(name)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(to_cpu(tree), tmp)
        os.replace(tmp, path)

    def save_step(self, step: int, tree: Any) -> None:
        self.save(f"step_{step:08d}", tree)

    def save_best(self, state_dict: dict[str, torch.Tensor], name: str = "best") -> None:
        """``<name>.pt`` (``best.pt``) in honk's layout: BN's ``num_batches_tracked`` (never read) left out."""
        self.save(name, {k: v for k, v in state_dict.items() if not k.endswith(".num_batches_tracked")})

    def restore(self, name: str, template: Any | None = None) -> Any:
        """Load ``<name>.pt`` on the CPU; with a template, check every tensor's shape against it."""
        out = torch.load(self._path(name), map_location="cpu", weights_only=True)
        if template is not None:
            mismatched = _mismatched(out, template)
            if mismatched:
                raise ValueError(
                    f"checkpoint {name!r} in {self.directory!r} has mismatched "
                    f"array shapes: {'; '.join(mismatched[:5])}"
                )
        return out

    def latest_step(self) -> int | None:
        """The newest complete step checkpoint; temporary files never match."""
        steps, orbax = [], False
        for entry in os.listdir(self.directory):
            if m := re.fullmatch(r"step_(\d{8,})\.pt", entry):
                steps.append(int(m.group(1)))
            elif re.fullmatch(r"step_\d{8,}", entry) and os.path.isdir(os.path.join(self.directory, entry)):
                orbax = True
        if orbax and not steps:
            raise RuntimeError(f"{self.directory!r} {ORBAX_MESSAGE}")
        return max(steps) if steps else None

    def restore_latest(self, template: Any | None = None) -> tuple[int, Any] | None:
        step = self.latest_step()
        if step is None:
            return None
        try:
            return step, self.restore(f"step_{step:08d}", template)
        except OSError:
            # A filesystem failure is not a template mismatch: the advice
            # below (start afresh) would throw away a good run.
            raise
        except Exception as e:
            raise RuntimeError(
                f"failed to restore checkpoint step_{step:08d} from "
                f"{self.directory!r} against the current train state — the "
                "directory likely holds a different run's checkpoints "
                "(different model/corpus/split). Use a fresh --output_dir "
                "to start a new run, or delete the stale checkpoints to "
                "retrain in place."
            ) from e


def is_orbax_path(path: str) -> bool:
    """Whether ``path`` names a JAX-package Orbax checkpoint (a directory, not a ``.pt``)."""
    return os.path.isdir(path) or not path.endswith(".pt")


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The weights at ``path`` in the port's names, on the CPU: a honk ``.pt``
    state dict, or the JAX package's Orbax checkpoint directory
    (``ckpt.orbax.load_orbax``, then ``models.from_flax_variables``), as the
    JAX ``LabelService`` and ``--input_file`` take either."""
    if not is_orbax_path(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    from ..models.torch_compat import from_flax_variables
    from .orbax import load_orbax

    return from_flax_variables(load_orbax(path))
