"""honk_tpu_torch: the PyTorch/CUDA port of honk_tpu for one NVIDIA H100.

The JAX package ``honk_tpu`` is the reference; this package imports nothing
of it and no JAX. Entry points run on the card (``cuda``) unless the caller
passes ``device="cpu"``, and raise where no CUDA device is present instead
of falling back to the CPU. Hand-written Hopper kernels live in ``ops/``;
on CPU tensors their wrappers run the plain PyTorch version beside them.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "use_full_f32"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, never a silent CPU.

    Raises ``RuntimeError`` when CUDA is asked for (or implied by ``None``)
    and no CUDA device is available, and ``ValueError`` for a device type
    that is neither ``cuda`` nor ``cpu``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"honk_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU explicitly"
        )
    return dev


def use_full_f32() -> None:
    """Turn TF32 off for float32 convolutions and matrix products (process-wide).

    cuDNN runs f32 convolutions in TF32 by default on Hopper, which keeps
    about three decimal digits and breaks the 2e-4 logit parity gate against
    the reference. The serving path of res15 and the CNNs runs cuDNN
    convolutions, so ``LabelService`` calls this before its first forward.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
