"""The reference's precision, shared by every family: float32 outside TF32, and the roundings of the controls.

``rounding(fmt)`` gives a function that a family's ``forward`` applies at
each point where a low-precision model rounds, forward and back: the
control of the comparison (``fp8``, ``int8``), or bf16's own rounding
(``bf16``), the witness that a gap of the program's is its precision's.
Where the points lie is the family's; the formats are the same for all.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

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
