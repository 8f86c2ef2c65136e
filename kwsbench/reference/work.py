"""The yardstick: published peaks of the card and the work each computation needs, from shapes.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity; they assume the
700 W power limit). Work is counted from the configuration's shapes, never
from what a kernel happens to do: each family's ``model_flops`` (in its own
module) is 2 x the multiply-adds of every conv and Dense of one
utterance's forward (a training step: 3 x that); ``forward_work`` /
``forward_bound`` are the res stack's operations and bytes from the
features; ``mfcc_work`` the frontend's.
"""

from __future__ import annotations

import math

from . import frontend

BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s, the MFU denominator


def peaks(name: str) -> tuple[float, float, float, float]:
    """(float32 FLOP/s outside the tensor cores, dense TF32 and dense bf16 tensor-core FLOP/s, HBM bytes/s)."""
    if "H200" in name:
        return 67e12, 495e12, 989e12, 4.8e12
    return 67e12, 495e12, 989e12, 3.35e12  # H100 SXM


def bound(flops: float, nbytes: float, name: str, tf32x3: bool = False, bf16: bool = False) -> tuple[float, str]:
    """Least time in ms: operations over the peak of the arithmetic used (3xTF32: three tensor-core products a
    product; bf16: one; else float32 CUDA cores) or bytes over HBM, the larger, and which."""
    f32, tf32, bf, b = peaks(name)
    t_ops = (3 * flops / tf32 if tf32x3 else flops / bf if bf16 else flops / f32) * 1e3
    t_bytes = nbytes / b * 1e3
    if t_ops < t_bytes:
        return t_bytes, "bytes"
    return t_ops, "operations (3xTF32)" if tf32x3 else "operations (bf16)" if bf16 else "operations"


def weight_bytes(mode: str) -> tuple[int, int]:
    """Bytes a conv weight and a Dense weight take in the res stack's ``mode``."""
    return (4 if mode == "float32" else 2), (2 if mode == "bfloat16" else 4)


def forward_work(b: int, C: int, H: int, W: int, L: int, n_lab: int, ph: int, pw: int,
                 mode: str = "float32") -> tuple[float, float, float]:
    """(conv0's operations, the stack's operations, bytes) of the res forward from the features at batch
    ``b``: conv0 over the H*ph x W*pw pixels the pool reads; the stack's convs and the Dense; the features,
    conv0's and BN's float32 values, the conv and Dense weights, the logits."""
    conv_b, dense_b = weight_bytes(mode)
    conv0 = 2 * b * H * ph * W * pw * 9 * C
    stack = 2 * b * L * H * W * 9 * C * C + 2 * b * C * n_lab
    nbytes = (4 * (b * 101 * 40 + 9 * C + 2 * L * C + n_lab + b * n_lab) + conv_b * L * 9 * C * C
              + dense_b * C * n_lab)
    return conv0, stack, nbytes


def forward_bound(b: int, C: int, H: int, W: int, L: int, n_lab: int, pool, name: str,
                  mode: str) -> tuple[float, str]:
    """Least time in ms of the res forward from the features: conv0 at the float32 CUDA-core rate plus the
    stack at the mode's tensor-core rate (3xTF32 or bf16), or the bytes over HBM, the larger."""
    f32, tf32, bf, hbm = peaks(name)
    conv0, stack, nbytes = forward_work(b, C, H, W, L, n_lab, *pool, mode)
    t_ops = (conv0 / f32 + (3 * stack / tf32 if mode == "float32" else stack / bf)) * 1e3
    t_bytes = nbytes / hbm * 1e3
    return (t_bytes, "bytes") if t_ops < t_bytes else (t_ops, "operations")


def mfcc_work(n_frames: int, n_samples: int) -> tuple[float, float]:
    """(operations, bytes) the MFCC needs for ``n_frames`` frames of ``n_samples`` samples: per frame the
    window, a 480-point real FFT (2.5 N log2 N), |X|^2 of 241 bins, the mel taps, 40 logs and the 40x40
    DCT; the audio in, the MFCCs out, the window, the taps and the DCT."""
    taps = frontend.mel_taps()
    per_frame = 480 + 2.5 * 480 * math.log2(480) + 3 * 241 + 2 * taps + 40 + 2 * 40 * 40
    return n_frames * per_frame, 4 * (n_samples + n_frames * 40 + 480 + taps + 40 * 40)

