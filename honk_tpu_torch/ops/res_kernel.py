"""Res-stack kernel: the eval-mode residual stack after conv0 + pool, mean and Dense.

Hopper counterpart of ``honk_tpu/ops/res_kernel.py`` (Pallas
``_res_stack_call`` / ``_make_kernel``, packer ``pack_res_params``). The
CUDA source is ``csrc/res_stack.cu``; its header says what bounds it on the
card (f32 FMAs, about 71.1 MFLOP per res8 utterance) and how the design
meets that. Shapes follow PyTorch: the input is the pooled activation
``(B, C, H, W)`` (res8: ``(B, 45, 25, 13)``), the output ``(B, n_labels)``
logits. Any batch size, ``C <= 64``, and any ``H``, ``W`` and layer count
(res8, res8-narrow, res26, res26-narrow); res15's dilated convs are not
covered, as on the TPU.

``res_stack`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``res_stack_plain``, the same function as
plain ``F.conv2d`` layers with the same BN folding. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

launches = 0
BN_EPS = 1e-5
MAX_MAPS = 64
# Shared memory one block may use on sm_90 (the only target the kernel is
# built for), less the kernel's static 64-float feature buffer.
_SMEM_BYTES = 232_448 - 4 * MAX_MAPS


@torch.no_grad()
def pack_res_params(model: torch.nn.Module) -> tuple[torch.Tensor, ...]:
    """Fold a res model's eval-mode weights into the kernel's operands.

    Returns ``(w_all (L, 9C, C), bn_scale (L, C), bn_offset (L, C),
    dense_w (C, n_labels), dense_b (n_labels,))`` on the model's device.
    ``w_all`` is tap-major like the TPU packer's: row ``(dy*3 + dx)*C + ic``,
    column ``oc``. BN is affine-free: ``scale = 1/sqrt(var + 1e-5)``,
    ``offset = -mean * scale``.
    """
    n_layers = model.n_layers
    w_all = torch.stack([
        getattr(model, f"conv{i}").weight.permute(2, 3, 1, 0).reshape(-1, model.n_maps)
        for i in range(1, n_layers + 1)
    ])
    scales, offsets = [], []
    for i in range(1, n_layers + 1):
        bn = getattr(model, f"bn{i}")
        # sqrt in float64, then rounded: PyTorch's vectorized float32 CPU sqrt
        # is off by one ulp for some inputs, the IEEE (numpy, CUDA) one is not.
        root = torch.sqrt((bn.running_var + BN_EPS).double()).float()
        s = 1.0 / root
        scales.append(s)
        offsets.append(-bn.running_mean * s)
    return (
        w_all.contiguous(),
        torch.stack(scales).contiguous(),
        torch.stack(offsets).contiguous(),
        model.output.weight.t().contiguous(),
        model.output.bias.detach().clone(),
    )


def res_stack_plain(x, w_all, bn_scale, bn_offset, dense_w, dense_b) -> torch.Tensor:
    """(B, C, H, W) pooled activation -> (B, n_labels) logits as plain PyTorch ops."""
    C = x.shape[1]
    old = x
    for i in range(w_all.shape[0]):
        w = w_all[i].reshape(3, 3, C, C).permute(3, 2, 0, 1)  # (out, in, kh, kw)
        y = F.relu(F.conv2d(x, w, padding=1))
        if (i + 1) % 2 == 0:
            y = y + old
            old = y
        x = y * bn_scale[i, :, None, None] + bn_offset[i, :, None, None]
    return x.mean(dim=(2, 3)) @ dense_w + dense_b


def res_stack(x, w_all, bn_scale, bn_offset, dense_w, dense_b) -> torch.Tensor:
    """(B, C, H, W) f32 -> (B, n_labels) f32: the kernel on CUDA, plain on CPU."""
    args = (x, w_all, bn_scale, bn_offset, dense_w, dense_b)
    B, C, H, W = x.shape if x.ndim == 4 else (0, 0, 0, 0)
    L = w_all.shape[0] if w_all.ndim == 3 else 0
    shapes_ok = (
        B >= 1 and 1 <= C <= MAX_MAPS and L >= 1
        and w_all.shape == (L, 9 * C, C)
        and bn_scale.shape == bn_offset.shape == (L, C)
        and dense_w.ndim == 2 and dense_w.shape[0] == C
        and dense_b.shape == (dense_w.shape[1],)
    )
    if not shapes_ok:
        raise ValueError(
            "res_stack takes x (B, C<=64, H, W), w_all (L, 9C, C), bn_scale/bn_offset "
            f"(L, C), dense_w (C, n), dense_b (n,); got {[tuple(a.shape) for a in args]}"
        )
    if any(a.dtype != torch.float32 or not a.is_contiguous() or a.device != x.device for a in args):
        raise ValueError("res_stack takes contiguous float32 tensors on one device")
    if x.device.type == "cpu":
        return res_stack_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"res_stack runs on cuda or cpu tensors, not {x.device}")
    return _launch(*args)


def _launch(x, w_all, bn_scale, bn_offset, dense_w, dense_b) -> torch.Tensor:
    global launches
    lib = _build.load("res_stack")
    fn = lib.res_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, C, H, W = x.shape
    L, n_labels = w_all.shape[0], dense_w.shape[1]
    # Per utterance: two zero-bordered activation buffers and the residual carry.
    per_utt = 2 * C * (H + 2) * (W + 2) + C * H * W
    scratch = None
    if 4 * per_utt > _SMEM_BYTES:
        scratch = torch.empty(B * per_utt, dtype=torch.float32, device=x.device)
    out = torch.empty((B, n_labels), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_all.data_ptr(), bn_scale.data_ptr(), bn_offset.data_ptr(),
            dense_w.data_ptr(), dense_b.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, C, H, W, L, n_labels, stream,
        )
    _build.check(err, "res_stack")
    launches += 1
    return out
