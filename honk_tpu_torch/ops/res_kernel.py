"""Res-stack kernel: the eval-mode residual stack after conv0 + pool, mean and Dense.

Hopper counterpart of ``honk_tpu/ops/res_kernel.py`` (Pallas
``_res_stack_call`` / ``_make_kernel``, packer ``pack_res_params``), in three
modes (``MODES``, by ``compute_dtype`` and ``activation_dtype``):
- ``float32``: the TPU kernel in float32;
- ``bfloat16``: the TPU kernel's default operand type, where each conv's
  activations and weights and the Dense layer's features and weights are
  rounded to bf16 (to nearest even) and multiplied with f32 sums, while
  activations, the residual carry and BN stay f32;
- ``bfloat16_activations``: bf16 operands with flax's dtype flow, what the
  JAX package computes for a bf16 model's eval forward through XLA
  (``honk_tpu/models/res.py``, ``apply(train=False)``): each conv's f32 sum
  rounded to bf16, ReLU, the residual add rounded to bf16 (the carry holds
  bf16 values), the folded BN taken in f32 and rounded back to bf16, then
  the mean over those values in f32 and a float32 Dense.

The CUDA source is ``csrc/res_stack.cu``; its header says what
bounds it on the card (the convolutions' products, on the tensor cores in
3xTF32 or in bf16) and how the design meets that: a small kernel packs (and
splits or rounds) the weights, then a thread block cluster per utterance,
each CTA a band of rows in shared memory, runs each conv as an implicit
GEMM with ``wgmma``. Shapes follow
PyTorch: the input is the pooled activation ``(B, C, H, W)`` (res8:
``(B, 45, 25, 13)``), the output ``(B, n_labels)`` logits. Any batch size,
``C <= 64``, any layer count, and maps whose rows split into at most 8
bands that each fit the kernel (``cluster_size``): res8, res8-narrow, res26
and res26-narrow. res15's dilated convs are not covered, as on the TPU:
``SpeechResModel`` runs them through cuDNN.

``res_stack`` is the wrapper: on CUDA tensors it launches the kernel in the
mode asked for (or raises), on CPU tensors it runs ``res_stack_plain``, the
same function as plain ``F.conv2d`` layers with the same BN folding and,
in the bf16 modes, the same operands rounded to bf16 and the convs run in
f32 (a product of two bf16 values is exact in f32 and in TF32, so this is
the kernel's arithmetic up to the order of f32 sums), and the same
roundings of the activations. ``launches`` counts kernel launches in every
mode, ``launches_by_mode`` each mode's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

launches = 0
# (compute_dtype, activation_dtype) -> the mode's name, and its number in csrc/res_stack.cu.
MODES = {(torch.float32, torch.float32): "float32", (torch.bfloat16, torch.float32): "bfloat16",
         (torch.bfloat16, torch.bfloat16): "bfloat16_activations"}
_MODE_ARG = {name: i for i, name in enumerate(MODES.values())}
launches_by_mode = {name: 0 for name in MODES.values()}
BN_EPS = 1e-5
MAX_MAPS = 64
# Launch geometry of csrc/res_stack.cu (its WARPS, STAGES and MAX_CLUSTER).
WARPS = 16
MAX_TILES = WARPS  # 16-pixel rows of M tiles one CTA's band may have (4 warpgroups x 64)
STAGES = 3  # per-tap weight stages in shared memory
MAX_CLUSTER = 8
# Dynamic shared memory one CTA may use on sm_90, less the kernel's static
# partial sums, features and BN constants (MAX_CLUSTER * 64 + 64 + 128 floats).
SMEM_LIMIT = 232_448 - 4 * (MAX_CLUSTER + 3) * MAX_MAPS


@torch.no_grad()
def fold_bn(model: torch.nn.Module) -> tuple[torch.Tensor, torch.Tensor]:
    """A res model's eval-mode BN as ``(scale (L, C), offset (L, C))``.

    BN is affine-free: ``scale = 1/sqrt(var + 1e-5)``, ``offset = -mean * scale``.
    """
    scales, offsets = [], []
    for i in range(1, model.n_layers + 1):
        bn = getattr(model, f"bn{i}")
        # sqrt in float64, then rounded: PyTorch's vectorized float32 CPU sqrt
        # is off by one ulp for some inputs, the IEEE (numpy, CUDA) one is not.
        root = torch.sqrt((bn.running_var + BN_EPS).double()).float()
        s = 1.0 / root
        scales.append(s)
        offsets.append(-bn.running_mean * s)
    return torch.stack(scales).contiguous(), torch.stack(offsets).contiguous()


def _mode(compute_dtype: torch.dtype, activation_dtype: torch.dtype = torch.float32) -> str:
    if (compute_dtype, activation_dtype) not in MODES:
        raise ValueError(
            "res_stack's (compute_dtype, activation_dtype) is one of "
            f"{[(str(c), str(a)) for c, a in MODES]}, not ({compute_dtype}, {activation_dtype})")
    return MODES[(compute_dtype, activation_dtype)]


def round_operand(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """An operand as the kernel multiplies it (or an activation as the mode
    keeps it): as it is, or rounded to bf16 (to nearest even) and held in
    ``t``'s dtype."""
    return t if compute_dtype == torch.float32 else t.to(torch.bfloat16).to(t.dtype)


@torch.no_grad()
def pack_res_params(model: torch.nn.Module, dtype: torch.dtype = torch.float32,
                    activation_dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, ...]:
    """Fold a res model's eval-mode weights into the kernel's operands for the
    mode ``(dtype, activation_dtype)``.

    Returns ``(w_all (L, 9C, C), bn_scale (L, C), bn_offset (L, C),
    dense_w (C, n_labels), dense_b (n_labels,))`` float32 on the model's
    device. ``w_all`` is tap-major like the TPU packer's: row
    ``(dy*3 + dx)*C + ic``, column ``oc``. The BN fold is ``fold_bn``'s. For
    ``dtype=torch.bfloat16`` the conv weights, and in the ``bfloat16`` mode
    the Dense weights, are the bf16 values that mode multiplies
    (``round_operand``), still float32 tensors: the kernel and
    ``res_stack_plain`` round them again, which changes nothing. The
    ``bfloat16_activations`` mode keeps the Dense float32, as flax's.
    """
    mode = _mode(dtype, activation_dtype)
    w_all = torch.stack([
        getattr(model, f"conv{i}").weight.permute(2, 3, 1, 0).reshape(-1, model.n_maps)
        for i in range(1, model.n_layers + 1)
    ])
    return (
        round_operand(w_all, dtype).contiguous(),
        *fold_bn(model),
        round_operand(model.output.weight.t(), torch.bfloat16 if mode == "bfloat16" else torch.float32).contiguous(),
        model.output.bias.detach().clone(),
    )


@functools.lru_cache(maxsize=None)
def fragment_index(C: int, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Where each value of the kernel's B tiles of one tap comes from.

    float32 (3xTF32): shape ``(NT, NT, 2, 8, 4)`` int32 with
    ``NT = ceil(C / 8)``: for K chunk ``kc``, N block ``j``, K half ``h``,
    row ``r`` and column ``k``, the value at that place of the chunk's
    tile, which ``wgmma`` reads as ``B[k = 4h + k][n = 8j + r]`` (no
    swizzle: core matrices of 8 rows of 4 values, K halves 128 B apart, N
    blocks 256 B apart), is the weight of input channel ``kc*8 + 4h + k``
    and output channel ``8j + r``. bfloat16: shape ``(KT, NT, 2, 8, 8)``
    with ``KT = ceil(C / 16)``, K chunks of 16 (``wgmma``'s bf16 depth)
    whose core matrices hold 8 values a row, input channel
    ``kc*16 + 8h + k``. The entry is that weight's offset in the tap's
    ``(C, C)`` block of ``w_all`` (``ic*C + oc``), or -1 for the zero
    padding of channels ``>= C``. The source's pack kernels gather
    ``w_all`` by it, once per call, and split each value for 3xTF32 or
    round it to bf16.
    """
    nt = -(-C // 8)
    depth = 16 if _mode(dtype) == "bfloat16" else 8  # K values of one chunk
    kc, j, h, r, k = np.meshgrid(np.arange(-(-C // depth)), np.arange(nt), np.arange(2), np.arange(8),
                                 np.arange(depth // 2), indexing="ij")
    ic, oc = kc * depth + (depth // 2) * h + k, 8 * j + r
    return np.where((ic < C) & (oc < C), ic * C + oc, -1).astype(np.int32)


def smem_bytes(C: int, H: int, W: int, cluster: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one CTA (``res_stack_smem_bytes`` in the source).

    The channel stride of a pixel is ``NT*8 + 4`` floats in the float32
    mode and ``KT*16 + 8`` in the bf16 mode (its K chunks are 16 deep); a
    weight stage is a tap's B tiles, ``NT*NT*128`` floats (big and small
    tf32 tiles) or ``KT*NT*128`` bf16 values.
    """
    nt, kt = -(-C // 8), -(-C // 16)
    bf16 = _mode(dtype) == "bfloat16"
    stride, band = (kt * 16 + 8 if bf16 else nt * 8 + 4), -(-H // cluster)
    act = -(-((band + 2) * (W + 2) * stride) // 4) * 4
    wstage = kt * nt * 64 if bf16 else nt * nt * 128
    return 4 * (2 * act + band * W * stride + STAGES * wstage)


def cluster_size(B: int, C: int, H: int, W: int, n_sm: int = 132, dtype: torch.dtype = torch.float32) -> int:
    """CTAs per utterance: the rows of an utterance split into that many bands.

    Among the cluster sizes 1, 2, 4, 8 (at most ``H``) whose bands fit the
    kernel (at most ``MAX_TILES`` tiles of 16 pixels, ``SMEM_LIMIT`` bytes),
    the one with the least cost, ties to the larger cluster. One CTA runs
    on an SM at a time (its 512 threads take the SM's registers), and its
    warps work side by side, so a CTA takes about as long with 4 tiles as
    with 11 (0.08 and 0.11 ms for res8 on an H100,
    scripts/probe_torch_res_stack.py): the cost counts waves of
    ``n_sm`` CTAs, each weighted by ``16 + tiles``. So B=1 spreads over 8
    SMs, and a large batch takes the largest bands that fit, in the fewest
    waves. ``dtype`` is the mode's (its shared memory differs). Raises
    ``ValueError`` if none fits.
    """
    best = None
    for cs in (1, 2, 4, 8):
        tiles = -(-(-(-H // cs) * W) // 16)
        if cs > H or tiles > MAX_TILES or smem_bytes(C, H, W, cs, dtype) > SMEM_LIMIT:
            continue
        cost = math.ceil(B * cs / n_sm) * (MAX_TILES + tiles)
        if best is None or cost <= best[0]:
            best = (cost, cs)
    if best is None:
        raise ValueError(
            f"res_stack: maps of {H}x{W} with {C} channels do not split into at most "
            f"{MAX_CLUSTER} bands of at most {MAX_TILES * 16} pixels in shared memory"
        )
    return best[1]


def _fma(y: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``fmaf(y, scale, offset)`` elementwise: the product of two float32 values is
    exact in float64, so one rounding of the float64 sum to float32 is the
    kernel's single rounding (a second rounding can differ from it only when
    the float64 sum lies within 2^-53 of a float32 tie)."""
    return (y.double() * scale.double() + offset.double()).float()


def res_stack_plain(x, w_all, bn_scale, bn_offset, dense_w, dense_b,
                    compute_dtype: torch.dtype = torch.float32,
                    activation_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, C, H, W) pooled activation -> (B, n_labels) logits as plain PyTorch ops,
    in the mode ``(compute_dtype, activation_dtype)``.

    In the bf16 modes each conv's operands are rounded to bf16
    (``round_operand``) and multiplied in float32 (``F.conv2d`` on bf16
    tensors would round its output too). In the ``bfloat16`` mode only
    operands are rounded, the Dense layer's too, never a product, a sum or
    an activation. In the ``bfloat16_activations`` mode each layer's conv
    output, the residual sum and BN's output (``fmaf(y, scale, offset)``,
    as the kernel takes it) are rounded to bf16, the mean is taken over
    those values in float32 and the Dense multiplies float32 operands.
    """
    mode = _mode(compute_dtype, activation_dtype)
    C = x.shape[1]
    old = x
    for i in range(w_all.shape[0]):
        w = w_all[i].reshape(3, 3, C, C).permute(3, 2, 0, 1)  # (out, in, kh, kw)
        y = F.conv2d(round_operand(x, compute_dtype), round_operand(w, compute_dtype), padding=1)
        y = F.relu(round_operand(y, activation_dtype))
        if (i + 1) % 2 == 0:
            y = round_operand(y + old, activation_dtype)
            old = y
        scale, offset = bn_scale[i, :, None, None], bn_offset[i, :, None, None]
        if mode == "bfloat16_activations":
            x = round_operand(_fma(y, scale, offset), activation_dtype)
        else:
            x = y * scale + offset
    dense_dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    return round_operand(x.mean(dim=(2, 3)), dense_dtype) @ round_operand(dense_w, dense_dtype) + dense_b


def res_stack(x, w_all, bn_scale, bn_offset, dense_w, dense_b,
              compute_dtype: torch.dtype = torch.float32,
              activation_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, C, H, W) f32 -> (B, n_labels) f32: the kernel on CUDA, plain on CPU,
    with ``compute_dtype`` operands and ``activation_dtype`` activations
    (a mode of ``MODES``)."""
    args = (x, w_all, bn_scale, bn_offset, dense_w, dense_b)
    _mode(compute_dtype, activation_dtype)
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
    cluster_size(B, C, H, W, dtype=compute_dtype)  # the same maps are refused on every device
    if x.device.type == "cpu":
        return res_stack_plain(*args, compute_dtype=compute_dtype, activation_dtype=activation_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"res_stack runs on cuda or cpu tensors, not {x.device}")
    return _launch(*args, compute_dtype=compute_dtype, activation_dtype=activation_dtype)


@torch.no_grad()
def res_forward_fused(model: torch.nn.Module, feats: torch.Tensor, packed: tuple[torch.Tensor, ...] | None = None,
                      compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The TPU kernel's fused inference forward for a res8 / res26 model
    (``honk_tpu/ops/res_kernel.py::res_forward_fused``): (B, 101, 40) MFCC ->
    (B, n_labels) logits, conv0, ReLU and the pool in float32
    (``model.stem``), then the kernel with ``compute_dtype`` operands and
    float32 activations (bf16 by default, as the TPU's: the ``bfloat16``
    mode). ``packed`` is ``pack_res_params(model, compute_dtype)``, computed
    if None. A bf16 model's eval forward, ``model(feats)``, is flax's flow
    instead (the ``bfloat16_activations`` mode)."""
    if model.dilated:
        raise ValueError("res_forward_fused takes res8 / res26 geometries; dilated res15 runs its eval forward")
    if packed is None:
        packed = pack_res_params(model, compute_dtype)
    return res_stack(model.stem(feats), *packed, compute_dtype=compute_dtype)


@functools.lru_cache(maxsize=None)
def _device_index(C: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fragment_index(C, dtype)).to(device)


def geometry(x: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> dict:
    """The launch the kernel gets for the pooled activation ``x`` on its CUDA device."""
    B, C, H, W = x.shape
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    cs = cluster_size(B, C, H, W, n_sm, compute_dtype)
    return {"cluster": cs, "ctas": B * cs, "threads": 32 * WARPS, "rows_per_cta": -(-H // cs),
            "smem_bytes": smem_bytes(C, H, W, cs, compute_dtype), "n_sm": n_sm}


def _launch(x, w_all, bn_scale, bn_offset, dense_w, dense_b, compute_dtype: torch.dtype = torch.float32,
            activation_dtype: torch.dtype = torch.float32, cluster: int | None = None) -> torch.Tensor:
    """The kernel on checked CUDA operands; ``cluster`` overrides the
    wrapper's choice (scripts/probe_torch_res_stack.py compares them)."""
    global launches
    mode = _mode(compute_dtype, activation_dtype)
    lib = _build.load("res_stack")
    fn = lib.res_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, C, H, W = x.shape
    L, n_labels = w_all.shape[0], dense_w.shape[1]
    cs = cluster or geometry(x, compute_dtype)["cluster"]
    idx = _device_index(C, compute_dtype, x.device)
    nt, kt = -(-C // 8), -(-C // 16)
    # The B tiles, in floats: (L, 9 taps, NT K chunks, big and small, NT * 64)
    # split for 3xTF32, or (L, 9 taps, KT K chunks, NT * 128 bf16).
    n_floats = L * 9 * (kt * nt * 64 if compute_dtype == torch.bfloat16 else nt * nt * 128)
    wpack = torch.empty(n_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((B, n_labels), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_all.data_ptr(), idx.data_ptr(), bn_scale.data_ptr(),
            bn_offset.data_ptr(), dense_w.data_ptr(), dense_b.data_ptr(), out.data_ptr(),
            wpack.data_ptr(), B, C, H, W, L, n_labels, cs, _MODE_ARG[mode], stream,
        )
    _build.check(err, "res_stack")
    launches += 1
    launches_by_mode[mode] += 1
    return out
