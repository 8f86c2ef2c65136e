"""Res-stack kernel: the eval forward of res8 / res26 from the features to the logits.

Hopper counterpart of ``honk_tpu/ops/res_kernel.py`` (Pallas
``_res_stack_call`` / ``_make_kernel``, packer ``pack_res_params``) with
the stem (conv0, ReLU and the pool, which the TPU path leaves to XLA)
inside it, in three modes (``MODES``, by ``compute_dtype`` and
``activation_dtype``):
- ``float32``: the TPU kernel in float32, behind a float32 stem;
- ``bfloat16``: the TPU kernel's default operand type, where each conv's
  activations and weights and the Dense layer's features and weights are
  rounded to bf16 (to nearest even) and multiplied with f32 sums, while
  activations, the residual carry and BN stay f32; behind a float32 stem,
  as the JAX package's ``res_forward_fused``;
- ``bfloat16_activations``: bf16 operands with flax's dtype flow, what the
  JAX package computes for a bf16 model's eval forward through XLA
  (``honk_tpu/models/res.py``, ``apply(train=False)``): the stem in bf16
  (conv0's f32 sum rounded, ReLU, the pool's adds in window order each
  rounded), each conv's f32 sum rounded to bf16, ReLU, the residual add
  rounded to bf16 (the carry holds bf16 values), the folded BN taken in
  f32 and rounded back to bf16, then the mean over those values in f32 and
  a float32 Dense.

The CUDA source is ``csrc/res_stack.cu``; its header says what bounds it on
the card (the convolutions' products, on the tensor cores in 3xTF32 or in
bf16) and how the design meets that: a thread block cluster per utterance,
each CTA a band of rows in shared memory, the stem computed from the
features by each CTA for its rows, each conv an implicit GEMM with
``wgmma`` (bf16 activations held as bf16, a layer's weights in one TMA
stage). Two entries, one kernel:
- ``res_forward(feats, conv0_w, pool, *packed, ...)``: ``(B, 101, 40)``
  features -> ``(B, n_labels)`` logits in one launch, what every res8 /
  res26 eval forward runs (``SpeechResModel.forward``, ``res_forward_fused``);
- ``res_stack(x, *packed, ...)``: the TPU kernel's interface, from the
  pooled activation ``(B, C, H, W)`` (res8: ``(B, 45, 25, 13)``).
Any batch size, ``C <= 64``, any layer count, and maps whose rows split
into at most 8 bands that each fit the kernel (``cluster_size``): res8,
res8-narrow, res26 and res26-narrow. res15's dilated convs are not
covered, as on the TPU: ``SpeechResModel`` runs them through cuDNN.

On CUDA tensors the wrappers launch the kernel in the mode asked for (or
raise); on CPU tensors they run ``res_forward_plain`` / ``res_stack_plain``,
the same function as plain ``F.conv2d`` layers with the same BN folding and,
in the bf16 modes, the same operands rounded to bf16 and the convs run in
f32 (a product of two bf16 values is exact in f32 and in TF32, so this is
the kernel's arithmetic up to the order of f32 sums), and the same
roundings of the activations. The weights' B tiles are packed once per set
of weights (``tiles``), not on every call. ``launches`` counts kernel
launches in every mode, ``launches_by_mode`` each mode's and
``launches_by_entry`` each entry's; ``packs`` counts weight packs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from . import _build

launches = 0
packs = 0
# (compute_dtype, activation_dtype) -> the mode's name, and its number in csrc/res_stack.cu.
MODES = {(torch.float32, torch.float32): "float32", (torch.bfloat16, torch.float32): "bfloat16",
         (torch.bfloat16, torch.bfloat16): "bfloat16_activations"}
_MODE_ARG = {name: i for i, name in enumerate(MODES.values())}
launches_by_mode = {name: 0 for name in MODES.values()}
launches_by_entry = {"res_forward": 0, "res_stack": 0}
BN_EPS = 1e-5
MAX_MAPS = 64
# Launch geometry of csrc/res_stack.cu (its WARPS, STAGES, WBUFS and MAX_CLUSTER).
WARPS = 16
MAX_TILES = WARPS  # float32: 16-pixel rows of M tiles one CTA's band may have (4 warpgroups x 64)
STAGES = 3  # float32: per-tap weight stages in shared memory
WBUFS = 2  # bf16: per-layer weight stages
MAX_CLUSTER = 8
# Dynamic shared memory one CTA may use on sm_90, less the kernel's static
# partial sums, features, BN constants and warps' channel sums
# ((MAX_CLUSTER + 3 + WARPS) * 64 floats) and its two mbarriers.
SMEM_LIMIT = 232_448 - 4 * (MAX_CLUSTER + 3 + WARPS) * MAX_MAPS - 16
# The stem's input, (B, 101, 40) MFCC features, and its largest pool window
# (csrc/res_stack.cu MAX_PH, MAX_PW: res8's 4x3).
FEATURE_SHAPE = (101, 40)
MAX_POOL = (4, 3)


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
    ``bfloat16_activations`` mode keeps the Dense float32, as flax's. On a
    CUDA device ``w_all``'s B tiles are packed here, once (``tiles``).
    """
    mode = _mode(dtype, activation_dtype)
    w_all = torch.stack([
        getattr(model, f"conv{i}").weight.permute(2, 3, 1, 0).reshape(-1, model.n_maps)
        for i in range(1, model.n_layers + 1)
    ])
    w_all = round_operand(w_all, dtype).contiguous()
    if w_all.is_cuda:
        tiles(w_all, dtype)
    return (
        w_all,
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
    padding of channels ``>= C``. ``pack_tiles`` gathers ``w_all`` by it
    and splits each value for 3xTF32 or rounds it to bf16.
    """
    nt = -(-C // 8)
    depth = 16 if _mode(dtype) == "bfloat16" else 8  # K values of one chunk
    kc, j, h, r, k = np.meshgrid(np.arange(-(-C // depth)), np.arange(nt), np.arange(2), np.arange(8),
                                 np.arange(depth // 2), indexing="ij")
    ic, oc = kc * depth + (depth // 2) * h + k, 8 * j + r
    return np.where((ic < C) & (oc < C), ic * C + oc, -1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_index(C: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fragment_index(C, dtype)).reshape(-1).long().to(device)


@torch.no_grad()
def pack_tiles(w_all: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's B tiles of ``w_all`` (L, 9C, C), as PyTorch ops on its device.

    float32 (3xTF32): ``(L, 9, NT, 2, NT * 64)`` float32, for each K chunk a
    big tile (the weight rounded to TF32 on the bits, ``(bits + 0x1000) &
    ~0x1FFF``, as the kernel rounds activations) then a small one (the
    weight less its big part, exact in f32). bfloat16 (both bf16 modes):
    ``(L, 9, KT, NT * 128)`` bf16, rounded to nearest even. Entry ``e`` of a
    tap's tiles is the weight at ``fragment_index`` entry ``e``, 0 for
    padding.
    """
    L, C = w_all.shape[0], w_all.shape[2]
    idx = _device_index(C, compute_dtype, w_all.device)
    vals = torch.where(idx >= 0, w_all.reshape(L, 9, C * C)[:, :, idx.clamp_min(0)], 0.0)
    if _mode(compute_dtype) == "bfloat16":
        return vals.to(torch.bfloat16).contiguous()
    nt = -(-C // 8)
    big = ((vals.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.stack([big.reshape(L, 9, nt, nt * 64), (vals - big).reshape(L, 9, nt, nt * 64)], dim=3).contiguous()


_tile_cache = WeakTensorKeyDictionary()  # w_all -> {tile kind: tiles}


def tiles(w_all: torch.Tensor, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``pack_tiles(w_all, compute_dtype)``, packed once per ``w_all`` tensor and
    kept while it lives. The operands are constants: new weights are new
    operands (``pack_res_params``), never ``w_all`` changed in place."""
    global packs
    per_kind = _tile_cache.setdefault(w_all, {})
    kind = _mode(compute_dtype)
    if kind not in per_kind:
        per_kind[kind] = pack_tiles(w_all, compute_dtype)
        packs += 1
    return per_kind[kind]


def _layout(C: int, H: int, W: int, cluster: int, mode: str) -> dict:
    """One CTA's shared memory in bytes, region by region (``Layout`` in the source).

    float32: channel stride ``NT*8 + 4`` floats, activations f32, the carry
    at the same stride, ``STAGES`` per-tap stages of ``NT*NT*128`` floats
    (big and small tf32 tiles). bf16 modes: channel stride ``KT*16 + 8``
    bf16 values, activations bf16, the carry at stride ``C`` (f32 in the
    ``bfloat16`` mode, bf16 in ``bfloat16_activations``), ``WBUFS``
    per-layer stages of ``9*KT*NT*128`` bf16 values.
    """
    nt, kt = -(-C // 8), -(-C // 16)
    band = -(-H // cluster)
    if mode == "float32":
        stride = nt * 8 + 4
        return {"stride": stride, "act": -(-((band + 2) * (W + 2) * stride) // 4) * 16,
                "old": band * W * stride * 4, "wstage": nt * nt * 512, "stages": STAGES}
    stride = kt * 16 + 8
    return {"stride": stride, "act": -(-((band + 2) * (W + 2) * stride * 2) // 16) * 16,
            "old": -(-(band * W * C * (2 if mode == "bfloat16_activations" else 4)) // 16) * 16,
            "wstage": 9 * kt * nt * 256, "stages": WBUFS}


def smem_bytes(C: int, H: int, W: int, cluster: int, dtype: torch.dtype = torch.float32,
               activation_dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one CTA (``Layout::bytes`` in the source):
    the weight stages, two activation buffers and the carry (``_layout``)."""
    lay = _layout(C, H, W, cluster, _mode(dtype, activation_dtype))
    return lay["stages"] * lay["wstage"] + 2 * lay["act"] + lay["old"]


def fits(C: int, H: int, W: int, cluster: int, dtype: torch.dtype = torch.float32,
         activation_dtype: torch.dtype = torch.float32) -> bool:
    """Whether bands of ``ceil(H / cluster)`` rows fit the kernel: at most ``H``
    bands, ``SMEM_LIMIT`` bytes, and in the float32 mode (one work item a
    warpgroup) at most ``MAX_TILES`` tiles of 16 pixels."""
    tiles16 = -(-(-(-H // cluster) * W) // 16)
    return (cluster <= H and smem_bytes(C, H, W, cluster, dtype, activation_dtype) <= SMEM_LIMIT
            and (tiles16 <= MAX_TILES or _mode(dtype, activation_dtype) != "float32"))


def cluster_size(B: int, C: int, H: int, W: int, n_sm: int = 132, dtype: torch.dtype = torch.float32,
                 activation_dtype: torch.dtype = torch.float32) -> int:
    """CTAs per utterance: the rows of an utterance split into that many bands.

    Among the cluster sizes 1, 2, 4, 8 whose bands fit the kernel
    (``fits``), the one with the least cost, ties to the larger cluster. One
    CTA runs on an SM at a time (its 512 threads take the SM's registers),
    so the cost counts waves of ``n_sm`` CTAs, each weighted by a CTA's
    time. float32: its warps work side by side, one tile each, so a CTA
    takes about as long with 4 tiles of 16 pixels as with 11 (0.08 and 0.11
    ms for res8 on an H100, scripts/probe_torch_res_stack.py), weight
    ``16 + tiles``. bf16 modes: each warpgroup loops over the band's
    64-pixel tiles, weight ``2 + tiles`` (the stem and the barriers about two
    tiles). So B=1 spreads over 8 SMs, and a large batch takes the largest
    bands that fit, in the fewest waves (res8 bf16: one CTA an utterance).
    On an H100 both weights pick the fastest cluster that fits in all 72
    cases of scripts/probe_torch_res_stack.py (res8, res26, res8-narrow;
    every mode; both entries; B = 1, 8, 256, 2,996).
    Raises ``ValueError`` if none fits.
    """
    bf16 = _mode(dtype, activation_dtype) != "float32"
    best = None
    for cs in (1, 2, 4, 8):
        if not fits(C, H, W, cs, dtype, activation_dtype):
            continue
        pixels = -(-H // cs) * W
        weight = 2 + -(-pixels // 64) if bf16 else MAX_TILES + -(-pixels // 16)
        cost = math.ceil(B * cs / n_sm) * weight
        if best is None or cost <= best[0]:
            best = (cost, cs)
    if best is None:
        raise ValueError(
            f"res_stack: maps of {H}x{W} with {C} channels do not split into at most "
            f"{MAX_CLUSTER} bands that fit the kernel in shared memory"
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


def chained_avg_pool(x: torch.Tensor, window: tuple[int, int]) -> torch.Tensor:
    """flax's ``nn.avg_pool(window, strides=window, padding="VALID")`` of a bf16
    NCHW ``x``: the window's values added one by one in ``x``'s dtype in
    row-major window order, the sum divided by the window's size in that dtype."""
    (ph, pw), (b, c, h, w) = window, x.shape
    v = x[:, :, : h // ph * ph, : w // pw * pw].view(b, c, h // ph, ph, w // pw, pw)
    acc = v[:, :, :, 0, :, 0]
    for i in range(ph):
        for j in range(pw):
            if i or j:
                acc = acc + v[:, :, :, i, :, j]
    return acc / (ph * pw)


def stem_plain(feats: torch.Tensor, conv0_w: torch.Tensor, pool: tuple[int, int] | None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """conv0 (3x3 SAME, no bias) -> ReLU -> the ``pool`` window's mean in ``dtype``'s
    flow (flax's: in bf16 each returns bf16, the pool ``chained_avg_pool``):
    (B, Hin, Win) -> (B, C, Hin // ph, Win // pw) float32, the res stack's input
    (holding bf16 values for a bf16 ``dtype``)."""
    x = feats[:, None]
    if dtype != torch.float32:
        x, conv0_w = x.to(dtype), conv0_w.to(dtype)
    y = F.relu(F.conv2d(x, conv0_w, None, (1, 1), (1, 1), (1, 1)))
    if pool is not None:
        y = F.avg_pool2d(y, pool) if y.dtype == torch.float32 else chained_avg_pool(y, tuple(pool))
    return y.float().contiguous()


def _stem_dtype(mode: str) -> torch.dtype:
    """The stem's flow per mode: bf16 in flax's bf16 forward, float32 otherwise
    (a float32 model's, and the JAX package's fused forward's)."""
    return torch.bfloat16 if mode == "bfloat16_activations" else torch.float32


def res_forward_plain(feats, conv0_w, pool, w_all, bn_scale, bn_offset, dense_w, dense_b,
                      compute_dtype: torch.dtype = torch.float32,
                      activation_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, Hin, Win) features -> (B, n_labels) logits as plain PyTorch ops: the
    mode's stem (``stem_plain``) then ``res_stack_plain``."""
    x = stem_plain(feats, conv0_w, pool, _stem_dtype(_mode(compute_dtype, activation_dtype)))
    return res_stack_plain(x, w_all, bn_scale, bn_offset, dense_w, dense_b,
                           compute_dtype=compute_dtype, activation_dtype=activation_dtype)


def _check(what: str, x: torch.Tensor, B: int, C: int, H: int, W: int, operands: tuple, mode: str) -> int:
    """The checks both entries make on every device; returns the cluster size."""
    w_all, bn_scale, bn_offset, dense_w, dense_b = operands
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
            f"{what} takes w_all (L, 9C, C) with C<=64, bn_scale/bn_offset (L, C), dense_w (C, n), "
            f"dense_b (n,) for its input; got {[tuple(a.shape) for a in (x, *operands)]}"
        )
    if any(a.dtype != torch.float32 or not a.is_contiguous() or a.device != x.device for a in (x, *operands)):
        raise ValueError(f"{what} takes contiguous float32 tensors on one device")
    dtypes = next(k for k, v in MODES.items() if v == mode)
    cs = cluster_size(B, C, H, W, dtype=dtypes[0], activation_dtype=dtypes[1])  # refused on every device
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    return cs


def res_stack(x, w_all, bn_scale, bn_offset, dense_w, dense_b,
              compute_dtype: torch.dtype = torch.float32,
              activation_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, C, H, W) f32 -> (B, n_labels) f32: the kernel on CUDA, plain on CPU,
    with ``compute_dtype`` operands and ``activation_dtype`` activations
    (a mode of ``MODES``), from the pooled map (the TPU kernel's interface)."""
    mode = _mode(compute_dtype, activation_dtype)
    B, C, H, W = x.shape if x.ndim == 4 else (0, 0, 0, 0)
    operands = (w_all, bn_scale, bn_offset, dense_w, dense_b)
    _check("res_stack", x, B, C, H, W, operands, mode)
    if x.device.type == "cpu":
        return res_stack_plain(x, *operands, compute_dtype=compute_dtype, activation_dtype=activation_dtype)
    return _launch(x, *operands, compute_dtype=compute_dtype, activation_dtype=activation_dtype)


def res_forward(feats, conv0_w, pool, w_all, bn_scale, bn_offset, dense_w, dense_b,
                compute_dtype: torch.dtype = torch.float32,
                activation_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, 101, 40) f32 features -> (B, n_labels) f32 logits: conv0 (``conv0_w``,
    (C, 1, 3, 3)), ReLU, the ``pool`` window's mean and the res stack, in one
    kernel launch on CUDA (plain on CPU), in the mode ``(compute_dtype,
    activation_dtype)`` with that mode's stem (``_stem_dtype``). ``w_all`` ..
    ``dense_b`` are ``pack_res_params``'s operands for the mode."""
    mode = _mode(compute_dtype, activation_dtype)
    operands = (w_all, bn_scale, bn_offset, dense_w, dense_b)
    if feats.shape[1:] != FEATURE_SHAPE or feats.shape[0] < 1:
        raise ValueError(f"res_forward takes (B, {FEATURE_SHAPE[0]}, {FEATURE_SHAPE[1]}) features, "
                         f"got {tuple(feats.shape)}")
    C = w_all.shape[-1] if w_all.ndim == 3 else 0
    if conv0_w.shape != (C, 1, 3, 3):
        raise ValueError(f"res_forward takes conv0 weights (C, 1, 3, 3) with w_all's C={C}, got {tuple(conv0_w.shape)}")
    if not (len(pool) == 2 and all(isinstance(p, int) and 1 <= p <= n for p, n in zip(pool, MAX_POOL))):
        raise ValueError(f"res_forward takes a pool window (ph, pw) of at most {MAX_POOL}, got {pool}")
    B, (H, W) = feats.shape[0], (FEATURE_SHAPE[0] // pool[0], FEATURE_SHAPE[1] // pool[1])
    cs = _check("res_forward", feats, B, C, H, W, operands, mode)
    if conv0_w.dtype != torch.float32 or not conv0_w.is_contiguous() or conv0_w.device != feats.device:
        raise ValueError("res_forward takes contiguous float32 tensors on one device")
    # The stem stages its features in the second activation buffer (csrc/res_stack.cu).
    if ((-(-H // cs) + 2) * pool[0] + 2) * (FEATURE_SHAPE[1] + 2) * 4 > _layout(C, H, W, cs, mode)["act"]:
        raise ValueError(f"res_forward: the stem's features do not fit a band of {H}x{W} maps with {C} channels")
    if feats.device.type == "cpu":
        return res_forward_plain(feats, conv0_w, pool, *operands, compute_dtype=compute_dtype,
                                 activation_dtype=activation_dtype)
    return _launch(feats, *operands, compute_dtype=compute_dtype, activation_dtype=activation_dtype,
                   conv0_w=conv0_w, pool=tuple(pool))


@torch.no_grad()
def res_forward_fused(model: torch.nn.Module, feats: torch.Tensor, packed: tuple[torch.Tensor, ...] | None = None,
                      compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The TPU kernel's fused inference forward for a res8 / res26 model
    (``honk_tpu/ops/res_kernel.py::res_forward_fused``): (B, 101, 40) MFCC ->
    (B, n_labels) logits, conv0, ReLU and the pool in float32, then the
    stack with ``compute_dtype`` operands and float32 activations (bf16 by
    default, as the TPU's: the ``bfloat16`` mode), in one launch
    (``res_forward``). ``packed`` is ``pack_res_params(model, compute_dtype)``,
    computed if None. A bf16 model's eval forward, ``model(feats)``, is
    flax's flow instead (the ``bfloat16_activations`` mode)."""
    if model.dilated:
        raise ValueError("res_forward_fused takes res8 / res26 geometries; dilated res15 runs its eval forward")
    if packed is None:
        packed = pack_res_params(model, compute_dtype)
    return res_forward(feats.contiguous(), model.conv0.weight, model.pool, *packed, compute_dtype=compute_dtype)


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def geometry(x: torch.Tensor, compute_dtype: torch.dtype = torch.float32,
             activation_dtype: torch.dtype = torch.float32) -> dict:
    """The launch the kernel gets for the pooled activation ``x`` (or its shape,
    ``(B, C, H, W)``) on its CUDA device, in the mode ``(compute_dtype,
    activation_dtype)``."""
    B, C, H, W = x.shape
    n_sm = _n_sm(x.device)
    cs = cluster_size(B, C, H, W, n_sm, compute_dtype, activation_dtype)
    return {"cluster": cs, "ctas": B * cs, "threads": 32 * WARPS, "rows_per_cta": -(-H // cs),
            "smem_bytes": smem_bytes(C, H, W, cs, compute_dtype, activation_dtype), "n_sm": n_sm}


# csrc/res_stack.cu's res_stack_forward: 8 tensors, 13 ints, the stream.
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("res_stack").res_stack_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(x, w_all, bn_scale, bn_offset, dense_w, dense_b, compute_dtype: torch.dtype = torch.float32,
            activation_dtype: torch.dtype = torch.float32, cluster: int | None = None,
            conv0_w: torch.Tensor | None = None, pool: tuple[int, int] = (1, 1), n_parts: int = 0) -> torch.Tensor:
    """The kernel on checked CUDA operands: from the pooled map ``x``, or with
    ``conv0_w`` from the features ``x`` through the stem with a ``pool``
    window. ``cluster`` overrides the wrapper's choice and, in the bf16
    modes, ``n_parts`` the kernel's split of N (scripts/probe_torch_res_stack.py
    compares them)."""
    global launches
    mode = _mode(compute_dtype, activation_dtype)
    fn = _entry()
    if conv0_w is None:
        B, C, H, W = x.shape
        (ph, pw), (Hin, Win) = (0, 0), (0, 0)
    else:
        (B, Hin, Win), (ph, pw), C = x.shape, pool, w_all.shape[-1]
        H, W = Hin // ph, Win // pw
    L, n_labels = w_all.shape[0], dense_w.shape[1]
    cs = cluster or cluster_size(B, C, H, W, _n_sm(x.device), compute_dtype, activation_dtype)
    wpack = tiles(w_all, compute_dtype)
    out = torch.empty((B, n_labels), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), None if conv0_w is None else conv0_w.data_ptr(), wpack.data_ptr(),
            bn_scale.data_ptr(), bn_offset.data_ptr(), dense_w.data_ptr(), dense_b.data_ptr(), out.data_ptr(),
            B, C, H, W, L, n_labels, cs, _MODE_ARG[mode], ph, pw, Hin, Win, n_parts, stream,
        )
    _build.check(err, "res_stack")
    launches += 1
    launches_by_mode[mode] += 1
    launches_by_entry["res_stack" if conv0_w is None else "res_forward"] += 1
    return out
