"""Weight-gradient kernel of the bf16 convolutions: each sample's float32 partial.

For bf16 ``x`` (B, C, H, W) and the bf16 cotangent ``gy`` (B, O, Ho, Wo) of
a conv of weight shape (O, C, kh, kw), ``conv_wgrad`` returns (B, O, C * kh
* kw) float32: sample ``b``'s weight gradient, the float32 sum of the exact
products ``gy[b, o, p] * col[b, r, p]`` over the output positions ``p``, with
``col`` F.unfold's im2col of ``x[b]``. Each sample's sum runs in one fixed
order that depends on neither B nor the sample's place in the batch, so the
float64 sum of a rank's partials adds the same numbers one rank adds
(``models/layers.py::_conv_weight_grad``).

The CUDA source is ``csrc/conv_wgrad.cu``; its header says what bounds it
(bytes, at res15's shapes) and how the design meets that: implicit im2col in
shared memory and ``wgmma`` bf16 -> f32, with no column in device memory. It
replaces no Pallas kernel (the JAX package leaves the weight gradient to XLA).

``conv_wgrad`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``conv_wgrad_plain``, im2col (``columns``)
and a batched float32 GEMM, TF32 off. ``plan`` is the launch geometry both
the wrapper and the tests read; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

launches = 0
KC = 64  # positions a stage (csrc/conv_wgrad.cu)
NB = 4  # B stages in shared memory
MAX_SMEM = 232_448  # shared memory a block can use on an H100
MAX_BATCH = 65_535  # the grid puts the batch on gridDim.y
MAX_SIDE = 16_384  # the position table holds each coordinate in 16 bits


def out_size(hw, kernel, stride, padding, dilation) -> tuple[int, int]:
    """A conv's output (Ho, Wo) for an input of ``hw``."""
    return tuple((hw[a] + 2 * padding[a] - dilation[a] * (kernel[a] - 1) - 1) // stride[a] + 1 for a in range(2))


@functools.lru_cache(maxsize=None)
def plan(c: int, o: int, kh: int, kw: int, h: int, w: int, ho: int, wo: int) -> dict:
    """The kernel's launch for one geometry: M = ``c * kh * kw`` in ``m_tiles`` tiles of 64 rows, N = ``o``
    in ``n_tiles`` tiles of ``nn * 8`` columns (at most 64, the fewest tiles, each as narrow as they allow),
    ``nch``: the most input channels one M tile reads, and ``smem``: a block's shared memory in bytes
    (NB B stages, the position table, those channels padded to 16 bytes, an mbarrier), as the kernel
    lays it out."""
    khw = kh * kw
    rows = c * khw
    m_tiles = -(-rows // 64)
    n_tiles = -(-o // 64)
    per_tile = -(-o // n_tiles)
    nn = -(-per_tile // 8)
    nch = max((min(rows, m + 64) - 1) // khw - m // khw + 1 for m in range(0, rows, 64))
    stages = -(-(ho * wo) // KC)
    smem = NB * nn * 1024 + stages * KC * 4 + -(-nch * h * w // 8) * 16 + 16
    return {"m_tiles": m_tiles, "n_tiles": n_tiles, "nn": nn, "nch": nch, "stages": stages, "smem": smem}


@contextlib.contextmanager
def full_f32():
    """cuBLAS's float32 products outside TF32 inside, whatever the process set, restored after."""
    flag, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def columns(x: torch.Tensor, shape: torch.Size, out_hw: tuple[int, int], geometry) -> torch.Tensor:
    """im2col of (B, C, H, W) ``x`` for a conv of weight ``shape`` and output size ``out_hw``:
    (B, C * kh * kw, Ho * Wo), ``F.unfold``'s layout, as one strided copy of the padded input
    (``F.unfold`` on the card launches a kernel for each row)."""
    stride, padding, dilation = geometry
    xp = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
    b, c, (kh, kw), (ho, wo) = x.shape[0], x.shape[1], shape[2:], out_hw
    sb, sc, sh, sw = xp.stride()
    view = xp.as_strided((b, c, kh, kw, ho, wo), (sb, sc, dilation[0] * sh, dilation[1] * sw,
                                                  stride[0] * sh, stride[1] * sw))
    return view.reshape(b, c * kh * kw, ho * wo)


def conv_wgrad_plain(gy: torch.Tensor, x: torch.Tensor, shape: torch.Size, geometry) -> torch.Tensor:
    """(B, O, C * kh * kw): each sample's float32 weight gradient, by one batched GEMM over ``columns``
    of ``x``, ``gy`` cast to float32, TF32 off (every product of bf16 operands exact)."""
    cols = columns(x, shape, gy.shape[2:], geometry).float()
    with full_f32():
        return torch.bmm(gy.float().flatten(2), cols.transpose(1, 2))


@functools.lru_cache(maxsize=None)
def _gy_shape(x_shape: torch.Size, shape: torch.Size, geometry) -> tuple:
    """The cotangent's shape a conv of weight ``shape`` gives ``x_shape``, or None if their channels differ."""
    if shape[1] != x_shape[1]:
        return None
    return (x_shape[0], shape[0], *out_size(x_shape[2:], shape[2:], *geometry))


def _check(gy: torch.Tensor, x: torch.Tensor, shape, geometry) -> None:
    if x.dtype != torch.bfloat16 or gy.dtype != torch.bfloat16:
        raise ValueError(f"conv_wgrad takes bf16 x and gy, got {x.dtype} and {gy.dtype}")
    if x.ndim != 4 or gy.ndim != 4 or len(shape) != 4:
        raise ValueError(f"conv_wgrad takes 4-D x, gy and weight shape, got {tuple(x.shape)}, {tuple(gy.shape)}, "
                         f"{tuple(shape)}")
    want = _gy_shape(x.shape, torch.Size(shape), tuple(map(tuple, geometry)))
    if gy.shape != want:
        raise ValueError(f"conv_wgrad: x {tuple(x.shape)}, weight {tuple(shape)} and {geometry} do not give "
                         f"gy {tuple(gy.shape)}")
    if gy.device != x.device or not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("conv_wgrad takes contiguous x and gy on one device")


def conv_wgrad(gy: torch.Tensor, x: torch.Tensor, shape: torch.Size, geometry) -> torch.Tensor:
    """(B, O, C * kh * kw) float32, each sample's weight gradient: the kernel on CUDA, plain on CPU.
    ``geometry`` is (stride, padding, dilation), each a pair."""
    _check(gy, x, shape, geometry)
    if x.device.type == "cpu":
        return conv_wgrad_plain(gy, x, shape, geometry)
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad runs on cuda or cpu tensors, not {x.device}")
    return _launch(gy, x, shape, geometry)


def _launch(gy, x, shape, geometry) -> torch.Tensor:
    global launches
    (stride, padding, dilation), (b, c, h, w), (o, _, kh, kw) = geometry, x.shape, shape
    ho, wo = gy.shape[2:]
    p = plan(c, o, kh, kw, h, w, ho, wo)
    if p["smem"] > MAX_SMEM or b > MAX_BATCH or max(h, w, ho, wo) >= MAX_SIDE:
        raise ValueError(f"conv_wgrad: {p['nch']} input channels of {h} x {w} and {ho * wo} positions need "
                         f"{p['smem']} bytes of shared memory (at most {MAX_SMEM}), B={b} (at most {MAX_BATCH})")
    out = torch.empty((b, o, c * kh * kw), dtype=torch.float32, device=x.device)
    fn = _build.load("conv_wgrad").conv_wgrad_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gy.data_ptr(), out.data_ptr(), b, c, h, w, o, ho, wo, kh, kw, *stride, *padding,
                 *dilation, p["nn"], p["m_tiles"], p["n_tiles"], p["smem"], stream)
    _build.check(err, "conv_wgrad")
    launches += 1
    return out
