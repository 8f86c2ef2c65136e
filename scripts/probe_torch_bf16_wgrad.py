#!/usr/bin/env python3
"""The bf16 layers' float64 weight gradient on the card (``layers._LowConv``).

    python scripts/probe_torch_bf16_wgrad.py      # one card

1. res8's conv0 and conv1 at B=64 on seeded bf16 operands (conv1 with a
   dead input channel): the weight gradient of the 64 rows rounded once
   against its float64 truth (``chip_smoke.rounding_reading``), whether
   the dead channel's is exactly 0, and, as ``chip_smoke.py`` phase 51
   holds it, the float64 parts of 2 and 4 ranks added and rounded once
   against the whole's: [share of elements differing, share past one bf16
   ulp, largest ulps].
2. The per-sample partials alone, at res8's conv0 and conv1 and res15's
   conv0 and its five dilations, at B=64 and 256, ms by CUDA events (20
   calls after 3): the kernel (``ops/wgrad_kernel.py::conv_wgrad``), the
   plain path it replaced (``conv_wgrad_plain``: the cotangent cast to
   float32, one strided im2col copy, again to float32, a batched float32
   GEMM on cuBLAS, TF32 off) and cuBLAS's bf16 GEMM with a float32 output
   over the bf16 columns; beside them the float64 sum over the rows that
   the layer adds, cuDNN's bf16 weight gradient (autograd's, summed and
   rounded by cuDNN: not the same function) and the bound (the larger of
   the bytes, x and gy read once in bf16 and the partials written once in
   float32, over 3.35 TB/s and the operations over 989 TFLOP/s); and the
   kernel's and the plain path's sums rounded once against the float64
   truth.
3. A bf16 forward and backward of res8 at B=256 and of res15 at B=64 on
   seeded features, ms a step by CUDA events (10 steps after 3), with the
   layers' float64 weight gradients and with autograd's bf16 ones (the
   convs as plain bf16 ops), in turns; and whether every gradient is
   finite.

4. ``cli.bench``'s train link (res8 bf16, B=256, its scan lengths and
   reps), audio-s/s, in turns: as shipped; with BN's forward sums in
   float32 by ``mean`` (the one-rank formula before the float64 sums); with
   autograd's bf16 weight gradients (the convs as plain bf16 ops); with
   both (the arithmetic before the repair); as shipped again.
5. The kernel's N tile at section 2's shapes and batches: the narrowest
   that holds O (``wgrad_kernel.plan``: 48 columns for 45 maps) against one
   of 64 columns for every conv (zeros past O), ms by CUDA events in turns
   (planned, 64, 64, planned), and whether the two give the same bits.

Prints one JSON line for 1, one for 2, one line a model for 3 and one JSON
line each for 4 and 5. Imports nothing of JAX.
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from honk_tpu_torch import use_full_f32  # noqa: E402
from honk_tpu_torch.cli import bench  # noqa: E402
from honk_tpu_torch.models import find_config, find_model, init_weights, layers, res  # noqa: E402
from honk_tpu_torch.ops import _build, wgrad_kernel  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("probe_torch_bf16_wgrad: needs a CUDA device")
use_full_f32()
dev = torch.device("cuda")
g = torch.Generator(device="cpu").manual_seed(0)
model = init_weights(find_model("res8")(find_config("res8"), dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0)).to(dev)


def operands(name, rows):
    layer = getattr(model, name)
    x16 = torch.randn((rows, *((1, 101, 40) if name == "conv0" else (45, 25, 13))), generator=g).bfloat16().to(dev)
    if name != "conv0":
        x16[:, 0] = 0  # a dead input channel
    y = F.conv2d(x16, layer.weight.bfloat16(), None, layer.stride, layer.padding, layer.dilation)
    return layer, x16, (torch.randn(y.shape, generator=g) * 1e-3).bfloat16().to(dev)


def geometry(layer):
    return layer.stride, layer.padding, layer.dilation


out = {}
for name in ("conv0", "conv1"):
    layer, x16, dy = operands(name, 64)

    def grad(rows):
        layer.weight.grad = None
        with layers.wide_grads() as wide:
            layers._LowConv.apply(x16[rows], layer.weight, None, torch.bfloat16, geometry(layer)).backward(dy[rows])
        return wide[layer.weight]

    whole = grad(slice(0, 64)).float().bfloat16().float()
    truth = C.conv_wgrad(layer, x16, dy, torch.float64, torch.device("cpu"))
    row = {"whole_vs_truth": C.rounding_reading(whole, truth),
           "dead_channel_zero": bool((whole[:, :1] == 0).all()) if name != "conv0" else None}
    for n in (2, 4):
        r = 64 // n
        total = sum(grad(slice(i * r, (i + 1) * r)) for i in range(n)).float().bfloat16().float()
        d = C.ulps(total, whole)
        row[n] = [float((d > 0).double().mean()), float((d > 1).double().mean()), float(d.max())]
    out[name] = row
print(json.dumps(out), flush=True)


def events(fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bf16_gemm_partials(dy, x16, shape, geo):
    """The layers' columns, kept in bf16, through cuBLAS's bf16 GEMM with a float32 output."""
    cols = wgrad_kernel.columns(x16, shape, dy.shape[2:], geo)
    return torch.bmm(dy.flatten(2), cols.transpose(1, 2), out_dtype=torch.float32)


def truth_of(dy, x16, shape, geo, rows=64):
    """The float64 weight gradient, by float64 GEMMs over the columns of ``rows`` samples at a time."""
    total = 0
    for i in range(0, dy.shape[0], rows):
        cols = wgrad_kernel.columns(x16[i:i + rows], shape, dy.shape[2:], geo).double()
        total = total + torch.bmm(dy[i:i + rows].double().flatten(2), cols.transpose(1, 2)).sum(dim=0)
    return total.view(shape)


res15 = init_weights(find_model("res15")(find_config("res15"), dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0)).to(dev)
shapes = {"res8.conv0": (model.conv0, (1, 101, 40)), "res8.conv1": (model.conv1, (45, 25, 13)),
          "res15.conv0": (res15.conv0, (1, 101, 40)),
          **{f"res15.d{d}": (next(getattr(res15, f"conv{i}") for i in range(1, 14)
                                  if getattr(res15, f"conv{i}").dilation[0] == d), (45, 101, 40))
             for d in (1, 2, 4, 8, 16)}}
out = {}
for name, (layer, chw) in shapes.items():
    for rows in (64, 256):
        shape, geo = layer.weight.shape, geometry(layer)
        x16 = torch.randn((rows, *chw), generator=g).bfloat16().to(dev)
        hw = wgrad_kernel.out_size(chw[1:], shape[2:], *geo)
        dy = (torch.randn((rows, shape[0], *hw), generator=g) * 1e-3).bfloat16().to(dev)
        partials = wgrad_kernel.conv_wgrad(dy, x16, shape, geo)
        truth = truth_of(dy, x16, shape, geo)
        n_bytes = 2 * (x16.numel() + dy.numel()) + 4 * partials.numel()
        n_ops = 2 * partials.numel() * hw[0] * hw[1]
        row = {"bound_ms": max(n_bytes / 3.35e12, n_ops / 989e12) * 1e3,
               "by": "bytes" if n_bytes / 3.35e12 > n_ops / 989e12 else "ops"}
        fns = {"kernel": lambda: wgrad_kernel.conv_wgrad(dy, x16, shape, geo),
               "plain": lambda: wgrad_kernel.conv_wgrad_plain(dy, x16, shape, geo),
               "library_bf16_gemm": lambda: bf16_gemm_partials(dy, x16, shape, geo),
               "float64_sum": lambda: partials.sum(dim=0, dtype=torch.float64),
               "cudnn_bf16": lambda: C.conv_wgrad(layer, x16, dy, torch.bfloat16)}
        for k, fn in fns.items():
            try:
                row[f"{k}_ms"] = events(fn, 20)
            except (RuntimeError, TypeError) as e:  # a torch without bmm's out_dtype
                row[f"{k}_ms"] = str(e)[:200]
        for k in ("kernel", "plain"):
            got = fns[k]().sum(dim=0, dtype=torch.float64).view(shape).float().bfloat16()
            row[f"{k}_vs_truth"] = C.rounding_reading(got, truth)
        out[f"{name}.b{rows}"] = row
print(json.dumps(out), flush=True)


def autograd_conv(layer, x, dtype):
    """``layers.conv`` in bf16 as plain autograd ops: cuDNN's bf16 weight gradient."""
    if dtype == torch.float32:
        return layer(x)
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, *geometry(layer))
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None, None]


conv = res.conv
for conf, B in (("res8", 256), ("res15", 64)):
    m = init_weights(find_model(conf)(find_config(conf), dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0)).to(dev).train()
    feats = torch.randn(B, 101, 40, generator=g).to(dev)
    labels = torch.randint(0, 12, (B,), generator=g).to(dev)

    def step():
        m.zero_grad(set_to_none=True)
        with layers.wide_grads() as wide:
            F.cross_entropy(m(feats), labels).backward()
        layers.finish_grads(m, wide)

    t = {}
    for tag, fn in (("layers", conv), ("autograd", autograd_conv), ("autograd ", autograd_conv), ("layers ", conv)):
        res.conv = fn
        t[tag] = events(step)
    res.conv = conv
    step()
    print(conf, B, json.dumps(t), all(bool(torch.isfinite(p.grad).all()) for p in m.parameters()), flush=True)


def f32_stats(xf, mesh=None):
    """BN's one-rank statistics before the float64 sums: float32 ``mean``."""
    return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3)), xf.new_tensor(xf.numel() // xf.shape[1])


def train_link():
    knobs = bench.settings()
    rng = np.random.default_rng(0)
    m = bench.make_model(knobs["model"], torch.bfloat16, dev)
    pool_n = bench.make_pool(rng, knobs["batch"], dev).shape[0]
    t, _ = bench.marginal(bench.make_train_run(m, rng, knobs["batch"], pool_n, knobs["scan_lens"], dev),
                          knobs["scan_lens"], knobs["reps"])
    return knobs["batch"] / t


stats, link = res.batch_moments, {}
for tag, c, st in (("shipped", conv, stats), ("before_repair", autograd_conv, f32_stats),
                   ("bn_float32_sums", conv, f32_stats), ("autograd_wgrad", autograd_conv, stats),
                   ("shipped_again", conv, stats)):
    res.conv, res.batch_moments = c, st
    link[tag] = train_link()
res.conv, res.batch_moments = conv, stats
print(json.dumps({"train_link_audio_s_per_s": link}), flush=True)


def launch_with_tile(nn, dy, x16, shape, geo, out):
    """``wgrad_kernel._launch`` with the N tile forced to ``nn`` * 8 columns, the shared memory to match."""
    (st, pad, dil), (b, c, h, w), (o, _, kh, kw) = geo, x16.shape, shape
    ho, wo = dy.shape[2:]
    p = wgrad_kernel.plan(c, o, kh, kw, h, w, ho, wo)
    smem = wgrad_kernel.NB * nn * 1024 + p["stages"] * wgrad_kernel.KC * 4 + -(-p["nch"] * h * w // 8) * 16 + 16
    fn = _build.load("conv_wgrad").conv_wgrad_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
    err = fn(x16.data_ptr(), dy.data_ptr(), out.data_ptr(), b, c, h, w, o, ho, wo, kh, kw, *st, *pad, *dil, nn,
             p["m_tiles"], -(-o // (nn * 8)), smem, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_wgrad")


out = {}
for name, (layer, chw) in shapes.items():
    for rows in (64, 256):
        shape, geo = layer.weight.shape, geometry(layer)
        x16 = torch.randn((rows, *chw), generator=g).bfloat16().to(dev)
        hw = wgrad_kernel.out_size(chw[1:], shape[2:], *geo)
        dy = (torch.randn((rows, shape[0], *hw), generator=g) * 1e-3).bfloat16().to(dev)
        nn = wgrad_kernel.plan(chw[0], shape[0], *shape[2:], *chw[1:], *hw)["nn"]
        got = {k: torch.empty((rows, shape[0], shape[1] * shape[2] * shape[3]), device=dev) for k in ("planned", "n64")}
        row = {"planned_n": 8 * nn}
        for k in ("planned", "n64", "n64", "planned"):
            row.setdefault(f"{k}_ms", []).append(events(
                lambda k=k: launch_with_tile(nn if k == "planned" else 8, dy, x16, shape, geo, got[k]), 20))
        row["same_bits"] = bool(torch.equal(got["planned"], got["n64"]))
        out[f"{name}.b{rows}"] = row
print(json.dumps({"n_tile": out}), flush=True)
