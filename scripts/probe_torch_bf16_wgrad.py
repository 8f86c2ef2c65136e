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
2. The weight gradient alone, conv0 and conv1 of res8 at B=256, ms by CUDA
   events (20 calls after 3): cuDNN's bf16 one (autograd's), the layers'
   (``_conv_weight_grad``: one strided im2col copy, a batched float32
   GEMM, the per-sample partials summed in float64), the same on ``F.unfold``'s im2col, the layers' columns in bf16
   through a bf16 GEMM with a float32 output, and the layers' with TF32 on,
   each with its reading against the float64 truth.
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

Prints one JSON line for 1, one for 2, one line a model for 3 and one JSON
line for 4. Imports nothing of JAX.
"""
import contextlib
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


@contextlib.contextmanager
def tf32():
    flag, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, True
    full, layers._full_f32 = layers._full_f32, contextlib.nullcontext
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, layers._full_f32 = flag, full


def bf16_gemm_grad(layer, x16, dy):
    """The layers' columns, kept in bf16, through cuBLAS's bf16 GEMM with a float32 output."""
    cols = layers._columns(x16, layer.weight.shape, dy.shape[2:], geometry(layer))
    return torch.bmm(dy.flatten(2), cols.transpose(1, 2), out_dtype=torch.float32).sum(dim=0).view(
        layer.weight.shape)


def unfold_grad(layer, x16, dy):
    cols = F.unfold(x16.float(), layer.weight.shape[2:], layer.dilation, layer.padding, layer.stride)
    with layers._full_f32():
        return torch.bmm(dy.float().flatten(2), cols.transpose(1, 2)).sum(dim=0).view(layer.weight.shape)


out = {}
for name in ("conv0", "conv1"):
    layer, x16, dy = operands(name, 256)
    truth = C.conv_wgrad(layer, x16, dy, torch.float64, torch.device("cpu"))
    fns = {"cudnn_bf16": lambda: C.conv_wgrad(layer, x16, dy, torch.bfloat16),
           "layers": lambda: layers._conv_weight_grad(dy.float(), x16, layer.weight.shape, geometry(layer)),
           "unfold": lambda: unfold_grad(layer, x16, dy), "bf16_gemm_f32_out": lambda: bf16_gemm_grad(layer, x16, dy)}
    row = {}
    for k, fn in fns.items():
        try:
            row[k] = {"ms": events(fn, 20), "vs_truth": C.rounding_reading(fn().bfloat16(), truth)}
        except (RuntimeError, TypeError) as e:  # a torch without bmm's out_dtype
            row[k] = {"error": str(e)[:200]}
    with tf32():
        row["layers_tf32"] = {"ms": events(fns["layers"], 20),
                              "vs_truth": C.rounding_reading(fns["layers"]().bfloat16(), truth)}
    out[name] = row
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
