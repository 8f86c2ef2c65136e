"""The res-stack kernel's entry from the features (``res_kernel.res_forward``) on the CPU.

Every res8 / res26 eval forward and ``res_forward_fused`` is one launch of
the kernel from the MFCC features, conv0, ReLU and the pool inside it. On
CPU tensors the entry runs its plain version, ``res_forward_plain``: the
mode's stem (``stem_plain``, the flow ``SpeechResModel.stem`` computes) and
``res_stack_plain``. ``chip_smoke.py`` phase 50 holds the kernel itself
against that version on the card.

Gates and why:
- the plain version equals the eval forward as it was computed before the
  stem moved into the kernel (``layers.conv``, ReLU, ``layers.avg_pool``,
  then ``res_stack_plain``), bit for bit: the same PyTorch ops in the same
  order;
- float32 against flax's ``apply(train=False)`` within LOGIT_GATE (2e-4),
  the reference's checkpoint logit gate;
- the ``bfloat16`` mode against the JAX package's ``res_forward_fused``
  (its float32 stem, the Pallas kernel's bf16 mode, run interpreted) within
  PLAIN_MAX (1e-3), as ``tests/test_torch_bf16.py`` holds that call;
- ``bfloat16_activations`` against flax's bf16 apply within NO_KERNEL_ATOL
  (1e-4) for res8 and res8-narrow, and by the ratio rule (at most
  RES26_RATIO of flax's own bf16-to-float32 distance) for res26 and
  res26-narrow, as ``tests/test_torch_bf16.py`` holds the eval forward.
"""

import ctypes
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from honk_tpu.models import find_config as jfind_config
from honk_tpu.ops.res_kernel import res_forward_fused as jres_forward_fused
from honk_tpu_torch.models import find_config, layers
from honk_tpu_torch.models import res as res_model
from honk_tpu_torch.ops import res_kernel
from test_torch_bf16 import NO_KERNEL_ATOL, PLAIN_MAX, RES26_RATIO, _apply, _feats, _flax, _port

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LOGIT_GATE = 2e-4
CONFS = ["res8", "res8-narrow", "res26-narrow"]
MODES = {"float32": (torch.float32, torch.float32), "bfloat16": (torch.bfloat16, torch.float32),
         "bfloat16_activations": (torch.bfloat16, torch.bfloat16)}
GEOMETRY = {"res8": (25, 13), "res8-narrow": (25, 13), "res26": (50, 20), "res26-narrow": (50, 20)}


def _entry(model, feats, mode):
    """``res_forward`` on the model's own operands for ``mode``."""
    compute, act = MODES[mode]
    with torch.no_grad():
        return res_kernel.res_forward(torch.from_numpy(feats), model.conv0.weight, model.pool,
                                      *res_kernel.pack_res_params(model, compute, act),
                                      compute_dtype=compute, activation_dtype=act).numpy()


# --- The plain version -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conf", CONFS)
def test_plain_entry_equals_the_eval_forward_as_it_was_bit_for_bit(conf, dtype):
    """model(feats), the entry's plain version and the eval forward as it ran
    before the stem moved into the kernel: conv0 through ``layers.conv``, ReLU,
    ``layers.avg_pool``, then ``res_stack_plain`` in the model's mode."""
    dt = getattr(torch, dtype)
    model = _port(conf, _flax(conf, seed=4), dt)
    feats = torch.from_numpy(_feats(9, 3))
    with torch.no_grad():
        packed = model.eval_operands()
        stem = layers.avg_pool(F.relu(layers.conv(model.conv0, feats[:, None], dt)), model.pool).float().contiguous()
        before = res_kernel.res_stack_plain(stem, *packed, compute_dtype=dt, activation_dtype=dt)
        plain = res_kernel.res_forward_plain(feats, model.conv0.weight, model.pool, *packed, compute_dtype=dt,
                                             activation_dtype=dt)
        got = model(feats, packed)
    assert torch.equal(model.stem(feats, dt), stem)
    assert torch.equal(plain, before) and torch.equal(got, before)


def test_the_eval_forwards_reach_the_entry_once_with_their_modes(monkeypatch):
    """``SpeechResModel``'s eval forward and ``res_forward_fused`` each call
    ``res_forward`` once, with the features, conv0's weights and the pool."""
    calls = []
    real = res_kernel.res_forward

    def spy(feats, conv0_w, pool, *packed, compute_dtype=torch.float32, activation_dtype=torch.float32):
        calls.append((tuple(feats.shape), conv0_w, pool, compute_dtype, activation_dtype))
        return real(feats, conv0_w, pool, *packed, compute_dtype=compute_dtype, activation_dtype=activation_dtype)

    monkeypatch.setattr(res_kernel, "res_forward", spy)
    monkeypatch.setattr(res_model, "res_forward", spy)
    variables = _flax("res8-narrow")
    feats = torch.from_numpy(_feats(3, 2))
    for dt in (torch.float32, torch.bfloat16):
        model = _port("res8-narrow", variables, dt)
        with torch.no_grad():
            model(feats)
        assert calls.pop() == ((2, 101, 40), model.conv0.weight, (4, 3), dt, dt) and not calls
    res_kernel.res_forward_fused(model, feats)
    assert calls == [((2, 101, 40), model.conv0.weight, (4, 3), torch.bfloat16, torch.float32)]


def test_the_cpu_entry_launches_nothing():
    model = _port("res8-narrow", _flax("res8-narrow"))
    before = (res_kernel.launches, dict(res_kernel.launches_by_entry), res_kernel.packs)
    _entry(model, _feats(1, 2), "float32")
    assert (res_kernel.launches, res_kernel.launches_by_entry, res_kernel.packs) == before


# --- Against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("conf", CONFS)
def test_float32_entry_matches_flax_apply(conf, batch):
    variables = _flax(conf, seed=5)
    feats = _feats(batch + 10, batch)
    want = _apply(conf, variables, feats, None)
    got = _entry(_port(conf, variables), feats, "float32")
    assert got.shape == want.shape == (batch, 12)
    np.testing.assert_allclose(got, want, atol=LOGIT_GATE, rtol=0)


@pytest.mark.parametrize("conf", ["res8-narrow", "res8"])
def test_bfloat16_entry_matches_the_tpu_kernels_fused_forward(conf):
    variables = _flax(conf, seed=6)
    feats = _feats(12, 2)
    want = np.asarray(jres_forward_fused(variables, jfind_config(conf), jnp.asarray(feats), B_blk=2,
                                         compute_dtype=jnp.bfloat16, interpret=True))
    got = _entry(_port(conf, variables), feats, "bfloat16")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= PLAIN_MAX


@pytest.mark.parametrize("conf", ["res8", "res8-narrow", "res26-narrow", "res26"])
def test_bfloat16_activations_entry_matches_flax_bf16_apply(conf):
    variables = _flax(conf, seed=7)
    feats = _feats(13, 3)
    want = _apply(conf, variables, feats, jnp.bfloat16)
    got = _entry(_port(conf, variables, torch.bfloat16), feats, "bfloat16_activations")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if conf.startswith("res8"):
        np.testing.assert_allclose(got, want, atol=NO_KERNEL_ATOL, rtol=0)
    else:
        own = np.abs(want - _apply(conf, variables, feats, None)).max()
        assert np.abs(got - want).max() / own <= RES26_RATIO


# --- Geometry, refusals, packing -------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("conf", list(GEOMETRY))
def test_geometry_fits_every_model_and_mode(conf, mode):
    """The cluster the wrapper picks fits shared memory (with the stem's features
    staged in an activation buffer) at every batch the paths use; bf16 res8
    runs one CTA an utterance from B=256 where its carry is bf16."""
    C, (H, W) = find_config(conf)["n_feature_maps"], GEOMETRY[conf]
    ph, pw = find_config(conf)["res_pool"]
    compute, act = MODES[mode]
    for B in (1, 8, 256, 2996):
        cs = res_kernel.cluster_size(B, C, H, W, dtype=compute, activation_dtype=act)
        lay = res_kernel._layout(C, H, W, cs, mode)
        assert cs in (1, 2, 4, 8) and res_kernel.fits(C, H, W, cs, compute, act)
        assert res_kernel.smem_bytes(C, H, W, cs, compute, act) <= res_kernel.SMEM_LIMIT
        assert ((-(-H // cs) + 2) * ph + 2) * 42 * 4 <= lay["act"]
        if mode == "bfloat16_activations" and conf.startswith("res8") and B >= 256:
            assert cs == 1
    assert res_kernel.cluster_size(1, C, H, W, dtype=compute, activation_dtype=act) >= 4  # B=1 spreads


def test_bf16_layout_holds_bf16_activations_and_a_layer_of_weights():
    """The bf16 modes' shared memory (csrc/res_stack.cu Layout): two bf16
    activation buffers at a stride of KT*16 + 8 values (4 mod 8 in 32-bit
    words: a warp's A loads hit 32 banks), the carry at C values (bf16 in the
    bf16-activation mode), and two stages of a layer's 9 taps of bf16 tiles."""
    C, H, W, kt, nt = 45, 25, 13, 3, 6
    for mode, carry in (("bfloat16", 4), ("bfloat16_activations", 2)):
        lay = res_kernel._layout(C, H, W, 1, mode)
        assert lay["stride"] == kt * 16 + 8 and (lay["stride"] // 2) % 8 == 4
        assert lay["act"] == 27 * 15 * lay["stride"] * 2 and lay["old"] == -(-(25 * 13 * C * carry) // 16) * 16
        assert lay["wstage"] == 9 * kt * nt * 128 * 2 == 41_472 and lay["stages"] == res_kernel.WBUFS
    # One CTA an utterance fits with a bf16 carry, not with the bfloat16 mode's float32 one.
    assert res_kernel.fits(C, H, W, 1, torch.bfloat16, torch.bfloat16)
    assert not res_kernel.fits(C, H, W, 1, torch.bfloat16, torch.float32)
    # The float32 mode keeps its per-tap layout: NT*8 + 4 floats, STAGES stages of big and small tiles.
    lay = res_kernel._layout(C, H, W, 2, "float32")
    assert lay["stride"] == nt * 8 + 4 and lay["wstage"] == nt * nt * 128 * 4 and lay["stages"] == res_kernel.STAGES


@pytest.mark.parametrize("bad", ["feature_rows", "feature_rank", "pool_too_large", "pool_zero", "conv0_shape",
                                 "float64", "not_contiguous", "meta"])
def test_entry_refuses_bad_operands_on_every_device(bad):
    model = _port("res8-narrow", _flax("res8-narrow"))
    packed = res_kernel.pack_res_params(model)
    feats, w0, pool = torch.zeros((2, 101, 40)), model.conv0.weight.detach(), model.pool
    match = None
    if bad == "feature_rows":
        feats = torch.zeros((2, 100, 40))
    elif bad == "feature_rank":
        feats = torch.zeros((2, 101 * 40))
    elif bad == "pool_too_large":
        pool = (5, 3)
    elif bad == "pool_zero":
        pool = (0, 3)
    elif bad == "conv0_shape":
        w0 = torch.zeros((18, 1, 3, 3))
    elif bad == "float64":
        feats = feats.double()
    elif bad == "not_contiguous":
        feats = torch.zeros((2, 40, 101)).transpose(1, 2)
    else:
        feats, w0, packed, match = feats.to("meta"), w0.to("meta"), [p.to("meta") for p in packed], "cuda or cpu"
    with pytest.raises(ValueError, match=match):
        res_kernel.res_forward(feats, w0, pool, *packed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_tiles_hold_each_weight_where_wgmma_reads_it(dtype):
    """The B tiles against the index table: bf16 tiles are the weights rounded
    to nearest even; a 3xTF32 big tile is the weight rounded to TF32 on the
    bits (13 low bits 0) and big + small is the weight exactly."""
    dt = getattr(torch, dtype)
    model = _port("res8-narrow", _flax("res8-narrow", seed=8))
    w_all = res_kernel.pack_res_params(model)[0]
    L, C = w_all.shape[0], w_all.shape[2]
    idx = res_kernel.fragment_index(C, dt)
    taps = w_all.numpy().reshape(L, 9, C * C)
    want = np.where(idx >= 0, taps[:, :, np.maximum(idx, 0)], 0.0).astype(np.float32)
    got = res_kernel.pack_tiles(w_all, dt)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16 and got.shape == (L, 9, idx.size)
        np.testing.assert_array_equal(got.float().numpy().reshape(want.shape),
                                      torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    else:
        assert got.dtype == torch.float32 and got.shape == (L, 9, idx.shape[0], 2, idx[0].size)
        big, small = (got[:, :, :, h].numpy().reshape(want.shape) for h in (0, 1))
        assert not (big.view(np.int32) & 0x1FFF).any()
        np.testing.assert_array_equal(big + small, want)
        assert (np.abs(small) <= np.abs(want) * 2.0 ** -11).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiles_are_packed_once_per_set_of_weights(dtype):
    dt = getattr(torch, dtype)
    model = _port("res8-narrow", _flax("res8-narrow"))
    before = res_kernel.packs
    w_all = res_kernel.pack_res_params(model, dt)[0]
    assert res_kernel.packs == before  # on the CPU nothing is packed for the kernel
    first = res_kernel.tiles(w_all, dt)
    assert res_kernel.tiles(w_all, dt) is first and res_kernel.packs == before + 1
    assert torch.equal(first, res_kernel.pack_tiles(w_all, dt))
    res_kernel.tiles(w_all, torch.bfloat16 if dtype == "float32" else torch.float32)  # the other mode's tiles
    assert res_kernel.packs == before + 2 and res_kernel.tiles(w_all, dt) is first
    other = res_kernel.pack_res_params(model, dt)[0]  # a new set of weights
    res_kernel.tiles(other, dt)
    assert res_kernel.packs == before + 3 and res_kernel.tiles(w_all, dt) is first
    held = len(res_kernel._tile_cache)
    del other  # the tiles live as long as their weights
    assert len(res_kernel._tile_cache) == held - 1 and w_all in res_kernel._tile_cache


def test_the_wrapper_passes_what_the_c_entry_takes():
    """``_launch``'s ctypes signature against ``res_stack_forward``'s in the source:
    the tensors as pointers, then the ints (the shapes, cluster, mode, pool,
    the feature map and the N split), then the stream."""
    src = (Path(res_kernel.__file__).parent / "csrc" / "res_stack.cu").read_text()
    params = re.search(r'extern "C" int res_stack_forward\((.*?)\)\s*\{', src, re.S).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in q else ctypes.c_int for q in params]
    assert kinds == res_kernel._ARGTYPES and params[-2].split()[-1] == "n_parts"


# --- chip_smoke.py's phase 50 helpers --------------------------------------------


@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_activations"])
def test_each_stem_fault_departs_from_the_modes_stem(mode):
    """Each fault ``chip_smoke.stem_faults`` plants is a pooled map of the stem's
    shape that differs from the mode's stem (``stem_plain``), and so moves the
    plain forward's logits: the faults the phase's row gates must refuse."""
    compute, act = MODES[mode]
    model = _port("res8-narrow", _flax("res8-narrow", seed=9), torch.bfloat16)
    feats = torch.from_numpy(_feats(14, 4))
    with torch.no_grad():
        packed = res_kernel.pack_res_params(model, compute, act)
        stem = res_kernel.stem_plain(feats, model.conv0.weight, model.pool, act)
        ref = res_kernel.res_stack_plain(stem, *packed, compute_dtype=compute, activation_dtype=act)
        faults = chip_smoke.stem_faults(torch, feats, model.conv0.weight, model.pool, mode)
        for name, x in faults.items():
            assert x.shape == stem.shape and x.dtype == torch.float32, name
            assert not torch.equal(x, stem), name
            got = res_kernel.res_stack_plain(x, *packed, compute_dtype=compute, activation_dtype=act)
            assert (got - ref).abs().max() > 0, name
    assert set(faults) == ({"bf16_stem"} if mode == "bfloat16" else
                           {"float32_stem", "conv0_float32", "pool_rounded_once"})


@pytest.mark.parametrize("mode", list(MODES))
def test_the_forward_bound_counts_each_modes_weight_bytes(mode):
    """res8 at B=1: the features, conv0, BN, the Dense's bias and the logits in
    float32; the conv weights in bf16 in both bf16 modes, the Dense in bf16 in
    the ``bfloat16`` mode; the pooled entry's bytes likewise."""
    C, L, n, H, W = 45, 6, 12, 25, 13
    conv_b, dense_b = (4, 4) if mode == "float32" else (2, 2) if mode == "bfloat16" else (2, 4)
    want = 4 * (101 * 40 + 9 * C + 2 * L * C + n + n) + conv_b * L * 9 * C * C + dense_b * C * n
    assert chip_smoke.forward_work(1, C, H, W, L, n, 4, 3, mode)[2] == want
    pooled = want - 4 * (101 * 40 + 9 * C) + 4 * C * H * W
    assert chip_smoke.res_work(1, C, H, W, L, n, mode)[1] == pooled
