"""Host-side tables and arithmetic of the port's MFCC and res-stack kernels, on the CPU.

The CUDA kernels cannot run here, but what they are built from can: the
MFCC kernel's mel runs and FFT twiddle table (``ops/mfcc_kernel.py``), the
res-stack kernel's weight index table (the order of wgmma's B tiles) and
launch geometry (``ops/res_kernel.py``), and the 3xTF32 arithmetic of its
tensor-core products, emulated in float32 numpy. Each is held against the JAX
package's own function where there is one. ``chip_smoke.py`` holds the
kernels themselves against their plain versions on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from honk_tpu import frontend as jfe
from honk_tpu.frontend import filters as jfilters
from honk_tpu_torch.frontend import filters as tfilters
from honk_tpu_torch.models import SpeechResModel, find_config, load_honk_checkpoint
from honk_tpu_torch.ops import mfcc_kernel, res_kernel

ZOO_RES8 = "zoo/res8.pt"
# The reference's checkpoint logit gate (tests/test_cross_runtime.py), which
# the service on the card is held to against the CPU.
LOGIT_GATE = 2e-4


# --- MFCC: mel runs and the FFT --------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mel_runs_rebuild_the_dense_mel_matrix_bit_for_bit(dtype):
    runs, taps = mfcc_kernel.mel_runs(dtype)
    dense = np.zeros((tfilters.N_RFFT, tfilters.N_MELS), dtype)
    for m, (start, length, offset) in enumerate(runs):
        dense[start:start + length, m] = taps[offset:offset + length]
    assert runs.shape == (40, 3) and runs.dtype == np.int32 and taps.dtype == dtype
    np.testing.assert_array_equal(dense, jfilters.frontend_constants(dtype)["mel"])
    np.testing.assert_array_equal(dense, tfilters.frontend_constants(dtype)["mel"])
    # Runs of at most 13 bins inside 1..119, 230 taps in all (the kernel's header).
    assert runs[:, 0].min() >= 1 and (runs[:, 0] + runs[:, 1]).max() <= mfcc_kernel.N_BINS
    assert runs[:, 1].max() <= 13 and len(taps) == int(runs[:, 1].sum()) == 230


def _stockham_model(z, tw):
    """The kernel's FFT passes (csrc/mfcc.cu ``pass``), driven by its twiddle table."""
    n = z.size
    off, ns = 0, 1
    for r in mfcc_kernel.FFT_RADICES:
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        out = np.empty_like(z)
        J = n // r
        for j in range(J):
            k = j % ns
            v = np.array([z[j + q * J] for q in range(r)]) * tw[off + k * r: off + k * r + r]
            d = (j // ns) * ns * r + k
            out[d + np.arange(r) * ns] = dft @ v
        z, off, ns = out, off + ns * r, ns * r
    return z, off


def _rfft_model(frames, tw):
    """Packed complex FFT and the real-FFT split step, bins 0..N_BINS-1."""
    out = []
    for x in frames:
        Z, off = _stockham_model(x[0::2] + 1j * x[1::2], tw)
        k = np.arange(mfcc_kernel.N_BINS)
        zk, zn = Z[k], np.conj(Z[(Z.size - k) % Z.size])
        out.append((zk + zn) / 2 + tw[off + k] * (zk - zn) / 2j)
    return np.stack(out)


def test_fft_model_with_the_kernels_twiddles_equals_numpy_rfft():
    tw64 = mfcc_kernel.fft_twiddles(np.float64)
    tw = tw64[:, 0] + 1j * tw64[:, 1]
    assert tw64.shape == (428, 2)
    np.testing.assert_array_equal(mfcc_kernel.fft_twiddles(np.float32), tw64.astype(np.float32))
    frames = np.random.default_rng(0).standard_normal((3, tfilters.N_FFT))
    got = _rfft_model(frames, tw)
    ref = np.fft.rfft(frames, axis=-1)[:, :mfcc_kernel.N_BINS]
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=0, atol=1e-9)


def test_kernel_mfcc_model_matches_jax_frontend_and_golden():
    # The kernel's whole pipeline in float64 numpy with its f32 tables:
    # reflect framing, window, the FFT model, |X|^2, mel runs, masked log, DCT.
    audio = (np.random.default_rng(3).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    audio[1, :] = 0.0  # a silent row: exactly 0
    consts = tfilters.frontend_constants(np.float32)
    tw32 = mfcc_kernel.fft_twiddles(np.float32).astype(np.float64)
    runs, taps = mfcc_kernel.mel_runs(np.float32)
    got = []
    for row in audio.astype(np.float64):
        padded = np.pad(row, 240, mode="reflect")
        frames = np.stack([padded[t * 160: t * 160 + 480] for t in range(101)]) * consts["window"]
        power = np.abs(_rfft_model(frames, tw32[:, 0] + 1j * tw32[:, 1])) ** 2
        mel = np.stack([power[:, s:s + n] @ taps[o:o + n] for s, n, o in runs], axis=1)
        logmel = np.where(mel > 0, np.log(np.where(mel > 0, mel, 1.0)), mel)
        got.append(logmel @ consts["dct"])
    got = np.stack(got)
    assert np.all(got[1] == 0.0)
    ref = np.asarray(jfe.compute_mfccs_jit(audio))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    golden = jfe.compute_mfccs_reference(audio[0].astype(np.float64))
    np.testing.assert_allclose(got[0], golden, atol=5e-3, rtol=1e-3)


# --- Res stack: B-tile order, geometry, 3xTF32 --------------------------------


def _unpack(idx, w_layer):
    """Gather each tap of one layer of w_all by the index table, as the
    kernel's pack does, then read the tiles back as wgmma reads B with no
    swizzle: per K chunk, N block j and K half h a core matrix of 8 rows
    (n = 8j + row) of 4 values (k = 4h + column) in the 3xTF32 mode's table,
    of 8 values (k = 8h + column) in the bf16 mode's."""
    kt, nt, _, _, width = idx.shape
    taps = w_layer.reshape(9, -1)
    packed = np.where(idx >= 0, taps[:, np.maximum(idx, 0)], 0.0).astype(np.float32)
    dense = np.full((9, kt * 2 * width, nt * 8), np.nan, np.float32)
    for kc in range(kt):
        for j in range(nt):
            for h in range(2):
                for row in range(8):
                    for col in range(width):
                        dense[:, (2 * kc + h) * width + col, 8 * j + row] = packed[:, kc, j, h, row, col]
    assert not np.isnan(dense).any()  # every (k, n) of the padded GEMM is written
    return dense


def _check_unpacks(w_layer, C):
    dense = _unpack(res_kernel.fragment_index(C), w_layer)
    np.testing.assert_array_equal(dense[:, :C, :C], w_layer.reshape(9, C, C))
    assert not dense[:, C:, :].any() and not dense[:, :, C:].any()


@pytest.mark.parametrize("C", [45, 19, 64, 3])
def test_fragment_index_unpacks_to_w_all_with_zero_padding(C):
    idx = res_kernel.fragment_index(C)
    nt = -(-C // 8)
    assert idx.shape == (nt, nt, 2, 8, 4) and idx.dtype == np.int32
    assert np.count_nonzero(idx >= 0) == C * C
    _check_unpacks(np.random.default_rng(C).standard_normal((9 * C, C)).astype(np.float32), C)


def test_fragment_index_unpacks_the_zoo_res8_pack():
    model = load_honk_checkpoint(ZOO_RES8, SpeechResModel(find_config("res8"))).eval()
    w_all = res_kernel.pack_res_params(model)[0].numpy()
    assert w_all.shape == (6, 9 * 45, 45)
    for layer in w_all:
        _check_unpacks(layer, 45)


@pytest.mark.parametrize("conf,H,W", [("res8", 25, 13), ("res8-narrow", 25, 13),
                                      ("res26", 50, 20), ("res26-narrow", 50, 20)])
def test_cluster_geometry_fits_and_spreads_one_utterance(conf, H, W):
    C = find_config(conf)["n_feature_maps"]
    for B in (1, 2, 3, 64, 133, 256, 1024):
        cs = res_kernel.cluster_size(B, C, H, W)
        assert cs in (1, 2, 4, 8) and cs <= H
        assert res_kernel.smem_bytes(C, H, W, cs) <= res_kernel.SMEM_LIMIT
        assert -(-(-(-H // cs) * W) // 16) <= res_kernel.MAX_TILES
    assert res_kernel.cluster_size(1, C, H, W) >= 4  # B=1 spans at least 4 SMs
    # A large batch fills whole waves of 132 SMs better than 8 bands would.
    if conf.startswith("res8"):
        assert res_kernel.cluster_size(256, C, H, W) < 8


def test_res_stack_refuses_maps_that_do_not_fit_on_every_device():
    model = SpeechResModel(find_config("res8-narrow")).eval()
    packed = res_kernel.pack_res_params(model)
    with pytest.raises(ValueError, match="bands"):
        res_kernel.res_stack(torch.zeros((1, 19, 200, 40)), *packed)


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away, as cvt.rna."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_truncated(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (np.ascontiguousarray(x, np.float32).view(np.int32) & ~0x1FFF).view(np.float32)


def _conv_emulated(x: np.ndarray, w: np.ndarray, products: int) -> np.ndarray:
    """3x3 SAME conv of f32 operands as the kernel's tensor cores take it.

    products=3: 3xTF32 as csrc/res_stack.cu splits it, big = x rounded to
    TF32 and small = x - big as the tensor core reads it; the product is
    big*big + big*small + small*big. products=1: one TF32 product. The
    tensor core sums the exact products in f32; here the products of TF32
    values are exact in float32 (11 x 11 significant bits) and are summed
    in float32 by conv2d.
    """
    xb, wb = _tf32(x), _tf32(w)
    terms = [(xb, wb)]
    if products == 3:
        xs, ws = _tf32_truncated(x - xb), _tf32_truncated(w - wb)
        terms += [(xb, ws), (xs, wb)]
    y = None
    for a, b in terms:
        t = F.conv2d(torch.from_numpy(a), torch.from_numpy(b), padding=1)
        y = t if y is None else y + t
    return y.numpy()


def _stack_emulated(x, w_all, scale, offset, dense_w, dense_b, products):
    C = x.shape[1]
    old = x
    for i in range(w_all.shape[0]):
        w = np.ascontiguousarray(w_all[i].reshape(3, 3, C, C).transpose(3, 2, 0, 1))
        y = np.maximum(_conv_emulated(np.ascontiguousarray(x), w, products), 0.0)
        if (i + 1) % 2 == 0:
            y = y + old
            old = y
        x = y * scale[i, :, None, None] + offset[i, :, None, None]
    return x.mean(axis=(2, 3)) @ dense_w + dense_b


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32 spacing at 1
    x = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), [one, one + ulp, one + ulp, -(one + ulp), 3.0])


def test_3xtf32_holds_the_logit_gate_and_one_tf32_product_does_not():
    model = load_honk_checkpoint(ZOO_RES8, SpeechResModel(find_config("res8"))).eval()
    audio = (np.random.default_rng(0).standard_normal((8, 16000)) * 0.2).astype(np.float32)
    feats = np.asarray(jfe.compute_mfccs_jit(audio))
    with torch.no_grad():
        pooled = model.stem(torch.from_numpy(feats))
        packed = res_kernel.pack_res_params(model)
        ref = res_kernel.res_stack_plain(pooled, *packed).numpy()
    ops = [pooled.numpy()] + [p.numpy() for p in packed]
    err3 = np.abs(_stack_emulated(*ops, products=3) - ref).max()
    err1 = np.abs(_stack_emulated(*ops, products=1) - ref).max()
    assert err3 <= LOGIT_GATE / 10, err3
    assert err1 > LOGIT_GATE, err1  # why the kernel takes three products, not one
