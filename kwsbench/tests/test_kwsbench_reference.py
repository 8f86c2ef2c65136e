"""The plain reference against the port on the CPU at tiny sizes: the frontend, the draws and the assembly, the
eval and training forwards of each family, three float32 train steps, the offline search; and the work counters'
numbers."""

import math

import numpy as np
import pytest
import torch

from kwsbench import common, harness
from kwsbench.reference import assemble, cnn, frontend, precision, recipe_honk_sgd as train, res as M, stream, work

TINY_RES15 = dict(n_labels=12, n_layers=4, n_feature_maps=8, use_dilation=True, registry_name="res15")
TINY_RES8 = dict(n_labels=12, n_layers=6, n_feature_maps=12, res_pool=[4, 3], use_dilation=False,
                 registry_name="res8")
# cnn-trad-pool2 and cnn-tstride4's layer patterns (two convs, no Dense; strided, pooled, dnn1 with its ReLU and
# dnn2), narrow.
_CNN = dict(height=101, width=40, n_labels=12, dropout_prob=0.0)
TINY_TRAD = dict(_CNN, registry_name="cnn-trad-pool2", n_feature_maps1=6, conv1_size=[20, 8], conv1_pool=[2, 2],
                 conv1_stride=[1, 1], n_feature_maps2=5, conv2_size=[10, 4], conv2_stride=[1, 1], conv2_pool=[1, 1],
                 tf_variant=True)
TINY_TSTRIDE = dict(_CNN, registry_name="cnn-tstride4", n_feature_maps1=7, conv1_size=[16, 8], conv1_pool=[1, 3],
                    conv1_stride=[4, 1], n_feature_maps2=5, conv2_size=[5, 4], conv2_stride=[1, 1],
                    conv2_pool=[1, 1], dnn1_size=16, dnn2_size=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(config, weights, bn=None, dtype=None):
    from honk_tpu_torch.models import find_model

    return common.load_weights(find_model(config["registry_name"])(config, dtype=dtype), weights, bn)


def _audio(n, samples=16000, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, samples), generator=g) * 0.1).clamp(-1, 1)


def test_frontend_constants_and_mfcc_match_the_port():
    from honk_tpu_torch.frontend import filters
    from honk_tpu_torch.frontend.mfcc import compute_mfccs

    port = filters.frontend_constants(np.float32)
    ours = frontend.constants()
    for a, b in (("window", "window"), ("dft_cos", "cos"), ("dft_sin", "sin"), ("mel", "mel"), ("dct", "dct")):
        np.testing.assert_array_equal(port[a], ours[b])
    audio = _audio(3)
    torch.testing.assert_close(frontend.mfcc(audio), compute_mfccs(audio), rtol=0, atol=1e-4)
    long = _audio(1, 48000)
    from honk_tpu_torch.stream.streamer import frame_mfccs
    torch.testing.assert_close(frontend.mfcc(long)[0], frame_mfccs(long[0]), rtol=0, atol=1e-4)


def test_draws_and_assembly_match_the_port():
    from honk_tpu_torch.data import AugmentConfig, prepare_train_arrays
    from honk_tpu_torch.data.augment import sample_train_batch, step_generator

    rng = np.random.default_rng(1)
    clips = rng.integers(-3000, 3000, (20, 16000), dtype=np.int16)
    labels = rng.integers(1, 12, 20).astype(np.int32)
    noise = (rng.standard_normal(40000) * 0.1).astype(np.float32)
    recipe = assemble.Recipe()
    aug = AugmentConfig(n_silence=3)
    arrays = prepare_train_arrays(clips, labels, noise, aug)
    for key, step in ((2_000_000_021, 0), (7, 5), (2**31 + 5, 2)):
        audio, lab = sample_train_batch(step_generator(key, step, "cpu"), arrays, 16, aug)
        drawn = assemble.draws(key, step, 16, 20, 3, len(noise), recipe, torch.device("cpu"))
        ref_audio, ref_lab = assemble.batch(clips, labels, noise, drawn, recipe, torch.device("cpu"))
        torch.testing.assert_close(ref_audio, audio, rtol=0, atol=1e-7)
        torch.testing.assert_close(ref_lab, lab)


@pytest.mark.parametrize("family,config", [(M, TINY_RES8), (M, TINY_RES15), (cnn, TINY_TRAD), (cnn, TINY_TSTRIDE)],
                         ids=["res8", "res15", "cnn-trad-pool2", "cnn-tstride4"])
def test_eval_forward_matches_the_port_in_float32(family, config):
    weights = common.make_weights(3, family, config, torch.device("cpu"), output_gain=20.0)
    feats = frontend.mfcc(_audio(8))
    bn = family.eval_state(weights, config, feats)
    model = _port_model(config, weights, bn).eval()
    assert isinstance(model, harness.port(family.PORT_MODEL))
    with torch.no_grad():
        torch.testing.assert_close(family.forward(weights, config, feats, bn=bn), model(feats), rtol=1e-4,
                                   atol=1e-4)
        stats: list = []
        family.forward(weights, config, feats, stats=stats)
        assert len(stats) == (config["n_layers"] if family is M else 0)


def test_three_float32_train_steps_match_the_port():
    from honk_tpu_torch.data import AugmentConfig, prepare_train_arrays
    from honk_tpu_torch.train import create_train_state, make_train_scan

    rng = np.random.default_rng(2)
    clips = rng.integers(-3000, 3000, (24, 16000), dtype=np.int16)
    labels = rng.integers(1, 12, 24).astype(np.int32)
    noise = (rng.standard_normal(40000) * 0.1).astype(np.float32)
    weights = common.make_weights(4, M, TINY_RES15, torch.device("cpu"))
    model = _port_model(TINY_RES15, weights)
    tx = train.port_optimizer(harness.port)
    state = create_train_state(model, tx)
    aug = AugmentConfig(n_silence=2)
    arrays = prepare_train_arrays(clips, labels, noise, aug)
    scan = make_train_scan(tx, 8, aug, 1)
    losses = []
    for _ in range(3):
        state, m = scan(state, 11, arrays)
        losses.append(float(m["loss"]))
    recipe = assemble.Recipe()
    batches = [assemble.batch(clips, labels, noise, assemble.draws(11, k, 8, 24, 2, len(noise), recipe,
                                                                   torch.device("cpu")), recipe, torch.device("cpu"))
               for k in range(3)]
    ref = train.steps(weights, TINY_RES15, batches, frontend.mfcc, M.forward)
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-4)
    for name, p in model.named_parameters():
        torch.testing.assert_close(ref["params"][name], p.detach(), rtol=1e-3, atol=1e-5)


def test_offline_search_matches_the_port_in_float32():
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.stream.streamer import stream_file

    cfg = dict(window_samples=16000, hop_samples=3200, smoothing_window=5, detection_threshold=0.2,
               min_gap_windows=4)
    weights = common.make_weights(5, M, TINY_RES15, torch.device("cpu"), output_gain=20.0)
    audio = _audio(1, 16000 * 5, seed=3)[0]
    feats = frontend.mfcc(audio[None])[0].unfold(0, 101, 20).transpose(1, 2)
    bn = M.eval_state(weights, TINY_RES15, feats)
    model = _port_model(TINY_RES15, weights, bn).eval()
    smoothed, dets = stream_file(model, None, audio.numpy(), StreamConfig(**cfg))
    ref = stream.search(M.forward, weights, TINY_RES15, bn, audio, cfg).numpy()
    np.testing.assert_allclose(ref, smoothed, rtol=0, atol=1e-5)
    assert stream.detect(smoothed, 0.2, 4, 0.2) == [(d.time_s, d.label, d.score) for d in dets]


def test_work_counters():
    res8 = dict(n_feature_maps=45, n_layers=6, res_pool=[4, 3], n_labels=12)
    res15 = dict(n_feature_maps=45, n_layers=13, use_dilation=True, n_labels=12)
    assert M.model_flops(res8) == 74_350_980  # about 74 MFLOP an utterance
    assert M.model_flops(res15) == 1_917_627_480
    assert M.stack_geometry(res8) == (45, 25, 13, 6, 12, (4, 3))
    # cnn-trad-pool2: conv1 64 x 160 taps over 82 x 33, conv2 64 x 64 x 40 over 32 x 13, a Dense of 26,624 x 12.
    trad = dict(TINY_TRAD, n_feature_maps1=64, n_feature_maps2=64)
    assert cnn.model_flops(trad) == 2 * (64 * 160 * 82 * 33 + 64 * 64 * 40 * 32 * 13 + 26_624 * 12) == 192_372_736
    bound_ms, by = work.forward_bound(256, 45, 25, 13, 6, 12, (4, 3), "NVIDIA H100 80GB HBM3",
                                      "bfloat16_activations")
    assert by == "operations" and math.isclose(bound_ms, 0.0304687, rel_tol=1e-5)
    mfcc_ms, by = work.bound(*work.mfcc_work(256 * 101, 256 * 16000), "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and math.isclose(mfcc_ms, 0.0061284, rel_tol=1e-4)


@pytest.mark.parametrize("fmt", ["fp8", "int8"])
def test_the_controls_rounding_is_coarser_than_bf16_both_ways(fmt):
    def rel(a, b):
        return float(((a - b).abs() / b.abs()).mean())

    mags = 10 ** torch.linspace(-2, 0.5, 1001)
    x = (mags * torch.where(torch.arange(1001) % 2 == 0, 1.0, -1.0)).requires_grad_(True)
    q = precision.rounding(fmt)(x)
    bf16 = rel(x.detach().to(torch.bfloat16).float(), x.detach())
    assert rel(q.detach(), x.detach()) > 4 * bf16
    g = x.detach().flip(0)
    q.backward(g)
    assert rel(x.grad, g) > 4 * bf16
