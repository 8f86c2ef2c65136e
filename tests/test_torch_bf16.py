"""The port's bf16 eval path against the JAX package, on the CPU.

A model built with ``dtype=torch.bfloat16`` evaluates in flax's bf16 dtype
flow, as flax's ``model.apply(train=False)`` of a model built with
``dtype=jnp.bfloat16`` does: res8 / res26 through a bf16 stem and the
res-stack kernel's ``bfloat16_activations`` mode (on the CPU its plain
version), res15 and the CNNs through ``layers.conv`` / ``layers.dense``. A training run's dev and test sweeps
use the run's model, so they are bf16 at the default ``--compute_dtype``;
where the JAX ``make_forward`` of a bf16 model takes its ``fast`` frontend
tier, the port's runs the one float32 MFCC kernel; ``--type eval`` stays
float32.

Gates and why:
- The plain bf16 res stack against the TPU kernel's bf16 mode
  (``res_forward_fused(compute_dtype=bfloat16, interpret=True)``, the call
  ``tests/test_res_kernel.py`` makes): that test's gate, atol and rtol
  0.05 with argmax equal, and a tighter bound on the observed maximum,
  1e-3: both round the same float32 values to bf16 to nearest even, so
  only float32 sum orders differ (measured 0 here), and one rounding they
  decide differently moves a logit by about 1e-3.
- The port's bf16 eval forward against flax's bf16 apply: argmax equal,
  and NO_KERNEL_ATOL, 1e-4, for res8, res8-narrow, res15-narrow and
  cnn-trad-pool2 (every layer returns bf16, BN's output rounded back to
  bf16; measured 2.2e-5 for res8, 2.9e-6 for res8-narrow, 9.4e-6 for
  res15-narrow, 2.9e-5 for cnn-trad-pool2). res26 and res26-narrow by the
  ratio rule of ``tests/test_torch_bf16_train.py``: the gap to flax's bf16
  apply at most RES26_RATIO (0.25) of flax's own bf16-to-float32 distance
  on the same inputs (measured 0.06-0.14: one bf16 rounding decided the
  other way by a float32 sum in another order grows through 24 layers of
  BN). The kernel's ``bfloat16`` mode (the TPU kernel's float32
  activations and bf16 Dense), which the eval forward ran before, misses
  both gates (1.7e-3 on res8, 2.2-5.2 of flax's own distance on
  res26-narrow).
- ``make_forward``: argmax equal, and the logit gap within the JAX
  package's own gap between its fast and exact bf16 forwards plus 0.05.
- A bf16 training run's dev and test accuracies equal JAX's
  ``make_eval_sweep`` of the same weights at bf16, clip for clip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from honk_tpu.data import load_speech_commands as jload_speech_commands
from honk_tpu.frontend import compute_mfccs as jcompute_mfccs
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.models.torch_compat import torch_state_dict_to_flax
from honk_tpu.ops.res_kernel import res_forward_fused
from honk_tpu.train import loop as JL
from honk_tpu.train import steps as JT
from honk_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
from honk_tpu_torch.frontend import compute_mfccs
from honk_tpu_torch.metrics import MetricsLogger
from honk_tpu_torch.models import find_config, find_model, from_flax_variables, load_state_dict
from honk_tpu_torch.ops import res_kernel
from honk_tpu_torch.train import evaluate, train
from honk_tpu_torch.train.steps import make_forward
from test_torch_kernel_design import _unpack
from test_torch_loop import corpus  # noqa: F401 (a fixture)

BF16_GATE = dict(atol=0.05, rtol=0.05)  # tests/test_res_kernel.py's bf16 gate
PLAIN_MAX = 1e-3
NO_KERNEL_ATOL = 1e-4
RES26_RATIO = 0.25
FWD_GAP = 0.05
CONFS = ["res8-narrow", "res15-narrow", "cnn-trad-pool2"]
BF16_MODES = (torch.bfloat16, torch.bfloat16)  # the bf16 eval forward's (compute_dtype, activation_dtype)
F32_MODE = (torch.float32, torch.float32)


def _flax(conf, seed=0):
    """Flax variables from a seed as numpy arrays, BN statistics randomized
    where the model has BN (``tests/test_res_kernel.py``'s trained-like variables)."""
    model = jfind_model(conf)(config=jfind_config(conf))
    variables = jax.tree.map(np.asarray, dict(model.init(jax.random.PRNGKey(seed),
                                                         jnp.zeros((1, 101, 40), jnp.float32), train=False)))
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables["batch_stats"] = {
            k: {"mean": rng.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                "var": (rng.random(v["var"].shape) * 0.5 + 0.5).astype(np.float32)}
            for k, v in variables["batch_stats"].items()
        }
    return variables


def _port(conf, variables, dtype=None):
    model = find_model(conf)(find_config(conf), dtype=dtype)
    return load_state_dict(model, from_flax_variables(variables)).eval()


def _apply(conf, variables, feats, dtype):
    model = jfind_model(conf)(config=jfind_config(conf), dtype=dtype)
    return np.asarray(model.apply(variables, jnp.asarray(feats), train=False)).astype(np.float32)


def _feats(seed, batch=8):
    return np.random.default_rng(seed).standard_normal((batch, 101, 40)).astype(np.float32)


def _bf16_valued(t: torch.Tensor) -> bool:
    return bool(torch.equal(t.float(), t.to(torch.bfloat16).float()))


@pytest.fixture
def recorder(monkeypatch):
    """Every conv2d / linear call's operand dtypes and whether their values are
    bf16 values, and every res-stack plain call's mode and whether its input
    holds bf16 values, in order."""
    calls = []
    conv2d, linear, plain = F.conv2d, F.linear, res_kernel.res_stack_plain

    def rec_conv(x, w, *a, **k):
        calls.append(("conv", x.dtype, w.dtype, _bf16_valued(x) and _bf16_valued(w)))
        return conv2d(x, w, *a, **k)

    def rec_linear(x, w, *a, **k):
        calls.append(("linear", x.dtype, w.dtype, _bf16_valued(x) and _bf16_valued(w)))
        return linear(x, w, *a, **k)

    def rec_plain(*a, compute_dtype=torch.float32, activation_dtype=torch.float32):
        calls.append(("res_stack_plain", (compute_dtype, activation_dtype), _bf16_valued(a[0])))
        return plain(*a, compute_dtype=compute_dtype, activation_dtype=activation_dtype)

    monkeypatch.setattr(F, "conv2d", rec_conv)
    monkeypatch.setattr(F, "linear", rec_linear)
    monkeypatch.setattr(res_kernel, "res_stack_plain", rec_plain)
    return calls


# --- The res-stack kernel's bf16 mode: plain version, packer, layout --------


@pytest.mark.parametrize("conf", ["res8-narrow", "res8"])
def test_plain_bf16_res_stack_matches_the_tpu_kernels_bf16_mode(conf):
    variables = _flax(conf)
    cfg = jfind_config(conf)
    feats = _feats(2)
    want = np.asarray(res_forward_fused(variables, cfg, jnp.asarray(feats), B_blk=4,
                                        compute_dtype=jnp.bfloat16, interpret=True))
    model = _port(conf, variables)
    with torch.no_grad():
        pooled = model.stem(torch.from_numpy(feats))  # the TPU path's conv0 + pool are float32 XLA
        got = res_kernel.res_stack_plain(pooled, *res_kernel.pack_res_params(model, torch.bfloat16),
                                         compute_dtype=torch.bfloat16).numpy()
        f32 = res_kernel.res_stack_plain(pooled, *res_kernel.pack_res_params(model)).numpy()
    assert got.shape == want.shape == (8, cfg["n_labels"])
    np.testing.assert_allclose(got, want, **BF16_GATE)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= PLAIN_MAX
    assert np.abs(got - f32).max() > 0  # the operands were rounded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_res_forward_fused_matches_the_tpu_kernels_fused_forward(dtype):
    """The port's ``res_forward_fused`` (float32 stem, then the kernel with
    float32 activations) against the JAX package's, in both operand types,
    whatever the model's own dtype: float32 within the logit gate (2e-4),
    bf16 within the plain bf16 stack's gates."""
    conf = "res8-narrow"
    variables = _flax(conf)
    feats = _feats(2)
    want = np.asarray(res_forward_fused(variables, jfind_config(conf), jnp.asarray(feats), B_blk=4,
                                        compute_dtype=getattr(jnp, dtype), interpret=True))
    model = _port(conf, variables, torch.bfloat16)
    got = res_kernel.res_forward_fused(model, torch.from_numpy(feats), compute_dtype=getattr(torch, dtype)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= (PLAIN_MAX if dtype == "bfloat16" else 2e-4)


def test_bf16_pack_holds_bf16_weights_and_the_wrapper_counts_nothing_on_the_cpu():
    model = _port("res8-narrow", _flax("res8-narrow"))
    f32 = res_kernel.pack_res_params(model)
    bf16 = res_kernel.pack_res_params(model, torch.bfloat16)
    for i in (0, 3):  # w_all and dense_w rounded; BN and the bias as they are
        assert bf16[i].dtype == torch.float32 and _bf16_valued(bf16[i]) and not _bf16_valued(f32[i])
        assert torch.equal(bf16[i], f32[i].to(torch.bfloat16).float())
    for i in (1, 2, 4):
        assert torch.equal(bf16[i], f32[i])
    pooled = model.stem(torch.from_numpy(_feats(3, 2)))
    before = (res_kernel.launches, dict(res_kernel.launches_by_mode))
    with torch.no_grad():
        got = res_kernel.res_stack(pooled, *f32, compute_dtype=torch.bfloat16)
        # The kernel rounds what it is given: the f32 pack gives the same logits.
        torch.testing.assert_close(got, res_kernel.res_stack_plain(pooled, *bf16, compute_dtype=torch.bfloat16),
                                   rtol=0, atol=0)
    assert (res_kernel.launches, res_kernel.launches_by_mode) == before
    with pytest.raises(ValueError, match="compute_dtype"):
        res_kernel.res_stack(pooled, *f32, compute_dtype=torch.float16)
    # bf16 activations need bf16 operands: the kernel has no float32-operand mode with them.
    with pytest.raises(ValueError, match="activation_dtype"):
        res_kernel.res_stack(pooled, *f32, activation_dtype=torch.bfloat16)
    # The bf16-activation mode's pack: bf16 conv weights, the Dense as it is (flax's float32 Dense).
    flow = res_kernel.pack_res_params(model, *BF16_MODES)
    assert torch.equal(flow[0], bf16[0]) and all(torch.equal(flow[i], f32[i]) for i in (1, 2, 3, 4))


@pytest.mark.parametrize("C", [45, 19, 64, 3])
def test_bf16_fragment_index_unpacks_to_w_all_with_zero_padding(C):
    idx = res_kernel.fragment_index(C, torch.bfloat16)
    kt, nt = -(-C // 16), -(-C // 8)
    assert idx.shape == (kt, nt, 2, 8, 8) and idx.dtype == np.int32
    assert np.count_nonzero(idx >= 0) == C * C
    w = np.random.default_rng(C).standard_normal((9 * C, C)).astype(np.float32)
    dense = _unpack(idx, w)
    np.testing.assert_array_equal(dense[:, :C, :C], w.reshape(9, C, C))
    assert not dense[:, C:, :].any() and not dense[:, :, C:].any()


@pytest.mark.parametrize("conf,H,W", [("res8", 25, 13), ("res8-narrow", 25, 13),
                                      ("res26", 50, 20), ("res26-narrow", 50, 20)])
def test_bf16_geometry_fits_with_the_deeper_channel_stride(conf, H, W):
    C = find_config(conf)["n_feature_maps"]
    kt, nt = -(-C // 16), -(-C // 8)
    for B in (1, 3, 8, 256, 2996):
        cs = res_kernel.cluster_size(B, C, H, W, dtype=torch.bfloat16)
        assert cs in (1, 2, 4, 8) and res_kernel.smem_bytes(C, H, W, cs, torch.bfloat16) <= res_kernel.SMEM_LIMIT
    band = -(-H // 8)
    stride = kt * 16 + 8  # every K chunk of 16 inside a pixel's channels, == 8 mod 16
    assert stride % 16 == 8 and stride >= kt * 16 >= C
    # Activations held as bf16 values, the carry as float32 at C a pixel, two
    # stages of a layer's 9 taps of bf16 tiles (csrc/res_stack.cu Layout).
    act = -(-((band + 2) * (W + 2) * stride * 2) // 16) * 16
    want = 2 * act + -(-(band * W * C * 4) // 16) * 16 + res_kernel.WBUFS * 9 * kt * nt * 128 * 2
    assert res_kernel.smem_bytes(C, H, W, 8, torch.bfloat16) == want
    # A weight stage is at most half the 3xTF32 mode's (half the bytes a value, one tile, not two;
    # a quarter where K pads no further than N, as res8's 45 maps to 48).
    assert 2 * kt * nt * 64 <= nt * nt * 128
    assert (4 * kt * nt * 64 <= nt * nt * 128) == (kt * 16 == nt * 8)


# --- The eval forwards -------------------------------------------------------


def _pallas_flow(model, feats):
    """The logits of the kernel's ``bfloat16`` mode (the TPU kernel's float32 activations
    and bf16 Dense) on the bf16 stem: what the eval forward ran before it followed flax."""
    with torch.no_grad():
        return res_kernel.res_stack_plain(model.stem(feats, torch.bfloat16),
                                          *res_kernel.pack_res_params(model, torch.bfloat16),
                                          compute_dtype=torch.bfloat16).numpy()


@pytest.mark.parametrize("conf", CONFS + ["res8"])
def test_bf16_eval_forward_matches_flax_bf16_apply(conf):
    variables = _flax(conf, seed=1)
    feats = _feats(4)
    want = _apply(conf, variables, feats, jnp.bfloat16)
    model = _port(conf, variables, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
        f32 = _port(conf, variables)(torch.from_numpy(feats)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=NO_KERNEL_ATOL, rtol=0)  # flax's dtype flow
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - f32).max() > 0  # not the float32 forward
    if conf.startswith("res8"):  # the kernel's Pallas-flow bf16 mode misses the gate
        assert np.abs(_pallas_flow(model, torch.from_numpy(feats)) - want).max() > NO_KERNEL_ATOL


@pytest.mark.parametrize("conf", ["res26-narrow", "res26"])
def test_bf16_res26_eval_forward_is_held_to_flax_by_the_ratio_rule(conf):
    """The gap to flax's bf16 apply as a share of flax's own bf16-to-float32
    distance on the same inputs: at most RES26_RATIO, where the Pallas-flow
    mode lies past 1."""
    variables = _flax(conf, seed=1)
    feats = _feats(4)
    want = _apply(conf, variables, feats, jnp.bfloat16)
    own = np.abs(want - _apply(conf, variables, feats, None)).max()
    model = _port(conf, variables, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    ratio = np.abs(got - want).max() / own
    assert ratio <= RES26_RATIO, f"{conf}: {ratio:.3f} of flax's own bf16-to-float32 distance {own:.3e}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(_pallas_flow(model, torch.from_numpy(feats)) - want).max() / own > 1.0


@pytest.mark.parametrize("conf", CONFS)
def test_bf16_eval_reaches_convs_and_the_kernel_with_bf16_operands(conf, recorder):
    variables = _flax(conf, seed=2)
    feats = torch.from_numpy(_feats(5, 2))
    model = _port(conf, variables, torch.bfloat16)
    with torch.no_grad():
        model(feats)
    convs = [c for c in recorder if c[0] in ("conv", "linear")]
    plains = [c for c in recorder if c[0] == "res_stack_plain"]
    if conf != "res8-narrow":  # the output Dense is float32, as flax's (it takes no dtype)
        assert convs.pop()[:3] == ("linear", torch.float32, torch.float32)
    assert convs and all(bf16 for *_, bf16 in convs)  # every other operand a bf16 value
    if conf == "res8-narrow":
        # The stem in bf16 (its output bf16 values), then the kernel's
        # bf16-activation mode, whose plain version multiplies bf16 values
        # held in float32 (its Dense is float32, a matmul no recorder sees).
        assert convs[0][1:3] == (torch.bfloat16, torch.bfloat16)
        assert plains == [("res_stack_plain", BF16_MODES, True)]
        assert all(c[1:3] == (torch.float32, torch.float32) for c in convs[1:])
    else:
        assert not plains
        assert all(c[1:3] == (torch.bfloat16, torch.bfloat16) for c in convs)
    # The float32 model and the fine-tune's frozen_forward of the bf16 one stay float32.
    recorder.clear()
    with torch.no_grad():
        _port(conf, variables)(feats)
        model.frozen_forward(feats)
    assert all(c[1] == torch.float32 for c in recorder if c[0] != "res_stack_plain")
    assert all(c[1] == F32_MODE for c in recorder if c[0] == "res_stack_plain")
    assert not all(c[3] for c in recorder if c[0] == "conv")


def test_eval_operands_follow_the_model_dtype():
    variables = _flax("res8-narrow")
    p32 = _port("res8-narrow", variables).eval_operands()
    p16 = _port("res8-narrow", variables, torch.bfloat16).eval_operands()
    w32, w16 = p32[0], p16[0]
    assert torch.equal(w16, w32.to(torch.bfloat16).float()) and not torch.equal(w16, w32)
    assert torch.equal(p16[3], p32[3])  # the bf16-activation mode's Dense is float32


@pytest.mark.parametrize("conf", ["res8-narrow", "cnn-trad-pool2"])
def test_make_forward_of_a_bf16_model_matches_jax(conf):
    variables = _flax(conf, seed=3)
    audio = (np.random.default_rng(6).standard_normal((6, 16000)) * 0.1).astype(np.float32)
    jmodel = jfind_model(conf)(config=jfind_config(conf), dtype=jnp.bfloat16)
    jfast = np.asarray(JT.make_forward(jmodel)(variables["params"], variables.get("batch_stats", {}),
                                               jnp.asarray(audio))).astype(np.float32)
    jexact = np.asarray(jmodel.apply(variables, jcompute_mfccs(jnp.asarray(audio)), train=False)).astype(np.float32)
    got = make_forward()(_port(conf, variables, torch.bfloat16), torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), jfast.argmax(-1))
    assert np.abs(got - jfast).max() <= np.abs(jfast - jexact).max() + FWD_GAP


def test_the_fast_frontend_tier_is_the_float32_kernel():
    """Where the JAX make_forward of a bf16 model takes its fast frontend tier,
    the port's feeds the model the one float32 MFCC kernel's features."""
    model = _port("res8-narrow", _flax("res8-narrow"), torch.bfloat16)
    audio = torch.from_numpy((np.random.default_rng(7).standard_normal((3, 16000)) * 0.2).astype(np.float32))
    with torch.no_grad():
        want = model(compute_mfccs(audio))
    torch.testing.assert_close(make_forward()(model, audio), want, rtol=0, atol=0)


# --- A training run's sweeps -------------------------------------------------


def test_bf16_training_run_sweeps_equal_jax_eval_sweep_at_bf16(corpus, recorder):  # noqa: F811
    """One bf16 epoch of res8-narrow: its dev and test sweeps run the kernel's
    bf16-activation mode only, and score each split as JAX's bf16 eval sweep
    scores the same weights, clip for clip; --type eval of the weights is float32."""
    cfg = ExperimentConfig(
        data=DataConfig(data_dir=corpus, timeshift_ms=40.0, noise_prob=0.1),
        train=TrainConfig(model="res8-narrow", batch_size=32, n_epochs=1, lr=(0.05,), schedule=(),
                          dev_every=1, eval_batch_size=8, compute_dtype="bfloat16"),
    )
    result = train(cfg, logger=MetricsLogger(None), device="cpu")
    modes = {c[1] for c in recorder if c[0] == "res_stack_plain"}
    assert modes == {BF16_MODES}
    jmodel = jfind_model("res8-narrow")(config={**jfind_config("res8-narrow"), "n_labels": 12}, dtype=jnp.bfloat16)
    jvars = torch_state_dict_to_flax({k: v.numpy() for k, v in result["best"].items()})
    jds = jload_speech_commands(corpus)
    sweep = JT.make_eval_sweep(jmodel, 8)
    dev = JL.evaluate_split(sweep, jvars["params"], jvars["batch_stats"], jds.dev)
    test = JL.evaluate_split(sweep, jvars["params"], jvars["batch_stats"], jds.test)
    assert result["best_dev_acc"] == pytest.approx(dev, abs=1e-6)  # the loop divides in float32
    assert result["test_acc"] == pytest.approx(test, abs=1e-12)
    recorder.clear()
    evaluate(cfg, result["best"], device="cpu")
    assert {c[1] for c in recorder if c[0] == "res_stack_plain"} == {F32_MODE}
