"""Port's model family beyond res8 (res15, res15-narrow, cnn-*) against the JAX package, on the CPU.

The eval forwards of all twelve configs are held against flax in
``tests/test_torch_models.py``; this file holds the committed res15 and
cnn-trad-pool2 checkpoints, res15's dilations, the CNN initialisation and
dropout, the training forward, gradients and steps, the eval sweep, the
label service and the training CLI.

Flax's dropout masks are recorded by wrapping ``jax.random.bernoulli``,
which ``flax.linen.Dropout`` calls once per layer, in order, and carried
across transposed from NHWC to the port's NCHW.

Tolerances:
- eval logits of a committed checkpoint: 2e-4, the reference's checkpoint
  gate (``tests/test_cross_runtime.py``);
- training forward and the updated BN statistics 1e-5, gradients atol
  1e-5, three train steps' weights atol 1e-5 / rtol 1e-4 and losses 1e-5:
  the gates of ``tests/test_torch_train.py``, for the same reasons;
- label-service probabilities: 1e-4 (``tests/test_torch_serve.py``);
- dropout against flax's ``nn.Dropout`` on one mask: equal;
- eval-sweep counts and CLI accuracies: equal.
"""

import os
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from honk_tpu.cli.train import main as jmain
from honk_tpu.data import augment as JA
from honk_tpu.frontend import compute_mfccs_jit
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.models import flax_to_torch_state_dict
from honk_tpu.models import load_honk_checkpoint as jload_honk_checkpoint
from honk_tpu.serve import LabelService as JLabelService
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch import data as D
from honk_tpu_torch.cli.train import main
from honk_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.metrics import MetricsLogger
from honk_tpu_torch.models import (
    SpeechModel,
    SpeechResModel,
    find_config,
    find_model,
    from_flax_variables,
    init_weights,
    load_honk_checkpoint,
    load_state_dict,
)
from honk_tpu_torch.models.layers import apply_dropout
from honk_tpu_torch.serve import LabelService
from honk_tpu_torch.train import create_train_state, make_optimizer, train
from honk_tpu_torch.train.steps import make_eval_sweep, make_train_step
from test_torch_loop import SMALL, _final_acc, _steps_per_epoch, corpus  # noqa: F401 (corpus is a fixture)
from test_torch_train import _corpus, _jax_draws

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 2e-4
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_ATOL = 1e-5
PROB_ATOL = 1e-4
# flax truncated_normal(0.01): +-2 standard deviations of the untruncated
# normal, 2 * 0.01 / 0.87962566103423978.
TRUNC_BOUND = 0.02274


def _flax(conf, seed=0):
    """The flax model at full precision and its variables, with randomized BN
    statistics where it has BN, as numpy arrays."""
    model = jfind_model(conf)(config=jfind_config(conf), precision="highest")
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 101, 40), jnp.float32), train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed)
    if "batch_stats" in variables:
        variables["batch_stats"] = {
            k: {"mean": rng.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                "var": (rng.random(v["var"].shape) * 0.5 + 0.5).astype(np.float32)}
            for k, v in variables["batch_stats"].items()
        }
    return model, variables


def _port(conf, variables):
    return load_state_dict(find_model(conf)(find_config(conf)), from_flax_variables(variables))


@pytest.fixture
def flax_masks(monkeypatch):
    """The keep masks flax's Dropout draws, in order, in the port's NCHW layout."""
    masks = []
    bernoulli = jax.random.bernoulli

    def record(*args, **kwargs):
        m = bernoulli(*args, **kwargs)
        a = np.asarray(m)
        masks.append(torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a.copy()))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", record)
    return masks


def _state_close(model, variables, **tol):
    got = model.state_dict()
    for k, v in from_flax_variables(variables).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("conf,path", [
    ("res15", "zoo_hard_v2/res15.pt"),
    ("res15-narrow", "zoo_hard_v2/res15-narrow.pt"),
    ("cnn-trad-pool2", "zoo_hard_v2/cnn-trad-pool2.pt"),
    ("cnn-trad-pool2", "zoo/cnn-trad-pool2.pt"),
])
def test_committed_checkpoint_loads_strictly_and_matches_jax(conf, path):
    model = load_honk_checkpoint(str(ROOT / path), find_model(conf)(find_config(conf))).eval()
    audio = (np.random.default_rng(0).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    feats = np.array(compute_mfccs_jit(audio))
    jmodel = jfind_model(conf)(config=jfind_config(conf), precision="highest")
    ref = np.asarray(jmodel.apply(jload_honk_checkpoint(str(ROOT / path)), jnp.asarray(feats), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("path", ["zoo_hard_v2/res15.pt", "zoo/cnn-trad-pool2.pt"])
def test_from_flax_variables_is_inverse_of_reference_converter(path):
    """Conv and dense biases, and a CNN's missing BN tree, carry across exactly."""
    variables = jload_honk_checkpoint(str(ROOT / path))
    assert ("batch_stats" in variables) == ("res15" in path)
    got, ref = from_flax_variables(variables), flax_to_torch_state_dict(variables)
    sd = torch.load(ROOT / path, map_location="cpu", weights_only=True)
    assert got.keys() == ref.keys() == sd.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


def test_res15_dilations_equal_flax():
    """Layer i takes dilation 2**((i-1)//3) and the same padding, as flax's
    kernel_dilation (honk_tpu/models/res.py:63), not 2**(i//3) as its comments say."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Conv) and context.method_name == "__call__":
            d = context.module.kernel_dilation  # conv0 leaves it at the default, 1
            seen[context.module.name] = ((d, d) if isinstance(d, int) else tuple(d), context.module.padding)
        return next_fun(*args, **kwargs)

    fmodel = jfind_model("res15")(config=jfind_config("res15"))
    with fnn.intercept_methods(record):
        jax.eval_shape(lambda: fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 101, 40)), train=False))
    model = SpeechResModel(find_config("res15"))
    assert len(seen) == 14
    for name, (dil, pad) in seen.items():
        conv = getattr(model, name)
        assert conv.dilation == dil and [(p, p) for p in conv.padding] == [tuple(p) for p in pad], name
    assert [getattr(model, f"conv{i}").dilation[0] for i in range(1, 14)] == [1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16]


@pytest.mark.parametrize("conf", ["res15-narrow", "cnn-trad-pool2"])
def test_train_forward_bn_update_and_gradients_match_flax(conf, flax_masks):
    fmodel, variables = _flax(conf, seed=3)
    rng = np.random.default_rng(3)
    feats = (rng.standard_normal((4, 101, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 12, 4)
    has_bn = "batch_stats" in variables

    def loss_fn(params):
        if has_bn:
            logits, mut = fmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jnp.asarray(feats), train=True, mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(7)})
        else:
            logits, mut = fmodel.apply({"params": params}, jnp.asarray(feats), train=True,
                                       rngs={"dropout": jax.random.PRNGKey(7)}), {}
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), (logits, mut)

    (want_loss, (want_logits, mut)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    model = _port(conf, variables).train()
    assert len(flax_masks) == len(getattr(model, "dropout_shapes", lambda b: [])(4)) == (0 if has_bn else 2)
    logits = model(torch.from_numpy(feats), dropout=list(flax_masks))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **FWD_TOL)
    assert abs(float(loss.detach()) - float(want_loss)) < LOSS_ATOL
    if has_bn:
        _state_close(model, {"params": variables["params"], "batch_stats": mut["batch_stats"]}, **FWD_TOL)
    params = dict(model.named_parameters())
    for k, g in from_flax_variables({"params": jax.tree.map(np.asarray, grads)}).items():
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), atol=GRAD_ATOL, rtol=0, err_msg=k)


def test_three_cnn_train_steps_match_jax(flax_masks):
    """cnn-trad-pool2 through JAX's make_train_step and the port's step on the
    same batches (JAX's draws injected) and the same dropout masks."""
    conf, batch = "cnn-trad-pool2", 8
    raw, labels, noise = _corpus(1)
    jaug = JA.AugmentConfig(n_silence=2)
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    fmodel = jfind_model(conf)(config=jfind_config(conf), precision="highest")
    tx = JS.make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
    jstate = JS.create_train_state(fmodel, tx, jax.random.PRNGKey(0))
    jstep = JT.make_train_step(fmodel, tx, batch, jaug, donate=False, jit=False)  # eager: masks are recorded
    key = jax.random.PRNGKey(5)

    aug = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    ptx = make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
    state = create_train_state(_port(conf, {"params": jax.tree.map(np.asarray, jstate.params)}), ptx)
    step = make_train_step(ptx, batch, aug)
    for s in range(3):
        flax_masks.clear()
        jstate, jm = jstep(jstate, key, jpool, jnp.asarray(labels), jwin)
        k_sample, _ = jax.random.split(jax.random.fold_in(key, s))
        audio, lab = A.assemble_batch(_jax_draws(k_sample, len(raw), jaug, arrays.n_noise, batch), arrays, aug)
        assert len(flax_masks) == 2
        state, m = step.apply_batch(state, audio, lab, dropout=list(flax_masks))
        assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ATOL, s
        assert float(m["acc"]) == float(jm["acc"])
    assert state.step == int(jstate.step) == 3
    _state_close(state.model, {"params": jax.tree.map(np.asarray, jstate.params)}, **PARAM_TOL)


def test_dropout_masks_come_from_the_step_generator_after_the_batch():
    """A train step's masks depend only on (key, step): the step equals the same
    batch and the masks that keep_masks draws after it from step_generator."""
    conf, batch = "cnn-trad-pool2", 8
    raw, labels, noise = _corpus(2)
    aug = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    tx = make_optimizer(lrs=(0.01,), boundaries=())

    def fresh():
        return create_train_state(init_weights(SpeechModel(find_config(conf)), torch.Generator().manual_seed(0)), tx)

    step = make_train_step(tx, batch, aug)
    a, _ = step(fresh(), 9, arrays)
    gen = A.step_generator(9, 0, "cpu")
    audio, lab = A.sample_train_batch(gen, arrays, batch, aug)
    b_state = fresh()
    masks = b_state.model.keep_masks(batch, gen)
    b, _ = step.apply_batch(b_state, audio, lab, dropout=masks)
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    def masks_of(step):
        return fresh().model.keep_masks(batch, A.step_generator(9, step, "cpu"))

    again = masks_of(0)
    assert [m.shape for m in again] == [(8, 64, 82, 33), (8, 64, 32, 13)]
    assert all(torch.equal(x, y) for x, y in zip(again, masks_of(0)))
    assert not torch.equal(again[0], masks_of(1)[0])
    rate = float(torch.cat([m.flatten() for m in masks]).float().mean())
    assert abs(rate - 0.5) < 0.005, rate
    with pytest.raises(ValueError, match="dropout layers"):
        b_state.model(torch.zeros(2, 101, 40))  # training mode needs its masks or a generator


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_dropout_equals_flax_dropout(rate, flax_masks):
    """x / keep_prob where kept, 0 elsewhere, bit for bit as flax (a division:
    x * (1 / 0.7) rounds differently)."""
    x = np.random.default_rng(0).standard_normal((4, 6, 5, 3)).astype(np.float32)
    want = fnn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    (keep,) = flax_masks
    got = apply_dropout(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), keep, 1.0 - rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_cnn_init_is_seeded_and_flax_shaped():
    a = init_weights(SpeechModel(find_config("cnn-trad-pool2")), torch.Generator().manual_seed(3))
    b = init_weights(SpeechModel(find_config("cnn-trad-pool2")), torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    for name, p in a.named_parameters():
        if name.endswith("bias"):
            assert (p == 0).all(), name
            continue
        peak = float(p.detach().abs().max())
        assert peak <= TRUNC_BOUND and (p.numel() < 10_000 or peak > 0.022), (name, peak)
        if p.numel() > 10_000:  # tf_variant: truncated normal, std 0.01 (flax's truncated_normal(0.01))
            assert abs(float(p.detach().std()) - 0.01) < 2e-4, name
    # Without tf_variant: uniform in +-1/sqrt(fan_in), zero biases, as flax's variance_scaling.
    c = init_weights(SpeechModel(find_config("cnn-one-fpool3")), torch.Generator().manual_seed(3))
    bound = 1 / np.sqrt(101 * 8)
    assert 0.95 * bound < float(c.conv1.weight.detach().abs().max()) <= bound
    assert (c.dnn1.bias == 0).all() and (c.output.bias == 0).all()


@pytest.mark.parametrize("conf", ["cnn-trad-pool2", "res15-narrow"])
def test_eval_sweep_counts_equal_jax(conf):
    fmodel, variables = _flax(conf, seed=4)
    rng = np.random.default_rng(4)
    raw = rng.integers(-8000, 8000, (21, 16000), dtype=np.int16)  # 21 = 2 * 8 + a ragged 5
    logits = JT.make_forward(fmodel)(variables["params"], variables.get("batch_stats", {}),
                                     jnp.asarray(raw.astype(np.float32) / 32768.0))
    labels = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    labels[1::2] = rng.integers(0, 12, labels[1::2].shape)  # half right by construction
    want_c, want_t = JT.make_eval_sweep(fmodel, 8)(variables["params"], variables.get("batch_stats", {}),
                                                   jnp.asarray(raw), jnp.asarray(labels))
    got_c, got_t = make_eval_sweep(8)(_port(conf, variables), torch.from_numpy(raw), torch.from_numpy(labels).long())
    assert (int(got_c), int(got_t)) == (int(want_c), int(want_t))
    assert int(got_t) == 21 and int(got_c) >= 11


@pytest.mark.parametrize("conf", ["res15", "cnn-trad-pool2"])
def test_label_service_matches_jax_service(conf):
    ckpt = str(ROOT / "zoo_hard_v2" / f"{conf}.pt")
    port, ref = LabelService(conf, ckpt, device="cpu"), JLabelService(conf, ckpt)
    assert (port._packed is None) == conf.startswith("cnn")  # res15: the BN fold, no kernel operands
    audio = (np.random.default_rng(5).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    got, want = port.evaluate_batch(audio), ref.evaluate_batch(audio)
    assert [lab for lab, _ in got] == [lab for lab, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=PROB_ATOL)
    long = np.concatenate([audio[0], audio[1, :4000] * 5])  # 20000 samples: trimmed to 1 s
    label, prob = port.evaluate(long)
    rlabel, rprob = ref.evaluate(long)
    assert label == rlabel and abs(prob - rprob) <= PROB_ATOL


@pytest.mark.parametrize("conf,lr", [("cnn-trad-pool2", "0.003"), ("res15-narrow", "0.05")])
def test_cli_train_then_eval(conf, lr, corpus, tmp_path, capsys):  # noqa: F811
    """One bf16 epoch through the CLI; --type eval of its best.pt scores what
    the run reported, and what the JAX package's --type eval scores."""
    flags = [*SMALL, "--model", conf, "--lr", lr]
    assert main(["--type", "train", "--data_dir", corpus, "--n_epochs", "1", "--output_dir",
                 str(tmp_path), *flags]) == 0
    trained = _final_acc(capsys.readouterr().out)
    best = str(tmp_path / "best.pt")
    load_state_dict(find_model(conf)(find_config(conf)), torch.load(best, weights_only=True))  # a strict load
    args = ["--type", "eval", "--model", conf, "--data_dir", corpus, "--input_file", best, "--eval_batch_size", "64"]
    assert main([*args, "--device", "cpu"]) == 0
    ours = _final_acc(capsys.readouterr().out)
    assert jmain(args) == 0
    assert ours == trained == _final_acc(capsys.readouterr().out)


def test_cnn_resume_equals_unbroken_run(corpus, tmp_path):  # noqa: F811
    """A model with no BN buffers checkpoints and resumes; its dropout masks,
    drawn from (seed + 1, step), make the resumed run equal the unbroken one."""
    spe = _steps_per_epoch(corpus)

    def cfg(n_epochs):
        return ExperimentConfig(
            data=DataConfig(data_dir=corpus, noise_prob=0.5, timeshift_ms=40),
            train=TrainConfig(model="cnn-trad-pool2", batch_size=32, n_epochs=n_epochs, lr=(0.003, 0.001),
                              schedule=(spe + 1,), dev_every=1, eval_batch_size=64, compute_dtype="float32"),
        )

    ds = D.load_speech_commands(corpus)
    log = MetricsLogger(stream=open(os.devnull, "w"))
    straight = train(cfg(2), dataset=ds, logger=log, device="cpu")
    train(cfg(1), dataset=ds, logger=log, checkpoint_dir=str(tmp_path), save_every_epochs=1, device="cpu")
    resumed = train(cfg(2), dataset=ds, logger=log, checkpoint_dir=str(tmp_path), device="cpu")
    assert not list(resumed["model"].buffers())
    assert resumed["state"].step == straight["state"].step == 2 * spe
    for (k, a), b in zip(straight["state"].model.state_dict().items(), resumed["state"].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert set(resumed["best"]) == {f"{m}.{p}" for m in ("conv1", "conv2", "output") for p in ("weight", "bias")}
    assert resumed["best_dev_acc"] == straight["best_dev_acc"]
    assert resumed["test_acc"] == straight["test_acc"]
