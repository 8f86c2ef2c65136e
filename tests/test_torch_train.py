"""Port's training pieces (train-mode BN, lr ladder, SGD, train steps, eval sweep) against JAX, on the CPU.

Both sides start from the same flax-initialised weights (carried across with
``from_flax_variables``) and zero momentum, and see the same batches: the
JAX step's batch is rebuilt from ``fold_in(key, step)`` (``honk_tpu/train/
steps.py``), its draws injected into the port's assembly, and the result
fed to the port's ``apply_batch``. Everything runs in float32.

Tolerances:
- train-mode forward and the updated BN running statistics: 1e-5
  (float32 sums over the batch in another order);
- gradients on identical features and weights: atol 1e-5 (measured
  6e-6; float32 sums in another order);
- parameters after three SGD steps at lr 0.01 then 0.001: atol 1e-5,
  rtol 1e-4 (measured 2e-6), and per-step losses within 1e-5. The two
  frontends' MFCCs differ by up to 2e-5 (their parity gate), and the first steps
  from a fresh init amplify that: at lr 0.1 the same three steps drift
  5e-5 apart in conv1 while the gradients on identical features agree;
- the lr ladder: equal as float32;
- four optimizer updates against the optax chain: atol 1e-7, rtol 1e-6
  (``torch.optim.SGD`` may fuse ``p - lr * u`` into one rounding);
- eval counts: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from honk_tpu.data import augment as JA
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.models import SpeechResModel, find_config, from_flax_variables, load_state_dict
from honk_tpu_torch.models import init_weights
from honk_tpu_torch.train import create_train_state, lr_ladder, make_optimizer
from honk_tpu_torch.frontend import compute_mfccs
from honk_tpu_torch.train.steps import make_eval_step, make_eval_sweep, make_forward, make_train_scan, make_train_step

CONF = "res8-narrow"
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_ATOL = 1e-5


def _flax(seed=0, random_stats=False):
    cfg = jfind_config(CONF)
    model = jfind_model(CONF)(config=cfg, precision="highest")
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 101, 40), jnp.float32), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    if random_stats:
        rng = np.random.default_rng(seed)
        variables["batch_stats"] = {
            k: {"mean": rng.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                "var": (rng.random(v["var"].shape) * 0.5 + 0.5).astype(np.float32)}
            for k, v in variables["batch_stats"].items()
        }
    return model, variables


def _port(variables, dtype=None):
    return load_state_dict(SpeechResModel(find_config(CONF), dtype=dtype), from_flax_variables(variables))


def _state_close(model, variables, **tol):
    want = from_flax_variables(variables)
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


def _corpus(seed=0, n=16):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-3000, 3000, (n, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (n,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 2) * 0.05).astype(np.float32)
    return raw, labels, noise


def _jax_draws(key, n, cfg, n_noise, batch):
    """The draws of honk_tpu.data.augment.sample_train_batch, from its key."""
    k_idx, k_shift, k_off, k_noise, k_scale = jax.random.split(key, 5)
    ts = cfg.timeshift_samples

    def t(a):
        return torch.from_numpy(np.array(a))

    return A.Draws(
        idx=t(jax.random.randint(k_idx, (batch,), 0, n + cfg.n_silence)).long(),
        shift=t(jax.random.randint(k_shift, (batch,), -ts, ts + 1)).long(),
        noise_row=t(jax.random.randint(k_off, (batch,), 0, n_noise)).long(),
        add_u=t(jax.random.uniform(k_noise, (batch,))),
        scale_u=t(jax.random.uniform(k_scale, (batch,))),
    )


def test_train_forward_and_bn_update_match_flax():
    fmodel, variables = _flax(seed=1, random_stats=True)
    feats = np.random.default_rng(1).standard_normal((6, 101, 40)).astype(np.float32) * 3
    want, mut = fmodel.apply(variables, jnp.asarray(feats), train=True, mutable=["batch_stats"])

    model = _port(variables).train()
    got = model(torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    _state_close(model, {"params": variables["params"], "batch_stats": mut["batch_stats"]}, **FWD_TOL)
    # flax's update uses the biased batch variance, which nn.BatchNorm2d would not.
    x = torch.randn(4, 5, 3, 2)
    bn = torch.nn.BatchNorm2d(5, affine=False)
    from honk_tpu_torch.models.res import batch_norm_train

    batch_norm_train(x, bn)
    want_var = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, want_var, atol=1e-6, rtol=1e-6)


def test_train_gradients_match_jax_on_same_features():
    fmodel, variables = _flax(seed=3, random_stats=True)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((8, 101, 40)).astype(np.float32) * 10
    labels = rng.integers(0, 12, 8)

    def loss_fn(params):
        logits, _ = fmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(feats), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    want_loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    model = _port(variables).train()
    loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(feats)), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < LOSS_ATOL
    params = dict(model.named_parameters())
    for k, g in from_flax_variables({"params": jax.tree.map(np.asarray, grads)}).items():
        np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_train_forward_bf16_runs_convs_in_bf16():
    _, variables = _flax(seed=2)
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 101, 40)).astype(np.float32))
    f32 = _port(variables).train()(feats)
    bf16 = _port(variables, dtype=torch.bfloat16).train()(feats)
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    assert 0 < float((bf16 - f32).detach().abs().max()) < 0.1  # bf16 operands: close, not equal


@pytest.mark.parametrize("lrs,boundaries", [((0.1, 0.01, 0.001), (3, 7)), ((0.3,), ()), ((0.05, 0.02), (4, 9))])
def test_lr_ladder_equals_optax_schedule(lrs, boundaries):
    ours, ref = lr_ladder(lrs, boundaries), JS.lr_ladder(lrs, boundaries)
    for count in range(12):
        assert np.float32(ours(count)) == np.float32(ref(count)), count
    if len(lrs) == 3:  # switches when the update count EQUALS the boundary
        assert ours(2) == ours(0) != ours(3) == ours(6) != ours(7)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_update_equals_optax_chain(nesterov):
    rng = np.random.default_rng(3)
    lin = torch.nn.Linear(5, 3)
    params = {"weight": rng.standard_normal((3, 5)).astype(np.float32),
              "bias": rng.standard_normal(3).astype(np.float32)}
    with torch.no_grad():
        for k, v in params.items():
            getattr(lin, k).copy_(torch.from_numpy(v))
    tx = JS.make_optimizer(lrs=(0.1, 0.01), boundaries=(2,), nesterov=nesterov)
    ours = make_optimizer(lrs=(0.1, 0.01), boundaries=(2,), nesterov=nesterov)
    opt_state = tx.init(params)
    state = create_train_state(lin, ours)
    for _ in range(4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        for k, g in grads.items():
            getattr(lin, k).grad = torch.from_numpy(g)
        ours.apply(state)
    assert state.step == 4
    for k, v in params.items():
        np.testing.assert_allclose(getattr(lin, k).detach().numpy(), v, atol=1e-7, rtol=1e-6)


def test_three_train_steps_match_jax():
    raw, labels, noise = _corpus(0)
    batch = 8
    jaug = JA.AugmentConfig(n_silence=2)
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    fmodel, _ = _flax()
    tx = JS.make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))  # crosses the boundary at update 2
    jstate = JS.create_train_state(fmodel, tx, jax.random.PRNGKey(0))
    jstep = JT.make_train_step(fmodel, tx, batch, jaug, donate=False)
    key = jax.random.PRNGKey(5)

    variables = {"params": jax.tree.map(np.asarray, jstate.params),
                 "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    aug = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    ptx = make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
    state = create_train_state(_port(variables), ptx)
    step = make_train_step(ptx, batch, aug)

    for s in range(3):
        k_sample, _ = jax.random.split(jax.random.fold_in(key, s))
        audio, lab = A.assemble_batch(_jax_draws(k_sample, len(raw), jaug, arrays.n_noise, batch), arrays, aug)
        state, m = step.apply_batch(state, audio, lab)
        jstate, jm = jstep(jstate, key, jpool, jnp.asarray(labels), jwin)
        assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ATOL, s
        assert float(m["acc"]) == float(jm["acc"])
    assert state.step == int(jstate.step) == 3
    _state_close(state.model, {"params": jax.tree.map(np.asarray, jstate.params),
                               "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}, **PARAM_TOL)


def test_eval_sweep_counts_equal_jax():
    fmodel, variables = _flax(seed=4, random_stats=True)
    rng = np.random.default_rng(4)
    raw = rng.integers(-8000, 8000, (21, 16000), dtype=np.int16)  # 21 = 2 * 8 + a ragged 5
    feats_logits = JT.make_forward(fmodel)(variables["params"], variables["batch_stats"],
                                           jnp.asarray(raw.astype(np.float32) / 32768.0))
    labels = np.asarray(jnp.argmax(feats_logits, axis=-1)).astype(np.int32)
    labels[1::2] = rng.integers(0, 12, labels[1::2].shape)  # half right by construction
    want_c, want_t = JT.make_eval_sweep(fmodel, 8)(variables["params"], variables["batch_stats"],
                                                   jnp.asarray(raw), jnp.asarray(labels))
    model = _port(variables)
    got_c, got_t = make_eval_sweep(8)(model, torch.from_numpy(raw), torch.from_numpy(labels).long())
    assert (int(got_c), int(got_t)) == (int(want_c), int(want_t))
    assert int(got_t) == 21 and int(got_c) >= 11
    audio = torch.from_numpy(raw.astype(np.float32) / 32768.0)
    # The reference's logit gate for the eval forward (tests/test_cross_runtime.py).
    np.testing.assert_allclose(make_forward()(model, audio).numpy(), np.asarray(feats_logits), atol=2e-4, rtol=0)
    valid = torch.arange(21) < 17
    step_c, step_t = make_eval_step()(model, audio, torch.from_numpy(labels).long(), valid)
    assert int(step_t) == 17
    assert int(step_c) == int((((model.eval()(compute_mfccs(audio)).argmax(-1)) == torch.from_numpy(labels))
                               & valid).sum())


def test_scan_chunks_equal_single_steps():
    raw, labels, noise = _corpus(5)
    aug = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)

    def fresh():
        model = init_weights(SpeechResModel(find_config(CONF)), torch.Generator().manual_seed(0))
        return create_train_state(model, tx)

    tx = make_optimizer(lrs=(0.05, 0.01), boundaries=(2,))
    s1, losses = fresh(), []
    step = make_train_step(tx, 8, aug)
    for _ in range(3):
        s1, m = step(s1, 9, arrays)
        losses.append(float(m["loss"]))
    s2, m2 = make_train_scan(tx, 8, aug, 3)(fresh(), 9, arrays)
    assert s1.step == s2.step == 3
    for (k, a), b in zip(s1.model.state_dict().items(), s2.model.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_allclose(float(m2["loss"]), np.mean(losses), rtol=1e-6)


def test_init_weights_is_seeded_and_flax_shaped():
    a = init_weights(SpeechResModel(find_config(CONF)), torch.Generator().manual_seed(3))
    b = init_weights(SpeechResModel(find_config(CONF)), torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert (a.output.bias == 0).all()
    bound = 1 / np.sqrt(9 * 19)
    peak = float(a.conv1.weight.detach().abs().max())
    assert 0.9 * bound < peak <= bound
    assert (a.bn1.running_var == 1).all() and (a.bn1.running_mean == 0).all()
