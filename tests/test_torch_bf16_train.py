"""The port's bf16 training step against the JAX package's, on the CPU.

A model built with ``dtype=torch.bfloat16`` trains as flax's
``model.apply(train=True)`` of a model built with ``dtype=jnp.bfloat16``:
every conv and hidden Dense returns bf16 (product rounded, then the bias
added in bf16), ReLU, the pools, dropout and the residual add stay bf16,
BN takes float32 statistics and returns bf16, and the global mean, the
output Dense and the loss are float32.

The ratio rule. For a quantity q (the logits' largest gap, or the
Frobenius norm over all parameters' gradients, over the updated BN running
statistics, over the parameters after three steps):
``ratio = |q(port bf16) - q(JAX bf16)| / |q(JAX bf16) - q(JAX f32)|``,
so 1 means the port's bf16 step is as far from JAX's as JAX's own float32
step is. JAX's bf16 step here is its op-by-op execution
(``jax.disable_jit()``): every primitive returns its dtype, which is
flax's dtype flow. The compiled step (``jax.jit``) is another execution of
the same program in which XLA keeps float32 inside its fusions where the
program rounds to bf16 (on the CPU its optimized program sums the pool's
window in float32 and adds the residual without rounding), so it parts
from the op-by-op step too. The gate is
``ratio <= max(0.5, JAX's own ratio)``, JAX's own being the compiled
step's ratio against the op-by-op step. Where that is above 0.5 (the deep
configs) the reference does not pin its own bf16 step closer: one bf16
rounding decided the other way (a float32 sum in another order) grows
through BN layer by layer.

Measured, port / JAX's own (one step, B=16, features N(0, 10^2), biases
N(0, 0.1^2); logits, gradients, running statistics):
res8-narrow 0.36 / 0.45, 0.21 / 0.32, 0.05 / 0.09; res15-narrow
0.14 / 0.20, 0.51 / 0.72, 0.01 / 0.03; res26-narrow 0.72 / 1.16,
0.69 / 0.80, 0.09 / 0.11; cnn-trad-pool2 0.08 / 0, 0.03 / 0.03;
cnn-one-stride1 0.10 / 0, 0.04 / 0.05. Three steps (parameters, running
statistics): res8-narrow 0.34 / 0.68, 0.18 / 0.41; res15-narrow
0.27 / 0.39, 0.09 / 0.32; res26-narrow 0.77 / 0.78, 0.50 / 0.26 (the
nearest to its limits: deterministic here, whatever the thread count);
cnn-trad-pool2 0.26 / 0.13; cnn-one-stride1 0.12 / 0.15. The parent's
float32 activations, one step: res8-narrow 0.99, 0.67, 0.18;
res15-narrow 0.92, 0.87; res26-narrow 0.91 on gradients; the CNNs 1.08 and
1.04 on logits (a bias fused into the product); three steps: res8-narrow
1.13, 1.05; res26-narrow 1.36, 0.61. The CNNs' and res15-narrow's three
steps passed on the parent too (flax initialises the biases to 0).

Other gates:
- the dtype of every layer's output equals flax's ``capture_intermediates``;
- conv and Dense with a bias against flax's: at most FLIP_SHARE (1e-3) of
  the outputs differ (a float32 sum in another order rounds the other
  way), where a bias fused into the product differs in more than 5%;
- the bf16 pool equals ``flax.linen.avg_pool`` and its gradient JAX's,
  bitwise (elementwise bf16 arithmetic in the same order), where
  ``F.avg_pool2d`` (float sum, one rounding) differs in more than 5%;
- two gloo ranks against one, bf16: ``tests/test_torch_parallel.py``'s gate
  (first loss rtol 1e-5, weights after two steps atol 5e-4 and at most
  1e-3 apart, the ranks bitwise equal).
"""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from honk_tpu.data import augment as JA
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.models import cnn, find_config, find_model, from_flax_variables, load_state_dict, res
from honk_tpu_torch.models.layers import avg_pool
from honk_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from test_torch_train import _corpus, _jax_draws
from torch_ranks import REPO, free_port, run_ranks

CONFS = ["res8-narrow", "res15-narrow", "res26-narrow", "cnn-trad-pool2", "cnn-one-stride1"]
RATIO = 0.5
LOSS_RTOL = 1e-5  # tests/test_torch_parallel.py's gate of two ranks against one
DP_PARAM_ATOL, DP_PARAM_MAX = 5e-4, 1e-3
FLIP_SHARE = 1e-3


def _variables(conf, seed=0):
    """Flax's initial variables, with biases drawn from N(0, 0.1^2) as trained weights have them
    (flax initialises them to 0, where a bias added in one rounding or two gives the same)."""
    model = jfind_model(conf)(config=jfind_config(conf))
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 101, 40), jnp.float32), train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed)
    variables["params"] = {
        name: {k: (rng.normal(0, 0.1, v.shape).astype(np.float32) if k == "bias" else v) for k, v in leaves.items()}
        for name, leaves in variables["params"].items()
    }
    return variables


def _jmodel(conf, dtype):
    cfg = jfind_config(conf)
    return jfind_model(conf)(config=cfg, dtype=dtype) if dtype else jfind_model(conf)(config=cfg, precision="highest")


def _port(conf, variables, dtype=torch.bfloat16):
    return load_state_dict(find_model(conf)(find_config(conf), dtype=dtype), from_flax_variables(variables))


def _np(params, batch_stats=None):
    """Flax parameters, or with ``batch_stats`` the running statistics alone, in the port's names."""
    tree = {"params": params, **({"batch_stats": batch_stats} if batch_stats is not None else {})}
    sd = from_flax_variables(jax.tree.map(np.asarray, tree))
    return {k: v.numpy() for k, v in sd.items() if ("running" in k) == (batch_stats is not None)}


@pytest.fixture
def flax_masks(monkeypatch):
    """The keep masks flax's Dropout draws in an op-by-op run, in order, in the port's NCHW layout."""
    masks = []
    bernoulli = jax.random.bernoulli

    def record(*args, **kwargs):
        m = bernoulli(*args, **kwargs)
        if not isinstance(m, jax.core.Tracer):
            a = np.asarray(m)
            masks.append(torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a.copy()))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", record)
    return masks


def _jax_step(conf, variables, feats, labels, dtype, mode):
    """One flax forward and backward: logits, gradients and updated running statistics in the port's names."""
    model = _jmodel(conf, dtype)
    has_bn = "batch_stats" in variables

    def loss_fn(params):
        v = {"params": params, **({"batch_stats": variables["batch_stats"]} if has_bn else {})}
        out = model.apply(v, jnp.asarray(feats), train=True, mutable=["batch_stats"] if has_bn else False,
                          rngs={"dropout": jax.random.PRNGKey(9)})
        logits, mut = out if has_bn else (out, {})
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean(), (logits, mut)

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    if mode == "jit":
        (_, (logits, mut)), grads = jax.jit(fn)(variables["params"])
    else:
        with jax.disable_jit():
            (_, (logits, mut)), grads = fn(variables["params"])
    stats = _np(variables["params"], mut["batch_stats"]) if has_bn else {}
    return {"logits": np.asarray(logits, np.float32), "grads": _np(grads), "stats": stats}


def _port_step(conf, variables, feats, labels, masks, dtype=torch.bfloat16):
    model = _port(conf, variables, dtype).train()
    logits = model(torch.from_numpy(feats), dropout=masks)
    F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    return {"logits": logits.detach().numpy(),
            "grads": {k: p.grad.numpy() for k, p in model.named_parameters()},
            "stats": {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}}


def _gap(a, b):
    """Largest gap of two arrays, or the Frobenius norm of the gaps over two dicts of arrays."""
    if isinstance(a, dict):
        return float(np.sqrt(sum(((a[k].astype(np.float64) - b[k]) ** 2).sum() for k in a)))
    return float(np.abs(a - b).max())


def _ratios(port, exact, compiled, f32):
    """For each quantity, (the port's ratio, JAX's own ratio), both against the op-by-op step."""
    out = {}
    for q in port:
        if isinstance(port[q], np.ndarray) or port[q]:
            den = _gap(exact[q], f32[q])
            out[q] = (_gap(port[q], exact[q]) / den, _gap(compiled[q], exact[q]) / den)
    return out


def _assert_ratios(ratios):
    for q, (got, jax_own) in ratios.items():
        assert got <= max(RATIO, jax_own), f"{q}: ratio {got:.3f}, JAX's own {jax_own:.3f}; all: {ratios}"


# --- (a) the dtype flow ------------------------------------------------------


def _port_layer_dtypes(model, feats, masks):
    """The dtype of each layer's output in the port's forward, under flax's module names."""
    names = {id(m): n for n, m in model.named_modules()}
    seen, drops = {}, []
    conv, dense, bn, drop = res.conv, cnn.dense, res.batch_norm_train, cnn.apply_dropout

    def rec_conv(layer, x, dtype):
        y = conv(layer, x, dtype)
        seen[names[id(layer)]] = y.dtype
        return y

    def rec_dense(layer, x, dtype):
        y = dense(layer, x, dtype)
        seen[names[id(layer)]] = y.dtype
        return y

    def rec_bn(x, module, mesh=None):
        y = bn(x, module, mesh)
        seen[names[id(module)]] = y.dtype
        return y

    def rec_drop(x, keep, keep_prob):
        y = drop(x, keep, keep_prob)
        seen[f"Dropout_{len(drops)}"] = y.dtype
        drops.append(y)
        return y

    mp = pytest.MonkeyPatch()
    try:
        for mod, name, fn in ((res, "conv", rec_conv), (cnn, "conv", rec_conv), (cnn, "dense", rec_dense),
                              (res, "batch_norm_train", rec_bn), (cnn, "apply_dropout", rec_drop)):
            mp.setattr(mod, name, fn)
        handle = model.output.register_forward_hook(lambda m, i, o: seen.__setitem__("output", o.dtype))
        logits = model(torch.from_numpy(feats), dropout=masks)
        handle.remove()
    finally:
        mp.undo()
    return seen, logits


@pytest.mark.parametrize("conf", CONFS)
def test_every_layer_output_has_flax_dtype(conf, flax_masks):
    variables = _variables(conf)
    feats = np.random.default_rng(1).standard_normal((4, 101, 40)).astype(np.float32)
    model = _jmodel(conf, jnp.bfloat16)
    has_bn = "batch_stats" in variables
    with jax.disable_jit():
        _, mut = model.apply(variables, jnp.asarray(feats), train=True, capture_intermediates=True,
                             mutable=["intermediates"] + (["batch_stats"] if has_bn else []),
                             rngs={"dropout": jax.random.PRNGKey(3)})
    want = {k: v["__call__"][0].dtype for k, v in mut["intermediates"].items() if k != "__call__"}
    got, logits = _port_layer_dtypes(_port(conf, variables).train(), feats, list(flax_masks))
    assert {k: str(v).replace("torch.", "") for k, v in got.items()} == {k: str(v) for k, v in want.items()}
    assert logits.dtype == torch.float32 and mut["intermediates"]["__call__"][0].dtype == jnp.float32
    assert sum(v == jnp.bfloat16 for v in want.values()) == len(want) - 1  # all but the output Dense


def _share(got, want):
    """The share of elements where two tensors differ."""
    return float((got.float() != want).float().mean())


def test_conv_and_dense_round_the_product_then_add_the_bias_in_bf16_as_flax():
    """flax's Conv / Dense in bf16 round the product, then add the bias in bf16.
    The port's layers agree with them but for a product whose float32 sum,
    in another order, rounds the other way (at most FLIP_SHARE of the
    outputs); a bias fused into the product, rounded once, differs in more
    than 5%."""
    from honk_tpu_torch.models.layers import conv, dense

    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 30, 20, 1)).astype(np.float32)
    kernel = (rng.standard_normal((5, 5, 1, 16)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(16) * 0.5).astype(np.float32)
    with jax.disable_jit():
        want = fnn.Conv(16, (5, 5), padding="VALID", dtype=jnp.bfloat16).apply(
            {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    layer = torch.nn.Conv2d(1, 16, 5)
    layer.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                           "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = conv(layer, xt, torch.bfloat16)
        fused = F.conv2d(xt.bfloat16(), layer.weight.bfloat16(), layer.bias.bfloat16())
    assert got.dtype == torch.bfloat16
    assert _share(got, want) <= FLIP_SHARE < 0.05 < _share(fused, want)

    x = rng.standard_normal((64, 300)).astype(np.float32)
    kernel = (rng.standard_normal((300, 128)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(128) * 0.5).astype(np.float32)
    with jax.disable_jit():
        want = fnn.Dense(128, dtype=jnp.bfloat16).apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    layer = torch.nn.Linear(300, 128)
    layer.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = dense(layer, torch.from_numpy(x), torch.bfloat16)
        fused = F.linear(torch.from_numpy(x).bfloat16(), layer.weight.bfloat16(), layer.bias.bfloat16())
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16
    assert _share(got, want) <= FLIP_SHARE < 0.05 < _share(fused, want)


# --- (b) the pool ------------------------------------------------------------


@pytest.mark.parametrize("shape,window", [((16, 19, 101, 40), (4, 3)), ((8, 45, 101, 40), (4, 3)),
                                          ((8, 19, 101, 40), (2, 2))])
def test_bf16_pool_equals_flax_avg_pool_and_its_gradient(shape, window):
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(np.maximum(rng.standard_normal(shape) * 3, 0).astype(np.float32)).to(torch.bfloat16)
    ct = torch.from_numpy(rng.standard_normal((*shape[:2], shape[2] // window[0], shape[3] // window[1]))
                          .astype(np.float32)).to(torch.bfloat16)

    def nhwc(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 3, 1)).astype(jnp.bfloat16)

    def nchw(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())

    with jax.disable_jit():
        want, vjp = jax.vjp(lambda a: fnn.avg_pool(a, window, strides=window, padding="VALID"), nhwc(x))
        want_grad = vjp(nhwc(ct))[0]
    assert want.dtype == want_grad.dtype == jnp.bfloat16
    xr = x.clone().requires_grad_(True)
    got = avg_pool(xr, window)
    got.backward(ct)
    assert got.dtype == xr.grad.dtype == torch.bfloat16
    torch.testing.assert_close(got.detach().float(), nchw(want), rtol=0, atol=0)
    torch.testing.assert_close(xr.grad.float(), nchw(want_grad), rtol=0, atol=0)
    # Summing in float and rounding once (F.avg_pool2d) is another pool: many windows differ.
    assert (F.avg_pool2d(x, window).float() != nchw(want)).float().mean() > 0.05


# --- (c) one step ------------------------------------------------------------


def _one_step(conf, flax_masks, seed=0, batch=16):
    variables = _variables(conf, seed)
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((batch, 101, 40)) * 10).astype(np.float32)
    labels = rng.integers(0, jfind_config(conf)["n_labels"], batch)
    exact = _jax_step(conf, variables, feats, labels, jnp.bfloat16, "op-by-op")
    masks = list(flax_masks)
    compiled = _jax_step(conf, variables, feats, labels, jnp.bfloat16, "jit")
    f32 = _jax_step(conf, variables, feats, labels, None, "jit")
    port = _port_step(conf, variables, feats, labels, masks)
    return port, exact, compiled, f32


@pytest.mark.parametrize("conf", CONFS)
def test_one_bf16_step_is_held_to_jax_by_the_ratio_rule(conf, flax_masks):
    port, exact, compiled, f32 = _one_step(conf, flax_masks)
    assert port["logits"].dtype == np.float32
    assert all(g.dtype == np.float32 for g in port["grads"].values())
    ratios = _ratios(port, exact, compiled, f32)
    assert set(ratios) == ({"logits", "grads", "stats"} if conf.startswith("res") else {"logits", "grads"})
    _assert_ratios(ratios)


# --- (d) three steps through make_train_step ---------------------------------


@pytest.mark.parametrize("conf", CONFS)
def test_three_bf16_train_steps_are_held_to_jax_by_the_ratio_rule(conf, flax_masks):
    raw, labels, noise = _corpus(0)
    batch = 8
    jaug = JA.AugmentConfig(n_silence=2)
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    tx = JS.make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
    key = jax.random.PRNGKey(5)
    init = JS.create_train_state(_jmodel(conf, None), tx, jax.random.PRNGKey(0))

    def jax_run(dtype, mode):
        model = _jmodel(conf, dtype)
        step = JT.make_train_step(model, tx, batch, jaug, donate=False, jit=mode == "jit")
        state, masks = init, []
        for _ in range(3):
            flax_masks.clear()
            if mode == "jit":
                state, _ = step(state, key, jpool, jnp.asarray(labels), jwin)
            else:
                with jax.disable_jit():
                    state, _ = step(state, key, jpool, jnp.asarray(labels), jwin)
            masks.append(list(flax_masks))
        final = {"params": _np(state.params),
                 "stats": _np(state.params, state.batch_stats) if state.batch_stats else {}}
        return final, masks

    exact, masks = jax_run(jnp.bfloat16, "op-by-op")
    compiled, _ = jax_run(jnp.bfloat16, "jit")
    f32, _ = jax_run(None, "jit")

    variables = {"params": jax.tree.map(np.asarray, init.params)}
    if init.batch_stats:
        variables["batch_stats"] = jax.tree.map(np.asarray, init.batch_stats)
    aug = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    ptx = make_optimizer(lrs=(0.01, 0.001), boundaries=(2,))
    state = create_train_state(_port(conf, variables), ptx)
    step = make_train_step(ptx, batch, aug)
    for s in range(3):
        k_sample, _ = jax.random.split(jax.random.fold_in(key, s))
        audio, lab = A.assemble_batch(_jax_draws(k_sample, len(raw), jaug, arrays.n_noise, batch), arrays, aug)
        state, m = step.apply_batch(state, audio, lab, dropout=masks[s])
        assert torch.isfinite(m["loss"])
    assert state.step == 3
    sd = state.model.state_dict()
    port = {"params": {k: sd[k].numpy() for k in exact["params"]},
            "stats": {k: sd[k].numpy() for k in exact["stats"]}}
    ratios = _ratios(port, exact, compiled, f32)
    assert set(ratios) == ({"params", "stats"} if conf.startswith("res") else {"params"})
    _assert_ratios(ratios)


# --- (e) two gloo ranks ------------------------------------------------------


def test_two_gloo_ranks_train_bf16_within_the_data_parallel_gate(tmp_path):
    """Two bf16 steps of res8-narrow and cnn-trad-pool2 on two ranks against one rank
    (``tests/torch_bf16_rank_worker.py``): BN's statistics all-reduced in float32, the bf16 flow on each rank."""
    rng = np.random.default_rng(0)
    n = 48
    spec = {"raw": rng.integers(-3000, 3000, (n, 16000), dtype=np.int16),
            "labels": rng.integers(2, 12, (n,), dtype=np.int32),
            "noise": (rng.standard_normal(16000 * 3) * 0.05).astype(np.float32),
            "n_silence": 4, "batch": 16, "steps": 2, "key": 7, "confs": ["res8-narrow", "cnn-trad-pool2"]}
    spec_path = str(tmp_path / "spec.pt")
    torch.save(spec, spec_path)
    port = free_port()
    worker = os.path.join(REPO, "tests", "torch_bf16_rank_worker.py")
    outs = [str(tmp_path / f"out{r}.pt") for r in range(2)] + [str(tmp_path / "one.pt")]
    run_ranks([[sys.executable, worker, str(r), "2", str(port), spec_path, outs[r]] for r in range(2)]
              + [[sys.executable, worker, "0", "1", "0", spec_path, outs[2]]])
    *ranks, one = (torch.load(o, weights_only=False) for o in outs)
    for conf in spec["confs"]:
        a, b, ref = ranks[0][conf], ranks[1][conf], one[conf]
        np.testing.assert_allclose(a["losses"][0], ref["losses"][0], rtol=LOSS_RTOL)
        assert a["losses"] == b["losses"]
        for k, v in ref["state"].items():
            assert torch.equal(a["state"][k], b["state"][k]), f"{conf} {k} differs across the ranks"
            if v.is_floating_point():
                np.testing.assert_allclose(a["state"][k].numpy(), v.numpy(), atol=DP_PARAM_ATOL, err_msg=f"{conf} {k}")
                assert float((a["state"][k] - v).abs().max()) < DP_PARAM_MAX, f"{conf} {k}"
        assert ref["losses"] != one["float32"][conf]["losses"]  # bf16 steps, not float32 ones
