"""The port's data-parallel train step is the same step on 1, 2 and 4 gloo ranks, bit for bit.

Every sum over rows that leaves a rank is taken in float64 and rounded once
after the ranks' parts are added (ROADMAP.md §3.2):
- BN's sums, forward (``res.batch_moments``) and backward (``res._BatchNorm``:
  the cotangent and the cotangent times ``x - mean``, one float64 pair
  all-reduced);
- every parameter gradient that is a sum over rows (``layers._LowConv``,
  ``_LowDense``, ``_Output``: float64, kept by ``layers.wide_grads``),
  all-reduced as one flat float64 vector and rounded once
  (``layers.finish_grads``);
- the loss is ``cross_entropy(reduction="sum") / batch_size`` on every
  topology.

res8-narrow, B=16, lr 0.01, three steps on the JAX step's own draws
(``test_torch_bf16_ranks.injected``), on 1, 2 and 4 gloo ranks
(``tests/torch_bf16_rank_worker.py``), each rank taking its rows. In bf16
each step's all-reduced gradients, momentum, weights and BN running
statistics are ``torch.equal`` across the three topologies, and so are BN's
input gradients, row for row. In float32 the convs keep autograd's float32
weight gradients (oneDNN's, which part the topologies), so only the first
step is held: BN's input gradients and the output layer's gradients.

The parts, each against its reference: BN's backward against
``torch.autograd.gradcheck`` in float64 and, at one rank, against flax's
BatchNorm VJP (float32 within ``test_torch_train.FWD_TOL``; bf16 by the
ratio rule of ``test_torch_bf16_train.py``); a conv's per-sample float32
weight-gradient partial, bit for bit the same in calls of 4, 8, 16 and 64
rows; the output layer, bit for bit ``nn.Linear``'s forward and input
gradient.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu_torch.models import layers, res
from test_torch_bf16_ranks import STEPS, injected, port_ranks
from test_torch_bf16_train import RATIO
from test_torch_train import FWD_TOL

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def topologies(tmp_path_factory):
    """Each world's ranks' outputs (``torch_bf16_rank_worker.batch_steps``), bf16 and float32."""
    return port_ranks(injected(), tmp_path_factory.mktemp("topologies"), WORLDS, ("bfloat16", "float32"))


def _quantity(out: dict, what: str, step: int) -> dict:
    """``what`` of a rank's bf16 run after ``step``: the update's gradients, the momentum, the weights or
    BN's running statistics, by name."""
    if what in ("grads", "momentum"):
        return out["steps"]["bfloat16"][step - 1][what]
    state = out["bfloat16"][step - 1]
    return {k: v for k, v in state.items() if ("running" in k) == (what == "running") and v.is_floating_point()}


@pytest.mark.parametrize("what", ["grads", "momentum", "weights", "running"])
@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_bf16_steps_are_bitwise_on_one_two_and_four_ranks(topologies, step, what):
    one = _quantity(topologies[1][0], what, step)
    assert one and all(bool(v.abs().sum() > 0) for v in one.values()), f"{what}: nothing to compare"
    for world in WORLDS[1:]:
        for rank, out in enumerate(topologies[world]):
            got = _quantity(out, what, step)
            assert got.keys() == one.keys()
            apart = {k: int((got[k] != one[k]).sum()) for k in one if not torch.equal(got[k], one[k])}
            assert not apart, f"after step {step}, {world} ranks (rank {rank}): elements apart from one rank's {apart}"


def _bn_dx(topologies: dict, world: int, dtype: str, step: int) -> list[torch.Tensor]:
    """Each BN's input gradient after ``step`` over the world's ranks' rows, in order."""
    ranks = [out["steps"][dtype][step - 1]["bn_dx"] for out in topologies[world]]
    return [torch.cat(rows) for rows in zip(*ranks)]


@pytest.mark.parametrize("dtype,steps", [("bfloat16", STEPS), ("float32", 1)])
def test_bn_input_gradients_are_bitwise_across_topologies(topologies, dtype, steps):
    """BN's own input gradient (its cotangent, not the residual's), the ranks' rows put together, is
    one rank's bit for bit: in bf16 after each step, in float32 after the first (the float32 convs'
    weight gradients part the topologies' weights after it)."""
    for step in range(1, steps + 1):
        one = _bn_dx(topologies, 1, dtype, step)
        assert len(one) == 6 and all(str(g.dtype) == f"torch.{dtype}" for g in one)
        for world in WORLDS[1:]:
            got = _bn_dx(topologies, world, dtype, step)
            apart = [int((a != b).flatten(1).any(dim=1).sum()) for a, b in zip(got, one)]
            assert apart == [0] * len(one), f"{dtype} step {step}, {world} ranks: rows apart per BN {apart}"


def test_float32_output_layer_gradients_are_bitwise_across_topologies(topologies):
    """The float32 model's output layer, whose gradients are float64 sums rounded once, takes the same
    gradient on 1, 2 and 4 ranks in the first step; its convs' float32 weight gradients (oneDNN's,
    left to autograd) need not."""
    one = topologies[1][0]["steps"]["float32"][0]["grads"]
    for world in WORLDS[1:]:
        for out in topologies[world]:
            got = out["steps"]["float32"][0]["grads"]
            for k in ("output.weight", "output.bias"):
                assert torch.equal(got[k], one[k]), f"{world} ranks: {k}"


@pytest.mark.parametrize("shape,scale,offset", [((4, 3, 5, 6), 1.0, 0.0), ((3, 5, 4, 3), 30.0, 7.0)])
def test_the_bn_backward_passes_gradcheck_in_float64(shape, scale, offset):
    """``res._BatchNorm`` on float64 input runs its formula in float64: gradcheck's numerical gradient."""
    gen = torch.Generator().manual_seed(len(shape) + int(scale))
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * scale + offset).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: res._BatchNorm.apply(t, None)[0], (x,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_bn_backward_at_one_rank_is_flaxs_vjp(dtype):
    """At one rank ``res.batch_norm_train``'s input gradient is flax's affine-free BatchNorm VJP
    (``honk_tpu/models/res.py``'s, run op by op): float32 within ``FWD_TOL``; bf16, flax's dtype flow,
    within RATIO of flax's own bf16-to-float32 distance."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 25, 13, 19)) * 2 + 0.5).astype(np.float32)  # NHWC, res8-narrow's BN
    ct = rng.standard_normal(x.shape).astype(np.float32)
    low = getattr(jnp, dtype)
    x, ct = (np.array(jnp.asarray(a, low).astype(jnp.float32)) for a in (x, ct))  # values the dtype holds
    bn = fnn.BatchNorm(use_running_average=False, use_bias=False, use_scale=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def flax_vjp(d):
        with jax.disable_jit():
            _, vjp = jax.vjp(lambda t: bn.apply(variables, t, mutable=["batch_stats"])[0], jnp.asarray(x, d))
            return np.asarray(vjp(jnp.asarray(ct, d))[0].astype(jnp.float32))

    t = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)).requires_grad_(True)
    out = res.batch_norm_train(t, torch.nn.BatchNorm2d(19, affine=False))
    out.backward(torch.from_numpy(ct).permute(0, 3, 1, 2).to(t.dtype))
    got = t.grad.float().permute(0, 2, 3, 1).numpy()
    assert t.grad.dtype == t.dtype
    want = flax_vjp(low)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FWD_TOL)
    else:
        ratio = np.linalg.norm(got - want) / np.linalg.norm(want - flax_vjp(jnp.float32))
        assert ratio <= RATIO, f"ratio {ratio:.3f}"


# (config, in channels, out channels, input H x W, dilation): res8's conv0 and conv1, res8-narrow's
# conv1 (after the pool), res15-narrow's dilated conv at full height.
PARTIAL_SHAPES = [("res8-conv0", 1, 45, (101, 40), 1), ("res8-conv1", 45, 45, (25, 13), 1),
                  ("res8-narrow-conv1", 19, 19, (25, 13), 1), ("res15-narrow-dilated", 19, 19, (101, 40), 4)]


@pytest.mark.parametrize("conf,c,o,hw,d", PARTIAL_SHAPES, ids=[s[0] for s in PARTIAL_SHAPES])
def test_a_per_sample_weight_gradient_partial_is_bitwise_at_any_row_count(conf, c, o, hw, d):
    """``layers._conv_weight_partials`` of each sample is the same bits in a call of 4, 8, 16 or 64
    rows, so a rank's float64 part adds the same partials one rank adds (MKL could split one item
    of a small batched GEMM over threads)."""
    gen = torch.Generator().manual_seed(c + o + d)
    x = torch.randn((64, c, *hw), generator=gen).bfloat16()
    gy = torch.randn((64, o, *hw), generator=gen).bfloat16().float()
    shape, geometry = torch.Size((o, c, 3, 3)), ((1, 1), (d, d), (d, d))
    whole = layers._conv_weight_partials(gy, x, shape, geometry)
    assert whole.shape == (64, o, c * 9)
    for rows in (4, 8, 16):
        parts = torch.cat([layers._conv_weight_partials(gy[i:i + rows], x[i:i + rows], shape, geometry)
                           for i in range(0, 64, rows)])
        assert torch.equal(parts, whole), f"{rows} rows: {int((parts != whole).sum())} elements apart"


def test_the_output_layer_is_nn_linears_forward_and_input_gradient():
    """``layers.Output``: forward and input gradient bit for bit ``nn.Linear``'s; its weight and bias
    gradients the float64 sums over the rows (``wide_grads``), ``.grad`` their float32 rounding."""
    gen = torch.Generator().manual_seed(4)
    lin, out = torch.nn.Linear(19, 12), layers.Output(19, 12)
    out.load_state_dict(lin.state_dict())
    x = torch.randn((16, 19), generator=gen)
    ct = torch.randn((16, 12), generator=gen)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    y0 = lin(xs[0])
    with layers.wide_grads() as wide:
        y1 = out(xs[1])
    y0.backward(ct)
    y1.backward(ct)
    assert torch.equal(y0, y1) and torch.equal(xs[0].grad, xs[1].grad)
    truth_w, truth_b = ct.double().t().mm(x.double()), ct.double().sum(dim=0)
    assert torch.allclose(wide[out.weight], truth_w, rtol=1e-15, atol=0) and torch.equal(wide[out.bias], truth_b)
    assert torch.equal(out.weight.grad, wide[out.weight].float()) and torch.equal(out.bias.grad, truth_b.float())
    scale = ct.abs().double().t().mm(x.abs().double())  # nn.Linear's float32 sum lies within its bound
    assert bool(((lin.weight.grad.double() - truth_w).abs() <= 16 * 2.0 ** -24 * scale).all())
