"""The port's bf16 data-parallel step on two gloo ranks against the JAX
package's bf16 step on two devices, tensor by tensor, over three steps.

This localizes on single steps the bf16 one-vs-two-rank difference that
``tests/test_torch_parallel.py::test_bf16_resumes_across_one_and_two_ranks_within_the_jax_gap``
pins after four epochs (ROADMAP.md §3.2). res8-narrow from flax's initial
weights, B=16, lr 0.01, three steps on the same global batches: the JAX
step's own draws (``make_train_step(data_axis="data")`` on 1 and 2 of the
8 virtual CPU devices, compiled), injected into the port's step on one
rank and on two gloo ranks (``tests/torch_bf16_rank_worker.py``), each
rank taking its rows. The JAX bf16 step run op by op (``jax.disable_jit``,
flax's dtype flow) is the reference; on the mesh it does not partition, so
it is the same on one and two devices (measured bitwise).

Distances are Frobenius norms, as shares of the JAX 2-device step's own
bf16-to-float32 distance (the ratio rule of ``tests/test_torch_bf16_train.py``).
Gates:
- The ratio rule, per tensor, after steps 1 and 2: the port's 2-rank step
  from JAX's op-by-op step at most max(0.5, JAX's compiled 2-device step's
  own distance from it). Measured on seeds 0-2: at most 0.68 of that limit
  after one step, 0.88 after two. After three steps seed 0 (this test's)
  reads 1.41 of it (conv0, conv1, output.bias), where the port's one-rank
  step still holds the rule: the difference grows over steps, and is
  recorded in ROADMAP.md §3.2, not gated.
- Where the parting comes from. Over all parameters after each of steps
  1-3, the port's one and two ranks part no further than JAX's one and two
  devices (seeds 0-2: 0.12-0.96 of JAX's gap). So each rank's weight
  gradient rounded to bf16 before the float32 all-reduce (the suspect,
  ``parallel/mesh.py``) does not part the port's topologies further than
  JAX's partitioned step parts its own on a step: JAX's partitioner also
  reduces bf16 partial products. Per tensor the port's gap first exceeds
  JAX's in BN's running statistics (over all of them after step 1:
  0.015 against 0.004).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.data import augment as JA
from honk_tpu.parallel import make_data_mesh as jmake_data_mesh
from honk_tpu.parallel import replicate as jreplicate
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.models import from_flax_variables
from test_torch_bf16_train import RATIO, _jmodel, _np
from test_torch_parallel import _jax_draws
from torch_ranks import REPO, free_port, run_ranks

CONF, N_CLIPS, BATCH, STEPS = "res8-narrow", 48, 16, 3
RULE_STEPS = (1, 2)


def _norm(a: dict, b: dict, keys) -> float:
    return float(np.sqrt(sum(((np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) ** 2).sum()
                             for k in keys)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The state after each step: JAX's compiled step on 1 and 2 devices in bf16 and on 2 in
    float32, its op-by-op bf16 step, the port's bf16 step on 1 rank and on 2 gloo ranks."""
    rng = np.random.default_rng(0)
    raw = rng.integers(-3000, 3000, (N_CLIPS, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (N_CLIPS,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 3) * 0.05).astype(np.float32)
    jaug = JA.AugmentConfig(n_silence=4)
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    tx = JS.make_optimizer(lrs=(0.01,), boundaries=())
    init = JS.create_train_state(_jmodel(CONF, None), tx, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(7)

    def jax_run(devices, dtype, jit=True):
        mesh = jmake_data_mesh(devices, "data")
        step = JT.make_train_step(_jmodel(CONF, dtype), tx, BATCH, jaug, donate=False, data_axis="data", jit=jit)
        states = []
        with jax.set_mesh(mesh):
            state = jreplicate(mesh, init)
            args = jreplicate(mesh, (jpool, jnp.asarray(labels), jwin))
            for _ in range(STEPS):
                if jit:
                    state, _ = step(state, key, *args)
                else:
                    with jax.disable_jit():
                        state, _ = step(state, key, *args)
                params, stats = jax.device_get(state.params), jax.device_get(state.batch_stats)
                states.append({**_np(params), **_np(params, stats)})
        return states

    out = {"jax1": jax_run(1, jnp.bfloat16), "jax2": jax_run(2, jnp.bfloat16), "jax2_f32": jax_run(2, None),
           "flax_flow": jax_run(1, jnp.bfloat16, jit=False)}
    aug = A.AugmentConfig(n_silence=4)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    batches = []
    for s in range(STEPS):
        k_sample, _ = jax.random.split(jax.random.fold_in(key, s))
        batches.append(A.assemble_batch(_jax_draws(k_sample, N_CLIPS, jaug, arrays.n_noise, BATCH), arrays, aug))
    variables = from_flax_variables({"params": jax.tree.map(np.asarray, init.params),
                                     "batch_stats": jax.tree.map(np.asarray, init.batch_stats)})
    tmp = tmp_path_factory.mktemp("bf16_ranks")
    spec = str(tmp / "spec.pt")
    torch.save({"variables": variables, "batches": batches}, spec)
    port = free_port()
    worker = os.path.join(REPO, "tests", "torch_bf16_rank_worker.py")
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)] + [str(tmp / "one.pt")]
    run_ranks([[sys.executable, worker, str(r), "2", str(port), spec, outs[r]] for r in range(2)]
              + [[sys.executable, worker, "0", "1", "0", spec, outs[2]]])
    rank0, rank1, one = (torch.load(o, weights_only=False)["bfloat16"] for o in outs)
    for a, b in zip(rank0, rank1):
        assert all(torch.equal(a[k], b[k]) for k in a), "the two ranks' states differ"
    out["port2"] = [{k: v.numpy() for k, v in s.items()} for s in rank0]
    out["port1"] = [{k: v.numpy() for k, v in s.items()} for s in one]
    return out


@pytest.mark.parametrize("step", RULE_STEPS)
def test_a_bf16_step_on_two_gloo_ranks_is_held_to_jax_by_the_ratio_rule(runs, step):
    s = step - 1
    exact, compiled, f32, port = (runs[k][s] for k in ("flax_flow", "jax2", "jax2_f32", "port2"))
    ratios = {}
    for k in f32:
        den = _norm(compiled, f32, [k])
        ratios[k] = (_norm(port, exact, [k]) / den, _norm(compiled, exact, [k]) / den)
    bad = {k: r for k, r in ratios.items() if r[0] > max(RATIO, r[1])}
    assert not bad, f"after step {step}, (port's ratio, JAX's own) past the rule: {bad}"


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_two_gloo_ranks_part_no_further_than_jaxs_two_devices(runs, step):
    s = step - 1
    params = [k for k in runs["jax2_f32"][s] if "running" not in k]
    port_gap = _norm(runs["port1"][s], runs["port2"][s], params)
    jax_gap = _norm(runs["jax1"][s], runs["jax2"][s], params)
    assert 0 < port_gap <= jax_gap, f"after step {step}: the port's 1 and 2 ranks {port_gap:.4g} apart, JAX's {jax_gap:.4g}"
