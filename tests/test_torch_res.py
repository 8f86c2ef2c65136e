"""Port's res model and res-stack kernel module against the JAX package, on the CPU.

Weights are made by the flax model from a seed, with randomized BN stats so
the folding is exercised, and carried across with ``from_flax_variables``.
On CPU tensors the res-stack wrapper runs its plain version (``F.conv2d``
layers with the kernel's BN folding); ``chip_smoke.py`` holds the CUDA
kernel against that version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.ops.res_kernel import pack_res_params as jpack_res_params
from honk_tpu.ops.res_kernel import res_forward_fused
from honk_tpu_torch.models import SpeechResModel, find_config, from_flax_variables, load_state_dict
from honk_tpu_torch.ops import res_kernel

# The reference's gate for its f32 res-stack kernel against the flax model.
RES_TOL = dict(atol=5e-4, rtol=1e-3)


def _flax_variables(conf, seed=0):
    cfg = jfind_config(conf)
    model = jfind_model(conf)(config=cfg)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 101, 40), jnp.float32), train=False)
    rng = np.random.default_rng(seed)
    stats = {
        name: {
            "mean": rng.normal(0, 0.1, leaf["mean"].shape).astype(np.float32),
            "var": (rng.random(leaf["var"].shape) * 0.5 + 0.5).astype(np.float32),
        }
        for name, leaf in variables["batch_stats"].items()
    }
    params = jax.tree.map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}, cfg


def _port_model(conf, variables):
    model = SpeechResModel(find_config(conf))
    load_state_dict(model, from_flax_variables(variables))
    return model.eval()


@pytest.fixture(scope="module", params=["res8-narrow", "res8"])
def case(request):
    conf = request.param
    fmodel, variables, cfg = _flax_variables(conf)
    return conf, fmodel, variables, cfg, _port_model(conf, variables)


def test_pack_res_params_equals_reference_on_real_channels(case):
    _, _, variables, cfg, model = case
    C, L = cfg["n_feature_maps"], cfg["n_layers"]
    n_lab = cfg["n_labels"]
    jw, js, jo, jdw, jdb = (np.asarray(a) for a in jpack_res_params(variables, cfg))
    w, s, o, dw, db = (a.numpy() for a in res_kernel.pack_res_params(model))
    assert w.shape == (L, 9 * C, C) and s.shape == o.shape == (L, C)
    np.testing.assert_array_equal(w.reshape(L, 9, C, C), jw.reshape(L, 9, 64, 64)[:, :, :C, :C])
    np.testing.assert_array_equal(s, js[:, :C])
    np.testing.assert_array_equal(o, jo[:, :C])
    np.testing.assert_array_equal(dw, jdw[:C, :n_lab])
    np.testing.assert_array_equal(db, jdb[:n_lab])


@pytest.mark.parametrize("batch", [1, 3])
def test_res_forward_matches_tpu_kernel_and_flax(case, batch):
    _, fmodel, variables, cfg, model = case
    feats = np.random.default_rng(batch).standard_normal((batch, 101, 40)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    kernel = np.asarray(res_forward_fused(
        variables, cfg, jnp.asarray(feats), B_blk=batch, compute_dtype=jnp.float32, interpret=True
    ))
    flax = np.asarray(fmodel.apply(variables, jnp.asarray(feats), train=False))
    assert got.shape == flax.shape == (batch, cfg["n_labels"])
    np.testing.assert_allclose(got, kernel, **RES_TOL)
    np.testing.assert_allclose(got, flax, **RES_TOL)


def test_res_stack_plain_is_the_wrappers_cpu_path(case):
    _, _, _, _, model = case
    feats = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 101, 40)).astype(np.float32))
    with torch.no_grad():
        pooled = model.stem(feats)
        packed = res_kernel.pack_res_params(model)
        before = res_kernel.launches
        got = res_kernel.res_stack(pooled, *packed)
        assert res_kernel.launches == before
        torch.testing.assert_close(got, res_kernel.res_stack_plain(pooled, *packed), rtol=0, atol=0)


def test_res_stack_wrapper_rejects_bad_operands():
    model = SpeechResModel(find_config("res8-narrow")).eval()
    packed = res_kernel.pack_res_params(model)
    pooled = torch.zeros((2, 19, 25, 13))
    with pytest.raises(ValueError):
        res_kernel.res_stack(torch.zeros((2, 18, 25, 13)), *packed)  # wrong channel count
    with pytest.raises(ValueError):
        res_kernel.res_stack(pooled.double(), *packed)
    with pytest.raises(ValueError, match="cuda or cpu"):
        res_kernel.res_stack(pooled.to("meta"), *(p.to("meta") for p in packed))
