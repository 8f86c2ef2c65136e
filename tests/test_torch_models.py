"""Port's model registry, eval forwards and checkpoint loading against the JAX package, on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.frontend import compute_mfccs_jit
from honk_tpu.models import ConfigType as JConfigType
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.models import flax_to_torch_state_dict
from honk_tpu.models import load_honk_checkpoint as jload_honk_checkpoint
from honk_tpu_torch.models import (
    ConfigType,
    SpeechModel,
    SpeechResModel,
    find_config,
    find_model,
    from_flax_variables,
    load_honk_checkpoint,
    load_state_dict,
)

ZOO_RES8 = os.path.join(os.path.dirname(__file__), "..", "zoo", "res8.pt")


def test_find_config_equal_for_every_config_type():
    """The JAX package's 16 types in its order, each config equal; then kwt-3, which the port alone has."""
    assert [c.value for c in ConfigType] == [c.value for c in JConfigType] + ["kwt-3"]
    assert len(JConfigType) == 16
    for c in JConfigType:
        assert find_config(c.value) == jfind_config(c.value), c.value
        assert find_config(ConfigType(c.value)) == jfind_config(c.value), c.value


def _flax_init(conf, seed=0):
    """A flax model at full precision and its variables from a seed, with
    randomized BN statistics where it has BN, as numpy arrays."""
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


def _eval_logits_match_jax(conf):
    """Eval logits of the port against flax on the same random weights and
    features, within the reference's checkpoint gate (2e-4)."""
    fmodel, variables = _flax_init(conf)
    feats = (np.random.default_rng(1).standard_normal((3, 101, 40)) * 3).astype(np.float32)
    ref = np.asarray(fmodel.apply(variables, jnp.asarray(feats), train=False))
    model = load_state_dict(find_model(conf)(find_config(conf)), from_flax_variables(variables)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert np.abs(ref).max() > 1e-3  # the weights reach the logits
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("conf", ["res15", "res15-narrow"])
def test_dilated_res_eval_logits_match_jax(conf):
    assert find_model(conf) is SpeechResModel
    _eval_logits_match_jax(conf)


@pytest.mark.parametrize("conf", [c.value for c in ConfigType if c.value.startswith("cnn")])
def test_cnn_eval_logits_match_jax(conf):
    assert find_model(conf) is SpeechModel
    _eval_logits_match_jax(conf)


def test_training_forward_moves_bn_statistics():
    """In training mode a forward gives logits with a gradient and moves the
    BN running statistics (tests/test_torch_train.py holds it against flax)."""
    model = SpeechResModel(find_config("res8-narrow"))  # nn.Modules start in training mode
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 101, 40)).astype(np.float32))
    logits = model(x)
    assert logits.shape == (2, 12) and torch.isfinite(logits).all() and logits.requires_grad
    assert not torch.equal(model.bn1.running_mean, torch.zeros(19))
    assert not torch.equal(model.bn1.running_var, torch.ones(19))


def test_zoo_res8_logits_match_jax():
    # zoo/res8.pt has no num_batches_tracked keys: it must load as it is.
    sd = torch.load(ZOO_RES8, map_location="cpu", weights_only=True)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    model = load_honk_checkpoint(ZOO_RES8, SpeechResModel(find_config("res8"))).eval()

    audio = (np.random.default_rng(0).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    feats = np.array(compute_mfccs_jit(audio))
    variables = jload_honk_checkpoint(ZOO_RES8)
    jmodel = jfind_model("res8")(config=jfind_config("res8"), precision="highest")
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(feats), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    # The reference's checkpoint logit gate (tests/test_cross_runtime.py).
    np.testing.assert_allclose(got, ref, atol=2e-4)


def _res8_state_dict():
    return torch.load(ZOO_RES8, map_location="cpu", weights_only=True)


def test_state_dict_with_num_batches_tracked_also_loads():
    model = SpeechResModel(find_config("res8"))
    load_state_dict(model, model.state_dict())  # carries num_batches_tracked


def test_missing_key_other_than_num_batches_tracked_raises():
    sd = _res8_state_dict()
    del sd["bn3.running_var"]
    with pytest.raises(KeyError, match="bn3.running_var"):
        load_state_dict(SpeechResModel(find_config("res8")), sd)


def test_unexpected_key_raises():
    sd = _res8_state_dict()
    sd["conv7.weight"] = sd["conv6.weight"]
    with pytest.raises(KeyError, match="conv7.weight"):
        load_state_dict(SpeechResModel(find_config("res8")), sd)


def test_from_flax_variables_is_inverse_of_reference_converter():
    variables = jload_honk_checkpoint(ZOO_RES8)
    got = from_flax_variables(variables)
    ref = flax_to_torch_state_dict(variables)
    assert got.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    sd = _res8_state_dict()
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
