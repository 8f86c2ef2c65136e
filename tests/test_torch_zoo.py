"""The port's zoo tool (``honk_tpu_torch.cli.zoo``) against the JAX repo's
``scripts/make_zoo.py`` and ``scripts/compare_zoo.py``, on the CPU.

One module fixture builds a zoo of res8-narrow and res8 (four bf16 epochs
each, B=8, lr 0.1) on a tiny hard-mode corpus (10 clips a word, 12
speakers, dev 10 %, test 40 %: 72 test clips) through ``python -m
honk_tpu_torch.cli.zoo build``, copies it, and runs the port's ``compare``
on one copy and ``scripts/compare_zoo.py::main`` on the other. Gates:
make_zoo's MANIFEST schema (``orbax`` null), the per-clip correctness
vectors and ``ladder_stats`` equal to compare_zoo's (both score in float32
with full-precision products, so the two runtimes' logits part by ~1e-6
and a clip could differ only at an exact tie), McNemar's rounding and its
tie, and ``--against`` pairing vectors by model name.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest

from honk_tpu.models.torch_compat import load_honk_checkpoint as jload_honk_checkpoint
from honk_tpu_torch.cli import zoo
from honk_tpu_torch.data import generate_hard_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["res8-narrow", "res8"]
SPLIT = ["--dev_pct", "10", "--test_pct", "40"]
# make_zoo's MANIFEST keys, its model entries' and their recipes' (scripts/make_zoo.py::build_zoo).
MANIFEST_KEYS = {"corpus", "corpus_recipe", "split_sizes", "n_labels", "labels", "models"}
ENTRY_KEYS = {"pt", "orbax", "test_acc", "best_dev_acc", "n_params", "recipe"}
RECIPE_KEYS = {"n_epochs", "batch_size", "seed", "compute_dtype", "lr", "schedule", "dev_pct", "test_pct",
               "n_test_clips"}


def _compare_zoo_main():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import compare_zoo
    finally:
        sys.path.pop(0)
    return compare_zoo.main


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo")
    data = str(tmp / "hard")
    generate_hard_dataset(data, clips_per_word=10, n_speakers=12, noise_seconds=3)
    port, ref = str(tmp / "port"), str(tmp / "jax")
    assert zoo.main(["build", port, "--models", *MODELS, "--data_dir", data, "--n_epochs", "4",
                     "--batch_size", "8", "--lr", "0.1", "--schedule", *SPLIT, "--device", "cpu"]) == 0
    with open(os.path.join(port, "MANIFEST.json")) as f:
        built_manifest = json.load(f)
    shutil.copytree(port, ref)
    assert zoo.main(["compare", port, "--data_dir", data, *SPLIT, "--device", "cpu"]) == 0
    return {"data": data, "port": port, "ref": ref, "built": built_manifest}


@pytest.fixture(scope="module")
def jax_compared(built):
    """compare_zoo.py's own run on the copy, JAX's compilation cache settings left as conftest.py set them."""
    update = jax.config.update

    def keep_cache(name, value):
        if "cache" not in name:
            update(name, value)

    jax.config.update = keep_cache
    try:
        assert _compare_zoo_main()([built["ref"], "--data_dir", built["data"], *SPLIT]) == 0
    finally:
        jax.config.update = update
    with open(os.path.join(built["ref"], "MANIFEST.json")) as f:
        return json.load(f)


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def test_build_writes_make_zoos_manifest_with_no_orbax(built):
    m = built["built"]
    assert set(m) == MANIFEST_KEYS
    assert m["n_labels"] == 12 and len(m["labels"]) == 12
    assert m["corpus_recipe"]["clips_per_word"] == 10
    assert m["split_sizes"] == {"train": 33, "dev": 12, "test": 72}
    assert list(m["models"]) == MODELS
    for name, e in m["models"].items():
        assert set(e) == ENTRY_KEYS and set(e["recipe"]) == RECIPE_KEYS
        assert e["pt"] == f"{name}.pt" and e["orbax"] is None
        assert e["recipe"]["compute_dtype"] == "bfloat16" and e["recipe"]["lr"] == [0.1]
        assert e["recipe"]["schedule"] == [] and e["recipe"]["n_test_clips"] == 72
        assert 0.0 <= e["test_acc"] <= 1.0 and e["test_acc"] == round(e["test_acc"], 4)
        # The .pt is a honk state dict the JAX package loads; n_params counts flax's params.
        variables = jload_honk_checkpoint(os.path.join(built["port"], e["pt"]))
        assert e["n_params"] == sum(int(np.asarray(p).size) for p in jax.tree.leaves(variables["params"]))


def test_build_refuses_a_manifest_of_another_label_set(built, tmp_path):
    out = str(tmp_path / "other")
    os.makedirs(out)
    m = dict(built["built"], labels=["a", "b"], n_labels=2)
    with open(os.path.join(out, "MANIFEST.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="use a fresh out_dir"):
        zoo.main(["build", out, "--models", "res8-narrow", "--data_dir", built["data"], "--n_epochs", "1",
                  *SPLIT, "--device", "cpu"])
    assert not os.path.exists(os.path.join(out, "res8-narrow.pt"))


def test_compare_gives_compare_zoos_vectors_and_ladder_stats(built, jax_compared):
    port = _manifest(built["port"])
    for name in MODELS:
        got = np.load(os.path.join(built["port"], f"{name}_test_correct.npy"))
        want = np.load(os.path.join(built["ref"], f"{name}_test_correct.npy"))
        assert got.dtype == want.dtype == np.bool_ and got.shape == (72,)
        np.testing.assert_array_equal(got, want)
        for k in ("test_acc_recheck", "test_acc_se"):
            assert port["models"][name][k] == jax_compared["models"][name][k]
    assert port["ladder_stats"] == jax_compared["ladder_stats"]
    assert list(port["ladder_stats"]["pairwise"]) == ["res8-narrow_vs_res8"]


@pytest.mark.parametrize("first,second,want", [
    ([1, 1, 0, 0, 1], [0, 0, 1, 1, 1], {"n_only_first_correct": 2, "n_only_second_correct": 2,
                                         "mcnemar_z": 0.0, "winner": None, "resolved_2se": False}),
    ([1, 1], [1, 1], {"n_only_first_correct": 0, "n_only_second_correct": 0,
                      "mcnemar_z": 0.0, "winner": None, "resolved_2se": False}),
    ([1] * 9 + [0], [0] * 9 + [1], {"n_only_first_correct": 9, "n_only_second_correct": 1,
                                    "mcnemar_z": 2.53, "winner": "a", "resolved_2se": True}),
    ([0] * 3, [1] * 3, {"n_only_first_correct": 0, "n_only_second_correct": 3,
                        "mcnemar_z": -1.73, "winner": "b", "resolved_2se": False}),
])
def test_mcnemar_rounds_as_compare_zoo_and_a_tie_has_no_winner(first, second, want):
    assert zoo.mcnemar(np.array(first, bool), np.array(second, bool), "a", "b") == want


def test_against_pairs_each_model_with_the_vector_of_its_name(built, tmp_path):
    other = str(tmp_path / "other")
    os.makedirs(other)
    vec = np.load(os.path.join(built["port"], "res8_test_correct.npy"))
    flipped = vec.copy()
    flipped[:5] = ~flipped[:5]
    np.save(os.path.join(other, "res8_test_correct.npy"), flipped)
    np.save(os.path.join(other, "res15_test_correct.npy"), np.ones_like(vec))  # no such model in the zoo
    work = str(tmp_path / "port")
    shutil.copytree(built["port"], work)
    assert zoo.main(["compare", work, "--data_dir", built["data"], *SPLIT, "--against", other,
                     "--device", "cpu"]) == 0
    m = _manifest(work)
    against = m["against_stats"]
    assert against["zoo"] == other and against["n_test_clips"] == 72
    assert list(against["pairwise"]) == ["res8"]  # res8-narrow has no vector there, res15 no model here
    assert against["pairwise"]["res8"] == zoo.mcnemar(vec, flipped, "res8", os.path.join(other, "res8"))
    assert against["pairwise"]["res8"]["n_only_first_correct"] + against["pairwise"]["res8"][
        "n_only_second_correct"] == 5
    assert m["ladder_stats"] == _manifest(built["port"])["ladder_stats"]
    np.save(os.path.join(other, "res8_test_correct.npy"), vec[:10])
    with pytest.raises(ValueError, match="10 clips"):
        zoo.main(["compare", work, "--data_dir", built["data"], *SPLIT, "--against", other, "--device", "cpu"])
