"""The port's Orbax loader against the committed checkpoints and the JAX package, on the CPU.

Every committed ``best/`` directory (Orbax OCDBT, zstd-compressed) loads
through ``ckpt.load_orbax`` exactly equal to its sibling ``.pt`` and to the
JAX package's own Orbax restore; ``LabelService``, ``--input_file`` and the
serving CLI take a directory as the JAX ones do; where ``tensorstore`` is
not importable, every entry point refuses an Orbax checkpoint, naming it.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu.ckpt import Checkpointer as JCheckpointer
from honk_tpu_torch.ckpt import load_orbax, read_state_dict
from honk_tpu_torch.ckpt.orbax import REFUSAL, check, resolve
from honk_tpu_torch.cli.serve import make_server
from honk_tpu_torch.cli.train import main
from honk_tpu_torch.models import from_flax_variables
from honk_tpu_torch.serve import LabelService
from test_torch_loop import _final_acc, corpus  # noqa: F401 (corpus is a fixture)

ROOT = Path(__file__).resolve().parents[1]
BEST = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("zoo*/*/best"))


def test_the_fourteen_committed_checkpoints_are_found():
    assert len(BEST) == 14
    assert sum(b.startswith("zoo/") for b in BEST) == 3
    assert sum(b.startswith("zoo_hard/") for b in BEST) == 4
    assert sum(b.startswith("zoo_hard_v2/") for b in BEST) == 7


@pytest.mark.parametrize("best", BEST)
def test_committed_best_loads_equal_to_its_pt(best):
    got = read_state_dict(str(ROOT / best))
    pt = torch.load(ROOT / (best[: -len("/best")] + ".pt"), weights_only=True)
    pt = {k: v for k, v in pt.items() if not k.endswith(".num_batches_tracked")}
    assert set(got) == set(pt)
    for k, v in pt.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("best", ["zoo/res8/best", "zoo/cnn-trad-pool2/best", "zoo_hard_v2/res15/best"])
def test_load_orbax_equals_the_jax_restore(best):
    jax_tree = JCheckpointer(str(ROOT / best[: -len("/best")])).restore("best")
    tree = load_orbax(str(ROOT / best))
    assert set(tree) == set(jax_tree)
    for group in tree:
        assert set(tree[group]) == set(jax_tree[group])
        for name, leaves in tree[group].items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(value, np.asarray(jax_tree[group][name][leaf]))


def test_a_run_directory_resolves_to_its_best():
    run = str(ROOT / "zoo" / "res8")
    assert resolve(run) == str(ROOT / "zoo" / "res8" / "best")
    a, b = read_state_dict(run), read_state_dict(run + "/best")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert check(run) == check(run + "/best") == str(ROOT / "zoo" / "res8" / "best")
    for refused in (check, load_orbax):
        with pytest.raises(FileNotFoundError, match="no Orbax checkpoint"):
            refused(str(ROOT / "zoo"))
    assert from_flax_variables(load_orbax(run)).keys() == a.keys()


@pytest.mark.parametrize("path", ["zoo/res8/best", "zoo/res8"])
def test_label_service_takes_an_orbax_directory(path):
    audio = (np.random.default_rng(0).standard_normal((4, 16000)) * 0.2).astype(np.float32)
    orbax = LabelService("res8", str(ROOT / path), device="cpu")
    pt = LabelService("res8", str(ROOT / "zoo" / "res8.pt"), device="cpu")
    torch.testing.assert_close(orbax.logits(audio), pt.logits(audio), rtol=0, atol=0)
    assert orbax.evaluate_batch(audio) == pt.evaluate_batch(audio)


def test_cli_eval_of_an_orbax_input_file_gives_the_pt_accuracy(corpus, capsys):  # noqa: F811
    args = ["--type", "eval", "--model", "res8", "--data_dir", corpus, "--device", "cpu", "--eval_batch_size", "64"]
    assert main([*args, "--input_file", str(ROOT / "zoo" / "res8" / "best")]) == 0
    orbax = _final_acc(capsys.readouterr().out)
    assert main([*args, "--input_file", str(ROOT / "zoo" / "res8.pt")]) == 0
    assert orbax == _final_acc(capsys.readouterr().out)


def test_serving_cli_builds_on_an_orbax_checkpoint():
    httpd = make_server(["--checkpoint", str(ROOT / "zoo" / "res8"), "--device", "cpu", "--port", "0",
                         "--stream-slots", "0"])
    httpd.server_close()


@pytest.fixture
def no_tensorstore(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import tensorstore raises ImportError


def test_every_entry_point_refuses_orbax_without_tensorstore(no_tensorstore, capsys):
    best = str(ROOT / "zoo" / "res8" / "best")
    with pytest.raises(RuntimeError, match="needs the tensorstore package"):
        LabelService("res8", best, device="cpu")
    with pytest.raises(RuntimeError, match=re.escape(REFUSAL)):
        read_state_dict(best)
    for argv in (["--type", "eval", "--input_file", best], ["--type", "train", "--input_file", best]):
        with pytest.raises(SystemExit) as e:
            main([*argv, "--device", "cpu"])
        assert e.value.code == 2 and "tensorstore" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        make_server(["--checkpoint", best, "--device", "cpu"])
    assert e.value.code == 2 and "tensorstore" in capsys.readouterr().err
    # A .pt needs nothing of it.
    assert LabelService("res8", str(ROOT / "zoo" / "res8.pt"), device="cpu").labels
