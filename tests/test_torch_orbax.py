"""The port's Orbax loader against the committed checkpoints and the JAX package, on the CPU.

Every committed ``best/`` directory (Orbax OCDBT, zstd-compressed) loads
through ``ckpt.load_orbax`` exactly equal to its sibling ``.pt`` and to the
JAX package's own Orbax restore; ``LabelService``, ``--input_file``, the
serving CLI and ``datagen --eval_checkpoint`` take a directory as the JAX
ones do, and every one of them reads it with ``tensorstore``, ``zstandard``
and ``numcodecs`` hidden (the port's own reader, ``ckpt.ocdbt``; its own
tests are ``test_torch_orbax_reader.py``).
"""

import base64
import json
import os
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu.ckpt import Checkpointer as JCheckpointer
from honk_tpu_torch.ckpt import load_orbax, read_state_dict
from honk_tpu_torch.ckpt.orbax import check, resolve
from honk_tpu_torch.cli.serve import make_server
from honk_tpu_torch.cli.train import main
from honk_tpu_torch.datagen.cli import main as datagen_main
from honk_tpu_torch.models import from_flax_variables
from honk_tpu_torch.serve import LabelService
from test_torch_datagen import _make_video
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


def test_a_path_that_is_neither_is_named_so(tmp_path):
    """A mistyped ``.pt`` is taken for a directory, as before, and the error says it is neither."""
    for path in (str(tmp_path / "res8.pth"), str(ROOT / "zoo" / "res8.pt.missing"), str(ROOT / "zoo")):
        with pytest.raises(FileNotFoundError, match="is neither a .pt file nor an Orbax checkpoint directory"):
            check(path)
    with pytest.raises(FileNotFoundError, match="neither a .pt file"):
        read_state_dict(str(tmp_path / "res8.pth"))


@pytest.fixture
def no_tensorstore(monkeypatch):
    for name in ("tensorstore", "zstandard", "numcodecs"):  # importing any of them raises ImportError
        monkeypatch.setitem(sys.modules, name, None)


def test_every_entry_point_reads_orbax_without_tensorstore(no_tensorstore, corpus, tmp_path, capsys):  # noqa: F811
    best, pt = str(ROOT / "zoo" / "res8" / "best"), str(ROOT / "zoo" / "res8.pt")
    want = {k: v for k, v in torch.load(pt, weights_only=True).items() if not k.endswith(".num_batches_tracked")}
    got = read_state_dict(best)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

    pcm = (np.random.default_rng(1).standard_normal((3, 16000)) * 6000).astype(np.int16)
    audio = pcm.astype(np.float32) / 32768.0
    pt_service = LabelService("res8", pt, device="cpu")
    torch.testing.assert_close(LabelService("res8", best, device="cpu").logits(audio), pt_service.logits(audio),
                               rtol=0, atol=0)
    httpd = make_server(["--checkpoint", best, "--device", "cpu", "--port", "0", "--stream-slots", "0"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for clip, wave in zip(pcm, audio):
            body = json.dumps({"wav_data": base64.b64encode(clip.tobytes()).decode()}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/listen", data=body)
            with urllib.request.urlopen(req, timeout=60) as r:
                answer = json.loads(r.read())
            assert (answer["label"], answer["prob"]) == pt_service.evaluate(wave)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    args = ["--model", "res8", "--data_dir", corpus, "--device", "cpu", "--eval_batch_size", "64"]
    acc = {}
    for source in (best, pt):
        assert main(["--type", "eval", *args, "--input_file", source]) == 0
        acc["eval", source] = _final_acc(capsys.readouterr().out)
        out = str(tmp_path / f"warm-{len(acc)}")
        assert main(["--type", "train", *args, "--input_file", source, "--n_epochs", "0", "--output_dir", out]) == 0
        acc["train", source] = _final_acc(capsys.readouterr().out)
    assert acc["eval", best] == acc["eval", pt] == acc["train", best] == acc["train", pt]

    src = str(tmp_path / "src")
    os.makedirs(src)
    _make_video(src)
    reports = []
    for source in (best, pt):
        report = str(tmp_path / f"report-{len(reports)}.json")
        assert datagen_main(["--keywords", "yes", "no", "--input_dir", src, "--out_dir", str(tmp_path / "clips"),
                             "--eval_checkpoint", source, "--device", "cpu", "--report_json", report]) == 0
        with open(report) as f:
            reports.append(json.load(f))
    capsys.readouterr()
    assert reports[0] == reports[1] and reports[0]["verdicts"]
