"""Port's training loop, checkpoints, data loader and training CLI, on the CPU.

Against the JAX package: ``load_speech_commands`` on one synthetic tree
(arrays, labels and ``n_silence`` equal), the corpus generators (the same
bytes), and ``--type eval`` of the committed ``zoo/res8.pt`` (the same
accuracy as ``python -m honk_tpu.cli.train --type eval``). On its own: the
CLI trains res8-narrow and its loss falls, ``best.pt`` loads in
``LabelService``, a resumed run equals an unbroken one exactly (the same
CPU ops on the same draws from ``(seed + 1, step)``), bf16 runs, flags the
port cannot honour are refused, and nothing of JAX is imported.
"""

import filecmp
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu import data as JD
from honk_tpu.cli.train import main as jmain
from honk_tpu_torch import data as D
from honk_tpu_torch.ckpt import Checkpointer
from honk_tpu_torch.cli.train import main
from honk_tpu_torch.config import DataConfig, ExperimentConfig, TrainConfig
from honk_tpu_torch.metrics import MetricsLogger
from honk_tpu_torch.serve import LabelService
from honk_tpu_torch.train import train

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--model", "res8-narrow", "--batch_size", "32", "--lr", "0.05", "--schedule",
         "--eval_batch_size", "64", "--timeshift_ms", "40", "--noise_prob", "0.1", "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """generate_dataset names files with Python's salted hash(), so its splits
    change from process to process; a child with a fixed hash seed writes the
    same corpus every run (105 / 14 / 14 clips)."""
    root = str(tmp_path_factory.mktemp("sc"))
    code = ("import sys; from honk_tpu_torch.data import generate_dataset; "
            "generate_dataset(sys.argv[1], clips_per_word=12, n_speakers=4, noise_seconds=4)")
    env = {**os.environ, "PYTHONHASHSEED": "0"}
    subprocess.run([sys.executable, "-c", code, root], cwd=ROOT, env=env, check=True, timeout=120)
    return root


def _steps_per_epoch(corpus, batch_size=32):
    n = len(D.load_speech_commands(corpus).train)
    return -(-(n + int(0.1 * n)) // batch_size)


def _final_acc(out: str) -> float:
    return float(out.rsplit("final test accuracy:", 1)[1].split()[0])


def test_load_speech_commands_equals_jax(corpus):
    for kw in ({}, {"unknown_prob": 0.3, "silence_prob": 0.2, "seed": 3}):
        got, want = D.load_speech_commands(corpus, **kw), JD.load_speech_commands(corpus, **kw)
        assert got.label_names == want.label_names
        np.testing.assert_array_equal(got.noise, want.noise)
        for split in ("train", "dev", "test"):
            g, w = getattr(got, split), getattr(want, split)
            assert g.n_silence == w.n_silence and len(g) > 0
            np.testing.assert_array_equal(g.audio, w.audio)
            np.testing.assert_array_equal(g.labels, w.labels)
            assert g.audio.dtype == np.int16 and g.labels.dtype == np.int32


def _same_tree(a: Path, b: Path) -> None:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    _, mismatch, errors = filecmp.cmpfiles(a, b, [str(f) for f in files], shallow=False)
    assert not mismatch and not errors, mismatch + errors


def test_generators_write_the_same_bytes(tmp_path):
    kw = dict(clips_per_word=2, n_speakers=2, noise_seconds=1)
    D.generate_hard_dataset(str(tmp_path / "p_hard"), **kw)
    JD.generate_hard_dataset(str(tmp_path / "j_hard"), **kw)
    _same_tree(tmp_path / "p_hard", tmp_path / "j_hard")
    # generate_dataset names files with the salted hash(): equal within one process.
    D.generate_dataset(str(tmp_path / "p"), **kw)
    JD.generate_dataset(str(tmp_path / "j"), **kw)
    _same_tree(tmp_path / "p", tmp_path / "j")


def test_cli_train_learns_and_writes_best_pt(corpus, tmp_path, capsys):
    out_dir, metrics = tmp_path / "run", tmp_path / "m.jsonl"
    rc = main(["--type", "train", "--data_dir", corpus, "--n_epochs", "5", "--dev_every", "5",
               "--compute_dtype", "float32", "--output_dir", str(out_dir),
               "--metrics_jsonl", str(metrics), *SMALL])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final test accuracy:" in out and 0.0 <= _final_acc(out) <= 1.0
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["loss"] for r in recs if r["kind"] == "train_epoch"]
    assert len(losses) == 5 and losses[-1] < losses[0] * 0.8, losses
    assert [r["kind"] for r in recs][-2:] == ["dev_eval", "final"]
    assert all(r["audio_s_per_s"] > 0 for r in recs if r["kind"] == "train_epoch")
    assert sorted(os.listdir(out_dir)) == ["best.pt", f"step_{5 * _steps_per_epoch(corpus):08d}.pt"]
    svc = LabelService("res8-narrow", str(out_dir / "best.pt"), device="cpu")
    label, prob = svc.evaluate(np.zeros(16000, np.float32))
    assert label in svc.labels and 0.0 < prob <= 1.0


def test_resume_equals_unbroken_run(corpus, tmp_path):
    spe = _steps_per_epoch(corpus)

    def cfg(n_epochs):
        return ExperimentConfig(
            data=DataConfig(data_dir=corpus, noise_prob=0.5, timeshift_ms=40),
            train=TrainConfig(model="res8-narrow", batch_size=32, n_epochs=n_epochs, lr=(0.05, 0.01),
                              schedule=(spe + 1,), dev_every=1, eval_batch_size=64, steps_per_call=2,
                              compute_dtype="float32"),  # the ladder switches in the resumed epoch
        )

    ds = D.load_speech_commands(corpus)
    log = MetricsLogger(stream=open(os.devnull, "w"))
    straight = train(cfg(2), dataset=ds, logger=log, device="cpu")
    train(cfg(1), dataset=ds, logger=log, checkpoint_dir=str(tmp_path), save_every_epochs=1, device="cpu")
    resumed = train(cfg(2), dataset=ds, logger=log, checkpoint_dir=str(tmp_path), device="cpu")
    assert resumed["state"].step == straight["state"].step == 2 * spe
    for (k, a), b in zip(straight["state"].model.state_dict().items(),
                         resumed["state"].model.state_dict().values()):
        assert torch.equal(a, b), k
    bufs = [s["state"].optimizer.state_dict()["state"] for s in (straight, resumed)]
    assert bufs[0].keys() == bufs[1].keys() and len(bufs[0]) == len(list(resumed["model"].parameters()))
    for k, a in bufs[0].items():
        assert torch.equal(a["momentum_buffer"], bufs[1][k]["momentum_buffer"]), k
    assert resumed["best_dev_acc"] == straight["best_dev_acc"]
    assert resumed["test_acc"] == straight["test_acc"]


def test_cli_resumes_its_own_finished_run(corpus, tmp_path):
    """The JAX CLI overwrites its last step checkpoint with a params-only tree,
    so a second run into the same --output_dir cannot resume; the port's final
    step checkpoint is a full resume payload."""
    out_dir, metrics = tmp_path / "run", tmp_path / "m.jsonl"
    argv = ["--type", "train", "--data_dir", corpus, "--output_dir", str(out_dir),
            "--metrics_jsonl", str(metrics), "--compute_dtype", "float32", *SMALL]
    assert main([*argv, "--n_epochs", "1"]) == 0
    assert main([*argv, "--n_epochs", "2"]) == 0
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    spe = _steps_per_epoch(corpus)
    (resume,) = [r for r in recs if r["kind"] == "resume"]
    assert (resume["epoch"], resume["step"]) == (1, spe)
    assert [r["epoch"] for r in recs if r["kind"] == "train_epoch"] == [0, 1]
    assert sorted(os.listdir(out_dir)) == ["best.pt", f"step_{spe:08d}.pt", f"step_{2 * spe:08d}.pt"]


def test_cli_eval_of_zoo_res8_equals_jax(corpus, capsys):
    args = ["--type", "eval", "--model", "res8", "--data_dir", corpus,
            "--input_file", str(ROOT / "zoo" / "res8.pt"), "--eval_batch_size", "64"]
    assert main([*args, "--device", "cpu"]) == 0
    ours = _final_acc(capsys.readouterr().out)
    assert jmain(args) == 0
    assert ours == _final_acc(capsys.readouterr().out)


def test_cli_train_warm_starts_from_input_file(corpus, tmp_path, capsys):
    """--input_file on --type train loads a honk .pt before training: with 0
    epochs the run scores the checkpoint exactly as --type eval does."""
    pt = str(ROOT / "zoo" / "res8-narrow.pt")
    assert main(["--type", "eval", "--data_dir", corpus, "--input_file", pt, *SMALL]) == 0
    want = _final_acc(capsys.readouterr().out)
    assert main(["--type", "train", "--data_dir", corpus, "--input_file", pt, "--n_epochs", "0",
                 "--output_dir", str(tmp_path), *SMALL]) == 0
    assert _final_acc(capsys.readouterr().out) == want > 0.5


def test_cli_bf16_trains_with_finite_loss(corpus, tmp_path):
    metrics = tmp_path / "m.jsonl"
    assert main(["--type", "train", "--data_dir", corpus, "--n_epochs", "1", "--output_dir",
                 str(tmp_path / "run"), "--metrics_jsonl", str(metrics), *SMALL]) == 0  # bf16 default
    (epoch,) = [json.loads(r) for r in metrics.read_text().splitlines() if '"train_epoch"' in r]
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["acc"])


def test_cli_without_device_raises_without_cuda(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--type", "train", "--data_dir", corpus, "--output_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # refused before any work


_COORD = ["--coordinator", "localhost:1234"]


@pytest.mark.parametrize("flags,item", [
    (_COORD, "needs --num-processes and --process-id"),
    (["--process-id", "0"], "need --coordinator"),
    (["--num-processes", "2"], "need --coordinator"),
    (["--n_devices", "4", *_COORD, "--num-processes", "2", "--process-id", "0"], "--n_devices 4"),
    ([*_COORD, "--num-processes", "2", "--process-id", "2"], "not a rank"),
    (["--input_file", "ckpts/run"], "is neither a .pt file nor an Orbax checkpoint directory"),
])
def test_cli_refuses_what_the_port_cannot_honour(flags, item, capsys, monkeypatch):
    """Data parallel and --profile-dir are ported; a malformed multi-process
    command line, and an --input_file that is neither a .pt nor an Orbax
    checkpoint, are refused before any work (with tensorstore hidden: the
    port reads Orbax without it)."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # import tensorstore raises ImportError
    with pytest.raises(SystemExit) as e:
        main(["--type", "train", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_checkpointer_atomic_latest_and_errors(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore_latest() is None
    ck.save_step(3, {"w": torch.ones(2, 3), "epoch": 0})
    ck.save_step(12, {"w": torch.zeros(2, 3), "epoch": 1})
    (tmp_path / "step_00000099.pt.tmp-123").write_bytes(b"half a file")  # a write cut short
    step, tree = ck.restore_latest({"w": torch.empty(2, 3), "epoch": 0})
    assert step == 12 and tree["epoch"] == 1 and torch.equal(tree["w"], torch.zeros(2, 3))
    with pytest.raises(RuntimeError, match="different run's checkpoints") as e:
        ck.restore_latest({"w": torch.empty(4, 3), "epoch": 0})
    assert "mismatched array shapes" in str(e.value.__cause__)
    ck.save_best({"conv0.weight": torch.ones(1), "bn1.num_batches_tracked": torch.tensor(0)})
    assert set(torch.load(tmp_path / "best.pt", weights_only=True)) == {"conv0.weight"}
    orbax = tmp_path / "orbax"
    (orbax / "step_00000005").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="Orbax"):
        Checkpointer(str(orbax)).latest_step()


def test_port_runtime_imports_no_jax():
    import honk_tpu_torch

    modules = sorted(m.name for m in pkgutil.walk_packages(honk_tpu_torch.__path__, "honk_tpu_torch."))
    assert {"honk_tpu_torch.train.loop", "honk_tpu_torch.cli.train", "honk_tpu_torch.ops.assemble_kernel",
            "honk_tpu_torch.data.synthetic", "honk_tpu_torch.ckpt.checkpoint"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'honk_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
