"""The port's profiling hooks (``honk_tpu_torch.metrics.profiling``) and ``--profile-dir``, on the CPU.

Counterpart of ``honk_tpu.metrics.profiling``: ``trace_to`` with a falsy
directory does nothing (as ``jax.profiler``'s wrapper), and the training
CLI's ``--profile-dir`` writes ``torch.profiler`` traces of the first train
dispatch and the first dev eval that hold the loop's ``annotate`` ranges.
On the card the same traces also hold the three kernels' CUDA symbols
(``chip_smoke.py``).
"""

import glob
import json
import os

import torch

from honk_tpu.metrics import trace_to as jtrace_to
from honk_tpu_torch.cli.train import main
from honk_tpu_torch.data import generate_dataset
from honk_tpu_torch.metrics import annotate, trace_to
from honk_tpu_torch.metrics.profiling import trace_file


def test_trace_to_falsy_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace_to(log_dir), jtrace_to(log_dir):
            torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_trace_to_writes_annotated_trace(tmp_path):
    with trace_to(str(tmp_path / "t"), "probe"):
        with annotate("probe_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = trace_file(str(tmp_path / "t"), "probe")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "probe_range" in names and any("mm" in str(n) for n in names)


def test_cli_profile_dir_traces_first_dispatch_and_dev_eval(tmp_path, capsys):
    data = str(tmp_path / "sc")
    generate_dataset(data, clips_per_word=4, n_speakers=2, noise_seconds=2)
    prof = str(tmp_path / "prof")
    rc = main(["--type", "train", "--device", "cpu", "--model", "res8-narrow", "--data_dir", data,
               "--batch_size", "16", "--n_epochs", "2", "--lr", "0.01", "--schedule", "--eval_batch_size", "32",
               "--steps_per_call", "2", "--output_dir", str(tmp_path / "ck"), "--profile-dir", prof])
    assert rc == 0 and "final test accuracy:" in capsys.readouterr().out
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(prof, "*"))) == [
        "dev_eval.rank0.pt.trace.json", "train_dispatch.rank0.pt.trace.json"]
    train = [e.get("name") for e in json.load(open(trace_file(prof, "train_dispatch")))["traceEvents"]]
    for name in ("train_step", "assemble", "mfcc", "forward_backward", "update"):
        assert train.count(name) == 2, name  # one dispatch: steps_per_call steps
    assert "eval_batch" not in train
    dev = [e.get("name") for e in json.load(open(trace_file(prof, "dev_eval")))["traceEvents"]]
    assert dev.count("eval_batch") >= 1 and "train_step" not in dev
