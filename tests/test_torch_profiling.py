"""The port's profiling hooks (``honk_tpu_torch.metrics.profiling``) and ``--profile-dir``, on the CPU.

Counterpart of ``honk_tpu.metrics.profiling``: ``trace_to`` with a falsy
directory does nothing (as ``jax.profiler``'s wrapper), and the training
CLI's ``--profile-dir`` writes ``torch.profiler`` traces of the first train
dispatch and the first dev eval that hold the loop's ``annotate`` ranges.
On the card the same traces also hold the three kernels' CUDA symbols
(``chip_smoke.py``). ``annotate`` is one shared null context unless a
profiler runs; under one, a bf16 train step, an eval forward and
``stream_file`` hold the spans the benchmark's readers read.
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


# A res15-shaped model at a width the CPU runs in a moment: dilated, no pool, BN after every conv but conv0.
SMALL_RES15 = {"n_feature_maps": 4, "n_layers": 4, "use_dilation": True, "n_labels": 12}


def _span_names(prof) -> list[str]:
    return [e.name for e in prof.events()]


def _small_res15(dtype=None):
    from honk_tpu_torch.models import SpeechResModel

    torch.manual_seed(0)
    return SpeechResModel(SMALL_RES15, dtype=dtype)


def test_annotate_is_a_shared_null_context_unless_a_profiler_runs():
    from contextlib import nullcontext

    from torch.autograd.profiler import record_function
    from torch.profiler import profile

    off = annotate("probe_range")
    assert isinstance(off, nullcontext) and annotate("another_range") is off
    with off:  # re-entrant, like every null context
        with annotate("nested"):
            pass
    with profile() as prof:
        on = annotate("probe_range")
        assert isinstance(on, record_function)
        with on:
            torch.ones(3).sum()
    assert _span_names(prof).count("probe_range") == 1
    assert annotate("probe_range") is off


def test_a_traced_bf16_train_step_holds_bn_and_weight_gradient_spans():
    from torch.profiler import profile

    from honk_tpu_torch.data import AugmentConfig
    from honk_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    model = _small_res15(torch.bfloat16)
    tx = make_optimizer(lrs=(0.01,), boundaries=())
    state = create_train_state(model, tx)
    step = make_train_step(tx, 4, AugmentConfig())
    g = torch.Generator().manual_seed(1)
    audio, labels = torch.rand(4, 16000, generator=g) * 0.2 - 0.1, torch.randint(0, 12, (4,), generator=g)
    with profile() as prof:
        for _ in range(2):
            step.apply_batch(state, audio, labels)
    names = _span_names(prof)
    n_convs = SMALL_RES15["n_layers"] + 1
    assert names.count("bn_forward") == names.count("bn_backward") == 2 * SMALL_RES15["n_layers"]
    assert names.count("conv_weight_grad") == 2 * n_convs
    assert names.count("mfcc") == names.count("forward_backward") == 2


def test_a_traced_stream_file_holds_its_copy_forward_and_detect_spans():
    from torch.profiler import profile

    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.stream import stream_file

    model = _small_res15().eval()
    audio = torch.rand(32000, generator=torch.Generator().manual_seed(2)).numpy() * 0.2 - 0.1
    cfg = StreamConfig()
    untraced = stream_file(model, None, audio, cfg)
    with profile() as prof:
        traced = stream_file(model, None, audio, cfg)
    names = _span_names(prof)
    for name in ("stream_copy", "stream_forward", "stream_detect", "eval_forward"):
        assert names.count(name) == 1, name
    assert (traced[0] == untraced[0]).all() and traced[1] == untraced[1]


def test_an_eval_forward_holds_the_gather_mfcc_and_forward_spans():
    from torch.profiler import profile

    from honk_tpu_torch.data import eval_batch
    from honk_tpu_torch.frontend import compute_mfccs
    from honk_tpu_torch.models import SpeechResModel, find_config

    clips = torch.randint(-3000, 3000, (5, 16000), dtype=torch.int16, generator=torch.Generator().manual_seed(3))
    labels = torch.arange(5)
    for model in (_small_res15(torch.bfloat16).eval(),
                  SpeechResModel(find_config("res8-narrow")).eval()):  # res8's eval forward: the res stack
        with profile() as prof, torch.no_grad():
            audio, _, valid = eval_batch(clips, labels, 0, 8)
            model(compute_mfccs(audio))
        names = _span_names(prof)
        assert [names.count(n) for n in ("eval_gather", "mfcc", "eval_forward")] == [1, 1, 1]
        assert valid.tolist() == [True] * 5 + [False] * 3
