"""The port's forward-decomposition tools against the JAX package, on the CPU.

Every leg on weights carried across from flax (``from_flax_variables``),
at the reference's gates:

- ``cli.microbench`` (``scripts/tpu_microbench.py``): ``frontend_jnp``
  (``mfcc_plain``) and ``frontend_pallas`` (the MFCC kernel's wrapper)
  within 2e-5 of ``honk_tpu.frontend.mfcc.compute_mfccs``; the model
  alone and the full forward (float32) within 2e-4 of flax's ``apply``;
  each link the reference's ``|out[0, 0(, 0)]| + 1``.
- ``cli.prof_fwd`` (``prof_fwd2.py``): ``xla`` and ``pmfcc`` within 2e-4
  of flax's ``apply`` on XLA's and on the Pallas MFCC (interpret mode);
  ``mfcc_only`` and ``pmfcc_only`` within 2e-5 of theirs; ``mk`` (the res
  stack's ``bfloat16`` mode) against JAX's ``res_forward_fused`` in
  interpret mode at ``tests/test_torch_bf16.py``'s gate for it (1e-3,
  argmax equal).
- ``cli.bench_res_kernel`` (``scripts/bench_res_kernel.py``): the ``xla``
  leg (``_folded_stack`` in bf16) and the model's own forward against
  flax's bf16 ``apply`` within NO_KERNEL_ATOL (1e-4), argmax equal; the
  ``fused`` leg against JAX's ``res_forward_fused`` as above; and the
  ``fused`` leg against the ``xla`` leg at the reference's bf16 gate
  (``tests/test_res_kernel.py``: atol and rtol 0.05), the check
  ``chip_smoke.py`` makes on the card.
- Each of the nine new tools at tiny knobs with ``--device cpu`` prints the
  reference's line format or JSON keys (listed here from the reference's
  source), and raises without ``--device cpu`` (there is no card here).
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.frontend.mfcc import compute_mfccs as jcompute_mfccs
from honk_tpu.models import find_config as jfind_config
from honk_tpu.ops import compute_mfccs_pallas
from honk_tpu.ops.res_kernel import res_forward_fused as jres_forward_fused
from honk_tpu_torch.cli import (bench, bench_res_kernel, hard_probe, make_corpus, microbench, prof_fwd, prof_res15,
                                prof_res15_dispatch, prof_res15_parts, prof_train)
from test_torch_bf16 import _apply, _flax, _port

FRONTEND_ATOL = 2e-5
LOGIT_ATOL = 2e-4
NO_KERNEL_ATOL = 1e-4
PLAIN_MAX = 1e-3  # tests/test_torch_bf16.py: the bf16 fused forward against JAX's
BF16_GATE = dict(atol=0.05, rtol=0.05)  # tests/test_res_kernel.py's bf16 gate
CPU = torch.device("cpu")
B = 4

# scripts/bench_res_kernel.py:97-106
RK_KEYS = ["model", "batch", "xla_ms_per_batch", "fused_ms_per_batch", "xla_audio_s_per_s", "fused_audio_s_per_s",
           "speedup_fused_over_xla", "compile_s", "device"]
# scripts/prof_res15.py:82-236 (in insertion order)
RES15_KEYS = ["batch", "device", "conv45_fwd_ms_by_dilation", "conv45_fwdbwd_ms_by_dilation",
              "conv45_fwdbwd_implied_tflops_by_dilation", "conv_fwd_ms_by_maps_d1", "bn_residual_ms", "res15_fwd_ms",
              "res15_train_step_ms", "conv45_implied_tflops_by_dilation", "res15_train_implied_tflops"]
# scripts/prof_res15_parts.py:78-147
PARTS_KEYS = ["batch", "device", "full_grad_train_bn_ms", "full_grad_eval_bn_ms", "convstack13_grad_ms"]
# scripts/prof_res15_dispatch.py:75-209
DISPATCH_KEYS = ["batch", "model", "device", "scan_carry_ms_per_step", "step_dispatch_ms_per_step",
                 "auto_layout_nondefault_leaves", "auto_layout_total_leaves", "step_dispatch_auto_layout_ms_per_step",
                 "speedup_step_vs_scan", "speedup_auto_vs_scan", "train_audio_s_per_s_scan",
                 "train_audio_s_per_s_step", "train_audio_s_per_s_auto"]
AUTO_KEYS = [k for k in DISPATCH_KEYS if "auto" in k]  # XLA's layout choice: no counterpart, null
# scripts/hard_probe.py:76, :116-125
PROBE_KEYS = {"generated": ["variant", "generated_s"],
              "epoch": ["variant", "model", "epoch", "loss", "train_acc", "dev_acc", "wall_s"],
              "summary": ["variant", "model", "knobs", "dev_curve", "final_dev", "best_dev"]}
# scripts/make_corpus.py:49 (the CORPUS.json recipe) and :57
EASY_KEYS = ["generator", "root", "seed", "clips_per_word", "n_speakers"]
# scripts/tpu_microbench.py:82; prof_fwd2.py:36-47; prof_train.py:153-157
MICRO_LINE = re.compile(r"^ *(\S+): +\d+\.\d{3} ms/batch +[\d,]+ audio-s/s$")
FWD_LINES = [re.compile(r"^compile short \d+\.\ds$"),
             re.compile(r"^compile long \d+\.\ds$")] + [
    re.compile(rf"^  rep {r}: short=\d+\.\d{{3}}s long=\d+\.\d{{3}}s marginal=-?\d+\.\d{{3}}ms$") for r in range(3)]
TRAIN_LINE = re.compile(r"^(\w+): B=(\d+) per-step \d+\.\d{3} ms -> [\d,]+ audio-s/s$")
# Chains long enough, and reps enough, that a loaded CPU still gives a positive marginal.
TINY_RES15 = ["--batch", "2", "--reps", "3", "--short", "1", "--long", "8", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small tensors one op at a time: OpenMP workers would spin against the other test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def short_chains(monkeypatch):
    """Chains of 2 and 16 links, and a small corpus, in every tool that fixes them."""
    for mod in (microbench, prof_fwd, prof_train, bench_res_kernel):
        monkeypatch.setattr(mod, "CHAINS", (2, 16))
    monkeypatch.setattr(prof_train, "N_CLIPS", 16)
    monkeypatch.setattr(prof_train, "MODEL", "res8-narrow")
    monkeypatch.setattr(prof_fwd, "BATCH", 2)


def _jfused(conf, variables, feats):
    return np.asarray(jres_forward_fused(variables, jfind_config(conf), jnp.asarray(feats), B_blk=4,
                                         compute_dtype=jnp.bfloat16, interpret=True))


def _held_fused(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= PLAIN_MAX


def test_marginal_calls_each_leg_hook_around_the_leg_and_its_untimed_chains(monkeypatch):
    """``bench.LEG_HOOKS`` brackets one ``marginal`` call: what runs between
    "begin" and "end" is (1 + reps) chains of each length (chip_smoke.py's
    links a leg)."""
    events, links = [], []
    monkeypatch.setattr(bench, "LEG_HOOKS", [lambda *a: events.append((a, sum(links)))])

    def run(length, seed):
        links.append(length)
        return length * 1e-3 + seed

    bench.marginal(run, (2, 6), 3)
    assert events == [(("begin", (2, 6), 3), 0), (("end", (2, 6), 3), (1 + 3) * (2 + 6))]


def test_each_timed_leg_of_a_tool_is_one_marginal_call(short_chains, monkeypatch, capsys):
    legs = []
    monkeypatch.setattr(bench, "LEG_HOOKS", [lambda phase, lens, reps: legs.append(phase)])
    assert microbench.main([str(B), "res8-narrow", "--device", "cpu"]) == 0
    assert legs == ["begin", "end"] * 4


# --- microbench -------------------------------------------------------------


@pytest.mark.parametrize("leg", ["frontend_jnp", "frontend_pallas", "model_only", "full_fwd"])
def test_microbench_legs_match_the_jax_functions(leg):
    conf = "res8-narrow"
    variables = _flax(conf)
    audio, feats = microbench.make_inputs(B, CPU)
    legs = microbench.make_legs(_port(conf, variables), conf, audio, feats)
    label = leg if leg.startswith("frontend") else f"{conf}_{leg}"
    fn, x = legs[label]
    assert x is (feats if leg == "model_only" else audio)
    if leg.startswith("frontend"):
        want, atol = np.asarray(jcompute_mfccs(jnp.asarray(x.numpy()))), FRONTEND_ATOL
    elif leg == "model_only":
        want, atol = _apply(conf, variables, x.numpy(), None), LOGIT_ATOL
    else:
        want, atol = _apply(conf, variables, jcompute_mfccs(jnp.asarray(x.numpy())), None), LOGIT_ATOL
    with torch.no_grad():
        got = fn(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    c = torch.tensor(0.5)
    link = microbench.make_link(fn, x)(0, c)
    with torch.no_grad():
        first = fn(x + c * 1e-12).reshape(B, -1)[0, 0]
    assert float(link) == float(first.abs() + 1.0)


# --- prof_fwd ---------------------------------------------------------------


@pytest.mark.parametrize("leg", prof_fwd.LEGS)
def test_prof_fwd_legs_match_the_jax_functions(leg):
    conf = "res8-narrow"
    variables = _flax(conf, seed=1)
    audio = prof_fwd.make_audio(B, CPU)
    with torch.no_grad():
        got = prof_fwd.make_forwards(_port(conf, variables))[leg](audio).numpy()
    a = jnp.asarray(audio.numpy())
    xla_feats, pallas_feats = jcompute_mfccs(a), compute_mfccs_pallas(a, interpret=True)
    if leg == "mk":
        _held_fused(got, _jfused(conf, variables, xla_feats))
        return
    want, atol = {
        "xla": (_apply(conf, variables, xla_feats, None), LOGIT_ATOL),
        "pmfcc": (_apply(conf, variables, pallas_feats, None), LOGIT_ATOL),
        "mfcc_only": (np.asarray(xla_feats), FRONTEND_ATOL),
        "pmfcc_only": (np.asarray(pallas_feats), FRONTEND_ATOL),
    }[leg]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    link = prof_fwd.make_link(prof_fwd.make_forwards(_port(conf, variables))[leg], audio)
    assert float(link(0, torch.tensor(0.0))) == pytest.approx(float(got.sum()) * 1e-9, rel=1e-5, abs=0)


# --- bench_res_kernel -------------------------------------------------------


@pytest.mark.parametrize("conf", ["res8-narrow", "res8"])
def test_bench_res_kernel_legs_match_flax_and_the_tpu_kernel(conf):
    variables = _flax(conf, seed=2)
    pool = bench_res_kernel.make_pool(B, CPU)
    assert pool.shape == (2048, 101, 40)  # max(2048, 2 B)
    i, acc = 5, torch.tensor(0.25)
    start = (i * B) % (2048 - B)
    feats = (pool[start:start + B] + acc * 1e-12).numpy()
    forwards = bench_res_kernel.make_forwards(_port(conf, variables, torch.bfloat16))
    with torch.no_grad():
        got = {leg: fn(torch.from_numpy(feats)).numpy() for leg, fn in forwards.items()}
    flax_bf16 = _apply(conf, variables, feats, jnp.bfloat16)
    for leg in ("xla", "model"):
        np.testing.assert_allclose(got[leg], flax_bf16, atol=NO_KERNEL_ATOL, rtol=0, err_msg=leg)
        np.testing.assert_array_equal(got[leg].argmax(-1), flax_bf16.argmax(-1))
    _held_fused(got["fused"], _jfused(conf, variables, feats))
    np.testing.assert_allclose(got["fused"], got["xla"], **BF16_GATE)
    np.testing.assert_array_equal(got["fused"].argmax(-1), got["xla"].argmax(-1))
    link = bench_res_kernel.make_link(forwards["xla"], pool, B)
    assert float(link(i, acc)) == pytest.approx(0.25 + float(got["xla"].sum()), abs=1e-4)


# --- every tool's output, and its refusal without a card ---------------------


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_microbench_prints_the_reference_lines(short_chains, capsys):
    assert microbench.main(["2", "res8-narrow", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    labels = [MICRO_LINE.match(line).group(1) for line in lines]
    assert labels == ["frontend_jnp", "frontend_pallas", "res8-narrow_model_only", "res8-narrow_full_fwd"]


def test_bench_res_kernel_prints_the_reference_keys(short_chains, monkeypatch, capsys):
    for k, v in {"RK_MODEL": "res8-narrow", "RK_BATCH": "2", "RK_REPS": "3"}.items():
        monkeypatch.setenv(k, v)
    assert bench_res_kernel.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and re.match(r"^model_eval_ms_per_batch: \d+\.\d{3} \(res8-narrow bf16 model\(feats\)", out[0])
    row = json.loads(out[1])
    assert list(row) == RK_KEYS and list(row["compile_s"]) == ["xla", "fused"]
    assert row["model"] == "res8-narrow" and row["batch"] == 2 and row["device"] == "cpu"
    assert row["xla_ms_per_batch"] > 0 and row["fused_ms_per_batch"] > 0


@pytest.mark.parametrize("leg", prof_fwd.LEGS)
def test_prof_fwd_prints_the_reference_lines(leg, short_chains, capsys):
    assert prof_fwd.main([leg, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    for pattern, line in zip(FWD_LINES, lines):
        assert pattern.match(line), line
    assert re.match(rf"^{leg}: \d+\.\d{{3}} ms/iter \(\d+ audio-s/s\)$", lines[-1]), lines[-1]


@pytest.mark.parametrize("leg", prof_train.LEGS)
def test_prof_train_prints_the_reference_lines(leg, short_chains, capsys):
    assert prof_train.main([leg, "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and FWD_LINES[0].match(lines[0]) and FWD_LINES[1].match(lines[1]), lines
    m = TRAIN_LINE.match(lines[2])
    assert m and m.group(1) == leg and m.group(2) == "2", lines[2]


@pytest.mark.parametrize("tool", ["prof_res15", "prof_res15_parts", "prof_res15_dispatch"])
def test_res15_probes_print_the_reference_keys(tool, tmp_path, capsys):
    mod, keys = {"prof_res15": (prof_res15, RES15_KEYS), "prof_res15_parts": (prof_res15_parts, PARTS_KEYS),
                 "prof_res15_dispatch": (prof_res15_dispatch, DISPATCH_KEYS)}[tool]
    out = tmp_path / "row.json"
    extra = ["--model", "res15-narrow"] if tool == "prof_res15_dispatch" else []
    assert mod.main(TINY_RES15 + extra + ["--out", str(out)]) == 0
    rows = _json_lines(capsys.readouterr().out)
    assert len(rows) == 1 and list(rows[0]) == keys and rows[0]["batch"] == 2 and rows[0]["device"] == "cpu"
    assert json.loads(out.read_text()) == rows[0]
    row = rows[0]
    times = [v for k, v in row.items() if k.endswith("_ms") or k.endswith("_ms_per_step")]
    times += [t for k, v in row.items() if k.endswith(("_by_dilation", "_d1")) and "tflops" not in k
              for t in v.values()]
    if tool == "prof_res15":
        assert list(row["conv45_fwd_ms_by_dilation"]) == ["1", "2", "4", "8", "16"]
        assert list(row["conv_fwd_ms_by_maps_d1"]) == ["45", "64", "128"]
    if tool == "prof_res15_dispatch":
        assert all(row[k] is None for k in AUTO_KEYS) and row["model"] == "res15-narrow"
        times = [t for t in times if t is not None]
    assert times and all(t > 0 for t in times)


def test_prof_res15_dispatch_refuses_a_short_chain_not_below_the_long():
    with pytest.raises(SystemExit, match="need 0 < --short"):
        prof_res15_dispatch.main(["--short", "4", "--long", "4", "--device", "cpu"])


def test_hard_probe_prints_the_reference_lines(tmp_path, capsys):
    argv = ["--epochs", "2", "--batch", "8", "--clips_per_word", "2", "--n_speakers", "2", "--models", "res8-narrow",
            "--variants", '[{}, {"snr_db": [0, 12]}]', "--root", str(tmp_path / "probe"), "--device", "cpu"]
    assert hard_probe.main(argv) == 0
    rows = _json_lines(capsys.readouterr().out)
    kinds = ["generated", "epoch", "epoch", "summary"] * 2
    assert [list(r) for r in rows] == [PROBE_KEYS[k] for k in kinds]
    assert [r["variant"] for r in rows] == [0] * 4 + [1] * 4
    assert rows[7]["knobs"] == {"snr_db": [0, 12]} and len(rows[7]["dev_curve"]) == 2
    assert rows[3]["final_dev"] == rows[3]["dev_curve"][-1] and all(0 <= r["dev_acc"] <= 1 for r in rows[1:3])
    assert hard_probe.main(argv) == 0  # the corpora are there: nothing generated
    assert [list(r) for r in _json_lines(capsys.readouterr().out)] == [PROBE_KEYS[k] for k in kinds if k != "generated"]


@pytest.mark.parametrize("tool", ["microbench", "bench_res_kernel", "hard_probe", "make_corpus", "prof_fwd",
                                  "prof_train", "prof_res15", "prof_res15_parts", "prof_res15_dispatch"])
def test_tools_raise_without_a_card(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"microbench": [], "bench_res_kernel": [], "hard_probe": ["--root", str(tmp_path / "p")],
            "make_corpus": [str(tmp_path / "c")], "prof_fwd": ["xla"], "prof_train": ["full"], "prof_res15": [],
            "prof_res15_parts": [], "prof_res15_dispatch": []}[tool]
    mod = globals()[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not os.listdir(tmp_path)  # refused before any work
