"""The port's scaling harness (``honk_tpu_torch.cli.scaling``) against ``scripts/scaling_bench.py``, and
its launcher's failure paths, on the CPU.

- ``cli.scaling 1 2 --device cpu`` at small knobs (``SCALING_BATCH=2``,
  scans of 1 and 2 steps): one row per size with exactly scaling_bench's
  keys (its CPU rows' two extra included, read from scaling_bench's own
  output), ``scaling_efficiency_vs_1`` the first size's step time over the
  row's, and scaling_bench's clips and noise;
- a step's collectives at 2 gloo ranks against the all-reduces of the JAX
  package's compiled 2-device step (its HLO, as
  ``tests/test_parallel.py::test_dp_step_collective_bytes_match_param_count``
  reads them): one gradient all-reduce of the same parameters and the same
  12 BN-statistic reductions;
- on ``cuda`` a size past the visible cards gives scaling_bench's
  ``skipped`` row and ``cli.train --n_devices`` is refused (the card count
  mocked; nothing falls back);
- a 2-rank ``cli.train`` whose rank 1 dies after rank 0's first epoch
  returns non-zero within ``DEAD_RANK_S`` and leaves no rank behind.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_resume as R
from torch_ranks import REPO, TIMEOUT, child_pids, rank_env
from honk_tpu.data import AugmentConfig as JAugmentConfig
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.parallel import make_data_mesh as jmake_data_mesh
from honk_tpu.parallel import replicate as jreplicate
from honk_tpu.train import create_train_state as jcreate_train_state
from honk_tpu.train import make_optimizer as jmake_optimizer
from honk_tpu.train import make_train_step as jmake_train_step
from honk_tpu_torch.cli import scaling as S
from honk_tpu_torch.models import find_config, find_model

KNOBS = {"SCALING_BATCH": "2", "SCALING_SCAN_SHORT": "1", "SCALING_SCAN_LONG": "2"}
JAX_KEYS = ["n_devices", "global_batch", "step_ms", "audio_s_per_s", "scaling_efficiency_vs_1"]
CPU_KEYS = ["note", "serialized_throughput_frac"]
DEAD_RANK_S = 10


@pytest.fixture(scope="module")
def scaled():
    """``cli.scaling 1 2 --device cpu``: its output and, through a spy on ``run``, every rank's record."""
    mp = pytest.MonkeyPatch()
    for k, v in {**KNOBS, "OMP_NUM_THREADS": "1"}.items():
        mp.setenv(k, v)
    seen = {}
    real_run = S.run

    def spy(sizes, device):
        seen["out"] = real_run(sizes, device)
        return seen["out"]

    mp.setattr(S, "run", spy)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = S.main(["1", "2", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    return {"rc": rc, "rows": rows, "records": [records for _, records in seen["out"]]}


@pytest.fixture(scope="module")
def jax_bench():
    """scaling_bench's own row at 1 device at the same knobs, and the clips and noise it prepared."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import scaling_bench
    import honk_tpu.data as jdata

    mp = pytest.MonkeyPatch()
    for k, v in KNOBS.items():
        mp.setenv(k, v)
    seen = {}
    real = jdata.prepare_train_arrays

    def spy(audio, noise, aug, *a, **kw):
        seen["audio"], seen["noise"] = np.array(audio), np.array(noise)
        return real(audio, noise, aug, *a, **kw)

    mp.setattr(jdata, "prepare_train_arrays", spy)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            scaling_bench.main([1], force_cpu=True)
    finally:
        mp.undo()
    return {"rows": [json.loads(line) for line in buf.getvalue().splitlines()], **seen}


def test_one_row_per_size_with_scaling_benchs_keys(scaled, jax_bench):
    assert scaled["rc"] == 0
    assert [r["n_devices"] for r in scaled["rows"]] == [1, 2]
    assert list(jax_bench["rows"][0]) == JAX_KEYS + CPU_KEYS
    for row in scaled["rows"]:
        assert list(row) == list(jax_bench["rows"][0])
        assert row["global_batch"] == 2 * row["n_devices"]
        assert row["step_ms"] > 0 and rate_within_rounding(row)


def rate_within_rounding(row: dict) -> bool:
    """``audio_s_per_s`` against ``global_batch / step_ms``, within what the row's
    own rounding allows (``cli/scaling.py``): audio_s_per_s is rounded to 0.1,
    so it moves by up to 0.05; step_ms is rounded to 1e-3 ms, so it moves by up
    to 5e-4 ms, and global_batch * 1e3 / step_ms moves by up to
    5e-4 * global_batch * 1e3 / (step_ms - 5e-4) ** 2 audio-s/s with it."""
    b, ms = row["global_batch"], row["step_ms"]
    slack = 0.05 + 5e-4 * b * 1e3 / (ms - 5e-4) ** 2
    return abs(row["audio_s_per_s"] - b / ms * 1e3) <= slack * (1 + 1e-9)


@pytest.mark.parametrize("step_s", [0.002, 0.0123456, 0.1, 2 / 19.449, 0.7345678])
def test_the_rate_gate_allows_the_rows_own_rounding(step_s):
    """Rows rounded as cli/scaling.py rounds them pass the gate at every step
    time; at a long step (2 / 19.449 s: 19.449 audio-s/s, read as 19.4) a gate
    of rel 1e-3 refuses the row's own rounding, which made the test fail when
    a loaded host slowed the gloo step."""
    batch = 2
    row = {"global_batch": batch, "step_ms": round(step_s * 1e3, 3), "audio_s_per_s": round(batch / step_s, 1)}
    assert rate_within_rounding(row)
    if step_s == 2 / 19.449:
        assert row["audio_s_per_s"] != pytest.approx(batch / row["step_ms"] * 1e3, rel=1e-3)


def test_efficiency_is_the_first_sizes_step_time_over_the_rows(scaled):
    first = scaled["rows"][0]["step_ms"]
    for row in scaled["rows"]:
        eff = first / row["step_ms"]
        assert row["scaling_efficiency_vs_1"] == pytest.approx(eff, abs=1e-4)
        assert row["serialized_throughput_frac"] == pytest.approx(eff * row["n_devices"], abs=1e-4)
    assert scaled["rows"][0]["scaling_efficiency_vs_1"] == 1.0


def test_the_clips_and_noise_are_scaling_benchs(jax_bench):
    audio, labels, noise = S.inputs()
    assert np.array_equal(audio, jax_bench["audio"]) and audio.shape == (1024, 16000)
    assert np.array_equal(noise, jax_bench["noise"]) and noise.shape == (160000,)
    assert labels.min() >= 2 and labels.max() < 12


def test_every_rank_runs_every_timed_step_and_counts_no_kernel_on_the_cpu(scaled):
    """Each rank ran the warm-up and both reps of both scans; on the CPU the kernel wrappers run their
    plain versions, so no launch is counted (the card's counts are held by chip_smoke.py phase 35 and
    scripts/chip_train_nccl.py)."""
    for records in scaled["records"]:
        assert [r["rank"] for r in records] == list(range(len(records)))
        for r in records:
            assert r["steps"] == (1 + S.REPS) * (1 + 2) and r["card"] == "cpu"
            assert r["launches"] == {"assemble": 0, "mfcc": 0, "res_stack": 0}, r


def _jax_all_reduce_bytes(n_devices: int, batch: int) -> list[int]:
    """The payload of each all-reduce in the JAX package's compiled data-parallel res8 step."""
    model = jfind_model("res8")(config=jfind_config("res8"))
    tx = jmake_optimizer()
    rng = np.random.default_rng(0)
    audio = rng.integers(-3000, 3000, (16, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (16,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 10) * 0.05).astype(np.float32)
    aug = JAugmentConfig(n_silence=8)
    from honk_tpu.data import prepare_train_arrays

    pool, win = prepare_train_arrays(audio, noise, aug)
    mesh = jmake_data_mesh(n_devices, "data")
    state = jcreate_train_state(model, tx, jax.random.PRNGKey(0))
    step = jmake_train_step(model, tx, batch, aug, donate=False, data_axis="data")
    with jax.set_mesh(mesh):
        txt = step.lower(jreplicate(mesh, state), jax.random.PRNGKey(1),
                         *jreplicate(mesh, (pool, jnp.asarray(labels), win))).compile().as_text()
    payloads = []
    for line in txt.splitlines():
        m = re.match(r"\s*%\S+ = (.*?) all-reduce(?:-start)?\(", line)
        if m:
            payloads.append(sum(4 * int(np.prod([int(d) for d in dims.split(",") if d]))
                                for dims in re.findall(r"f32\[([0-9,]*)\]", m.group(1))))
    return payloads


def test_a_steps_collectives_at_two_ranks_match_the_jax_steps_all_reduces(scaled):
    """One gradient all-reduce of JAX's parameters and JAX's 12 BN reductions: the forward's six with the
    element count the port adds (its sums carry the count), the backward's six the same pair of sums
    (JAX fuses loss and accuracy into the gradient's). The port's are float64, JAX's float32."""
    collectives = scaled["records"][1][0]["collectives"]
    jax_bytes = _jax_all_reduce_bytes(2, 4)
    n_params = sum(p.numel() for p in find_model("res8")(find_config("res8")).parameters())
    assert all(op == "all_reduce" for op, *_ in collectives)
    sizes = [n for _, n, _ in collectives]
    assert sizes.count(n_params) == 1 and 4 * n_params + 8 in jax_bytes
    bn = [n for n in sizes if n not in (n_params, 2)]
    jax_bn = [b for b in jax_bytes if b != 4 * n_params + 8]
    assert len(bn) == len(jax_bn) == 12 and sizes.count(2) == 1  # and the loss and hits
    forward, backward = bn[:6], bn[6:]
    assert sorted([4 * (n - 1) for n in forward] + [4 * n for n in backward]) == sorted(jax_bn)
    assert all(size == 8 for _, n, size in collectives if n != 2)


def test_a_size_past_the_visible_cards_is_skipped(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(S, "run_size", lambda n, device: pytest.fail(f"size {n} ran on {device}"))
    assert S.main(["4", "8"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == [{"n_devices": 4, "skipped": "not enough devices"}, {"n_devices": 8, "skipped": "not enough devices"}]


def test_cli_train_refuses_more_ranks_than_cards(monkeypatch, capsys):
    from honk_tpu_torch.cli import train as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(T, "launch_local_ranks", lambda *a: pytest.fail("ranks were started"))
    with pytest.raises(SystemExit) as e:
        T.main(["--n_devices", "4", "--device", "cuda"])
    assert e.value.code == 2 and "only 2 CUDA devices are visible" in capsys.readouterr().err


def test_a_dead_rank_ends_the_cli_run_and_leaves_no_rank_behind(tmp_path):
    """Rank 1 of a 2-rank cli.train is killed once rank 0 has logged its first epoch: the launcher kills
    rank 0, which would wait for it in a collective, and returns non-zero."""
    data = str(tmp_path / "sc")
    R.write_corpus(data, "0", rank_env(), TIMEOUT)
    cmd = R.port_cli(data, "float32", str(tmp_path / "out"), 50, 2)
    proc = subprocess.Popen(cmd, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = {}
    try:
        log = []
        for line in proc.stdout:
            log.append(line)
            if line.startswith("[train_epoch]"):
                break
        ranks = child_pids(proc.pid)
        assert len(ranks) == 2, (ranks, "".join(log))
        victim = next(pid for pid, c in ranks.items() if c.endswith("--process-id 1"))
        t0 = time.monotonic()
        os.kill(victim, signal.SIGKILL)
        log.append(proc.communicate(timeout=TIMEOUT)[0])
        took = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            for pid in child_pids(proc.pid):
                os.kill(pid, signal.SIGKILL)
            proc.kill()
            proc.communicate()
    assert proc.returncode != 0, "".join(log)
    assert took < DEAD_RANK_S, took
    assert not any(os.path.exists(f"/proc/{pid}") for pid in ranks), ranks
    assert "final test accuracy" not in "".join(log)
