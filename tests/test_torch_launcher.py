"""The rank launcher's heartbeat (``parallel.runtime.launch_local_ranks``), on the CPU.

A rank that neither runs nor exits is what a SIGKILLed NCCL rank whose main
thread is held in the driver looks like to the launcher; on the CPU a
SIGSTOPped rank stands in for it. Each run is a 2-rank gloo ``cli.train``
started through a launcher whose ``HEARTBEAT_TIMEOUT_S`` is cut to
``HEARTBEAT_S`` (the runs take seconds here):

- rank 1 stopped once rank 0 has logged its first epoch: the launcher
  returns non-zero within ``HEARTBEAT_S + EXIT_WAIT_S``, says which rank
  was silent, and leaves no rank process;
- a healthy run that lasts longer than ``HEARTBEAT_S`` is not ended by it.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

import torch_resume as R
from torch_ranks import child_pids, rank_env
from honk_tpu_torch.parallel.runtime import EXIT_WAIT_S

HEARTBEAT_S = 20.0
RUN_LIMIT_S = 240  # each test's own limit on its launcher
# The launcher of cli.train --n_devices 2, with the heartbeat's timeout cut to argv[1].
LAUNCHER = ("import sys; from honk_tpu_torch.parallel import runtime; runtime.HEARTBEAT_TIMEOUT_S = float(sys.argv[1]); "
            "from honk_tpu_torch.cli import train; sys.exit(train.main(sys.argv[2:]))")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("launcher") / "sc")
    R.write_corpus(data, "0", rank_env(), RUN_LIMIT_S)
    return data


def _launch(corpus: str, out: str, epochs: int) -> subprocess.Popen:
    cli = R.port_cli(corpus, "float32", out, epochs, 2)
    assert cli[1:3] == ["-m", "honk_tpu_torch.cli.train"]
    return subprocess.Popen([sys.executable, "-c", LAUNCHER, str(HEARTBEAT_S), *cli[3:]], env=rank_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _end(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        for pid in child_pids(proc.pid):
            os.kill(pid, signal.SIGKILL)
        proc.kill()
        proc.communicate()


def test_a_stopped_rank_ends_the_run_and_leaves_no_rank_behind(corpus, tmp_path):
    proc = _launch(corpus, str(tmp_path / "out"), 500)
    ranks, log = {}, []
    try:
        for line in proc.stdout:
            log.append(line)
            if line.startswith("[train_epoch]"):
                break
        ranks = child_pids(proc.pid)
        assert len(ranks) == 2, (ranks, "".join(log))
        victim = next(pid for pid, c in ranks.items() if c.endswith("--process-id 1"))
        t0 = time.monotonic()
        os.kill(victim, signal.SIGSTOP)
        log.append(proc.communicate(timeout=HEARTBEAT_S + EXIT_WAIT_S)[0])
        took = time.monotonic() - t0
    finally:
        _end(proc)
    text = "".join(log)
    assert proc.returncode != 0, text
    assert took < HEARTBEAT_S + EXIT_WAIT_S, took
    assert f"rank 1 (process {victim}) has not beaten" in text, text[-3000:]
    assert not any(os.path.exists(f"/proc/{pid}") for pid in ranks), ranks
    assert "final test accuracy" not in text


def test_a_healthy_run_outlasting_the_heartbeat_timeout_is_not_ended(corpus, tmp_path):
    proc = _launch(corpus, str(tmp_path / "out"), 150)
    t0 = time.monotonic()
    try:
        log = proc.communicate(timeout=RUN_LIMIT_S)[0]
    finally:
        _end(proc)
    took = time.monotonic() - t0
    assert proc.returncode == 0, log[-3000:]
    assert "has not beaten" not in log and "final test accuracy" in log
    assert took > HEARTBEAT_S, f"the run took {took:.1f} s: too short to show the beat"
