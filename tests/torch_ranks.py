"""Start the ranks of a multi-process test of the port: one subprocess per rank.

Each rank is a child process with ``PYTHONPATH`` at the repository and one
intra-op thread (ranks share the host's cores), waited for with a timeout
and killed by exact PID if it runs past it, so a hang fails the test
instead of eating the suite's time.
"""

import os
import socket
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(cmds: list[list[str]], during=None, returncodes: dict[int, int] | None = None) -> list[str]:
    """Start one process per command and wait for all; their outputs.

    ``during(procs)``, if given, runs while they do. Each process must exit
    0, or with the code ``returncodes`` gives its index.
    """
    procs = [subprocess.Popen(c, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        if during is not None:
            during(procs)
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except BaseException as e:
        for p in procs:
            p.kill()
            p.communicate()
        if isinstance(e, subprocess.TimeoutExpired):
            pytest.fail("ranks timed out")
        raise
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == (returncodes or {}).get(i, 0), f"rank {i} exited {p.returncode}:\n{log[-3000:]}"
    return logs
