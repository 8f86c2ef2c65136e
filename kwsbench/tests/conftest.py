"""Tests of the benchmark harness. Those that need an NVIDIA card carry the ``chip`` marker and decide inside
the test whether there is one; the rest rehearse every cell on the CPU at tiny sizes.

The cells are those of ``BENCHMARK.json``. Each has a rehearsal file,
``kwsbench/rehearse/<cell>.json``: the ``config`` and ``traffic`` keys that
shrink it to a size the CPU runs in seconds (narrower, shallower and fewer
than the cell; widths are cut here only, never in a cell), and the
``faults`` (``kwsbench/faults.py``) the cell can have. So a cell added as
files is rehearsed, checked for JAX and held to its faults and its control
with no test edited.
"""

import json
import os
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cells(root: Path = ROOT, chips: int | None = None) -> list[str]:
    """The cells of ``BENCHMARK.json`` (those on ``chips`` cards, when given)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return sorted(w["name"] for w in bench["workloads"] if chips is None or w["chips"] == chips)


def rehearsal(workload: str, root: Path = ROOT) -> dict:
    """A cell's rehearsal file."""
    return json.loads((root / "kwsbench" / "rehearse" / f"{workload}.json").read_text())


def shrink(workload: str) -> str:
    """The ``--rehearse`` argument of a cell: its rehearsal's sizes."""
    r = rehearsal(workload)
    return json.dumps({"config": r["config"], "traffic": r["traffic"]})


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")


def rehearse(workload: str, *extra: str, seed: int = 2_000_000_021, script: str = "run.py",
             timeout: float = 300) -> subprocess.CompletedProcess:
    """Run a cell's rehearsal on the CPU in a subprocess (one intra-op thread), as the benchmark runs."""
    cmd = [sys.executable, str(ROOT / "kwsbench" / script), "--workload", workload, "--device", "cpu",
           "--rehearse", shrink(workload), *extra]
    if script == "run.py":
        cmd += ["--seed", str(seed), "--seconds", "0.5"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def result_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
