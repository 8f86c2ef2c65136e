"""Each one-card cell on the card, briefly: it runs and is correct. Skips without a card.

    python -m pytest kwsbench/tests -m chip      # on a machine with an NVIDIA H100
"""

import json
import subprocess
import sys

import pytest
from conftest import ROOT, cells


@pytest.mark.chip
@pytest.mark.parametrize("workload", cells(chips=1))
def test_a_one_card_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, str(ROOT / "kwsbench" / "run.py"), "--workload", workload,
                           "--seed", "2000000041", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu" and result["metrics"]["setup_s"]["value"] > 0
