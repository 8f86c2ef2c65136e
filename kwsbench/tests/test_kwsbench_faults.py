"""Each fault a cell can have, planted under its timed path, makes ``correct`` come out false; so does the
control, the reference in a lower precision in the program's place. The sound rehearsal of each cell is
correct. At rehearsal sizes on the CPU, against each cell's own limits."""

import pytest
from conftest import cells, rehearsal, rehearse, result_line

# The faults each cell can have, from its rehearsal file.
CASES = [(w, f) for w in cells() for f in rehearsal(w)["faults"]]


@pytest.mark.parametrize("workload", cells())
def test_a_sound_rehearsal_is_correct(workload):
    result = result_line(rehearse(workload, "--trace", "1"))
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check" and result["metrics"]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_a_planted_fault_is_not_correct(workload, fault):
    result = result_line(rehearse(workload, "--fault", fault))
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("workload", cells())
def test_the_control_is_not_correct(workload):
    result = result_line(rehearse(workload, "--control", "int8"))
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("workload", [w for w in cells() if "altered_detection" in rehearsal(w)["faults"]])
def test_a_rehearsal_that_drops_a_detection_has_detections_to_drop(workload):
    sound = rehearse(workload)
    assert result_line(sound)["correct"] is True and " 0 detections" not in sound.stderr
    result = result_line(rehearse(workload, "--fault", "altered_detection"))
    assert result["check"]["detections_mismatched"]["value"] > 0
