"""A run with the timed path broken underneath comes out as not correct,
once for each fault a serving cell can have (``harness/faults.py``): half
of the chunk's frames left out of the detections, and an answer altered
where it is produced (one car's inside count).  The run skips the
harness's look for a card and runs the program's CPU path at a size a
test run holds; the sound run beside them comes out correct.  (A state
left unchanged and an exchange between chips left out are faults of
training and of cells over several chips, which these cells are not.)
On the card the faults were read at the cells' own size
(``tools/readings.py --fault``)."""

import time

import pytest

from benchmark.harness import cell as cell_lib
from benchmark.harness import spec
from benchmark.harness.faults import FAULTS


@pytest.mark.parametrize("workload, fault, correct", [
    ("n_csv_tta_b64", None, True),
    ("n_csv_tta_b64", "half_left_out", False),
    ("n_csv_tta_b64", "count_altered", False),
    ("x_headline_b64", "half_left_out", False),
])
def test_faults_are_not_correct(monkeypatch, workload, fault, correct):
    if fault is not None:
        FAULTS[fault](monkeypatch.setattr)
    cell = spec.load_cell(workload)
    result = cell_lib.run_cell(cell, 99, 0.1, False, time.perf_counter(),
                               device="cpu", chunk=2)
    assert result["correct"] is correct, result["checks"]
