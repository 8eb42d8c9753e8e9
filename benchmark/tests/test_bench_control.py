"""The control of the comparison, at a size a test run holds: the
reference put in the program's place and computed one precision below
the configuration's (TF32 for n, fp8 for x) comes out as not correct.  On
the card it was read at the cells' own size (``tools/readings.py
--control``)."""

import time

import pytest

from benchmark.harness import cell as cell_lib
from benchmark.harness import spec


@pytest.mark.parametrize("workload, chunk", [("n_csv_tta_b64", 2),
                                             ("x_headline_b64", 1)])
def test_control_is_not_correct(workload, chunk):
    cell = spec.load_cell(workload)
    result = cell_lib.run_cell(cell, 2024, 0.1, False, time.perf_counter(),
                               device="cpu", chunk=chunk,
                               make_system=cell.family.control_system)
    assert not result["correct"]
    failed = [k for k, v in result["checks"].items()
              if v["value"] > v["limit"]]
    assert set(failed) & {"score_gap", "box_gap_px", "mask_gap",
                          "count_gap"}, failed
