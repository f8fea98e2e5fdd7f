"""The ``fl_rounds`` path (the paper CNN; no cell yet, PERF.md §7) on the
CPU at a small size: a whole run (set-up,
window, check) is correct, its traced run reads the per-layer metrics,
and with the timed path broken underneath (``faults.py``) it is not; the
traffic copy draws what the program's generator draws."""
import time

import numpy as np
import pytest

from bench import core, faults
from bench.conftest import small_cell

CELLS = ("permfl_full", "permfl_topk_ef")


def test_image_traffic_is_the_programs_generator():
    from repro_torch.scenarios.spec import DataSpec
    from bench.traffic import fl_images

    cell = small_cell("paper-cnn", "permfl_full", 1, full=True)
    got = fl_images.federation(cell.config["federation"], 1)
    want = DataSpec(dataset="fmnist").build(1)
    for k in ("train_x", "train_y", "val_x", "val_y"):
        np.testing.assert_array_equal(got[k], getattr(want, k))


@pytest.mark.parametrize("traffic", CELLS)
def test_a_sound_run_is_correct(traffic):
    cell = small_cell("paper-cnn", traffic, 3000000019)
    res = core.run(cell, seconds=0.2, trace=False, t0=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= cell.config["rounds"] and res["failed"] == 0
    assert res["metrics"]["fl_rounds_per_s"]["value"] > 0
    res = core.run(cell, seconds=0.2, trace=True, t0=time.perf_counter())
    assert res["correct"] and res["metrics"]["fl_eval_ms"]["value"] > 0
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("traffic", CELLS)
def test_a_broken_step_is_caught(traffic, fault):
    cell = small_cell("paper-cnn", traffic, 11)
    undo = faults.plant("fl_rounds", fault)
    try:
        res = core.run(cell, seconds=0.1, trace=False,
                       t0=time.perf_counter())
    finally:
        undo()
    assert not res["correct"], res["checks"]
