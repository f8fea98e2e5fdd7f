"""On the card, at the configuration's own size: the TF32 control of the
float32 CNN fails the check (the plain reference twice a seed, a few
seconds; the paper CNN's cells wait, PERF.md §7)."""
import pytest
import torch

from bench import core
from bench.conftest import small_cell


@pytest.mark.gpu
@pytest.mark.parametrize("traffic", ["permfl_full", "permfl_topk_ef"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_tf32_control_fails(cuda, seed, traffic):
    cell = small_cell("paper-cnn", traffic, seed, device="cuda", full=True)
    path = core.load("paths", "fl_rounds").Path(cell)
    path.inputs()
    with torch.no_grad():
        checks = path.compare(path.reference(control=True),
                              path.reference())
    assert not all(core.passed(c) for c in checks), checks
