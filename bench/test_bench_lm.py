"""The ``lm_tier`` path on the CPU at a small size: the harness's weights
have the program's tree at published widths, a whole run is correct,
with the timed path broken underneath (``faults.py``) it is not, and the
float8 control fails the check; the token copy draws what the program's
generator draws."""
import time

import numpy as np
import pytest
import torch

from bench import core, faults
from bench.conftest import small_cell

CELLS = ("tier_b4_s1024", "tier_b1_s4096")


def test_token_traffic_is_the_programs_generator():
    from repro_torch.data.tokens import zipf_bigram_stream
    from bench.traffic import lm_tokens

    got = lm_tokens.zipf_bigram_stream(np.random.default_rng(5), 32064,
                                       3000, topic=0)
    want = zipf_bigram_stream(np.random.default_rng(5), 32064, 3000,
                              topic=0)
    np.testing.assert_array_equal(got, want)


def test_weights_have_the_programs_tree_at_published_widths():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from bench.reference import phi3

    cell = core.load_cell("phi3_tier_1k", 0, "cpu")
    with FakeTensorMode():
        ours = phi3.nest(phi3.init_params(cell.config["model"], 0, "cpu"))
    theirs = M.param_specs(get_config(cell.config["program_config"]))
    flat = lambda t, p="": {  # noqa: E731
        f"{p}{k}": v for k, v in t.items() if not isinstance(v, dict)} | {
        q: w for k, v in t.items() if isinstance(v, dict)
        for q, w in flat(v, f"{p}{k}/").items()}
    assert {k: tuple(v.shape) for k, v in flat(ours).items()} == \
        {k: tuple(v.shape) for k, v in flat(theirs).items()}
    assert sum(v.numel() for v in flat(theirs).values()) == \
        cell.config["parameters"]


@pytest.mark.parametrize("traffic", CELLS)
def test_a_sound_run_is_correct(traffic):
    cell = small_cell("phi3-mini-3.8b", traffic, 3000000021)
    res = core.run(cell, seconds=0.2, trace=False, t0=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["metrics"]["lm_tokens_per_s"]["value"]
    res = core.run(cell, seconds=0.2, trace=True, t0=time.perf_counter())
    assert res["correct"] and res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("traffic", CELLS)
def test_a_broken_step_is_caught(traffic, fault):
    cell = small_cell("phi3-mini-3.8b", traffic, 13)
    undo = faults.plant("lm_tier", fault)
    try:
        res = core.run(cell, seconds=0.1, trace=False,
                       t0=time.perf_counter())
    finally:
        undo()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_float8_control_fails(seed):
    cell = small_cell("phi3-mini-3.8b", "tier_b4_s1024", seed)
    path = core.load("paths", "lm_tier").Path(cell)
    path.inputs()
    with torch.no_grad():
        checks = path.compare(path.reference(control=True),
                              path.reference())
    assert not all(core.passed(c) for c in checks), checks
