"""One compressed PerMFL round of the paper CNN, the port against
``repro.core.permfl.permfl_round`` on ``small_fed_data`` (k_team=2,
l_local=2), per compressor, with full and masked participation and the
reference's uniforms injected. Tolerances and the flipped choices are
handled as in ``tests/test_torch_comm.py``.

Sign flips many choices here, each at its boundary. Where a weight's
gradient is exactly zero (dense inputs a ReLU zeroes), its team model
ends the K-loop at x up to the rounding of the eq.-9 update, which the
two frameworks round differently (XLA in float32 with fused
multiply-adds, the port from double coefficients). So the WAN message
``w - x`` there is exactly 0 in one and ~1e-10 in the other, and sign
sends 0 against +-scale."""
import pytest

pytest.importorskip("torch")

from test_torch_comm import (COMPRESSORS, DEVICE_MASK, TEAM_MASK,  # noqa
                             TOL_1, assert_state_close, run_both)


@pytest.fixture(scope="module")
def cnn_rounds(small_fed_data):
    cache = {}

    def get(compressor, masked):
        key = (compressor, masked)
        if key not in cache:
            masks = (TEAM_MASK, DEVICE_MASK) if masked else None
            cache[key] = run_both("cnn", small_fed_data, 1, compressor,
                                  masks)
        return cache[key]
    return get


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masks"])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_cnn_round_matches_jax(cnn_rounds, compressor, masked):
    state, jstate, flips = cnn_rounds(compressor, masked)
    assert state.round == int(jstate.round) == 1
    assert_state_close(state, jstate, TOL_1, flips)
