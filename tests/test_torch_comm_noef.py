"""Compressed PerMFL rounds WITHOUT error feedback, the port against
``repro.core.permfl.permfl_round`` with ``CommConfig(c,
error_feedback=False)``: MCLR (1 and 3 rounds; full and masked
participation) and the paper CNN (1 round) on ``small_fed_data``
(k_team=2, l_local=2), with the reference's uniforms injected; and the
byte ledger, ``run_permfl`` and ``run_scenario`` on such configs.

Tolerances and the flipped choices are those of
``tests/test_torch_comm.py``: top-k, int8 and sign replay their choices
on both runs' recorded messages (:class:`Flips`); rand-k chooses on the
injected uniforms alone and is excused nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_comm import (DEVICE_MASK, JL, JP, JPM, J_MCLR,  # noqa: E402
                             TEAM_MASK, TOL_1, TOL_3, JCommConfig,
                             assert_state_close, jax_fns, jax_init,
                             reference_uniforms, run_both)

LOSSY = ["topk", "randk", "int8", "sign"]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masks"])
@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("compressor", LOSSY)
def test_mclr_rounds_without_ef_match_jax(small_fed_data, compressor,
                                          rounds, masked):
    masks = (TEAM_MASK, DEVICE_MASK) if masked else None
    state, jstate, flips = run_both("mclr", small_fed_data, rounds,
                                    compressor, masks, error_feedback=False)
    assert state.round == int(jstate.round) == rounds
    assert float(state.comm.ef_dev.abs().max()) == 0.0
    assert float(state.comm.ef_team.abs().max()) == 0.0
    assert_state_close(state, jstate, TOL_1 if rounds == 1 else TOL_3, flips)


@pytest.mark.parametrize("compressor", LOSSY)
def test_cnn_round_without_ef_matches_jax(small_fed_data, compressor):
    state, jstate, flips = run_both("cnn", small_fed_data, 1, compressor,
                                    None, error_feedback=False)
    assert state.round == int(jstate.round) == 1
    assert_state_close(state, jstate, TOL_1, flips)


@pytest.mark.parametrize("compressor", LOSSY)
def test_ledger_does_not_depend_on_error_feedback(compressor):
    """The byte model prices the wire formats alone: with error feedback
    or without, the port's ledger over the paper CNN's leaves equals the
    reference's non-EF ledger round for round."""
    from repro_torch.comm import CommConfig, CommLedger
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params

    layout = Layout.of(init_params(CNN, torch.Generator().manual_seed(0)))
    ledgers = [CommLedger.for_layout(CommConfig(compressor,
                                                error_feedback=ef), layout)
               for ef in (True, False)]
    jled = JL.CommLedger.for_params(
        JCommConfig(compressor, error_feedback=False), jax_init("cnn"))
    gated = int((DEVICE_MASK * TEAM_MASK[:, None]).sum())
    for ledger in ledgers + [jled]:
        ledger.log_round(k_team=5, n_teams=4, n_devices=40)
        ledger.log_round(k_team=5, n_teams=int(TEAM_MASK.sum()),
                         n_devices=gated)
    want = [dataclasses.astuple(r) for r in jled.rounds]
    for led in ledgers:
        assert [dataclasses.astuple(r) for r in led.rounds] == want
        assert led.summary() == jled.summary()


def test_run_permfl_without_ef_matches_the_reference(small_fed_data):
    """The engine with unbiased rand-k uplinks and the reference's
    uniforms injected: the ledger equals the reference run's byte for
    byte, and the losses and accuracies agree."""
    from repro.train.fl_trainer import run_permfl as j_run
    from repro_torch.comm import CommConfig
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    from repro_torch.core.permfl import PerMFLHParams
    from repro_torch.flat import Layout
    from repro_torch.scenarios.spec import fns_for
    from repro_torch.train.fl_trainer import run_permfl

    fd = small_fed_data
    tr = {"x": fd.train_x, "y": fd.train_y}
    va = {"x": fd.val_x, "y": fd.val_y}
    kw = dict(rounds=2, m=fd.m_teams, n=fd.n_devices)
    jcfg = JCommConfig("randk", k_frac=0.2, error_feedback=False)
    jres = j_run(jax_init("mclr"), jax.tree.map(jnp.asarray, tr),
                 jax.tree.map(jnp.asarray, va), loss_fn=jax_fns("mclr"),
                 metric_fn=lambda p, b: JPM.accuracy(p, J_MCLR, b),
                 hp=JP.PerMFLHParams(k_team=2, l_local=2), comm=jcfg, **kw)
    loss, met = fns_for(MCLR)
    params = jax.tree.map(np.asarray, jax_init("mclr"))
    res = run_permfl(
        params, tr, va, loss_fn=loss, metric_fn=met,
        hp=PerMFLHParams(k_team=2, l_local=2),
        comm=CommConfig("randk", k_frac=0.2, error_feedback=False),
        uniforms=reference_uniforms(0, Layout.of(params).leaf_sizes),
        device="cpu", **kw)
    assert res.comm.summary() == jres.comm.summary()
    assert [dataclasses.astuple(r) for r in res.comm.rounds] == \
        [dataclasses.astuple(r) for r in jres.comm.rounds]
    np.testing.assert_allclose(res.train_loss, jres.train_loss, rtol=1e-4)
    one = 1.0 / fd.val_y.shape[-1]
    np.testing.assert_allclose(res.pm_acc, jres.pm_acc, atol=one + 1e-6)


@pytest.mark.parametrize("compressor", LOSSY)
def test_run_scenario_without_ef_on_cpu(compressor):
    """A comm cell without error feedback at a small size through
    run_scenario with the port's own generator: finite metrics, zero
    residuals and the ledger of the byte model."""
    from repro_torch.comm import (CommConfig, compressed_leaf_bytes,
                                  full_leaf_bytes)
    from repro_torch.scenarios import get_scenario, run_scenario

    s = dataclasses.replace(
        get_scenario("comm/mnist/mclr/int8"),
        comm=CommConfig(compressor, error_feedback=False)).scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 2})
    res = run_scenario(s, rounds=2, device="cpu")
    assert all(np.isfinite(res.pm_acc + res.train_loss))
    sizes = res.state.layout.leaf_sizes
    comp = sum(compressed_leaf_bytes(s.comm, p) for p in sizes)
    full = sum(full_leaf_bytes(p) for p in sizes)
    assert res.comm.total_bytes() == 2 * (2 * (comp + full)
                                          + 2 * 6 * (comp + full))
    assert float(res.state.comm.ef_dev.abs().max()) == 0.0
