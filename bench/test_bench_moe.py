"""The ``lm_tier_moe`` path and its reference on the CPU: the harness's
weights have the program's tree at published widths, the program's tier
round agrees with ``reference/deepseek_moe.py`` on a small cut (the
loss, each leaf's gradient and the three tiers, with the gates
renormalised or not, with pairs over capacity or none), a whole run is
correct, with the timed path broken underneath (``faults.py``, planted
as ``lm_tier``'s: the same trainer) it is not, and the float8 control
fails the check."""
import time

import pytest
import torch

from bench import core, faults
from bench.conftest import small_cell
from bench.paths.lm_tier import _flat

CONFIG, TRAFFIC = "deepseek-moe-16b", "tier_moe_b4_s1024"
TIER = {"alpha": 0.003, "lam": 0.5, "gamma": 1.5, "eta": 0.03, "beta": 0.3}


def moe_cell(seed, **moe):
    """The cell cut small: 1 dense + 2 MoE layers of width 64 (4 heads of
    16), dense width 160, 8 experts of width 32, top-2, 2 shared,
    vocabulary 256, 2 x 16 tokens, float32 (``small_cell`` shrinks the
    dense widths; the MoE keys here, ``moe`` overriding them)."""
    cell = small_cell(CONFIG, TRAFFIC, seed)
    cell.config["model"].update(num_layers=3, first_dense_layers=1, d_ff=160)
    cell.config["model"]["moe"].update(
        {"num_experts": 8, "num_shared_experts": 2, "top_k": 2,
         "expert_d_ff": 32, **moe})
    return cell


def test_weights_have_the_programs_tree_at_published_widths():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model as M
    from bench.reference import deepseek_moe as ref

    cell = core.load_cell("deepseek_moe_tier_1k", 0, "cpu")
    m = cell.config["model"]
    pcfg = core.load("paths", "lm_tier_moe").Path(cell).program_config()
    with FakeTensorMode():
        ours = ref.init_params(m, 0, "cpu")
    theirs = _flat(M.param_specs(pcfg))
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}
    assert len(theirs) == 25 and theirs[
        "blocks/pos0/moe/router"].dtype == torch.float32
    total = sum(v.numel() for v in theirs.values())
    assert total == cell.config["parameters"] == 4_030_625_792


# (renormalise, capacity factor): the published gates with the cell's
# capacity, renormalised gates, and a capacity of half the mean load
# (most experts drop pairs)
CASES = [(False, 1.25), (True, 1.25), (False, 0.5)]


@pytest.mark.parametrize("renorm,factor", CASES)
def test_tier_round_matches_the_reference(renorm, factor):
    """The program's ``make_tier_round`` (its plain kernels on the CPU)
    against the reference from the same weights and batch, in float32:
    the loss and every leaf's first gradient within 1e-4 relative (plus
    1e-6 of the leaf's largest value), every tier's leaves after the
    round within 1e-5 of their scale: the same sums in another order
    (one-hot einsums against a gather a expert) differ in the last bits
    of float32, a wrong gate or a dropped pair by far more. Every route
    and every drop is the same on both sides."""
    import repro_torch.train.trainer as trainer
    from bench.reference import deepseek_moe as ref

    cell = moe_cell(7, renormalize=renorm, capacity_factor=factor)
    path = core.load("paths", "lm_tier_moe").Path(cell)
    path.inputs()
    m = cell.config["model"]
    tok, tgt = (torch.from_numpy(a[0]) for a in path.host_batches)
    params = ref.init_params(m, 7, "cpu", torch.float32)
    pcfg = path.program_config()

    routes, grads = [], {}

    def on_layer(pre, i, layer):
        for k, g in layer.items():
            grads.setdefault(k, torch.zeros(params[k].shape))[i] = g

    want_loss, rest = ref.loss_and_grads(params, m, tok, tgt, on_layer,
                                         routes=routes)
    grads.update(rest)
    loss, got = trainer.value_and_grad(ref.nest(params), pcfg,
                                       {"tokens": tok, "targets": tgt})
    got = _flat(got)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=0)
    assert set(got) == set(grads)
    for k, g in grads.items():
        torch.testing.assert_close(got[k], g, rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()),
                                   msg=k)
    if factor < 1:
        assert all(n > 0 for _, n in routes)

    hp = {**TIER, "l_local": 2}
    want = ref.tier_round(params, params, params, m, tok, tgt, hp)
    got = trainer.make_tier_round(pcfg, **hp)(
        *(ref.nest(params),) * 3, {"tokens": tok, "targets": tgt})
    torch.testing.assert_close(got[3]["loss"], torch.tensor(want[3]),
                               rtol=1e-4, atol=0)
    for tree, ref_tree in zip(got[:3], want[:3]):
        for k, v in _flat(tree).items():
            scale = float(ref_tree[k].abs().max())
            torch.testing.assert_close(v, ref_tree[k], rtol=0,
                                       atol=1e-5 * scale, msg=k)


def test_the_first_steps_routes_are_recorded_alike():
    """The path's record of the first step's routing (at the seam) and the
    reference's agree on a sound small run: no pair moved, the same drops
    a layer."""
    from bench.paths.lm_tier_moe import routing_line

    cell = moe_cell(11, capacity_factor=0.5)
    path = core.load("paths", "lm_tier_moe").Path(cell)
    path.setup()
    got = path.record["routes"]
    want = path.reference()["routes"]
    assert len(got) == len(want) == 2
    assert [n for _, n in got] == [n for _, n in want]
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(got, want))
    assert "alone [0, 0]" in routing_line(got, want, 8)


def test_a_sound_run_is_correct():
    cell = moe_cell(3000000021)
    assert [m["name"] for m in cell.end_to_end] == [
        "lm_tokens_per_s", "peak_mem_gib", "setup_s"]
    res = core.run(cell, seconds=0.2, trace=False, t0=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["metrics"]["lm_tokens_per_s"]["value"]
    res = core.run(cell, seconds=0.2, trace=True, t0=time.perf_counter())
    assert res["correct"] and res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_step_is_caught(fault):
    cell = moe_cell(13)
    undo = faults.plant("lm_tier", fault)
    try:
        res = core.run(cell, seconds=0.1, trace=False,
                       t0=time.perf_counter())
    finally:
        undo()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_float8_control_fails(seed):
    cell = moe_cell(seed)
    path = core.load("paths", "lm_tier_moe").Path(cell)
    path.inputs()
    with torch.no_grad():
        checks = path.compare(path.reference(control=True),
                              path.reference())
    assert not all(core.passed(c) for c in checks), checks
