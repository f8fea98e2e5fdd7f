"""The tier round's team and server updates (``repro_torch.kernels.
tier_update``) on the CPU: the wrapper's plain path is the op-by-op form
the tier round ran before the kernel (``tree_map`` over eqs. 9 and 13) bit
for bit, in float32 and bfloat16, at the phi3 mix's hyperparameters and
another set; it leaves its inputs as they are, one tree passed three
times too; it raises on trees of different structure and leaves of
different type or shape. The kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.tier_update import (tier_update,  # noqa: E402
                                             tier_update_tree)
from repro_torch.train.optim import tree_map  # noqa: E402

# the phi3 mix's (bench/workloads/tier_b*.json) and a set off it
HPARAMS = {"phi3": dict(eta=0.03, lam=0.5, gamma=1.5, beta=0.3),
           "other": dict(eta=0.07, lam=1.3, gamma=0.8, beta=0.45)}
SHAPES = {"embed": (11, 8), "blocks": {"wq": (2, 8, 12), "norm": (2, 8)},
          "scale": ()}


def _tree(gen, dtype, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(gen, dtype, v) for k, v in shapes.items()}
    return torch.randn(shapes, generator=gen).to(dtype)


def _leaves(tree):
    from repro_torch.flat import tree_leaves
    return [p for _, p in tree_leaves(tree)]


def _tree_map_form(w, x, theta, *, eta, lam, gamma, beta):
    """The updates as the tier round ran them before the kernel."""
    c = 1.0 - eta * lam - eta * gamma
    w = tree_map(lambda wl, xl, tb: c * wl + eta * gamma * xl
                 + lam * eta * tb, w, x, theta)
    x = tree_map(lambda xl, wl: (1 - beta * gamma) * xl
                 + beta * gamma * wl, x, w)
    return w, x


@pytest.mark.parametrize("hp", sorted(HPARAMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [None, "torch"])
def test_plain_path_is_the_tree_map_form_bit_for_bit(hp, dtype, mode):
    gen = torch.Generator().manual_seed(3)
    w, x, theta = (_tree(gen, getattr(torch, dtype)) for _ in range(3))
    got = tier_update_tree(w, x, theta, mode=mode, **HPARAMS[hp])
    want = _tree_map_form(w, x, theta, **HPARAMS[hp])
    for g, wt in zip(got, want):
        assert g.keys() == wt.keys()
        for a, b in zip(_leaves(g), _leaves(wt)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("aliased", [False, True])
def test_inputs_are_left_as_they_are(aliased):
    gen = torch.Generator().manual_seed(4)
    trees = [_tree(gen, torch.bfloat16) for _ in range(1 if aliased else 3)]
    w, x, theta = trees * 3 if aliased else trees
    before = [[t.clone() for t in _leaves(tr)] for tr in (w, x, theta)]
    w2, x2 = tier_update_tree(w, x, theta, **HPARAMS["phi3"])
    for tr, was in zip((w, x, theta), before):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(tr), was))
    inputs = {t.data_ptr() for tr in (w, x, theta) for t in _leaves(tr)}
    assert not inputs & {t.data_ptr() for tr in (w2, x2)
                         for t in _leaves(tr)}
    want = _tree_map_form(w, x, theta, **HPARAMS["phi3"])
    for g, wt in zip((w2, x2), want):
        assert all(torch.equal(a, b) for a, b in zip(_leaves(g),
                                                     _leaves(wt)))


def _bad(case):
    """(w, x, theta) trees that do not go together, and the error."""
    gen = torch.Generator().manual_seed(5)
    w, x, theta = (_tree(gen, torch.float32) for _ in range(3))
    if case == "dtype":
        x["embed"] = x["embed"].to(torch.bfloat16)
        return (w, x, theta), TypeError
    if case == "shape":
        theta["blocks"]["wq"] = theta["blocks"]["wq"][:, :, :6]
        return (w, x, theta), ValueError
    if case == "missing leaf":
        del x["scale"]
        return (w, x, theta), ValueError
    if case == "subtree for a leaf":
        theta["embed"] = {"w": theta["embed"]}
        return (w, x, theta), ValueError
    if case == "leaf for a subtree":
        x["blocks"] = x["embed"]
        return (w, x, theta), ValueError
    raise KeyError(case)


@pytest.mark.parametrize("case", ["dtype", "shape", "missing leaf",
                                  "subtree for a leaf", "leaf for a subtree"])
def test_mismatched_trees_raise(case):
    trees, err = _bad(case)
    with pytest.raises(err):
        tier_update_tree(*trees, **HPARAMS["phi3"])


def test_the_kernel_is_refused_off_the_card():
    t = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        tier_update(t, t, t, mode="cuda", **HPARAMS["phi3"])
