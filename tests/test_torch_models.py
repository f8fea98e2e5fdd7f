"""The port's paper models (batched over devices) against the JAX
package's, at the paper widths: apply, loss_fn, accuracy, and the
per-device gradient of one backward of the summed losses against
``jax.vmap(jax.vmap(jax.grad(loss_fn)))``. Parameters come from the JAX
``init_params`` plus numpy noise for each device (so that devices differ
and biases and the MCLR weights are not zero) through
``repro_torch.convert``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.configs.paper_cnn import CONFIG as J_CNN  # noqa: E402
from repro.configs.paper_dnn import CONFIG as J_DNN  # noqa: E402
from repro.configs.paper_mclr import CONFIG as J_MCLR  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402

M, N, B = 2, 2, 8          # 4 devices x 8 samples
RTOL, ATOL = 1e-5, 1e-6
# The CNN's logits end in a 1568-wide f32 dot product, which XLA and
# PyTorch sum in different orders: about sqrt(1568) * 2**-24 * |terms|,
# some 2e-6, apart. Logits near zero then miss ATOL while every other
# output (losses, accuracies, all gradients) holds RTOL/ATOL.
CNN_LOGIT_ATOL = 1e-5


def _port_cfg(kind):
    from repro_torch.configs.paper_cnn import CONFIG as CNN
    from repro_torch.configs.paper_dnn import CONFIG as DNN
    from repro_torch.configs.paper_mclr import CONFIG as MCLR
    return {"mclr": MCLR, "dnn": DNN, "cnn": CNN}[kind]


J_CFG = {"mclr": J_MCLR, "dnn": J_DNN, "cnn": J_CNN}


@pytest.fixture(scope="module", params=["mclr", "dnn", "cnn"])
def case(request):
    """(kind, stacked numpy params (M, N, ...), numpy batch (M, N, B, ...))
    for one model."""
    kind = request.param
    jcfg = J_CFG[kind]
    rng = np.random.default_rng(42)
    params = jax.tree.map(
        lambda l: (np.asarray(l) + 0.01 * rng.standard_normal(
            (M, N) + l.shape)).astype(np.float32), _jax_init(kind))
    x = rng.standard_normal((M, N, B) + tuple(jcfg.input_shape)) \
        .astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, (M, N, B)).astype(np.int32)
    return kind, params, {"x": x, "y": y}


@functools.lru_cache(maxsize=None)
def _jax_init(kind):
    return JPM.init_params(jax.random.PRNGKey(0), J_CFG[kind])


def _port(params, batch):
    """numpy (M, N, ...) trees -> port trees with one device axis."""
    from repro_torch.convert import params_from_numpy

    flat = lambda tr: jax.tree.map(
        lambda l: l.reshape((M * N,) + l.shape[2:]), tr)
    return params_from_numpy(flat(params)), params_from_numpy(flat(batch))


def _vv(fn):
    return jax.jit(jax.vmap(jax.vmap(fn)))


def test_apply_matches_jax(case):
    from repro_torch.models import paper_models as PM

    kind, params, batch = case
    tp, tb = _port(params, batch)
    got = PM.apply(tp, _port_cfg(kind), tb["x"])
    want = _vv(lambda p, x: JPM.apply(p, J_CFG[kind], x))(params,
                                                          batch["x"])
    np.testing.assert_allclose(
        got.numpy().reshape(want.shape), np.asarray(want), rtol=RTOL,
        atol=CNN_LOGIT_ATOL if kind == "cnn" else ATOL)


def test_loss_and_accuracy_match_jax(case):
    from repro_torch.models import paper_models as PM

    kind, params, batch = case
    tp, tb = _port(params, batch)
    cfg = _port_cfg(kind)
    loss = _vv(lambda p, b: JPM.loss_fn(p, J_CFG[kind], b))(params, batch)
    acc = _vv(lambda p, b: JPM.accuracy(p, J_CFG[kind], b))(params, batch)
    np.testing.assert_allclose(PM.loss_fn(tp, cfg, tb).numpy(),
                               np.asarray(loss).reshape(-1),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(PM.accuracy(tp, cfg, tb).numpy(),
                                  np.asarray(acc).reshape(-1))


def test_per_device_grad_matches_jax_vmap_vmap_grad(case):
    """One backward of the summed per-device losses through the flat
    (D, S) buffer gives each device's own gradient."""
    from repro_torch.core.permfl import device_grads
    from repro_torch.flat import Layout
    from repro_torch.models import paper_models as PM

    kind, params, batch = case
    tp, tb = _port(params, batch)
    cfg = _port_cfg(kind)
    layout = Layout.of(jax.tree.map(lambda l: l[0], tp))
    buf = layout.flatten(tp, lead=(M * N,))
    g = device_grads(lambda p, b: PM.loss_fn(p, cfg, b), layout, buf, tb)
    assert g.shape == buf.shape
    assert torch.count_nonzero(g[:, layout.size:]) == 0
    got = layout.unflatten(g.reshape(M, N, -1))
    want = _vv(jax.grad(lambda p, b: JPM.loss_fn(p, J_CFG[kind], b)))(
        params, batch)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL), got, want)


def test_layout_round_trip_and_leaf_order(case):
    """Leaves sit in jax.tree.leaves order; flatten/unflatten round-trip;
    the row is padded to a multiple of 64 with zeros."""
    from repro_torch.flat import ROW_ALIGN, Layout, tree_leaves

    kind, params, _ = case
    tp = jax.tree.map(torch.from_numpy, params)
    layout = Layout.of(jax.tree.map(lambda l: l[0, 0], tp))
    assert [np.asarray(l).shape[2:] for l in jax.tree.leaves(params)] \
        == list(layout.shapes)
    assert [p for p, _ in tree_leaves(tp)] == list(layout.paths)
    assert layout.stride % ROW_ALIGN == 0
    assert layout.size == sum(int(np.prod(s)) for s in layout.shapes)
    buf = layout.flatten(tp, lead=(M, N))
    assert buf.shape == (M, N, layout.stride)
    assert torch.count_nonzero(buf[..., layout.size:]) == 0
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                 layout.unflatten(buf), params)


def test_paper_cnn_size():
    """The paper CNN has 206,922 parameters, as the reference's."""
    from repro_torch.flat import Layout
    from repro_torch.models import paper_models as PM

    p = PM.init_params(_port_cfg("cnn"), torch.Generator().manual_seed(0))
    j = _jax_init("cnn")
    assert Layout.of(p).size == 206_922 == sum(
        int(np.prod(np.shape(l))) for l in jax.tree.leaves(j))
    jax.tree.map(lambda a, b: np.testing.assert_equal(
        tuple(a.shape), tuple(np.shape(b))), p, j)
