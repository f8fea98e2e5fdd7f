"""Tests of the port that need an NVIDIA card: each hand-written kernel
held against its plain PyTorch version on the card, and one PerMFL round
through the kernel path held against the plain path.

Marked ``gpu``. Whether a card is there is decided inside the ``cuda``
fixture, so every worker collects the same tests; without a card (or
without ``nvcc`` to build the kernels) they skip with the reason. Run
them on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

# the kernel rounds each operation as the plain version does, so f32
# agrees to the last bit; the tolerances are those of the CPU suite
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.kernels.build import nvcc_path

    try:
        nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(device=device, dtype=dtype)


@pytest.mark.parametrize("shape", [(128,), (1024,), (257,), (8, 128),
                                   (3, 5, 64), (4096,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.0),
                                         (0.9, 0.01)])
def test_prox_sgd_kernel_matches_plain(cuda, shape, dtype, momentum, wd):
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.prox_update import prox_sgd

    rng = np.random.default_rng(len(shape) + 10 * (dtype == "bfloat16"))
    dt = getattr(torch, dtype)
    theta, grad, anchor = (_randn(rng, shape, dt, cuda) for _ in range(3))
    mom = _randn(rng, shape, torch.float32, cuda)
    before = LAUNCHES.get("prox_update", 0)
    kw = dict(alpha=0.05, lam=0.7, momentum=momentum, weight_decay=wd)
    t_k, m_k = prox_sgd(theta, grad, anchor, mom, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["prox_update"] == before + 1
    t_r, m_r = prox_sgd(theta, grad, anchor, mom, mode="torch", **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(t_k.float(), t_r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m_k, m_r, atol=tol, rtol=tol)
    if momentum == 0.0:
        assert m_k is mom


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.01)])
@pytest.mark.parametrize("cols,ld", [(1000, 1024), (1001, 1001)])
def test_prox_step_kernel_matches_plain(cuda, dtype, momentum, wd, cols,
                                        ld):
    """Stacked in-place op over (M*N, cols) rows of a padded buffer, the
    anchor given as the team tier (M, cols); the unaligned row length
    takes the scalar path."""
    from repro_torch.kernels.prox_update import prox_step_

    m, n = 3, 4
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)

    def padded(rows, dtype):
        """(rows, cols) view of a zeroed (rows, ld) buffer."""
        buf = torch.zeros(rows, ld, dtype=dtype, device=cuda)
        buf[:, :cols] = _randn(rng, (rows, cols), dtype, cuda)
        return buf[:, :cols]

    theta, grad = padded(m * n, dt), padded(m * n, dt)
    w = padded(m, dt)
    mom = padded(m * n, torch.float32)
    kw = dict(alpha=0.05, lam=0.7, momentum=momentum, weight_decay=wd)
    t_k, m_k = padded(m * n, dt), padded(m * n, torch.float32)
    t_k.copy_(theta)
    m_k.copy_(mom)
    prox_step_(t_k, grad, w, m_k, **kw)
    t_r, m_r = theta.clone(), mom.clone()
    prox_step_(t_r, grad, w, m_r, mode="torch", **kw)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(t_k.float(), t_r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m_k, m_r, atol=tol, rtol=tol)
    if dtype == "float32":
        assert torch.equal(t_k, t_r)


def test_round_kernel_path_matches_plain_path(cuda):
    """One PerMFL round of a small CNN scenario on the card, through the
    kernel and through the plain version: the same state, and K*L kernel
    launches."""
    from repro_torch.core import permfl as P
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.scenarios import build_scenario, get_scenario

    s = get_scenario("table1/mnist/cnn/permfl").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 3})
    b = build_scenario(s, seed=0, device=cuda)
    hp = s.algo.hparams()
    state = P.init_state(b.params0, b.m, b.n)
    before = LAUNCHES.get("prox_update", 0)
    s_k = P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                         n_devices=b.n)
    assert LAUNCHES["prox_update"] == before + hp.k_team * hp.l_local
    s_t = P.permfl_round(state, b.train, hp, b.loss_fn, m_teams=b.m,
                         n_devices=b.n, mode="torch")
    assert LAUNCHES["prox_update"] == before + hp.k_team * hp.l_local
    for tier in ("x", "w", "theta"):
        torch.testing.assert_close(getattr(s_k, tier), getattr(s_t, tier),
                                   rtol=0, atol=1e-4)
