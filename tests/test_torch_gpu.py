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


@pytest.mark.parametrize("case", ["team", "device", "config", "rows"])
def test_prox_step_per_config_kernel_bit_equal(cuda, case):
    """The sweep's step: (G,) alpha / lam read by the kernel from device
    memory, row r taking group r // (rows // G), bit-equal to the plain
    version; anchors per team (PerMFL, L2GD), per device (pFedMe) and
    per config (Ditto); and 70,000 rows, past the grid's 65,535, in one
    launch."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.prox_update import prox_step_

    g, m, n, p, ld = 3, 4, 10, 1000, 1024
    if case == "rows":
        g, m, n, p, ld = 7, 1000, 10, 60, 64
    rows = g * m * n
    a_rows = {"team": g * m, "device": rows, "config": g,
              "rows": g * m}[case]
    rng = np.random.default_rng(3)
    theta = torch.zeros(rows, ld, device=cuda)
    theta[:, :p] = _randn(rng, (rows, p), torch.float32, cuda)
    grad = _randn(rng, (rows, p), torch.float32, cuda)
    anchor = _randn(rng, (a_rows, p), torch.float32, cuda)
    alpha = torch.from_numpy(rng.uniform(0.01, 0.5, g).astype(np.float32))
    lam = torch.from_numpy(rng.uniform(0.1, 2.0, g).astype(np.float32))
    alpha, lam = alpha.to(cuda), lam.to(cuda)
    t_k, t_p = theta[:, :p].clone(), theta[:, :p].clone()
    before = LAUNCHES.get("prox_update", 0)
    prox_step_(t_k, grad, anchor, alpha=alpha, lam=lam)
    torch.cuda.synchronize()
    assert LAUNCHES["prox_update"] == before + 1
    prox_step_(t_p, grad, anchor, alpha=alpha, lam=lam, mode="torch")
    assert torch.equal(t_k, t_p)
    # the by-value path of one group is unchanged
    r = rows // g
    one = theta[:r, :p].clone()
    prox_step_(one, grad[:r], anchor[:a_rows // g], alpha=float(alpha[0]),
               lam=float(lam[0]))
    assert torch.equal(one, t_k[:r])


@pytest.mark.parametrize("configs", [1, 3])
def test_swept_round_launches_prox_update_once_a_step(cuda, configs):
    """One swept PerMFL round of ``configs`` grid points on the card:
    LAUNCHES["prox_update"] is K*L whatever the number of configs, and
    each config equals its looped run on the card (f32, within 1e-5:
    the products of C*M*N models sum in another order than those of
    M*N)."""
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import build_scenario, get_scenario, \
        sweep_scenario
    from repro_torch.scenarios.spec import init_model
    from repro_torch.train.engine import run_experiment

    s = get_scenario("fig3/mnist/mclr").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 3})
    grid = [dict(lam=0.1 * (i + 1)) for i in range(configs)]
    reset_launches()
    sw = sweep_scenario(s, grid, (0,), rounds=1, device=cuda)
    assert LAUNCHES["prox_update"] == 2 * 3
    b = build_scenario(s, 0, device=cuda)
    _, rebuild = b.algo.tree_hparams()
    for res, g in zip(sw, grid):
        ref = run_experiment(rebuild(g), init_model(b.config, 0), b.train,
                             b.val, metric_fn=b.metric_fn, rounds=1, m=2,
                             n=3, device=cuda)
        for tier in ("x", "w", "theta"):
            torch.testing.assert_close(getattr(res.state, tier),
                                       getattr(ref.state, tier), rtol=0,
                                       atol=1e-5)


# the baselines whose steps run the prox kernel: (scenario, loop counts
# cut for a short test, prox_update launches a round at those counts)
BASELINE_ROUNDS = {
    "pfedme": ("table1/mnist/cnn/pfedme",
               {"inner_steps": 3, "local_rounds": 2}, 2 * 3 + 3),
    "ditto": ("table1/mnist/cnn/ditto", {"local_steps": 4}, 4),
    "l2gd": ("fig2/fmnist/cnn/l2gd", {"k_team": 2, "l_local": 3}, 2 * 3),
}


@pytest.mark.parametrize("algo", list(BASELINE_ROUNDS))
def test_baseline_round_kernel_path_matches_plain_path(cuda, algo):
    """One round of pFedMe, Ditto or L2GD on a small CNN scenario on the
    card, through the prox kernel (anchors of M*N, 1 and M rows) and
    through the plain version: the same x and personal tier, and the
    round's exact number of kernel launches."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.scenarios import build_scenario, get_scenario

    name, cut, launches = BASELINE_ROUNDS[algo]
    s = get_scenario(name).scaled(m_teams=2, n_devices=3,
                                  samples_per_device=16, algo_overrides=cut)
    b = build_scenario(s, seed=0, device=cuda)
    state = b.algo.init_state(b.params0, b.m, b.n)
    masks = dict(team_mask=torch.ones(b.m, device=cuda),
                 device_mask=torch.ones(b.m, b.n, device=cuda))
    before = LAUNCHES.get("prox_update", 0)
    s_k = b.algo.round(state, b.train, **masks)
    torch.cuda.synchronize()
    assert LAUNCHES["prox_update"] == before + launches
    s_t = b.algo.round(state, b.train, mode="torch", **masks)
    assert LAUNCHES["prox_update"] == before + launches
    for tier in ("x", "personal"):
        torch.testing.assert_close(getattr(s_k, tier), getattr(s_t, tier),
                                   rtol=0, atol=1e-4)


def test_perfedavg_meta_grads_on_the_card_equal_the_cpu(cuda):
    """Per-FedAvg's second-order meta-gradient of the paper CNN (2 x 3
    devices x 16 samples) on the card against the same on the CPU."""
    from repro_torch.core.baselines import meta_grads
    from repro_torch.scenarios import build_scenario, get_scenario

    s = get_scenario("table1/mnist/cnn/perfedavg").scaled(
        m_teams=2, n_devices=3, samples_per_device=16)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        b = build_scenario(s, seed=0, device=dev)
        state = b.algo.init_state(b.params0, b.m, b.n)
        d = b.m * b.n
        theta = state.x.expand(d, -1).clone()
        batch = {k: v.reshape((d,) + tuple(v.shape[2:]))
                 for k, v in b.train.items()}
        out[dev.type] = meta_grads(b.loss_fn, state.layout, theta, batch,
                                   b.algo.inner_lr)
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-5,
                               atol=1e-5)


# -------------------------------------------------- compress kernels

# leaf sizes of one flat row: ragged int8/sign rows, a 4097-value leaf, and
# offsets that are mostly not multiples of 4 (the scalar path)
SMALL_LEAVES = (1, 10, 127, 128, 129, 1000, 4097)


def _compress_rows(rng, b, leaves, ld, cuda, zero_run=True, tie_run=True):
    """(delta, ef, u) as (b, end) views of zeroed (b, ld) buffers. The
    largest leaf gets a run of exact zeros and tied uniforms, the leaf
    before it all-equal values, and the first leaf of at least 10 values
    only one nonzero (its top-k threshold is 0): the tie-fill runs."""
    end = sum(leaves)

    def rows(scale=1.0):
        buf = torch.zeros(b, ld, device=cuda)
        buf[:, :end] = torch.from_numpy(
            scale * rng.standard_normal((b, end)).astype(np.float32))
        return buf[:, :end]

    delta, ef = rows(), rows(0.1)
    u = torch.zeros(b, ld, device=cuda)
    u[:, :end] = torch.from_numpy(rng.random((b, end)).astype(np.float32))
    u = u[:, :end]
    big = int(np.argmax(leaves))
    o = sum(leaves[:big])
    n = leaves[big]
    if zero_run:
        delta[:, o:o + n // 2] = 0.0
        ef[:, o:o + n // 2] = 0.0
    if tie_run and len(leaves) > 1:
        o2 = sum(leaves[:big - 1])
        delta[:, o2:o2 + leaves[big - 1]] = 0.5
        ef[:, o2:o2 + leaves[big - 1]] = 0.0
        u[:, o:o + n] = torch.floor(u[:, o:o + n] * 8.0) / 8.0
        i = next(j for j, p in enumerate(leaves) if p >= 10)
        o3 = sum(leaves[:i])
        delta[:, o3:o3 + leaves[i]] = 0.0
        ef[:, o3:o3 + leaves[i]] = 0.0
        delta[:, o3 + leaves[i] - 1] = 1.0
    return delta, ef, u


def _run_compress(op, delta, ef, u, segs, mode=None):
    from repro_torch.kernels import compress as K

    if op == "ef_topk":
        return K.ef_topk(delta, ef, segs, mode=mode)
    if op == "ef_randk":
        return K.ef_randk(u, delta, ef, segs, mode=mode)
    if op == "ef_int8":
        return K.ef_int8(delta, ef, u, segs, mode=mode)
    return K.ef_sign(delta, ef, segs, mode=mode)


def _cnn_leaves():
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.flat import Layout
    from repro_torch.models.paper_models import init_params

    layout = Layout.of(init_params(CONFIG, torch.Generator().manual_seed(0)))
    return layout.leaf_sizes, layout.stride


@pytest.mark.parametrize("op", ["ef_topk", "ef_randk", "ef_int8", "ef_sign"])
@pytest.mark.parametrize("shape", ["small-aligned", "small-odd-stride",
                                   "mclr", "cnn-lan"])
def test_compress_kernel_matches_plain(cuda, op, shape):
    """Each compress kernel against its plain version on the card, bit
    for bit, on every output; one launch for all (sender, leaf) pairs."""
    from repro_torch.kernels import compress as K
    from repro_torch.kernels.interface import LAUNCHES

    rng = np.random.default_rng(sum(map(ord, op + shape)))
    if shape == "cnn-lan":
        leaves, ld = _cnn_leaves()
        b = 40
    elif shape == "mclr":
        leaves, ld, b = (10, 7840), 7872, 40
    else:
        leaves, b = SMALL_LEAVES, 3
        ld = 5504 if shape == "small-aligned" else sum(SMALL_LEAVES) + 3
    ks = tuple(max(1, round(0.1 * p)) for p in leaves)
    segs = K.segments(leaves, ks if op in ("ef_topk", "ef_randk") else None)
    delta, ef, u = _compress_rows(rng, b, leaves, ld, cuda)
    before = LAUNCHES.get(op, 0)
    got = _run_compress(op, delta, ef, u, segs)
    torch.cuda.synchronize()
    assert LAUNCHES[op] == before + 1
    want = _run_compress(op, delta, ef, u, segs, mode="torch")
    assert LAUNCHES[op] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("compressor", ["topk", "randk", "int8", "sign"])
def test_compressed_round_kernel_path_matches_plain_path(cuda, compressor):
    """One compressed PerMFL round of a small CNN scenario on the card
    through the kernels and through the plain versions, from the same
    state and generator seed: (K + 1) compress launches, and the same
    tiers and residuals."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import permfl as P
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.scenarios import build_scenario, get_scenario

    name = {"topk": "ef_topk", "randk": "ef_randk", "int8": "ef_int8",
            "sign": "ef_sign"}[compressor]
    cfg = CommConfig(compressor)
    s = get_scenario("table1/mnist/cnn/permfl").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 3})
    b = build_scenario(s, seed=0, device=cuda)
    hp = s.algo.hparams()
    state = P.init_state(b.params0, b.m, b.n, comm=cfg)
    before = LAUNCHES.get(name, 0)
    out = {}
    for mode in (None, "torch"):
        out[mode] = P.permfl_round(state, b.train, hp, b.loss_fn,
                                   m_teams=b.m, n_devices=b.n, comm=cfg,
                                   mode=mode)
        torch.cuda.synchronize()
    assert LAUNCHES[name] == before + hp.k_team + 1
    for tier in ("x", "w", "theta"):
        torch.testing.assert_close(getattr(out[None], tier),
                                   getattr(out["torch"], tier), rtol=0,
                                   atol=1e-4)
    for tier in ("ef_dev", "ef_team"):
        torch.testing.assert_close(getattr(out[None].comm, tier),
                                   getattr(out["torch"].comm, tier), rtol=0,
                                   atol=1e-4)


# ------------------------------ compress kernels without error feedback

def _run_plain(op, v, u, segs, mode=None, noise=None):
    from repro_torch.kernels import compress as K
    from repro_torch.kernels.quantize import quantize_int8

    if op == "topk":
        return K.topk(v, segs, mode=mode)
    if op in ("randk", "randk_unbiased"):
        return K.randk(u, v, segs, unbiased=op == "randk_unbiased",
                       mode=mode)
    if op == "sign":
        return K.sign(v, segs, mode=mode)
    return quantize_int8(v, u if noise is None else noise, segs, mode=mode)


@pytest.mark.parametrize("op", ["topk", "randk", "randk_unbiased", "sign",
                                "quantize"])
@pytest.mark.parametrize("shape", ["small-aligned", "small-odd-stride",
                                   "mclr", "cnn-lan", "cnn-wan"])
def test_plain_compress_kernel_matches_plain(cuda, op, shape):
    """Each compress kernel without error feedback (and quantize) against
    its plain version on the card, bit for bit, on every output; one
    launch for all (sender, leaf) pairs, and no error-feedback kernel."""
    from repro_torch.kernels.interface import LAUNCHES

    name = {"randk_unbiased": "randk"}.get(op, op)
    rng = np.random.default_rng(sum(map(ord, op + shape)) + 1)
    if shape.startswith("cnn"):
        leaves, ld = _cnn_leaves()
        b = 40 if shape == "cnn-lan" else 4
    elif shape == "mclr":
        leaves, ld, b = (10, 7840), 7872, 40
    else:
        leaves, b = SMALL_LEAVES, 3
        ld = 5504 if shape == "small-aligned" else sum(SMALL_LEAVES) + 3
    ks = tuple(max(1, round(0.1 * p)) for p in leaves)
    segs = _segs_for(op, leaves, ks)
    v, _, u = _compress_rows(rng, b, leaves, ld, cuda)
    before = dict(LAUNCHES)
    got = _run_plain(op, v, u, segs)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before.get(name, 0) + 1
    want = _run_plain(op, v, u, segs, mode="torch")
    assert {k: c - before.get(k, 0) for k, c in LAUNCHES.items()
            if c != before.get(k, 0)} == {name: 1}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _segs_for(op, leaves, ks):
    from repro_torch.kernels import compress as K

    return K.segments(leaves, ks if op.startswith(("topk", "randk"))
                      else None)


def test_quantize_kernel_at_the_store_export(cuda):
    """The int8 store export's call: residual rows of M*N devices and the
    noise 0.5 as one expanded (stride-0) row; bit-equal to the plain
    version."""
    from repro_torch.kernels.quantize import quantize_int8
    from repro_torch.kernels.segments import segments

    leaves, ld = _cnn_leaves()
    rng = np.random.default_rng(8)
    v, _, _ = _compress_rows(rng, 40, leaves, ld, cuda)
    noise = torch.full((1, ld), 0.5, device=cuda).expand(40, ld)
    segs = segments(leaves)
    got = quantize_int8(v, noise, segs)
    want = quantize_int8(v, noise, segs, mode="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("compressor", ["topk", "randk", "int8", "sign"])
def test_round_without_ef_kernel_path_matches_plain_path(cuda, compressor):
    """One PerMFL round of a small CNN scenario without error feedback,
    through the kernels and through the plain versions, from the same
    state and generator seed: (K + 1) launches of the compressor's
    non-EF kernel, none of an EF kernel, and the same tiers."""
    from repro_torch.comm import CommConfig
    from repro_torch.core import permfl as P
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.scenarios import build_scenario, get_scenario

    name = {"int8": "quantize"}.get(compressor, compressor)
    cfg = CommConfig(compressor, error_feedback=False)
    s = get_scenario("table1/mnist/cnn/permfl").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 3})
    b = build_scenario(s, seed=0, device=cuda)
    hp = s.algo.hparams()
    state = P.init_state(b.params0, b.m, b.n, comm=cfg)
    before = dict(LAUNCHES)
    out = {}
    for mode in (None, "torch"):
        out[mode] = P.permfl_round(state, b.train, hp, b.loss_fn,
                                   m_teams=b.m, n_devices=b.n, comm=cfg,
                                   mode=mode)
        torch.cuda.synchronize()
    moved = {k: c - before.get(k, 0) for k, c in LAUNCHES.items()
             if c != before.get(k, 0)}
    assert moved == {"prox_update": hp.k_team * hp.l_local,
                     name: hp.k_team + 1}
    for tier in ("x", "w", "theta"):
        torch.testing.assert_close(getattr(out[None], tier),
                                   getattr(out["torch"], tier), rtol=0,
                                   atol=1e-4)


# ------------------------------------------------ select kernel: tiles

SELECT_OPS = ["topk", "randk", "randk_unbiased", "ef_topk", "ef_randk"]
# case -> (leaf sizes, senders, exact zeros in the largest leaf, the
# fraction of each leaf kept); tiles hold compress.TILE = 4096 values
SELECT_CASES = {
    # 9,000 zeros across two tile ends, 3,388 nonzero, k 6,194: top-k's
    # threshold is 0 and its tie-fill ends mid-tile
    "3+ tiles, zeros across tiles": ((10, 3 * 4096 + 100), 3, (3000, 12000),
                                     0.5),
    "one tile": ((4096,), 5, (1000, 3000), 0.1),
    "unaligned offset": ((3, 9000, 4096), 3, (3000, 9000), 0.1),
    "cnn WAN": (None, 4, (3000, 9000), 0.1),
}


def _select_rows(rng, case, cuda):
    """(delta, ef, u, segs): the case's rows, 16-byte aligned, with the
    case's zero run in the largest leaf and its uniforms tied in
    eighths."""
    from repro_torch.kernels import compress as K

    leaves, b, (z0, z1), frac = SELECT_CASES[case]
    if leaves is None:
        leaves, ld = _cnn_leaves()
    else:
        ld = -(-sum(leaves) // 4) * 4
    delta, ef, u = _compress_rows(rng, b, leaves, ld, cuda, zero_run=False,
                                  tie_run=False)
    big = int(np.argmax(leaves))
    o, n = sum(leaves[:big]), leaves[big]
    delta[:, o + z0:o + z1] = 0.0
    ef[:, o + z0:o + z1] = 0.0
    u[:, o:o + n] = torch.floor(u[:, o:o + n] * 8) / 8
    return delta, ef, u, K.segments(
        leaves, tuple(max(1, round(frac * p)) for p in leaves))


def _select_op(op, delta, ef, u, segs, mode=None):
    from repro_torch.kernels import compress as K

    if op == "ef_topk":
        return K.ef_topk(delta, ef, segs, mode=mode)
    if op == "ef_randk":
        return K.ef_randk(u, delta, ef, segs, mode=mode)
    return _run_plain(op, delta, u, segs, mode=mode)


@pytest.mark.parametrize("case", list(SELECT_CASES))
@pytest.mark.parametrize("op", SELECT_OPS)
def test_select_kernel_tiles_match_plain(cuda, op, case):
    """Each select op (one call: the count and the scan) bit-equal to the
    plain version (dq, ranks, ef') where a leaf spans 3+ tiles with a zero
    run across tile ends, a leaf is exactly one tile, a leaf's offset is
    not a multiple of 4, and at the CNN WAN uplink (4 senders)."""
    from repro_torch.kernels.interface import LAUNCHES

    rng = np.random.default_rng(sum(map(ord, op + case)))
    delta, ef, u, segs = _select_rows(rng, case, cuda)
    name = {"randk_unbiased": "randk"}.get(op, op)
    before = LAUNCHES.get(name, 0)
    got = _select_op(op, delta, ef, u, segs)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want = _select_op(op, delta, ef, u, segs, mode="torch")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# ---------------------------------------------------------- serving

@pytest.mark.parametrize("encoding", ["delta", "int8", "raw"])
def test_serve_path_on_the_card(cuda, encoding):
    """A trained small CNN state exported on the card: the int8 export is
    one quantize launch and its payload equals the plain version's; the
    decoded rows equal the CPU store's (delta, raw bit for bit); save and
    reload are bit-equal; serve equals serve_cached; a replay's tier
    counts sum to the requests."""
    import tempfile

    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.models import paper_models as pm
    from repro_torch.scenarios import get_scenario, run_scenario
    from repro_torch.serve import (ModelStore, PersonalizedServer,
                                   replay_traffic)

    s = get_scenario("table1/mnist/cnn/permfl").scaled(
        m_teams=2, n_devices=3, samples_per_device=16,
        algo_overrides={"k_team": 2, "l_local": 2})
    res = run_scenario(s, rounds=1, device=cuda)
    algo, st = s.algo.build(None), res.state
    before = LAUNCHES.get("quantize", 0)
    store = ModelStore.from_state(algo, st, m=2, n=3, encoding=encoding)
    torch.cuda.synchronize()
    assert LAUNCHES.get("quantize", 0) == before + (encoding == "int8")
    plain = ModelStore.from_state(algo, st, m=2, n=3, encoding=encoding,
                                  mode="torch")
    t = np.array([0, 0, 1, 1, 1, 0, 5, -1])
    d = np.array([0, 2, 1, 2, 9, -1, 0, 1])
    rows = store.gather(t, d)
    if encoding == "int8":
        for k in ("q", "scales"):
            assert torch.equal(store.payload[k], plain.payload[k])
        assert torch.equal(rows, plain.gather(t, d))
    else:
        assert torch.equal(rows[:6][[0, 1, 2, 3]],
                           st.theta[[0, 0, 1, 1], [0, 2, 1, 2]])
    with tempfile.TemporaryDirectory() as tmp:
        store.save(f"{tmp}/s.ckpt")
        back = ModelStore.load(f"{tmp}/s.ckpt", device=cuda)
    assert torch.equal(back.gather(t, d), rows)
    cfg = s.model_config()
    apply = lambda p, x: pm.apply(p, cfg, x[:, None])[:, 0]
    server = PersonalizedServer(store, apply)
    xv = res.state.x.new_tensor(np.random.default_rng(0).random(
        (len(t),) + tuple(cfg.input_shape)).astype(np.float32))
    assert torch.equal(server.serve(t, d, xv), server.serve_cached(t, d, xv))
    stats = replay_traffic(server, xv, requests=128, batch=32,
                           unknown_frac=0.1)
    assert sum(stats["tier_counts"].values()) == 128
    assert stats["device"] == torch.cuda.get_device_name(cuda)


# --- LLM kernels: flash_attention and moe_router -------------------------

# (b, sq, skv, hq, hkv, d, causal, window, q_offset, the variant bf16
# reaches; float32 always reaches "simt")
LLM_ATTN_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0, None, "wgmma"),
    (1, 96, 256, 40, 8, 128, True, 0, None, "wgmma"),   # GQA 40:8 (qwen3)
    (2, 80, 80, 4, 4, 96, True, 0, None, "wgmma"),      # head_dim 96 (phi3)
    (1, 300, 300, 2, 2, 128, True, 64, None, "wgmma"),  # sliding window
    (1, 64, 72, 4, 2, 32, False, 0, 0, "simt"),         # non-causal, d 32
    (2, 1, 1040, 4, 4, 128, True, 0, 1030, "split_kv"),  # decode, long cache
    (2, 1, 96, 4, 2, 64, True, 0, 50, "split_kv"),      # GQA decode
    (1, 300, 300, 2, 2, 128, True, 0, None, "wgmma"),   # ragged q tiles
    (1, 129, 129, 2, 2, 128, True, 0, None, "wgmma"),
    (2, 1, 1040, 4, 4, 128, True, 0, 0, "split_kv"),    # decode, 1 key
    (2, 1, 1040, 4, 4, 128, True, 0, 1039, "split_kv"),  # the last slot
    (1, 1, 1040, 40, 8, 128, True, 0, 1030, "split_kv"),  # GQA 40:8 decode
    (2, 1, 1040, 12, 2, 128, True, 0, 700, "split_kv"),  # 12:2 (qwen2-vl)
    (1, 1, 1040, 4, 4, 128, True, 256, 1000, "split_kv"),  # windowed decode
    (2, 256, 256, 12, 12, 64, True, 0, None, "wgmma"),  # d 64 (whisper)
    (2, 1, 96, 4, 2, 64, True, 0, -1, "split_kv"),     # no key seen: 0
    # Whisper-small and Qwen2-VL-2B at their serving shapes: the encoder
    # (non-causal, q and kv tails of 28 rows), the cross-attention's
    # prefill (64 queries on 1,500 keys) and decode, GQA 12:2 at d 128
    (4, 1500, 1500, 12, 12, 64, False, 0, 0, "wgmma"),
    (4, 64, 1500, 12, 12, 64, False, 0, 0, "wgmma"),
    (4, 1, 1500, 12, 12, 64, False, 0, 0, "split_kv"),
    (4, 1024, 1024, 12, 2, 128, True, 0, None, "wgmma"),
    (2, 12, 75, 4, 4, 64, False, 0, 0, "wgmma"),       # ragged, sq != skv
    # head_dim 96 (a 64-column box and half a box): phi3-mini's decode on a
    # 1,040-slot cache, GQA decodes (2 and 8 q-heads a CTA), a ragged GQA
    # prefill, a windowed one, a non-causal one with sq != skv
    (2, 1, 1040, 32, 32, 96, True, 0, 1030, "split_kv"),
    (2, 1, 300, 8, 4, 96, True, 0, 250, "split_kv"),
    (1, 1, 1040, 16, 2, 96, True, 0, 1000, "split_kv"),
    (2, 300, 300, 8, 2, 96, True, 0, None, "wgmma"),
    (1, 300, 300, 4, 4, 96, True, 64, None, "wgmma"),
    (2, 12, 75, 4, 4, 96, False, 0, 0, "wgmma"),
]
# f32: the kernel's online softmax against one softmax over the row;
# bf16: one rounding of the output (the chip_smoke tolerances)
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _attn_inputs(rng, case, q_dtype, kv_dtype, cuda):
    b, sq, skv, hq, hkv, d = case[:6]
    return (_randn(rng, (b, sq, hq, d), q_dtype, cuda),
            _randn(rng, (b, skv, hkv, d), kv_dtype, cuda),
            _randn(rng, (b, skv, hkv, d), kv_dtype, cuda))


@pytest.mark.parametrize("case", LLM_ATTN_CASES, ids=lambda c: "x".join(
    map(str, c[:6])) + ("c" if c[6] else "n") + f"w{c[7]}o{c[8]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import VARIANTS, attention
    from repro_torch.kernels.interface import LAUNCHES

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = _attn_inputs(rng, case, dt, dt, cuda)
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    variant = case[9] if dtype == "bfloat16" else "simt"
    before = LAUNCHES.get("flash_attention", 0)
    ran = dict(VARIANTS)
    got = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    ran[variant] += 1
    assert VARIANTS == ran
    want = attention(q, k, v, mode="torch", **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err


def test_flash_attention_bf16_q_f32_cache(cuda):
    """The engine's default: a bfloat16 model's q against a float32
    cache, read as it is (no cast of the cache); output bfloat16."""
    from repro_torch.kernels.flash_attention import attention

    rng = np.random.default_rng(9)
    case = (2, 1, 1040, 4, 4, 128)
    q, k, v = _attn_inputs(rng, case, torch.bfloat16, torch.float32, cuda)
    got = attention(q, k, v, q_offset=700)
    want = attention(q, k, v, q_offset=700, mode="torch")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= \
        ATTN_TOL["bfloat16"]


def test_flash_attention_strided_views(cuda):
    """q, k, v as strided views (heads sliced out of wider tensors, rows
    not 16-byte aligned) take the scalar path and agree."""
    from repro_torch.kernels.flash_attention import attention

    rng = np.random.default_rng(4)
    q = _randn(rng, (2, 40, 6, 64), torch.float32, cuda)[:, :, 1:5]
    kv = _randn(rng, (2, 50, 5, 65), torch.float32, cuda)
    k, v = kv[:, :, 1:3, 1:], kv[:, :, 3:5, :64]
    got = attention(q, k, v)
    want = attention(q, k, v, mode="torch")
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTN_TOL["float32"]


@pytest.mark.parametrize("sq,variant", [(200, "wgmma"), (1, "split_kv")])
def test_flash_attention_bf16_strided_views_tensor_core(cuda, sq, variant):
    """bf16 q, k, v as 16-byte aligned strided views (k and v heads
    interleaved in one tensor, q heads sliced out of a wider one) go
    through the tensor maps and row strides of the Hopper variants."""
    from repro_torch.kernels.flash_attention import VARIANTS, attention

    rng = np.random.default_rng(12 + sq)
    q = _randn(rng, (2, sq, 6, 128), torch.bfloat16, cuda)[:, :, 1:5]
    kv = _randn(rng, (2, 240, 4, 128), torch.bfloat16, cuda)
    k, v = kv[:, :, 0::2], kv[:, :, 1::2]
    ran = dict(VARIANTS)
    got = attention(q, k, v, q_offset=230 if sq == 1 else None)
    want = attention(q, k, v, q_offset=230 if sq == 1 else None,
                     mode="torch")
    torch.cuda.synchronize()
    ran[variant] += 1
    assert VARIANTS == ran
    assert float((got.float() - want.float()).abs().max()) <= \
        ATTN_TOL["bfloat16"]


@pytest.mark.parametrize("sq", [300, 1])
def test_flash_attention_head_dim_96_writes_only_its_columns(cuda, sq):
    """head_dim 96 on the Hopper variants (300 queries: wgmma; one:
    split_kv), k and v slices of a stacked bf16 cache as the engine hands
    them over, q heads sliced out of a wider tensor, and the output a
    strided view of 96 columns into a sentinel buffer of rows of 128 with a
    head on either side: the entry point writes the view's 96 columns of
    each head and nothing else (wgmma's TMA stores of 64-column boxes drop
    columns 96-127; the neighbouring heads keep the sentinel), and the
    output equals the plain version's."""
    import math

    from repro_torch.kernels.flash_attention import attention, ops
    from repro_torch.kernels.flash_attention.ref import sm_scale, \
        visible_keys

    bf16 = torch.bfloat16
    rng = np.random.default_rng(96 + sq)
    b, skv, hq, hkv, d = 2, 300, 8, 2, 96
    q_offset = 0 if sq > 1 else 250
    stack = _randn(rng, (2, 3, b, skv, hkv, d), bf16, cuda)
    k, v = stack[0, 1], stack[1, 1]
    q = _randn(rng, (b, sq, hq + 2, d), bf16, cuda)[:, :, 1:hq + 1]
    buf = torch.full((b, sq, hq + 2, 128), 7.0, dtype=bf16, device=cuda)
    out = buf[:, :, 1:hq + 1, :d]
    variant, splits = ops.plan(q, k, v, q_offset=q_offset)
    assert variant == ("wgmma" if sq > 1 else "split_kv")
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if variant == "wgmma":
        err = ops._wgmma_fn()(
            d, *ptrs, b, sq, skv, hq, hkv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], q_offset, 1, 0,
            sm_scale(d) * math.log2(math.e), None, stream)
    else:
        lo, n = visible_keys(skv, q_offset=q_offset)
        rows = b * hq * splits
        part = torch.empty((2 + d) * rows, dtype=torch.float32, device=cuda)
        tickets = torch.zeros(b * hkv, dtype=torch.int32, device=cuda)
        err = ops._split_fn()(
            d, *ptrs, part[:rows].data_ptr(), part[rows:2 * rows].data_ptr(),
            part[2 * rows:].data_ptr(), tickets.data_ptr(), b, hq, hkv,
            q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
            out.stride(0), out.stride(2), lo, n, -(-n // splits), splits,
            sm_scale(d), stream)
    torch.cuda.synchronize()
    assert err == 0
    want = attention(q, k, v, q_offset=q_offset, mode="torch")
    assert float((out.float() - want.float()).abs().max()) <= \
        ATTN_TOL["bfloat16"]
    rest = buf.clone()
    rest[:, :, 1:hq + 1, :d] = 7.0
    assert bool((rest == 7.0).all()), "a column past 96 or a neighbouring " \
        "head was written"


@pytest.mark.parametrize("t", [4, 37, 4096])
@pytest.mark.parametrize("e,k", [(16, 2), (64, 6), (64, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_router_kernel_matches_plain(cuda, t, e, k, dtype):
    """idx bit-equal (tied rows included), gates and statistics within
    1e-6 of the plain version."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import route_topk

    rng = np.random.default_rng(t + e + k)
    x = _randn(rng, (t, e), getattr(torch, dtype), cuda) * 2
    x[0] = 0.5
    if t > 1:
        x[1, 2] = x[1, e - 1] = x[1].max() + 1
    before = LAUNCHES.get("moe_router", 0)
    g, i, aux = route_topk(x, top_k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["moe_router"] == before + 1
    g_p, i_p, aux_p = route_topk(x, top_k=k, mode="torch")
    assert torch.equal(i, i_p) and g.dtype == x.dtype
    assert float((g.float() - g_p.float()).abs().max()) <= 1e-6
    for key in ("mean_prob", "frac_tokens"):
        assert float((aux[key] - aux_p[key]).abs().max()) <= 1e-6
    assert i[0].tolist() == list(range(k))


def _fused_router_inputs(rng, t, d, e, dtype, cuda):
    """x (t, d) with every 7th row zero (all logits exactly 0), w (d, e)
    float32 at the model's scale with experts e - 2 and e - 1 copies of 1
    and 0 (exactly tied logits)."""
    x = _randn(rng, (t, d), dtype, cuda)
    x[::7] = 0
    w = _randn(rng, (d, e), torch.float32, cuda) / d ** 0.5
    w[:, e - 2] = w[:, 1]
    w[:, e - 1] = w[:, 0]
    return x, w


# (t, d, E, k, group): the decode, a ragged tile, a group longer than t,
# deepseek's prefill, small widths, and twice the prefill (256 CTAs, more
# than an H100 holds at once: tiles by start ticket, in two waves)
FUSED_CASES = [(1, 2048, 64, 6, 1), (4, 2048, 64, 6, 4), (4, 256, 4, 2, 4),
               (70, 256, 16, 2, 16), (70, 2048, 64, 1, 70),
               (1000, 2048, 4, 1, 1024), (1000, 256, 16, 6, 128),
               (4096, 2048, 64, 6, 1024), (4096, 2048, 16, 2, 1024),
               (8192, 2048, 64, 6, 1024)]


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: "-".join(
    map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_route_tokens_matches_plain(cuda, case, dtype):
    """The fused router against route_tokens_ref on the card: zero rows
    take ids 0..k-1 and tied experts the lower index, exactly; other ids
    equal but where the plain run's probabilities lie within 1e-5 (its
    k-th and (k+1)-th for a changed set, two of its top k for a changed
    order: the logits come from another f32 product, ~1e-6 apart); pos
    equal to positions_ref of the kernel's own ids; gates of agreeing
    tokens and mean_prob within 1e-5, frac_tokens the kernel's own
    count."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import (VARIANTS, positions_ref,
                                                route_tokens)

    t, d, e, k, gs = case
    rng = np.random.default_rng(t + d + e + k)
    x, w = _fused_router_inputs(rng, t, d, e, getattr(torch, dtype), cuda)
    before, fused = LAUNCHES.get("moe_router", 0), VARIANTS["fused"]
    g, i, p, aux = route_tokens(x, w, top_k=k, group_size=gs)
    torch.cuda.synchronize()
    assert LAUNCHES["moe_router"] == before + 1
    assert VARIANTS["fused"] == fused + 1
    g_p, i_p, _, aux_p = route_tokens(x, w, top_k=k, group_size=gs,
                                      mode="torch")
    zero = (x == 0).all(1)
    assert bool((i[zero] == torch.arange(k, device=cuda)).all())
    assert torch.equal(i[zero], i_p[zero])
    top = torch.softmax(x.float() @ w, -1).sort(1, descending=True).values
    same = (i == i_p).all(1)
    new_set = (i.sort(1).values != i_p.sort(1).values).any(1)
    for row in (~same).nonzero()[:, 0].tolist():
        gaps = top[row, :k] - top[row, 1:k + 1] if new_set[row] else \
            top[row, :k - 1] - top[row, 1:k]
        gap = gaps[-1] if new_set[row] else gaps.min()
        assert float(gap) <= 1e-5, (row, float(gap))
    assert torch.equal(p, positions_ref(i, gs, e))
    assert float((g - g_p)[same].abs().max()) <= 1e-5
    assert float((aux["mean_prob"] - aux_p["mean_prob"]).abs().max()) <= 1e-5
    counts = torch.nn.functional.one_hot(i.long(), e).sum((0, 1)).float()
    torch.testing.assert_close(aux["frac_tokens"], counts / (t * k),
                               atol=1e-7, rtol=0)
    assert g.dtype == torch.float32 and i.dtype == p.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_route_tokens_unrenormalised_matches_plain(cuda, dtype):
    """The fused router at deepseek's training shape (4,096 x 2,048, E 64,
    k 6, groups of 1,024) with its published gates, not renormalised,
    against route_tokens_ref on the card, as the renormalised cases are
    held: ids equal but where the plain run's probabilities lie within
    1e-5, positions those of the kernel's own ids, gates of agreeing
    tokens and mean_prob within 1e-5; the gates are the softmax
    probabilities of the chosen experts (they sum to less than 1)."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import positions_ref, route_tokens

    t, d, e, k, gs = 4096, 2048, 64, 6, 1024
    rng = np.random.default_rng(t + d + e + k + 1)
    x, w = _fused_router_inputs(rng, t, d, e, getattr(torch, dtype), cuda)
    before = LAUNCHES.get("moe_router", 0)
    g, i, p, aux = route_tokens(x, w, top_k=k, renormalize=False,
                                group_size=gs)
    torch.cuda.synchronize()
    assert LAUNCHES["moe_router"] == before + 1
    g_p, i_p, _, aux_p = route_tokens(x, w, top_k=k, renormalize=False,
                                      group_size=gs, mode="torch")
    top = torch.softmax(x.float() @ w, -1).sort(1, descending=True).values
    same = (i == i_p).all(1)
    for row in (~same).nonzero()[:, 0].tolist():
        assert float((top[row, :k] - top[row, 1:k + 1]).min()) <= 1e-5, row
    assert torch.equal(p, positions_ref(i, gs, e))
    assert float((g - g_p)[same].abs().max()) <= 1e-5
    assert float((aux["mean_prob"] - aux_p["mean_prob"]).abs().max()) <= 1e-5
    sums = g.sum(1)
    assert bool((sums < 1).all()) and float((sums[~(x == 0).all(1)]
                                             - top[~(x == 0).all(1), :k]
                                             .sum(1)).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_route_tokens_f32_accuracy(cuda, dtype):
    """The fused router's product at f32 accuracy, at deepseek's prefill
    shape: with k = E and no renormalisation its gates are the softmax
    probabilities, each within 4e-6 of the float64 route's, relative
    (chip_smoke.py's PROB_REL_TOL: an f32 product's rounding reads ~2e-6,
    w in two bf16 pieces ~1e-5)."""
    from repro_torch.kernels.moe_router import route_tokens

    rng = np.random.default_rng(19)
    x, w = _fused_router_inputs(rng, 4096, 2048, 64, getattr(torch, dtype),
                                cuda)
    g, i = route_tokens(x, w, top_k=64, renormalize=False,
                        group_size=1024)[:2]
    want = torch.softmax(x.double() @ w.double(), -1).gather(1, i.long())
    assert float(((g.double() - want).abs() / want).max()) <= 4e-6


def _same_route(got, want):
    return all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])) and \
        all(torch.equal(got[3][n], want[3][n]) for n in want[3])


def test_moe_route_tokens_two_streams(cuda):
    """Launches of the fused router interleaved on two streams, each
    stream with its own scratch (tails, statistics, tickets): every
    result equals the same call's on the default stream, bit for bit
    (the kernel's results do not depend on scheduling)."""
    from repro_torch.kernels.moe_router import route_tokens

    rng = np.random.default_rng(20)
    cases = [_fused_router_inputs(rng, t, 2048, 64, torch.bfloat16, cuda)
             for t in (8192, 4096)]
    wants = [route_tokens(x, w, top_k=6, group_size=1024) for x, w in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for stream, (x, w), out in zip(streams, cases, outs):
            with torch.cuda.stream(stream):
                out.append(route_tokens(x, w, top_k=6, group_size=1024))
    torch.cuda.synchronize()
    for want, out in zip(wants, outs):
        assert all(_same_route(got, want) for got in out)


def test_moe_route_tokens_graph_replay(cuda):
    """The fused router captured in a CUDA graph (its stream's scratch
    made by a run before the capture) and replayed: each replay takes a
    new epoch on the card, so every replay, and an eager call after
    them, equals the eager result bit for bit."""
    from repro_torch.kernels.moe_router import route_tokens

    rng = np.random.default_rng(21)
    x, w = _fused_router_inputs(rng, 4096, 2048, 64, torch.bfloat16, cuda)
    want = route_tokens(x, w, top_k=6, group_size=1024)
    stream, graph = torch.cuda.Stream(cuda), torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        route_tokens(x, w, top_k=6, group_size=1024)
    stream.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        got = route_tokens(x, w, top_k=6, group_size=1024)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _same_route(got, want)
    assert _same_route(route_tokens(x, w, top_k=6, group_size=1024), want)


def test_llm_generate_launch_counts(cuda):
    """Reduced deepseek-moe-16b (2 layers, MoE in each): one prefill and
    3 decode steps launch flash_attention and moe_router once per layer
    each (the router always the fused kernel), and no other kernel;
    greedy tokens equal to the plain path's."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.moe_router import VARIANTS, reset_variants
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = get_reduced_config("deepseek-moe-16b")
    params = M.init_params(0, cfg, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 24), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    kernel = ServeEngine(cfg=cfg, params=params, max_len=32)
    plain = ServeEngine(cfg=cfg, params=params, max_len=32, mode="torch")
    reset_launches()
    reset_variants()
    out = kernel.generate({"tokens": prompt}, max_new_tokens=4)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    assert launches == {"flash_attention": 4 * cfg.num_layers,
                        "moe_router": 4 * cfg.num_layers}, launches
    assert VARIANTS == {"fused": 4 * cfg.num_layers, "logits": 0}
    assert torch.equal(out, plain.generate({"tokens": prompt},
                                           max_new_tokens=4))
    assert out.shape == (3, 4) and out.dtype == torch.int32


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-2b"])
def test_encdec_vlm_generate_launch_counts(cuda, arch):
    """Reduced whisper-small and qwen2-vl-2b (2 layers each; Whisper's
    encoder 2 layers over 64 frames): a prefill and 3 decode steps launch
    flash_attention once per attention (Whisper: encoder, self and cross;
    decode reads the cached cross K/V) and no other kernel. In float32
    (simt) the greedy tokens equal the plain path's; in bfloat16 the
    prefill runs wgmma and the decode steps split_kv."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.flash_attention import VARIANTS, reset_variants
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.llm import prompts

    cfg = get_reduced_config(arch)
    n = cfg.num_layers
    prefill = n + (2 * n if cfg.is_encoder_decoder else 0)
    step = 2 * n if cfg.is_encoder_decoder else n
    for dt in (torch.float32, torch.bfloat16):
        params = M.init_params(0, cfg, dtype=dt, device=cuda)
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in prompts(cfg, 3, 24, torch.Generator(cuda)
                                     .manual_seed(1)).items()}
        kernel = ServeEngine(cfg=cfg, params=params, max_len=32,
                             cache_dtype=dt)
        reset_launches()
        reset_variants()
        out = kernel.generate(batch, max_new_tokens=4)
        torch.cuda.synchronize()
        launches = {k: c for k, c in LAUNCHES.items() if c}
        assert launches == {"flash_attention": prefill + 3 * step}, launches
        assert out.shape == (3, 4) and out.dtype == torch.int32
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
        if dt == torch.float32:
            assert VARIANTS["simt"] == prefill + 3 * step
            plain = ServeEngine(cfg=cfg, params=params, max_len=32,
                                cache_dtype=dt, mode="torch")
            assert torch.equal(out, plain.generate(batch, max_new_tokens=4))
        else:
            assert VARIANTS == {"wgmma": prefill, "split_kv": 3 * step,
                                "simt": 0}, VARIANTS


def test_jamba_generate_launch_counts(cuda):
    """Reduced jamba-1.5-large-398b ([(mamba, dense), (attn, MoE)] x 4):
    a prefill and 3 decode steps launch flash_attention and moe_router
    once per attention and MoE layer each, and the prefill mamba_scan once
    per Mamba layer (a decode step's recurrence step is torch ops). In
    float32 the prefill's logits are the plain path's within 1e-4 and the
    greedy tokens equal; in bfloat16 the attention's prefill runs wgmma
    and its decode steps split_kv, the router the tile form in the prefill
    and the split form in the decode steps."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import moe_router
    from repro_torch.kernels.flash_attention import VARIANTS, reset_variants
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = get_reduced_config("jamba-1.5-large-398b")
    n = sum(cfg.moe_layer_mask())               # = the attention layers
    n_mamba = cfg.layer_kinds().count("mamba")
    prompt = torch.randint(0, cfg.vocab_size, (3, 24), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    for dt in (torch.float32, torch.bfloat16):
        params = M.init_params(0, cfg, dtype=dt, device=cuda)
        kernel = ServeEngine(cfg=cfg, params=params, max_len=32,
                             cache_dtype=dt)
        reset_launches()
        reset_variants()
        moe_router.reset_variants()
        out = kernel.generate({"tokens": prompt}, max_new_tokens=4)
        torch.cuda.synchronize()
        launches = {k: c for k, c in LAUNCHES.items() if c}
        assert launches == {"flash_attention": 4 * n,
                            "moe_router": 4 * n,
                            "mamba_scan": n_mamba}, launches
        assert moe_router.VARIANTS == {"fused": 4 * n, "logits": 0}
        assert moe_router.FORMS == {"tile": n, "split": 3 * n}
        assert out.shape == (3, 4) and out.dtype == torch.int32
        if dt == torch.bfloat16:
            assert VARIANTS == {"wgmma": n, "split_kv": 3 * n, "simt": 0}
            continue
        logits = [M.prefill(params, cfg, {"tokens": prompt},
                            M.init_cache(cfg, 3, 32, dtype=dt, device=cuda),
                            mode=mode)[0] for mode in (None, "torch")]
        torch.testing.assert_close(logits[0], logits[1], rtol=1e-4,
                                   atol=1e-4)
        plain = ServeEngine(cfg=cfg, params=params, max_len=32,
                            cache_dtype=dt, mode="torch")
        assert torch.equal(out, plain.generate({"tokens": prompt},
                                               max_new_tokens=4))


# --- RWKV-6: rwkv6_scan ---------------------------------------------------

# (b, t, h, n, given state): head sizes 16/32/64, t off the kernel's tile
RWKV_CASES = [(2, 33, 3, 16, False), (2, 130, 2, 32, True),
              (1, 1, 4, 64, True), (2, 40, 4, 64, False),
              (1, 257, 2, 64, True)]


def _wkv_inputs(rng, b, t, h, n, dtype, w_dtype, state, cuda):
    r, k, v = (_randn(rng, (b, t, h, n), torch.float32, cuda).mul(0.3)
               .to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(_randn(rng, (b, t, h, n), torch.float32, cuda)
                             - 3.0)).to(w_dtype)
    u = _randn(rng, (h, n), torch.float32, cuda) * 0.1
    s = _randn(rng, (b, h, n, n), torch.float32, cuda) if state else None
    return r, k, v, w, u, s


def _assert_wkv_close(got, want):
    """f32 within 1e-5 of the output's scale (keys summed in another
    order); a bf16 output within one bf16 rounding (2^-7) of the plain
    one's; the float32 state within 1e-5 of its scale."""
    (o, s), (o_p, s_p) = got, want
    scale = float(o_p.float().abs().max())
    rel = 2.0 ** -7 if o.dtype == torch.bfloat16 else 0.0
    err = (o.float() - o_p.float()).abs()
    assert bool((err <= rel * o_p.float().abs() + 1e-5 * scale).all()), \
        float(err.max())
    assert float((s - s_p).abs().max()) <= 1e-5 * float(s_p.abs().max())


@pytest.mark.parametrize("case", RWKV_CASES,
                         ids=lambda c: "x".join(map(str, c[:4]))
                         + ("s" if c[4] else "z"))
@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_rwkv6_scan_kernel_matches_plain(cuda, case, dtype, w_dtype):
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import wkv

    rng = np.random.default_rng(sum(case[:4]))
    args = _wkv_inputs(rng, *case[:4], getattr(torch, dtype),
                       getattr(torch, w_dtype), case[4], cuda)
    before = LAUNCHES.get("rwkv6_scan", 0)
    got = wkv(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan"] == before + 1
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    _assert_wkv_close(got, wkv(*args, mode="torch"))


def test_rwkv6_scan_in_place_and_split(cuda):
    """The state written in place into the cache it was read from, and a
    state carried across a split at 17, equal one scan: bit for bit on
    the sequential simt kernel (f32), within the plain version's
    tolerance on the chunked one (bf16), whose chunks start elsewhere
    after a split."""
    from repro_torch.kernels.rwkv6_scan import VARIANTS, reset_variants, wkv

    for dtype, exact in ((torch.float32, True), (torch.bfloat16, False)):
        rng = np.random.default_rng(21)
        r, k, v, w, u, s0 = _wkv_inputs(rng, 2, 100, 4, 64, dtype,
                                        torch.float32, True, cuda)
        reset_variants()
        whole = wkv(r, k, v, w, u, s0)
        cache = s0.clone()
        o1, s1 = wkv(r[:, :17], k[:, :17], v[:, :17], w[:, :17], u, cache,
                     out_state=cache)
        o2, s2 = wkv(r[:, 17:], k[:, 17:], v[:, 17:], w[:, 17:], u, cache,
                     out_state=cache)
        torch.cuda.synchronize()
        assert VARIANTS == {"chunked": 0 if exact else 3,
                            "simt": 3 if exact else 0}
        assert s1 is cache and s2 is cache
        split = (torch.cat([o1, o2], 1), cache)
        if exact:
            assert torch.equal(split[0], whole[0])
            assert torch.equal(split[1], whole[1])
        else:
            _assert_wkv_close(split, whole)
        _assert_wkv_close(whole, wkv(r, k, v, w, u, s0, mode="torch"))


# (t, decays, given state, w dtype): the chunked kernel at one chunk, a
# chunk and a step, ragged lengths; strong decays with w exactly 0 and 1
RWKV_CHUNKED_CASES = [(16, "chip", True, "float32"),
                      (17, "chip", False, "float32"),
                      (33, "chip", True, "bfloat16"),
                      (130, "chip", True, "float32"),
                      (130, "strong", True, "float32"),
                      (130, "strong", False, "bfloat16"),
                      (1024, "model", True, "float32")]


@pytest.mark.parametrize("case", RWKV_CHUNKED_CASES,
                         ids=lambda c: f"t{c[0]}-{c[1]}-"
                         f"{'s' if c[2] else 'z'}-w{c[3]}")
def test_rwkv6_scan_chunked_matches_plain(cuda, case):
    """bf16 r/k/v at head size 64 and t >= 16 go to the chunked kernel,
    which holds the plain version's tolerance."""
    from repro_torch.kernels.rwkv6_scan import VARIANTS, plan, \
        reset_variants, wkv

    t, decays, state, w_dtype = case
    rng = np.random.default_rng(t)
    r, k, v, w, u, s0 = _wkv_inputs(rng, 2, t, 4, 64, torch.bfloat16,
                                    torch.float32, state, cuda)
    if decays == "strong":
        x = 2 * _randn(rng, w.shape, torch.float32, cuda)
        w = torch.exp(-torch.exp(x))
        w[..., ::7] = 0.0
        w[:, 3::5, :, 1::6] = 1.0
    elif decays == "model":
        x = -6.0 + 0.5 * torch.tanh(_randn(rng, w.shape, torch.float32,
                                           cuda))
        w = torch.exp(-torch.exp(x))
    w = w.to(getattr(torch, w_dtype))
    assert plan(r, k, v, w, s0) == "chunked"
    reset_variants()
    got = wkv(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert VARIANTS == {"chunked": 1, "simt": 0}
    assert bool(torch.isfinite(got[0]).all())
    _assert_wkv_close(got, wkv(r, k, v, w, u, s0, mode="torch"))


def test_rwkv6_scan_decay_stays_float32(cuda):
    """w = 0.9975 (the model's decay at decay_w0 = -6) over 1,024 steps
    decays the state to w^1024 ~ 0.077, not bf16(w)^1024 ~ 0.135."""
    from repro_torch.kernels.rwkv6_scan import wkv

    t, n = 1024, 64
    w = torch.full((1, t, 2, n), float(np.exp(-np.exp(-6.0))), device=cuda)
    z = torch.zeros(1, t, 2, n, dtype=torch.bfloat16, device=cuda)
    _, s = wkv(z, z, z, w, torch.zeros(2, n, device=cuda),
               torch.ones(1, 2, n, n, device=cuda))
    torch.cuda.synchronize()
    want = float(np.exp(-np.exp(-6.0), dtype=np.float64) ** t)
    np.testing.assert_allclose(s.cpu().numpy(), want, rtol=1e-4)


def test_rwkv6_scan_refuses_unsupported_head_size(cuda):
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import wkv

    rng = np.random.default_rng(22)
    args = _wkv_inputs(rng, 1, 4, 2, 8, torch.float32, torch.float32, False,
                       cuda)
    before = LAUNCHES.get("rwkv6_scan", 0)
    with pytest.raises(ValueError, match="head size"):
        wkv(*args)
    assert LAUNCHES.get("rwkv6_scan", 0) == before


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_rwkv_generate_launch_counts(cuda, cache_dtype):
    """Reduced rwkv6-7b (2 layers): one prefill and 3 decode steps launch
    rwkv6_scan once per layer each and no other kernel; greedy tokens
    equal to the plain path's."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.rwkv6_scan import VARIANTS, reset_variants
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = get_reduced_config("rwkv6-7b")
    params = M.init_params(0, cfg, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 24), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(cfg=cfg, params=params, max_len=32,
              cache_dtype=getattr(torch, cache_dtype))
    reset_launches()
    reset_variants()
    out = ServeEngine(**kw).generate({"tokens": prompt}, max_new_tokens=4)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    assert launches == {"rwkv6_scan": 4 * cfg.num_layers}, launches
    # float32 activations: every launch on the sequential kernel
    assert VARIANTS == {"chunked": 0, "simt": 4 * cfg.num_layers}
    plain = ServeEngine(mode="torch", **kw).generate({"tokens": prompt},
                                                     max_new_tokens=4)
    assert torch.equal(out, plain)
    assert out.shape == (3, 4) and out.dtype == torch.int32


def test_rwkv_generate_bf16_variants(cuda):
    """Reduced rwkv6-7b (2 layers) in bf16: the 24-token prefill runs the
    chunked kernel once per layer, the 3 decode steps the simt kernel; the
    tokens lie in the vocabulary."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.kernels.rwkv6_scan import VARIANTS, reset_variants
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    cfg = get_reduced_config("rwkv6-7b")
    params = M.init_params(0, cfg, dtype=torch.bfloat16, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (3, 24), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    reset_launches()
    reset_variants()
    out = ServeEngine(cfg=cfg, params=params, max_len=32,
                      cache_dtype=torch.bfloat16).generate(
        {"tokens": prompt}, max_new_tokens=4)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == \
        {"rwkv6_scan": 4 * cfg.num_layers}
    assert VARIANTS == {"chunked": cfg.num_layers,
                        "simt": 3 * cfg.num_layers}
    assert out.shape == (3, 4) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


def test_cohort_scatter_writes_in_place_on_the_card(cuda):
    """The cohort store's scatter writes the cohort's rows into the
    resident buffer itself: the buffer keeps its address, a round's peak
    stays a small fraction of the population's bytes, and a row sampled
    k times holds k."""
    from repro_torch.core.participation import sample_cohort
    from repro_torch.train.store import DeviceStateStore

    m, n, s, c = 2, 200_000, 640, 256
    tier = torch.zeros(m, n, s, device=cuda)
    store = DeviceStateStore({"theta": tier}, m, n)
    gen = torch.Generator(device=cuda).manual_seed(0)
    counts = torch.zeros(m, n, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(4):
        idx = sample_cohort(gen, m, n, c)
        assert idx.is_cuda and idx.dtype == torch.int64
        rows = store.gather(idx)["theta"]
        store.scatter(idx, {"theta": rows + 1.0})
        counts.scatter_add_(1, idx, torch.ones(m, c, device=cuda))
    torch.cuda.synchronize()
    assert store.tree["theta"].data_ptr() == tier.data_ptr()
    assert torch.cuda.max_memory_allocated() - base < tier.numel() * 4 // 20
    assert torch.equal(tier[..., 0], counts)
    assert torch.equal(tier[..., -1], counts)


def test_full_width_cohort_is_the_stacked_run_on_the_card(cuda):
    """cohort/virtual/n1000 (2 x 1,000 devices, MCLR) for 2 rounds with
    cohort = n through the kernel path: bit-equal to the stacked run, and
    prox_update launched K*L = 4 times a round in each."""
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.scenarios import run_scenario

    runs = {}
    for cohort in (None, 1000):
        reset_launches()
        runs[cohort] = run_scenario("cohort/virtual/n1000", rounds=2,
                                    cohort=cohort, device=cuda)
        torch.cuda.synchronize()
        assert {k: v for k, v in LAUNCHES.items() if v} == \
            {"prox_update": 8}
    a, b = runs[None], runs[1000]
    for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss", "participation"):
        assert getattr(a, f) == getattr(b, f), f
    for tier in ("x", "w", "theta"):
        assert torch.equal(getattr(a.state, tier), getattr(b.state, tier))
    assert b.cohort_indices[0] == [list(range(1000))] * 2


# (b, sq, skv, hq, hkv, d, causal, window, q_offset)
ATTN_BWD_CASES = [(2, 100, 100, 4, 2, 32, True, 0, None),
                  (1, 70, 130, 6, 2, 64, False, 0, 0),
                  (2, 90, 90, 4, 4, 96, True, 17, 0),
                  (1, 50, 120, 4, 1, 128, True, 0, None),
                  (1, 64, 200, 4, 4, 64, False, 33, 0),
                  (2, 130, 130, 4, 2, 128, True, 0, 0),
                  # one query row: the simt decode form (64 partitions of
                  # the keys, merged) writes the log-sum-exp; in bf16 at
                  # head_dim 64, 96 and 128 one row plans split_kv, which
                  # has no log-sum-exp output and raises
                  (2, 1, 77, 4, 2, 96, True, 0, None),
                  (2, 1, 77, 4, 2, 32, True, 0, None)]


@pytest.mark.parametrize("case", ATTN_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain(cuda, case, dtype):
    """The backward kernel against ``attention_bwd_ref`` with its
    variant's rounding, from the same (out, lse), which the forward
    kernel wrote (its lse against the plain one's); the variant that ran
    is the tensor-core one for bf16 at head_dim 64, 96 and 128, the
    CUDA-core one for f32 and head_dim 32; repeated launches bit-equal
    (no atomics); one launch counted per call. A bf16 query of one row
    at a tensor-core head_dim plans split_kv, whose forward refuses to
    write the log-sum-exp: that case asserts the refusal."""
    from repro_torch.kernels.flash_attention import (BWD_VARIANTS,
                                                     attention_bwd,
                                                     attention_bwd_ref,
                                                     attention_lse_ref)
    from repro_torch.kernels.flash_attention.ops import _forward
    from repro_torch.kernels.interface import LAUNCHES, KernelType

    b, sq, skv, hq, hkv, d, causal, window, q_offset = case
    q_offset = skv - sq if q_offset is None else q_offset
    rng = np.random.default_rng(sq + d)
    dt = getattr(torch, dtype)
    q, do = (_randn(rng, (b, sq, hq, d), dt, cuda) for _ in range(2))
    k, v = (_randn(rng, (b, skv, hkv, d), dt, cuda) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if sq == 1 and dtype == "bfloat16" and d != 32:
        with pytest.raises(NotImplementedError, match="split_kv"):
            _forward(q, k, v, causal, window, q_offset, KernelType.CUDA,
                     True)
        return
    out, lse = _forward(q, k, v, causal, window, q_offset, KernelType.CUDA,
                        True)
    _, lse_ref = attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    variant = "wgmma" if dtype == "bfloat16" and d != 32 else "simt"
    before = LAUNCHES.get("flash_attention_bwd", 0)
    ran = dict(BWD_VARIANTS)
    got = attention_bwd(q, k, v, out, lse, do, **kw)
    again = attention_bwd(q, k, v, out, lse, do, **kw)
    want = attention_bwd_ref(q, k, v, out, lse, do, variant=variant, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == before + 2
    assert {n: c - ran[n] for n, c in BWD_VARIANTS.items()} == \
        {"wgmma": 0, "simt": 0, variant: 2}
    tol = 1e-4 if dtype == "float32" else TOL[dtype]
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


# the encoder-decoder and VLM training paths' backward shapes, reduced
# (b, sq, skv, hq, hkv, d, causal): a cross-attention of ragged queries
# on more ragged keys, non-causal; sq 192, 1.5 dq CTAs of 128 queries
# (the lse padded to 256), as Whisper's 448 is 3.5; GQA groups 5 and 6
ENCDEC_VLM_BWD_CASES = [(2, 72, 200, 4, 4, 64, False),
                        (2, 192, 192, 4, 4, 64, True),
                        (2, 130, 130, 10, 2, 128, True),
                        (1, 256, 256, 12, 2, 128, True)]


@pytest.mark.parametrize("case", ENCDEC_VLM_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_bwd_encdec_vlm_shapes(cuda, case):
    """bf16 at the training paths' new shapes: the forward (``wgmma``)
    writes the lse of ``attention_lse_ref`` and the backward (``wgmma``)
    gives ``attention_bwd_ref``'s gradients with its rounding within the
    bf16 tolerance, repeats bit-equal; without a causal mask the
    q_offset (``skv - sq``, ``attention``'s default, or 0, which
    ``cross_apply`` passes) changes no bit of either."""
    from repro_torch.kernels.flash_attention import (BWD_VARIANTS, VARIANTS,
                                                     attention_bwd,
                                                     attention_bwd_ref,
                                                     attention_lse_ref)
    from repro_torch.kernels.flash_attention.ops import _forward
    from repro_torch.kernels.interface import KernelType

    b, sq, skv, hq, hkv, d, causal = case
    rng = np.random.default_rng(sq + hq)
    dt = torch.bfloat16
    q, do = (_randn(rng, (b, sq, hq, d), dt, cuda) for _ in range(2))
    k, v = (_randn(rng, (b, skv, hkv, d), dt, cuda) for _ in range(2))
    offsets = (skv - sq, 0) if not causal else (skv - sq,)
    runs = []
    for q_offset in offsets:
        kw = dict(causal=causal, window=0, q_offset=q_offset)
        fwd, bwd = dict(VARIANTS), dict(BWD_VARIANTS)
        out, lse = _forward(q, k, v, causal, 0, q_offset, KernelType.CUDA,
                            True)
        got = attention_bwd(q, k, v, out, lse, do, **kw)
        again = attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert VARIANTS["wgmma"] == fwd["wgmma"] + 1
        assert BWD_VARIANTS["wgmma"] == bwd["wgmma"] + 2
        _, lse_ref = attention_lse_ref(q, k, v, **kw)
        assert lse.shape == (b, hq, sq)
        torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
        want = attention_bwd_ref(q, k, v, out, lse, do, variant="wgmma",
                                 **kw)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            torch.testing.assert_close(g.float(), w.float(),
                                       rtol=TOL["bfloat16"],
                                       atol=TOL["bfloat16"])
        runs.append((out, lse, *got))
    for x, y in zip(runs[0], runs[-1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-2b"])
def test_encdec_vlm_value_and_grad_on_the_card(cuda, arch):
    """Reduced whisper-small and qwen2-vl-2b trained on the card: in
    bf16 one ``value_and_grad`` launches flash_attention and
    flash_attention_bwd once per attention (Whisper: 2 encoder, 2 self,
    2 cross), every one ``wgmma``, and no other kernel; in f32 (``simt``)
    its loss and every leaf's gradient equal the plain path's within 1e-5
    of the leaf's scale, Qwen2-VL's unread ``embed`` zeros."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.flat import tree_leaves
    from repro_torch.kernels.flash_attention import (BWD_VARIANTS, VARIANTS,
                                                     reset_variants)
    from repro_torch.kernels.interface import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.train.trainer import value_and_grad

    cfg = get_reduced_config(arch)
    n = cfg.encoder_layers + cfg.num_layers * (
        2 if cfg.is_encoder_decoder else 1)
    gen = torch.Generator(cuda).manual_seed(2)
    b, s = 2, 80
    batch = {"targets": torch.randint(0, cfg.vocab_size, (b, s),
                                      device=cuda, generator=gen)}
    if cfg.is_encoder_decoder:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                        device=cuda, generator=gen)
        batch["enc_frames"] = torch.randn(b, cfg.encoder_seq_len,
                                          cfg.d_model, device=cuda,
                                          generator=gen)
    else:
        batch["embeds"] = torch.randn(b, s, cfg.d_model, device=cuda,
                                      generator=gen)
        pos = torch.arange(s, device=cuda)[:, None].repeat(1, 3)
        pos[16:48, 1:] = torch.stack([torch.arange(32, device=cuda) // 8,
                                      torch.arange(32, device=cuda) % 8],
                                     -1) + 16
        pos[16:48, 0] = 16
        batch["mrope_positions"] = pos[None].expand(b, -1, -1).int()
        batch["targets"][:, 16:48] = -100
    for dt in (torch.bfloat16, torch.float32):
        params = M.init_params(0, cfg, dtype=dt, device=cuda)
        inputs = {k: v.to(dt) if v.is_floating_point() else v
                  for k, v in batch.items()}
        reset_launches()
        reset_variants()
        loss, grads = value_and_grad(params, cfg, inputs)
        torch.cuda.synchronize()
        assert {k: c for k, c in LAUNCHES.items() if c} == \
            {"flash_attention": n, "flash_attention_bwd": n}
        variant = "wgmma" if dt == torch.bfloat16 else "simt"
        assert VARIANTS[variant] == BWD_VARIANTS[variant] == n
        assert bool(torch.isfinite(loss))
        if dt == torch.bfloat16:
            continue
        lp, gp = value_and_grad(params, cfg, inputs, mode="torch")
        torch.testing.assert_close(loss, lp, rtol=1e-5, atol=1e-5)
        for (name, g), (_, w) in zip(tree_leaves(grads), tree_leaves(gp)):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-5 * scale, name
        if cfg.family == "vlm":
            assert not grads["embed"].any()


def test_attention_autograd_on_the_card(cuda):
    """loss.backward() through the op on the card: one forward and one
    backward launch, gradients equal to the plain path's."""
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.interface import LAUNCHES

    rng = np.random.default_rng(0)
    q = _randn(rng, (2, 64, 4, 64), torch.float32, cuda).requires_grad_()
    k = _randn(rng, (2, 64, 2, 64), torch.float32, cuda).requires_grad_()
    v = _randn(rng, (2, 64, 2, 64), torch.float32, cuda).requires_grad_()
    f0 = LAUNCHES.get("flash_attention", 0)
    b0 = LAUNCHES.get("flash_attention_bwd", 0)
    attention(q, k, v).square().sum().backward()
    assert LAUNCHES["flash_attention"] == f0 + 1
    assert LAUNCHES["flash_attention_bwd"] == b0 + 1
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention(q, k, v, mode="torch").square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-4)


def test_kernels_without_backward_refuse_a_gradient(cuda):
    """Under grad mode the router and WKV ops differentiate on the card (a
    forward and a backward launch each, none refused); the split-kv
    decode and the wire compressors, which have no backward, raise
    instead of returning detached tensors; under no_grad they run."""
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import route_tokens, route_topk
    from repro_torch.kernels.quantize import quantize_int8
    from repro_torch.kernels.rwkv6_scan import wkv

    rng = np.random.default_rng(1)
    x = _randn(rng, (64, 32), torch.float32, cuda).requires_grad_()
    w = _randn(rng, (32, 8), torch.float32, cuda)
    before = {k: LAUNCHES.get(k, 0) for k in (
        "moe_router", "moe_router_bwd", "rwkv6_scan", "rwkv6_scan_bwd")}
    g, _, _, aux = route_tokens(x, w, top_k=2, group_size=64)
    (g.sum() + aux["mean_prob"].sum()).backward()
    g, _, aux = route_topk(x @ w, top_k=2)
    (g.sum() + aux["mean_prob"].sum()).backward()
    r, kk, vv = (_randn(rng, (1, 8, 2, 64), torch.float32, cuda)
                 for _ in range(3))
    decay = torch.rand((1, 8, 2, 64), device=cuda)
    u = _randn(rng, (2, 64), torch.float32, cuda).requires_grad_()
    wkv(r, kk, vv, decay, u)[0].sum().backward()
    assert {k: LAUNCHES[k] - v for k, v in before.items()} == {
        "moe_router": 2, "moe_router_bwd": 2, "rwkv6_scan": 1,
        "rwkv6_scan_bwd": 1}
    assert bool(torch.isfinite(x.grad).all()) and float(u.grad.abs().max()) > 0
    q = _randn(rng, (1, 1, 4, 64), torch.bfloat16, cuda).requires_grad_()
    kv = _randn(rng, (1, 32, 4, 64), torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="split_kv"):
        attention(q, kv, kv)
    with torch.no_grad():
        assert attention(q, kv, kv).shape == q.shape
    v = _randn(rng, (3, 256), torch.float32, cuda).requires_grad_()
    noise = torch.full((3, 256), 0.5, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        quantize_int8(v, noise)
    with torch.no_grad():
        quantize_int8(v, noise)


# --- the backward kernels: moe_router_bwd, rwkv6_scan_bwd -----------------

# (t, E, k, renormalize): one row, odd rows, every expert chosen, E not a
# multiple of 4, deepseek's training shape
ROUTER_BWD_CASES = [(1, 4, 1, True), (37, 16, 2, True), (37, 64, 6, False),
                    (70, 64, 64, True), (1000, 12, 3, True),
                    (4096, 64, 6, True), (4099, 64, 1, True)]


@pytest.mark.parametrize("case", ROUTER_BWD_CASES,
                         ids=lambda c: "x".join(map(str, c[:3]))
                         + ("r" if c[3] else "n"))
@pytest.mark.parametrize("given", ["both", "gates", "mean"])
def test_moe_router_bwd_matches_plain(cuda, case, given):
    """dl of the kernel against route_tokens_bwd_ref on the same logits,
    ids and gates (the forward kernel's, tied rows included; past 8 rows
    the last 5 a padded group's zero rows, mean_prob averaged over all t;
    "gates" / "mean": the other cotangent zero): within
    1e-5 relative and 1e-6 absolute (unit cotangents; the two sum in
    other orders); a repeat bit-equal; one launch."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import logits_bwd, route_topk

    t, e, k, renorm = case
    rng = np.random.default_rng(t + e + k)
    logits = _randn(rng, (t, e), torch.float32, cuda) * 2
    logits[0] = 0.5
    if t > 2:
        logits[2, :4] = 3.0
    pad = 5 if t > 8 else 0
    # a padded last group: zero tokens, so zero logits, and no cotangent
    # for their gates, yet rows of mean_prob's average
    logits[t - pad:] = 0.0
    with torch.no_grad():
        gates, idx, _ = route_topk(logits, top_k=k, renormalize=renorm)
    dg = _randn(rng, (t, k), torch.float32, cuda)
    dm = _randn(rng, (e,), torch.float32, cuda)
    dg[t - pad:] = 0.0
    if given == "mean":             # the zeros autograd hands in
        dg.zero_()
    if given == "gates":
        dm.zero_()
    before = LAUNCHES.get("moe_router_bwd", 0)
    got = logits_bwd(logits, idx, gates, dg, dm, renormalize=renorm)
    again = logits_bwd(logits, idx, gates, dg, dm, renormalize=renorm)
    torch.cuda.synchronize()
    assert LAUNCHES["moe_router_bwd"] == before + 2
    want = logits_bwd(logits, idx, gates, dg, dm, renormalize=renorm,
                      mode="torch")
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# (t, d, E, k, renormalize): one stage, a ragged last stage and d not a
# multiple of 128, E 12 (padded to 16 columns), Jamba's E 16, deepseek's
# training shape, a token range of one stage each, and more items (160
# slices) than the card holds CTAs, so that some CTAs take two; deepseek's
# training shape with its published gates (not renormalised)
ROUTER_FUSED_CASES = [(1, 8, 4, 1, True), (300, 200, 12, 3, True),
                      (130, 256, 16, 2, False), (1000, 2048, 64, 6, True),
                      (4096, 2048, 64, 6, True), (70, 640, 64, 64, True),
                      (200, 20480, 64, 6, True), (4096, 2048, 64, 6, False)]


@pytest.mark.parametrize("case", ROUTER_FUSED_CASES,
                         ids=lambda c: "x".join(map(str, c[:4]))
                         + ("r" if c[4] else "n"))
@pytest.mark.parametrize("need", ["both", "dx", "dw"])
def test_moe_router_bwd_fused_matches_plain(cuda, case, need):
    """The fused backward (dl, dx, dw in one kernel) against
    route_tokens_full_bwd_ref on the fused forward's logits, ids and
    gates (tied rows, zero rows): dx within one bf16 rounding (2^-7) of
    each value plus 1e-5 of the largest, dw within 1e-5 of its largest;
    a repeat bit-equal; plan_bwd picks it, one launch each, counted
    ``fused``; an output not asked for is None."""
    from repro_torch.kernels.interface import LAUNCHES, KernelType
    from repro_torch.kernels.moe_router import BWD_VARIANTS, plan, \
        plan_bwd, tokens_bwd
    from repro_torch.kernels.moe_router.ops import _tokens_forward
    from repro_torch.kernels.moe_router.ref import route_tokens_full_bwd_ref

    t, d, e, k, renorm = case
    rng = np.random.default_rng(t + d + e)
    x = _randn(rng, (t, d), torch.bfloat16, cuda)
    w = _randn(rng, (d, e), torch.float32, cuda) / d ** 0.5
    x[::7] = 0
    if e >= 4:
        w[:, e - 1] = w[:, 0]
    opts = (k, renorm, 64, KernelType.CUDA,
            plan(x, w, top_k=k, group_size=64))
    with torch.no_grad():
        gates, idx, _, _, _, logits = _tokens_forward(x, w, opts, True)
    dg = _randn(rng, (t, k), torch.float32, cuda)
    dm = _randn(rng, (e,), torch.float32, cuda)
    want = dict(zip(("dx", "dw"), route_tokens_full_bwd_ref(
        x, w, logits, idx, gates, dg, dm, renormalize=renorm)[1:]))
    asked = (need != "dw", need != "dx")
    assert plan_bwd(x, w, top_k=k)["variant"] == "fused"
    before = (LAUNCHES.get("moe_router_bwd", 0), BWD_VARIANTS["fused"])
    got = tokens_bwd(x, w, logits, idx, gates, dg, dm, renormalize=renorm,
                     need=asked)
    again = tokens_bwd(x, w, logits, idx, gates, dg, dm,
                       renormalize=renorm, need=asked)
    torch.cuda.synchronize()
    assert (LAUNCHES["moe_router_bwd"], BWD_VARIANTS["fused"]) == (
        before[0] + 2, before[1] + 2)
    for name, g, a, on, rel in zip(("dx", "dw"), got, again, asked,
                                   (2.0 ** -7, 0.0)):
        if not on:
            assert g is None and a is None
            continue
        ref = want[name]
        assert g.dtype == ref.dtype and g.shape == ref.shape
        assert torch.equal(g, a), name
        err = (g.float() - ref.float()).abs()
        tol = rel * ref.float().abs() + 1e-5 * float(ref.float().abs().max())
        assert bool((err <= tol).all()), (name, float(err.max()))


def _route_grads(x, w, dg, fn):
    x, w = (a.detach().clone().requires_grad_() for a in (x, w))
    g, idx, pos, aux = fn(x, w)
    (g * dg).sum().add(aux["mean_prob"].square().sum()).backward()
    return x.grad, w.grad, idx, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_tokens_autograd_on_the_card(cuda, dtype):
    """Gradients of x and w through the fused forward (logits written) and
    the backward kernel against the plain path's, the same ids first;
    one forward and one backward launch; the tile and split forms."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import route_tokens

    for t, gs in ((300, 128), (20, 20)):
        rng = np.random.default_rng(t)
        x = _randn(rng, (t, 256), getattr(torch, dtype), cuda)
        w = _randn(rng, (256, 16), torch.float32, cuda) / 16
        dg = _randn(rng, (t, 2), torch.float32, cuda)
        before = {k: LAUNCHES.get(k, 0) for k in ("moe_router",
                                                  "moe_router_bwd")}
        got = _route_grads(x, w, dg, lambda a, b: route_tokens(
            a, b, top_k=2, group_size=gs))
        assert {k: LAUNCHES[k] - v for k, v in before.items()} == {
            "moe_router": 1, "moe_router_bwd": 1}
        want = _route_grads(x, w, dg, lambda a, b: route_tokens(
            a, b, top_k=2, group_size=gs, mode="torch"))
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


def test_route_tokens_forward_is_the_same_with_its_logits(cuda):
    """The fused forward writing its logits (under a gradient) gives the
    same gates, ids, positions and statistics as without, bit for bit,
    and the logits are the router product's."""
    from repro_torch.kernels.interface import KernelType
    from repro_torch.kernels.moe_router import route_tokens
    from repro_torch.kernels.moe_router.ops import _tokens_forward, plan

    rng = np.random.default_rng(3)
    x = _randn(rng, (1000, 2048), torch.bfloat16, cuda)
    w = _randn(rng, (2048, 64), torch.float32, cuda) / 2048 ** 0.5
    opts = (6, True, 1024, KernelType.CUDA,
            plan(x, w, top_k=6, group_size=1024))
    with torch.no_grad():
        plain = route_tokens(x, w, top_k=6, group_size=1024)
        g, i, p, m, f, logits = _tokens_forward(x, w, opts, True)
    torch.cuda.synchronize()
    assert torch.equal(g, plain[0]) and torch.equal(i, plain[1])
    assert torch.equal(p, plain[2])
    assert torch.equal(m, plain[3]["mean_prob"])
    assert torch.equal(f, plain[3]["frac_tokens"])
    torch.testing.assert_close(logits, x.float() @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_topk_autograd_on_the_card(cuda, dtype):
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.moe_router import route_topk

    rng = np.random.default_rng(11)
    logits = (_randn(rng, (77, 64), torch.float32, cuda) * 2).to(
        getattr(torch, dtype))
    dg = _randn(rng, (77, 6), torch.float32, cuda)
    grads = []
    for mode in (None, "torch"):
        x = logits.clone().requires_grad_()
        before = LAUNCHES.get("moe_router_bwd", 0)
        g, _, aux = route_topk(x, top_k=6, mode=mode)
        (g.float() * dg).sum().add(aux["mean_prob"].square().sum()) \
            .backward()
        assert LAUNCHES.get("moe_router_bwd", 0) - before == (
            1 if mode is None else 0)
        grads.append(x.grad)
    assert grads[0].dtype == logits.dtype
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    torch.testing.assert_close(grads[0].float(), grads[1].float(),
                               rtol=1e-5, atol=tol)


# (b, t, h, n, given state, final cotangent, strong decays: w 0 and 1); the
# last four at head size 64 around the chunked variant's chunk of 16
WKV_BWD_CASES = [(2, 1, 3, 16, True, True, False),
                 (2, 17, 2, 32, False, True, True),
                 (1, 130, 2, 64, True, False, True),
                 (2, 33, 4, 64, True, True, False),
                 (1, 257, 1, 64, False, False, False),
                 (3, 40, 3, 16, True, False, False),
                 (2, 15, 2, 64, True, True, False),
                 (2, 16, 2, 64, False, True, True),
                 (2, 17, 2, 64, True, True, True),
                 (1, 1000, 2, 64, False, True, False)]
# (case, r/k/v type, w type, variant: None for plan_bwd's, or named): both
# variants where the chunked one takes the tensors (bf16, head size 64)
WKV_BWD_PARAMS = [
    (case, dt, wdt, var) for case in WKV_BWD_CASES
    for dt, wdt in (("float32", "float32"), ("bfloat16", "float32"),
                    ("bfloat16", "bfloat16"))
    for var in ((None, "simt", "chunked")
                if dt == "bfloat16" and case[3] == 64 else (None,))]


def _wkv_bwd_args(rng, case, dtype, w_dtype, cuda):
    b, t, h, n, state, final, strong = case
    r, k, v, w, u, s = _wkv_inputs(rng, b, t, h, n, dtype, torch.float32,
                                   state, cuda)
    if strong:
        w = torch.exp(-torch.exp(_randn(rng, (b, t, h, n), torch.float32,
                                        cuda) * 2))
        w[..., ::7] = 0.0
        w[:, 3::5, :, 1::6] = 1.0
    dout = _randn(rng, (b, t, h, n), torch.float32, cuda).to(dtype)
    ds = _randn(rng, (b, h, n, n), torch.float32, cuda)
    if not final:                   # the zeros autograd hands in
        ds.zero_()
    return r, k, v, w.to(w_dtype), u, s, dout, ds


def _assert_wkv_grads_close(got, want):
    """Each gradient within 1e-5 of its largest value (the two sum over
    keys, values and steps in other orders); one in bf16 also within one
    bf16 rounding (2^-7) of each value."""
    for name, g, wt in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                           want):
        assert g.dtype == wt.dtype and g.shape == wt.shape, name
        scale = float(wt.float().abs().max())
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        err = (g.float() - wt.float()).abs()
        assert bool((err <= rel * wt.float().abs() + 1e-5 * scale).all()), \
            (name, float(err.max()), scale)


@pytest.mark.parametrize("case,dtype,w_dtype,variant", WKV_BWD_PARAMS, ids=[
    "x".join(map(str, c[:4])) + ("s" if c[4] else "z") + ("d" if c[5] else "")
    + ("w01" if c[6] else "") + f"-{dt}-w{wdt}-{var or 'plan'}"
    for c, dt, wdt, var in WKV_BWD_PARAMS])
def test_rwkv6_scan_bwd_matches_plain(cuda, case, dtype, w_dtype, variant):
    """A backward kernel against wkv6_bwd_ref: dr, dk, dv in r's type, dw
    in w's, du and dstate float32; the one plan_bwd picks, or each
    variant named on the tensors the chunked one takes; a repeat
    bit-equal; two launches, both counted on the variant that ran."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, plan_bwd, \
        wkv_bwd

    rng = np.random.default_rng(sum(case[:4]))
    args = _wkv_bwd_args(rng, case, getattr(torch, dtype),
                         getattr(torch, w_dtype), cuda)
    ran = variant or plan_bwd(*args[:4], args[5])
    before = LAUNCHES.get("rwkv6_scan_bwd", 0)
    counts = dict(BWD_VARIANTS)
    got = wkv_bwd(*args, variant=variant)
    again = wkv_bwd(*args, variant=variant)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan_bwd"] == before + 2
    assert {k: BWD_VARIANTS[k] - counts[k] for k in counts} == {
        k: 2 if k == ran else 0 for k in counts}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_wkv_grads_close(got, wkv_bwd(*args, mode="torch"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_autograd_on_the_card(cuda, dtype):
    """loss.backward() through wkv on the card (chunked forward and
    backward in bf16, simt in f32) against the plain path's autograd,
    from a given state: one forward and one backward launch, the
    backward counted on the variant plan_bwd picks."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.rwkv6_scan import BWD_VARIANTS, plan, \
        plan_bwd, wkv

    rng = np.random.default_rng(5)
    base = _wkv_inputs(rng, 2, 40, 2, 64, getattr(torch, dtype),
                       torch.float32, True, cuda)
    dout = _randn(rng, (2, 40, 2, 64), torch.float32, cuda)
    dsf = _randn(rng, (2, 2, 64, 64), torch.float32, cuda)
    grads = []
    for mode in (None, "torch"):
        ins = [a.clone().requires_grad_() for a in base]
        before = {k: LAUNCHES.get(k, 0) for k in ("rwkv6_scan",
                                                  "rwkv6_scan_bwd")}
        counts = dict(BWD_VARIANTS)
        out, s = wkv(*ins, mode=mode)
        ((out.float() * dout).sum() + (s * dsf).sum()).backward()
        assert {k: LAUNCHES.get(k, 0) - v for k, v in before.items()} == (
            {"rwkv6_scan": 1, "rwkv6_scan_bwd": 1} if mode is None
            else {"rwkv6_scan": 0, "rwkv6_scan_bwd": 0})
        assert {k: BWD_VARIANTS[k] - counts[k] for k in counts} == {
            k: int(mode is None and k == plan_bwd(*base[:4]))
            for k in counts}
        grads.append([a.grad for a in ins])
    assert plan(*base[:4]) == ("chunked" if dtype == "bfloat16" else "simt")
    _assert_wkv_grads_close(*grads)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b"])
def test_tiered_llm_example_on_the_card_moe_and_rwkv(cuda, capsys, arch):
    """examples/tiered_llm_training_torch.py on the card for the reduced
    deepseek (2 MoE layers) and rwkv6 (2 RWKV layers), 3 rounds: its
    assertion holds, and each device step went through the backward
    kernels (2 teams x 2 local steps x 2 layers a round)."""
    import importlib.util
    import pathlib

    from repro_torch.kernels.interface import LAUNCHES

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "tiered_llm_training_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = (("flash_attention_bwd", "moe_router_bwd")
             if arch.startswith("deepseek") else ("rwkv6_scan_bwd",))
    before = {k: LAUNCHES.get(k, 0) for k in names}
    pm, gm = mod.main(["--rounds", "3", "--arch", arch])
    assert pm <= gm and np.isfinite(pm)
    for k in names:
        assert LAUNCHES[k] - before[k] == 3 * 2 * 2 * 2, k
    assert "round   2: personalized loss" in capsys.readouterr().out


def test_tiered_llm_example_on_the_card(cuda, capsys):
    """examples/tiered_llm_training_torch.py on the card (reduced phi3,
    3 rounds): its assertion holds, and every device step went through
    the attention kernels and prox_update (2 teams x 2 local steps x 2
    layers a round; 12 leaves a step), every team's updates through
    tier_update (one launch a leaf)."""
    import importlib.util
    import pathlib

    from repro_torch.kernels.interface import LAUNCHES

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "tiered_llm_training_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = {k: LAUNCHES.get(k, 0) for k in ("flash_attention_bwd",
                                              "prox_update", "tier_update")}
    pm, gm = mod.main(["--rounds", "3"])
    assert pm <= gm and np.isfinite(pm)
    assert LAUNCHES["flash_attention_bwd"] - before["flash_attention_bwd"] \
        == 3 * 2 * 2 * 2
    assert LAUNCHES["prox_update"] - before["prox_update"] == 3 * 2 * 2 * 12
    assert LAUNCHES["tier_update"] - before["tier_update"] == 3 * 2 * 12
    assert "round   2: personalized loss" in capsys.readouterr().out


# --- Mamba's selective scan: mamba_scan, mamba_scan_bwd -------------------

# (b, s, d_in, given h0, final-state cotangent[, A on the lattice]): one
# step, an odd length, d_in not a multiple of a CTA (simt), segments
# crossed, a long ragged scan; d_in 128 and 256 run ring (and simt on the
# same tensors); A off the initial value's lattice in both variants
MAMBA_CASES = [(2, 1, 64, True, True), (2, 17, 100, False, False),
               (3, 130, 256, True, True), (1, 1000, 128, True, False),
               (4, 64, 192, False, True), (2, 130, 256, True, True, False),
               (2, 17, 100, True, True, False)]


def _mamba_inputs(rng, b, s, d_in, dtype, h0, cuda, lattice=True):
    """xc, dt (softplus, about 0.7), B and C as strided views of one (b,
    s, 8 + 32) projection, A = -(1..16) scaled per row (``lattice``) or
    -exp(log(1..16) + N(0, 0.3)) per entry, h0 or None."""
    xc = _randn(rng, (b, s, d_in), dtype, cuda)
    dt = torch.nn.functional.softplus(
        _randn(rng, (b, s, d_in), torch.float32, cuda)).to(dtype)
    proj = _randn(rng, (b, s, 8 + 32), dtype, cuda)
    _, b_mat, c_mat = proj.split([8, 16, 16], dim=-1)
    n = torch.arange(1, 17, dtype=torch.float32, device=cuda)
    if lattice:
        a = (-n * torch.from_numpy(rng.uniform(0.5, 1.5, (d_in, 1)).astype(
            np.float32)).to(cuda)).contiguous()
    else:
        a = -(n.log() + torch.from_numpy(rng.normal(0.0, 0.3, (
            d_in, 16)).astype(np.float32)).to(cuda)).exp()
    state = (_randn(rng, (b, d_in, 16), torch.float32, cuda) * 0.5
             if h0 else None)
    return xc, dt, b_mat, c_mat, a, state


def _mamba_id(case):
    return "x".join(map(str, case[:3])) + ("" if all(case[5:]) else "-off")


def _mamba_variants(args):
    """The variants a test runs on these tensors: the one plan picks,
    then simt where that is ring."""
    from repro_torch.kernels.mamba_scan import plan

    return ["ring", "simt"] if plan(*args) == "ring" else ["simt"]


def _assert_mamba_close(got, want):
    """Each tensor within 1e-5 of its largest value (sums in other
    orders), a bf16 one also within one bf16 rounding (2^-7) of each
    value."""
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        rel = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        bound = rel * w.float().abs() + 1e-5 * float(w.float().abs().max())
        assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("case", MAMBA_CASES, ids=_mamba_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_matches_plain(cuda, case, dtype):
    """Each forward variant (the one plan picks, and simt on the same
    tensors) against scan_ref: y, the final state and the snapshots (at
    the variant's cadence), two launches bit-equal and counted."""
    from repro_torch.kernels.interface import KernelType, LAUNCHES
    from repro_torch.kernels.mamba_scan import SNAPSHOT_EVERY, ops, scan_ref

    b, s, d_in, h0, _ = case[:5]
    args = _mamba_inputs(np.random.default_rng(s + d_in), b, s, d_in,
                         getattr(torch, dtype), h0, cuda, *case[5:])
    for variant in _mamba_variants(args):
        every = SNAPSHOT_EVERY[variant]
        before = LAUNCHES.get("mamba_scan", 0)
        got = ops._forward(*args, every, args[0].dtype, KernelType.CUDA,
                           True, variant=variant)
        again = ops._forward(*args, every, args[0].dtype, KernelType.CUDA,
                             True, variant=variant)
        torch.cuda.synchronize()
        assert LAUNCHES["mamba_scan"] == before + 2
        assert all(torch.equal(x, z) for x, z in zip(got, again))
        want = scan_ref(*args, segment=every, snapshots=True)
        _assert_mamba_close(got, want)


@pytest.mark.parametrize("case", MAMBA_CASES, ids=_mamba_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_bwd_matches_plain(cuda, case, dtype):
    """Each backward variant (the one plan picks, and simt on the same
    tensors) against scan_bwd_ref from the same snapshots at its cadence:
    dxc, ddt, dB, dC, dA and dh0, with and without a final-state
    cotangent; two launches bit-equal and counted."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.mamba_scan import SNAPSHOT_EVERY, scan_bwd, \
        scan_ref

    b, s, d_in, h0, final = case[:5]
    rng = np.random.default_rng(7 * s + d_in)
    dt_ = getattr(torch, dtype)
    args = _mamba_inputs(rng, b, s, d_in, dt_, h0, cuda, *case[5:])
    dy = _randn(rng, (b, s, d_in), dt_, cuda)
    dh = _randn(rng, (b, d_in, 16), torch.float32, cuda) if final else None
    for variant in _mamba_variants(args):
        every = SNAPSHOT_EVERY[variant]
        snaps = scan_ref(*args, segment=every, snapshots=True)[2]
        before = LAUNCHES.get("mamba_scan_bwd", 0)
        got = scan_bwd(*args[:5], snaps, dy, dh, every=every,
                       variant=variant, want_dh0=True)
        again = scan_bwd(*args[:5], snaps, dy, dh, every=every,
                         variant=variant, want_dh0=True)
        torch.cuda.synchronize()
        assert LAUNCHES["mamba_scan_bwd"] == before + 2
        assert all(torch.equal(x, z) for x, z in zip(got, again))
        want = scan_bwd(*args[:5], snaps, dy, dh, segment=every,
                        want_dh0=True, mode="torch")
        _assert_mamba_close(got, want)
        assert scan_bwd(*args[:5], snaps, dy, dh, every=every,
                        variant=variant)[5] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_autograd_on_the_card(cuda, dtype):
    """loss.backward() through the reduced Jamba mixer on the card (70
    steps from a cache) against the plain path's autograd: one forward
    and one backward launch, every leaf's and the input's gradient
    within 1e-4 of its scale (bf16: 2e-2)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.models import mamba

    cfg = get_reduced_config("jamba-1.5-large-398b")
    dt_ = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = mamba.mamba_init(gen, cfg, dt_)
    rng = np.random.default_rng(3)
    x = _randn(rng, (2, 70, cfg.d_model), dt_, cuda) * 0.3
    dy = _randn(rng, (2, 70, cfg.d_model), torch.float32, cuda)
    cache0 = mamba.init_mamba_cache(cfg, 2, dt_, device=cuda)
    cache0["ssm"].normal_(generator=gen)
    grads = []
    for mode in (None, "torch"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xi = x.clone().requires_grad_()
        cache = {k: v.clone() for k, v in cache0.items()}
        before = {k: LAUNCHES.get(k, 0) for k in ("mamba_scan",
                                                  "mamba_scan_bwd")}
        y, _ = mamba.mamba_apply(leaves, cfg, xi, cache=cache, mode=mode)
        (y.float() * dy).sum().backward()
        assert {k: LAUNCHES.get(k, 0) - v for k, v in before.items()} == (
            {"mamba_scan": 1, "mamba_scan_bwd": 1} if mode is None
            else {"mamba_scan": 0, "mamba_scan_bwd": 0})
        grads.append([xi.grad] + [leaves[k].grad for k in sorted(leaves)])
    tol = 1e-4 if dtype == "float32" else 2e-2
    for g, w in zip(*grads):
        assert bool(torch.isfinite(g).all())
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


def test_mamba_scan_refuses_what_it_does_not_take(cuda):
    """Mixed types and a state size other than 16 raise on the card; no
    launch, nothing in the kernel's place."""
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.mamba_scan import scan

    xc, dt, b_mat, c_mat, a, h0 = _mamba_inputs(
        np.random.default_rng(0), 1, 9, 64, torch.bfloat16, True, cuda)
    before = LAUNCHES.get("mamba_scan", 0)
    with pytest.raises(TypeError, match="one type"):
        scan(xc, dt.float(), b_mat, c_mat, a, h0)
    with pytest.raises(ValueError, match="N = 16"):
        scan(xc, dt, b_mat[..., :8], c_mat[..., :8], a[:, :8], None)
    assert LAUNCHES.get("mamba_scan", 0) == before


def test_tiered_llm_example_on_the_card_jamba(cuda, capsys):
    """examples/tiered_llm_training_torch.py on the card for the reduced
    Jamba ([(mamba, dense), (attn, MoE)] x 4), 3 rounds: its assertion
    holds, and each device step went through the selective scan's
    forward and backward kernels (2 teams x 2 local steps x 4 Mamba
    layers a round)."""
    import importlib.util
    import pathlib

    from repro_torch.kernels.interface import LAUNCHES

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "tiered_llm_training_torch.py")
    spec = importlib.util.spec_from_file_location("tiered_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = ("mamba_scan_bwd", "flash_attention_bwd", "moe_router_bwd")
    before = {k: LAUNCHES.get(k, 0) for k in names}
    pm, gm = mod.main(["--rounds", "3", "--arch", "jamba-1.5-large-398b"])
    assert pm <= gm and np.isfinite(pm)
    for k in names:
        assert LAUNCHES[k] - before[k] == 3 * 2 * 2 * 4, k
    assert "round   2: personalized loss" in capsys.readouterr().out


# --- tier_update: the tier round's team and server updates (eqs. 9, 13) --

TIER_HP = {"phi3": dict(eta=0.03, lam=0.5, gamma=1.5, beta=0.3),
           "other": dict(eta=0.07, lam=1.3, gamma=0.8, beta=0.45)}
W_GATE = 32 * 3072 * 8192          # phi3-mini's largest leaf, w_gate


def _tier_inputs(n, dtype, cuda, offset=0):
    """w, x, theta of ``n`` values drawn on the card, each a view
    ``offset`` values into its buffer (1: not 16-byte aligned)."""
    gen = torch.Generator(device=cuda).manual_seed(n % 1000 + offset)
    return [(s * torch.randn(n + offset, generator=gen, device=cuda))
            .to(getattr(torch, dtype))[offset:] for s in (1.0, 0.5, 2.0)]


def _tier_bit_equal(w, x, theta, hp):
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.tier_update import tier_update

    before = LAUNCHES.get("tier_update", 0)
    got = tier_update(w, x, theta, **hp)
    torch.cuda.synchronize()
    assert LAUNCHES["tier_update"] == before + 1
    want = tier_update(w, x, theta, mode="torch", **hp)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and g.shape == wt.shape
        assert torch.equal(g, wt)


@pytest.mark.parametrize("hp", sorted(TIER_HP))
@pytest.mark.parametrize("n", [1, 7, 8 * 1024 + 3, W_GATE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tier_update_kernel_bit_equal(cuda, hp, n, dtype):
    """The kernel against the eight eager ops it replaces, bit for bit:
    one value, a scalar tail alone, vectors and a tail, phi3's w_gate."""
    w, x, theta = _tier_inputs(n, dtype, cuda)
    _tier_bit_equal(w, x, theta, TIER_HP[hp])


@pytest.mark.parametrize("offset", ["all", "theta"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tier_update_kernel_unaligned_views_bit_equal(cuda, offset, dtype):
    """Views one value into their buffers take the scalar path."""
    w, x, theta = _tier_inputs(8 * 1024 + 3, dtype, cuda)
    shifted = _tier_inputs(8 * 1024 + 3, dtype, cuda, offset=1)
    if offset == "all":
        w, x, theta = shifted
    else:
        theta = shifted[2]
    assert theta.data_ptr() % 16
    _tier_bit_equal(w, x, theta, TIER_HP["phi3"])


def test_tier_update_kernel_leaves_aliased_inputs(cuda):
    """One tensor as w, x and theta (a tier round's first): it is read,
    never written, and the outputs are new."""
    from repro_torch.kernels.tier_update import tier_update

    (w, *_) = _tier_inputs(8 * 1024 + 3, "bfloat16", cuda)
    before = w.clone()
    got = tier_update(w, w, w, **TIER_HP["phi3"])
    torch.cuda.synchronize()
    assert torch.equal(w, before)
    assert {t.data_ptr() for t in got}.isdisjoint({w.data_ptr()})
    _tier_bit_equal(w, w, w, TIER_HP["phi3"])


def _phi3_round(cuda):
    """A 2-layer phi3 cut in bf16 on the card, its tier round (l_local 2)
    and a batch of 2 x 64 tokens."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.trainer import make_tier_round

    cfg = get_reduced_config("phi3-mini-3.8b")
    params = M.init_params(0, cfg, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                        device=cuda)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    round_fn = make_tier_round(cfg, l_local=2, alpha=3e-3,
                               **TIER_HP["phi3"])
    return params, batch, round_fn


def test_tier_round_launches_tier_update_once_a_leaf(cuda):
    """A round of a 2-layer phi3 cut: one tier_update launch a leaf, and
    w', x' the plain version's updates of the round's theta', bit for
    bit."""
    from repro_torch.flat import tree_leaves
    from repro_torch.kernels.interface import LAUNCHES
    from repro_torch.kernels.tier_update import tier_update_tree

    params, batch, round_fn = _phi3_round(cuda)
    leaves = len(tree_leaves(params))
    before = LAUNCHES.get("tier_update", 0)
    theta, w, x, _ = round_fn(params, params, params, batch)
    torch.cuda.synchronize()
    assert LAUNCHES["tier_update"] - before == leaves
    want = tier_update_tree(params, params, theta, mode="torch",
                            **TIER_HP["phi3"])
    for got, wt in zip((w, x), want):
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_leaves(got), tree_leaves(wt)))


def test_only_tier_update_runs_under_the_update_spans(cuda, tmp_path):
    """A round of the 2-layer phi3 cut traced with its spans: under
    ``team_update`` one tier_update kernel a leaf, under
    ``server_update`` no device work."""
    import json

    from bench import spans

    from repro_torch.flat import tree_leaves
    from repro_torch.obs.spans import SpanLog

    params, batch, round_fn = _phi3_round(cuda)
    round_fn(params, params, params, batch)          # builds, warms up
    torch.cuda.synchronize()
    log = SpanLog()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with log.activate():
            round_fn(params, params, params, batch)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    window = spans.read(json.loads(path.read_text()), log)
    owned = [(op[0], sp[0]) for op, sp in spans.attribute(window)
             if sp and spans.under(sp[0], ("team_update", "server_update"))]
    assert [p for _, p in owned] == \
        ["tier_round/team_update"] * len(tree_leaves(params))
    assert all("tier_update_kernel<" in name for name, _ in owned)


# deepseek-moe-16b's benchmark path cut small in float32: 1 dense + 2 MoE
# layers of width 128 (4 heads of 32), dense width 320, 8 experts of
# width 64, top-2, 2 shared, vocabulary 512, 2 x 64 tokens
MOE_SMALL = {"num_layers": 3, "first_dense_layers": 1, "d_model": 128,
             "num_heads": 4, "num_kv_heads": 4, "head_dim": 32, "d_ff": 320,
             "vocab_size": 512, "rope_theta": 10000.0, "norm_eps": 1e-6,
             "tie_embeddings": False,
             "moe": {"num_experts": 8, "num_shared_experts": 2, "top_k": 2,
                     "expert_d_ff": 64, "aux_weight": 0.001,
                     "capacity_factor": 1.25, "group_size": 1024}}


@pytest.mark.parametrize("renorm", [False, True])
def test_moe_tier_round_matches_the_reference(cuda, renorm):
    """One tier round of the small cut through the kernels (attention
    ``simt``, the fused router and its backward, prox_update a leaf a
    step, tier_update a leaf) against ``bench/reference/deepseek_moe.py``
    on the card, TF32 off: the loss within 1e-4 relative and every leaf
    of the three tiers within 1e-5 of its scale (float32 sums in other
    orders, as on the CPU); the kernels launched once a layer (the
    router once a MoE layer) a pass."""
    import numpy as np

    import repro_torch.train.trainer as trainer
    from bench.reference import deepseek_moe as ref
    from repro_torch.configs import MoEConfig, get_config
    from repro_torch.flat import tree_leaves
    from repro_torch.kernels.interface import LAUNCHES

    m = {**MOE_SMALL, "moe": {**MOE_SMALL["moe"], "renormalize": renorm}}
    mo = m["moe"]
    cfg = get_config("deepseek-moe-16b").replace(
        **{k: v for k, v in m.items() if k != "moe"},
        moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                      expert_d_ff=64, router_aux_weight=mo["aux_weight"],
                      capacity_factor=mo["capacity_factor"],
                      renormalize=renorm))
    rng = np.random.default_rng(41)
    tok = torch.as_tensor(rng.integers(0, 512, (2, 65)), device=cuda)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    params = ref.init_params(m, 41, cuda, torch.float32)
    hp = dict(alpha=3e-3, lam=0.5, gamma=1.5, eta=0.03, beta=0.3,
              l_local=2)
    want = ref.tier_round(params, params, params, m, batch["tokens"],
                          batch["targets"], hp)
    before = dict(LAUNCHES)
    got = trainer.make_tier_round(cfg, **hp)(
        *(ref.nest(params),) * 3, batch)
    torch.cuda.synchronize()
    counts = {k: LAUNCHES.get(k, 0) - before.get(k, 0)
              for k in ("flash_attention", "flash_attention_bwd",
                        "moe_router", "moe_router_bwd", "prox_update",
                        "tier_update")}
    assert counts == {"flash_attention": 6, "flash_attention_bwd": 6,
                      "moe_router": 4, "moe_router_bwd": 4,
                      "prox_update": 2 * len(params),
                      "tier_update": len(params)}
    assert abs(float(got[3]["loss"]) - want[3]) <= 1e-4 * abs(want[3])
    for tree, ref_tree in zip(got[:3], want[:3]):
        flat = {"/".join(p): v for p, v in tree_leaves(tree)}
        assert set(flat) == set(ref_tree)
        for k, v in flat.items():
            scale = float(ref_tree[k].abs().max())
            err = float((v - ref_tree[k]).abs().max())
            assert err <= 1e-5 * scale, (k, err, scale)
