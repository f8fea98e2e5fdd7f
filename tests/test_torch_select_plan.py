"""The tiled select kernel's math in plain PyTorch (``ref.select_tiled``)
on the CPU, and where its tiles lie (``compress.tiles``).

``select_tiled`` is the count-then-scan of ``csrc/select_hopper.cu``:
each tile's strict and tie counts, the counts of the tiles before it, the
leaf's cap, then the inclusive counts inside the tile. It is held with
``torch.equal`` (dq, ranks, and with error feedback ef' = msg - dq) to the
port's plain select, to the JAX package's ``topk_select_ref``,
``randk_select_ref``, ``ef_topk_select_ref`` and ``ef_randk_select_ref``,
and to the Pallas kernels in interpret mode, on numpy inputs from seeds:
tiles of 32, 128 and 4096 values over leaves of 1, 127, 4097 and 9000,
ties that straddle tile boundaries, a tie-fill that ends exactly at a
tile's end and one that ends mid-tile, a zero-heavy leaf (threshold 0),
n_strict = k - 1, and tied rand-k uniforms.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread, not one per core in each worker
torch.set_num_threads(1)

from repro.kernels.compress import compress as JP  # noqa: E402
from repro.kernels.compress import ref as JR  # noqa: E402

B = 2                     # senders
TILES = (32, 128, 4096)


def _signed(rng, mags):
    return (mags * rng.choice([-1.0, 1.0], size=mags.shape)).astype(
        np.float32)


def _leaf(rng, p, strict, ties):
    """(B, p) values whose |v| is 2..3 at ``strict``, exactly 1 at
    ``ties`` and under 1 elsewhere, random signs."""
    mags = rng.uniform(0.0, 0.99, size=(B, p))
    mags[:, ties] = 1.0
    mags[:, strict] = rng.uniform(2.0, 3.0, size=(B, len(strict)))
    return _signed(rng, mags)


def _case(name):
    """(scores source: v for top-k, u for rand-k, (B, p); k)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random"):
        p = int(name.split()[1])
        return rng.standard_normal((B, p)).astype(np.float32), \
            max(1, round(0.1 * p))
    if name == "ties straddle tiles":
        # ties 20..299 cross the 32- and 128-value tile ends; cap = 100
        strict = list(range(0, 20, 3)) + [4096]
        return _leaf(rng, 4097, strict, list(range(20, 300))), \
            len(strict) + 100
    if name == "tie-fill ends at a tile's end":
        # the cap-th tie is value 255: the end of a 32- and a 128-tile
        strict = [3, 40, 300, 4096]
        ties = list(range(100, 256)) + list(range(400, 4090, 7))
        return _leaf(rng, 4097, strict, ties), len(strict) + 156
    if name == "tie-fill ends mid-tile":
        strict = [5, 4100, 8999]
        ties = list(range(10, 9000, 5))
        return _leaf(rng, 9000, strict, ties), len(strict) + 1000
    if name == "zero-heavy":
        # 95% zeros: the threshold is 0, the zeros are the ties
        v = rng.standard_normal((B, 9000)).astype(np.float32)
        v[:, rng.permutation(9000)[:8550]] = 0.0
        return v, 900
    if name == "n_strict = k - 1":
        strict = list(range(1, 4097, 41))
        return _leaf(rng, 4097, strict, list(range(0, 4097, 2))), \
            len(strict) + 1
    if name == "one value":
        return rng.standard_normal((B, 1)).astype(np.float32), 1
    raise KeyError(name)


CASES = ["random 1", "random 127", "random 4097", "random 9000",
         "ties straddle tiles", "tie-fill ends at a tile's end",
         "tie-fill ends mid-tile", "zero-heavy", "n_strict = k - 1",
         "one value"]


def _randk_inputs(name):
    """(u, v, k) with uniforms tied the way the case ties scores: its
    scores mapped into [0, 1) keep their order and their ties."""
    x, k = _case(name)
    rng = np.random.default_rng(7 + len(name))
    mags = np.abs(x)
    if name.startswith("random"):
        u = np.floor(rng.random(x.shape) * 8.0) / 8.0     # tied uniforms
    else:
        u = mags / (mags.max() + 1.0)
    v = rng.standard_normal(x.shape).astype(np.float32)
    return u.astype(np.float32), v, k


def _ef_split(x, seed):
    """(delta, ef) whose f32 sum is the case's values where they are
    exact (ties and zeros stay ties and zeros)."""
    rng = np.random.default_rng(seed)
    ef = np.where(rng.random(x.shape) < 0.5, 0.0, x).astype(np.float32)
    return (x - ef).astype(np.float32), ef


def _jax_rows(fn, *rows):
    outs = [fn(*(jnp.asarray(r[i]) for r in rows)) for i in range(B)]
    return [np.stack([np.asarray(o[j]) for o in outs])
            for j in range(len(outs[0]))]


def _tiled(score, v, k, tile, scale=None):
    from repro_torch.kernels.compress import ref as R

    score, v = torch.from_numpy(score), torch.from_numpy(v)
    return R.select_tiled(score, v, R.kth_threshold(score, k), k, tile,
                          scale)


def _equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", CASES)
def test_tiled_topk_matches_port_and_jax(name):
    from repro_torch.kernels import compress as K

    x, k = _case(name)
    segs = K.segments((x.shape[1],), (k,))
    want = [o.numpy() for o in K.topk(torch.from_numpy(x), segs)]
    _equal(want, _jax_rows(lambda v: JR.topk_select_ref(v, k), x))
    for tile in TILES:
        _equal(_tiled(np.abs(x), x, k, tile), want)


@pytest.mark.parametrize("name", CASES)
def test_tiled_ef_topk_matches_port_and_jax(name):
    from repro_torch.kernels import compress as K

    x, k = _case(name)
    d, e = _ef_split(x, 3)
    msg = d + e
    segs = K.segments((x.shape[1],), (k,))
    want = [o.numpy() for o in K.ef_topk(torch.from_numpy(d),
                                         torch.from_numpy(e), segs)]
    _equal(want, _jax_rows(lambda a, b: JR.ef_topk_select_ref(a, b, k), d,
                           e))
    for tile in TILES:
        dq, ranks = _tiled(np.abs(msg), msg, k, tile)
        _equal((dq, ranks, torch.from_numpy(msg) - dq), want)


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_tiled_randk_matches_port_and_jax(name, unbiased):
    from repro_torch.kernels import compress as K

    u, v, k = _randk_inputs(name)
    p = v.shape[1]
    segs = K.segments((p,), (k,))
    want = [o.numpy() for o in K.randk(torch.from_numpy(u),
                                       torch.from_numpy(v), segs,
                                       unbiased=unbiased)]
    _equal(want, _jax_rows(lambda a, b: JR.randk_select_ref(
        a, b, k, p / k if unbiased else 1.0), u, v))
    scale = K.unbiased_scales(segs, "cpu")[0] if unbiased else None
    for tile in TILES:
        _equal(_tiled(u, v, k, tile, scale), want)


@pytest.mark.parametrize("name", CASES)
def test_tiled_ef_randk_matches_port_and_jax(name):
    from repro_torch.kernels import compress as K

    u, x, k = _randk_inputs(name)
    d, e = _ef_split(x, 4)
    msg = d + e
    segs = K.segments((x.shape[1],), (k,))
    want = [o.numpy() for o in K.ef_randk(
        torch.from_numpy(u), torch.from_numpy(d), torch.from_numpy(e), segs)]
    _equal(want, _jax_rows(lambda a, b, c: JR.ef_randk_select_ref(
        a, b, c, k), u, d, e))
    for tile in TILES:
        dq, ranks = _tiled(u, msg, k, tile)
        _equal((dq, ranks, torch.from_numpy(msg) - dq), want)


@pytest.mark.parametrize("op", ["topk", "ef_topk", "randk", "ef_randk"])
@pytest.mark.parametrize("name", ["tie-fill ends at a tile's end",
                                  "zero-heavy"])
def test_tiled_matches_interpret_pallas(op, name):
    """The Pallas kernel bodies (interpret mode) on sender 0's leaf, given
    the reference's threshold, against ``select_tiled`` at 128-value
    tiles."""
    if op.endswith("topk"):
        x, k = _case(name)
        u = None
    else:
        u, x, k = _randk_inputs(name)
    p = x.shape[1]
    d, e = _ef_split(x, 5)
    msg = d + e if op.startswith("ef_") else x
    score = np.abs(msg) if u is None else u
    thresh = JR.kth_threshold(jnp.asarray(score[0]), k)
    if op == "topk":
        got = JP.topk_select_flat(jnp.asarray(x[0]), thresh, k=k,
                                  interpret=True)
    elif op == "ef_topk":
        got = JP.ef_topk_select_flat(jnp.asarray(d[0]), jnp.asarray(e[0]),
                                     thresh, k=k, interpret=True)
    elif op == "randk":
        got = JP.randk_select_flat(jnp.asarray(u[0]), jnp.asarray(x[0]),
                                   thresh, k=k, scale=p / k, interpret=True)
    else:
        got = JP.ef_randk_select_flat(jnp.asarray(u[0]), jnp.asarray(d[0]),
                                      jnp.asarray(e[0]), thresh, k=k,
                                      interpret=True)
    scale = torch.tensor(p / k, dtype=torch.float32) if op == "randk" \
        else None
    dq, ranks = _tiled(score[:1], msg[:1], k, 128, scale)
    want = [dq[0], ranks[0]]
    if op.startswith("ef_"):
        want.append(torch.from_numpy(msg[0]) - dq[0])
    _equal(want, [np.asarray(g) for g in got])


def _served(name):
    """The uplinks' top-k segment table of the paper model ``name``."""
    from repro_torch.comm import CommConfig, compression_plan
    from repro_torch.configs import paper_cnn, paper_mclr
    from repro_torch.flat import Layout
    from repro_torch.kernels import compress as K
    from repro_torch.models.paper_models import init_params

    cfg = {"cnn": paper_cnn, "mclr": paper_mclr}[name].CONFIG
    sizes = Layout.of(init_params(
        cfg, torch.Generator().manual_seed(0))).leaf_sizes
    return K.segments(sizes, tuple(
        pl.k for pl in compression_plan(CommConfig("topk"), sizes)))


@pytest.mark.parametrize("name,want", [
    ("cnn", (0, 1, 2, 3, 5, 6, 55, 56, 57)), ("mclr", (0, 1, 3))])
def test_tiles_of_the_served_tables(name, want):
    """Each leaf's first tile and the total at the served tables: the
    CNN's eight leaves make 57 tiles of 4,096 values (its dense leaf of
    200,704 values 49), the MCLR's two leaves 3; no tile crosses a leaf's
    end."""
    from repro_torch.kernels import compress as K

    assert K.TILE == 4096
    assert K.tiles(_served(name)) == want


@pytest.mark.parametrize("lengths", [(1,), (4096,), (4097,), (3, 9000, 4096),
                                     (10, 3 * 4096 + 100)])
def test_tiles_cover_each_leaf(lengths):
    """A leaf of p values gets ceil(p / TILE) tiles, in leaf order."""
    from repro_torch.kernels import compress as K

    starts = K.tiles(K.segments(lengths))
    assert starts[0] == 0
    assert [b - a for a, b in zip(starts, starts[1:])] == [
        -(-p // K.TILE) for p in lengths]
