"""The port's partition specs against the reference's
(``repro/sharding/specs.py``), on the CPU, as tuples.

* ``param_pspecs`` (FSDP on and off) on every architecture's parameter
  tree at published widths (the port's fake tree has the reference's
  paths, shapes and dtypes); ``batch_pspecs``; ``cache_pspecs`` at
  decode_32k and at long_500k's batch of 1.
* ``validate_pspecs`` for a (16, 16) mesh (the reference on an abstract
  mesh): whisper's vocabulary 51,865 and 8 kv heads on a 16-way axis.
* ``fl_pspecs``, ``store_pspecs`` and ``sweep_pspecs`` on the reference
  tests' trees, ``DeviceStateStore.pspecs``, and ``place`` on the
  one-card mesh: specs validated, leaves put whole on the mesh's device.
* ``run_sweep(mesh=make_host_mesh(n_sweep=1))`` bit-equal to
  ``run_sweep()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import specs as JS  # noqa: E402

MESH_16 = {"data": 16, "model": 16}


def _paths(tree, prefix=""):
    """{path: leaf} of a port tree of tensors (or of specs)."""
    from repro_torch.sharding.specs import P

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    assert isinstance(tree, (torch.Tensor, P)), type(tree)
    return {prefix.lstrip("/"): tree}


def _jax_paths(tree):
    from jax.sharding import PartitionSpec

    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _same_specs(mine, ref):
    got = {k: tuple(v) for k, v in _paths(mine).items()}
    want = {k: tuple(v) for k, v in _jax_paths(ref).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_the_reference(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import param_pspecs, validate_pspecs

    mine = M.param_specs(get_config(arch))
    ref = JM.param_specs(j_config(arch), dtype=jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _paths(mine).items()} == \
        {k: (tuple(v.shape), str(v.dtype))
         for k, v in _jax_paths(ref).items()}
    for fsdp in (True, False):
        _same_specs(param_pspecs(mine, fsdp=fsdp),
                    JS.param_pspecs(ref, fsdp=fsdp))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    _same_specs(validate_pspecs(mine, param_pspecs(mine), MESH_16),
                JS.validate_pspecs(ref, JS.param_pspecs(ref), amesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_pspecs_match_the_reference(arch):
    """decode_32k's cache (batch 128) and long_500k's (batch 1: the KV
    sequence shards instead), each validated for a (16, 16) mesh too."""
    from repro.launch.mesh import batch_axes
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cache_len_for, resolve_config
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import (batch_pspecs, cache_pspecs,
                                            validate_pspecs)

    amesh = AbstractMesh((16, 16), ("data", "model"))
    for name in ("train_4k", "decode_32k", "long_500k"):
        shape = INPUT_SHAPES[name]
        cfg, skip = resolve_config(arch, name)
        if skip:
            continue
        kw = dict(batch=shape.global_batch, seq_len=shape.seq_len,
                  kind=shape.kind)
        for axes in ("data", ("pod", "data")):
            _same_specs(batch_pspecs(M.input_specs(get_config(arch), **kw),
                                     batch_axes=axes),
                        JS.batch_pspecs(JM.input_specs(j_config(arch), **kw),
                                        batch_axes=axes))
        if shape.kind != "decode":
            continue
        n = cache_len_for(cfg, shape)
        mine = M.cache_specs(cfg, shape.global_batch, n)
        ref = JM.cache_specs(j_config(arch).replace(
            sliding_window=cfg.sliding_window), shape.global_batch, n,
            dtype=jnp.bfloat16)
        ax = batch_axes(amesh)[0]
        mspec = cache_pspecs(mine, batch_axes=ax, mesh_batch=16)
        rspec = JS.cache_pspecs(ref, batch_axes=ax, mesh_batch=16)
        _same_specs(mspec, rspec)
        _same_specs(validate_pspecs(mine, mspec, MESH_16),
                    JS.validate_pspecs(ref, rspec, amesh))


def test_validate_drops_what_does_not_divide():
    """Whisper's vocabulary (51,865 rows) and 8 kv heads on a 16-way model
    axis lose the axis; 64 and 128 keep theirs; a 1-device mesh keeps
    everything; as the reference's fake-mesh test."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.specs import P, validate_pspecs

    shapes = {"a": torch.empty(51865, 64), "b": torch.empty(64, 128),
              "kv": torch.empty(2, 4, 32, 8, 64)}
    specs = {"a": P("model", None), "b": P("data", "model"),
             "kv": P(None, "data", None, "model", None)}
    out = validate_pspecs(shapes, specs, MESH_16)
    ref = JS.validate_pspecs(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
         for k, v in shapes.items()},
        {k: JS.P(*v) for k, v in specs.items()},
        AbstractMesh((16, 16), ("data", "model")))
    assert {k: tuple(v) for k, v in out.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    assert out["a"] == P(None, None) and out["b"] == P("data", "model")
    assert out["kv"] == P(None, None, None, None, None)
    one = validate_pspecs(shapes, specs, make_host_mesh(device="cpu"))
    assert one == specs


def test_fl_store_and_sweep_pspecs_match_the_reference():
    """The trees of tests/test_sharding.py, tests/test_cohort_store.py and
    tests/test_sweep.py."""
    from repro_torch.sharding.specs import (fl_pspecs, store_pspecs,
                                            sweep_pspecs)

    def both(shapes, mine_fn, ref_fn):
        mine = mine_fn({k: torch.empty(s) for k, s in shapes.items()})
        ref = ref_fn({k: jnp.zeros(s) for k, s in shapes.items()})
        assert {k: tuple(v) for k, v in mine.items()} == \
            {k: tuple(v) for k, v in ref.items()}

    both({"w": (4, 10, 7, 3), "b": (4,)}, fl_pspecs, JS.fl_pspecs)
    m, pop, d = 4, 100, 6
    store = {"dev": (m, pop, 3), "team": (m, d), "glob": (d,)}
    both(store, lambda t: store_pspecs(t, m=m, population=pop),
         lambda t: JS.store_pspecs(t, m=m, population=pop))
    swept = {k: (8,) + s for k, s in store.items()}
    both(swept, lambda t: store_pspecs(t, m=m, population=pop, sweep=True),
         lambda t: JS.store_pspecs(t, m=m, population=pop, sweep=True))
    sweep = {"theta": (8, 3, 4, 5), "w": (8, 3, 5), "x": (8, 5),
             "round": (8,)}
    both(sweep, lambda t: sweep_pspecs(t, m=3, n=4),
         lambda t: JS.sweep_pspecs(t, m=3, n=4))


def test_device_state_store_pspecs():
    """DeviceStateStore.pspecs shards the population axis over data, as
    the reference's (tests/test_cohort_store.py), and behind a sweep's
    config axis."""
    from repro.train.store import DeviceStateStore as JStore
    from repro_torch.sharding.specs import P
    from repro_torch.train.store import DeviceStateStore

    m, pop, d = 2, 100, 5
    tree = {"theta": (m, pop, d), "comm.ef_dev": (m, pop, d)}
    mine = DeviceStateStore({k: torch.zeros(s) for k, s in tree.items()},
                            m, pop)
    ref = JStore({k: jnp.zeros(s) for k, s in tree.items()}, m, pop)
    assert {k: tuple(v) for k, v in mine.pspecs().items()} == \
        {k: tuple(v) for k, v in ref.pspecs().items()}
    assert mine.pspecs()["theta"] == P(None, "data", None)
    swept = DeviceStateStore({k: torch.zeros((3,) + s)
                              for k, s in tree.items()}, m, pop)
    assert swept.pspecs(sweep=True)["theta"] == P("sweep", None, "data",
                                                  None)


def test_place_on_the_one_card_mesh():
    """place validates the specs and returns every tensor whole on the
    mesh's device (the same tensor where it already lives there), keeps
    fields without a spec, puts a tuple of generators on the sweep axis,
    and refuses a spec axis the mesh lacks."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.specs import P, place, sweep_pspecs

    @dataclasses.dataclass
    class State:
        theta: torch.Tensor
        gens: tuple
        round: int

    mesh = make_host_mesh(n_sweep=1, device="cpu")
    st = State(torch.randn(2, 3, 4, 5),
               tuple(torch.Generator().manual_seed(i) for i in range(2)), 7)
    specs = sweep_pspecs(st, m=3, n=4)
    assert specs.theta == P("sweep", "data", "model", None)
    assert specs.gens == P("sweep") and specs.round is None
    out = place(st, specs, mesh)
    assert out.theta is st.theta and out.gens is st.gens and out.round == 7
    with pytest.raises(ValueError, match="pod"):
        place({"a": torch.zeros(2)}, {"a": P("pod")}, mesh)


def test_run_sweep_on_the_sweep_mesh_is_bit_equal(small_fed_data):
    """The Fig-3 PerMFL sweep on fig3/mnist/mclr cut to 2 x 3 devices, two
    grid points x two seeds, through ``sweep_scenario(mesh=...)`` on the
    one-card sweep mesh: histories and every state tensor equal to the
    unsharded run's to the bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.scenarios import get_scenario, sweep_scenario
    from repro_torch.train.store import state_fields

    s = get_scenario("fig3/mnist/mclr").scaled(m_teams=2, n_devices=3,
                                               samples_per_device=16)
    grid = [dict(beta=0.3), dict(gamma=0.5, lam=0.1)]
    plain = sweep_scenario(s, grid, (0, 1), rounds=2, device="cpu")
    meshed = sweep_scenario(s, grid, (0, 1), rounds=2,
                            mesh=make_host_mesh(n_sweep=1, device="cpu"))
    for a, b in zip(plain, meshed):
        for f in ("pm_acc", "tm_acc", "gm_acc", "train_loss"):
            assert getattr(a, f) == getattr(b, f)
    fa = state_fields(plain.state_stacked)
    fb = state_fields(meshed.state_stacked)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, va), (_, vb) in zip(fa, fb):
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), path
    with pytest.raises(ValueError, match="mesh"):
        sweep_scenario(s, grid, (0,), rounds=1, device="cpu",
                       mesh=_cuda_named_mesh())


def _cuda_named_mesh():
    from repro_torch.launch.mesh import Mesh

    return Mesh(("sweep", "data", "model"), (1, 1, 1), torch.device("cuda"))


def test_specs_ignore_the_array_kind():
    """Numpy leaves (a sweep's stacked hyperparameters) take specs like
    tensors and stay on the host when placed."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.specs import P, place, sweep_pspecs

    h = {"lam": np.array([0.1, 0.5]), "beta": np.array([0.3, 0.3])}
    specs = sweep_pspecs(h, m=2, n=3)
    assert specs == {"lam": P("sweep"), "beta": P("sweep")}
    out = place(h, specs, make_host_mesh(n_sweep=1, device="cpu"))
    assert out["lam"] is h["lam"]
