"""The port's checkpoints (``repro_torch.train.checkpoint``) and saved
serving stores against the JAX package's files: each package loads what
the other wrote, bit for bit -- stores in every encoding, and bfloat16
leaves, which the reference writes as raw 2-byte npy records -- and a
key mismatch raises ``CheckpointKeyError``."""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.serve.store import ModelStore as JStore  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from test_torch_serve import ENCODINGS, _tree_equal, stores  # noqa: E402


def _jax_tiers(js):
    return {"global": js.global_params, "team": js.team_params,
            "device": js.device_payload}


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_port_loads_a_jax_store(tmp_path, encoding):
    from repro_torch.serve import ModelStore

    store, jstore = stores(encoding)
    path = str(tmp_path / "jax.ckpt")
    jstore.save(path)
    got = ModelStore.load(path, device="cpu")
    assert (got.encoding, got.m, got.n) == (encoding, jstore.m, jstore.n)
    assert got.layout == store.layout
    _tree_equal(got.as_tree(), _jax_tiers(jstore))
    for a, b in ((got.global_row, store.global_row),
                 (got.team_rows, store.team_rows)):
        assert torch.equal(a, b)
    assert got.device_tier_nbytes() == jstore.device_tier_nbytes()


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_jax_loads_a_port_store(tmp_path, encoding):
    store, jstore = stores(encoding)
    path = str(tmp_path / "port.ckpt")
    store.save(path)
    got = JStore.load(path)
    assert (got.encoding, got.m, got.n) == (encoding, store.m, store.n)
    _tree_equal(store.as_tree(), _jax_tiers(got))
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    jpath = str(tmp_path / "jax.ckpt")
    jstore.save(jpath)
    with zipfile.ZipFile(jpath) as zf:
        want = json.loads(zf.read("manifest.json"))
    assert manifest == want


def test_store_load_rejects_other_checkpoints(tmp_path):
    from repro_torch.serve import ModelStore
    from repro_torch.train.checkpoint import save_checkpoint

    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, {"a": torch.zeros(3)}, metadata={"kind": "x"})
    with pytest.raises(ValueError, match="not a saved ModelStore"):
        ModelStore.load(path, device="cpu")


def _tree():
    rng = np.random.default_rng(0)
    return {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "a": rng.integers(-100, 100, 7).astype(np.int8),
            "h": rng.standard_normal((2, 5)).astype(np.float32)}


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    """A bfloat16 leaf written by the port loads in JAX as bfloat16 with
    the same bits, and one written by JAX loads in the port."""
    from repro_torch.train.checkpoint import (load_checkpoint_arrays,
                                              save_checkpoint)

    tree = _tree()
    bf = torch.from_numpy(tree["h"]).to(torch.bfloat16)
    port = str(tmp_path / "port.ckpt")
    save_checkpoint(port, {**tree, "h": bf}, metadata={"step": 3})
    arrays, meta = JC.load_checkpoint_arrays(port)
    assert meta == {"step": 3}
    assert str(arrays["h"].dtype) == "bfloat16"
    np.testing.assert_array_equal(arrays["h"].view(np.uint16),
                                  bf.view(torch.int16).numpy()
                                  .view(np.uint16))
    np.testing.assert_array_equal(arrays["b/w"], tree["b"]["w"])

    jpath = str(tmp_path / "jax.ckpt")
    JC.save_checkpoint(jpath, {**tree, "h": jnp.asarray(tree["h"],
                                                        jnp.bfloat16)})
    got, _ = load_checkpoint_arrays(jpath)
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), bf.view(torch.int16))
    assert got["a"].dtype == torch.int8
    np.testing.assert_array_equal(got["b/i"].numpy(), tree["b"]["i"])


def test_restore_matches_by_key_path(tmp_path):
    """restore_checkpoint rebuilds the template's structure from a JAX
    checkpoint by key path (dtypes, shapes, values, metadata); the
    manifest the port writes is the reference's, structure string
    included."""
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    tree = _tree()
    jpath = str(tmp_path / "jax.ckpt")
    JC.save_checkpoint(jpath, tree, metadata={"name": "t"})
    like = jax.tree.map(lambda a: torch.zeros(1), tree)
    got, meta = restore_checkpoint(jpath, like)
    assert meta == {"name": "t"}
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w),
                 got, tree)
    port = str(tmp_path / "port.ckpt")
    save_checkpoint(port, jax.tree.map(torch.from_numpy, tree),
                    metadata={"name": "t"})
    manifests = []
    for p in (jpath, port):
        with zipfile.ZipFile(p) as zf:
            manifests.append(json.loads(zf.read("manifest.json")))
    assert manifests[0] == manifests[1]


def test_key_mismatch_raises(tmp_path):
    from repro_torch.train.checkpoint import (CheckpointKeyError,
                                              restore_checkpoint,
                                              save_checkpoint)

    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, {"a": torch.zeros(2), "b": {"c": torch.ones(3)}})
    with pytest.raises(CheckpointKeyError, match=r"missing.*'b/d'.*"
                       r"extra.*'b/c'"):
        restore_checkpoint(path, {"a": 0, "b": {"d": 0}})
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"a": 0})
