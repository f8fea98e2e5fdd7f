"""The port's launch layer against the reference's
(``repro/launch/{mesh,dryrun}.py``, ``repro/models/model.py``'s dry-run
helpers), on the CPU.

* ``resolve_config`` and ``cache_len_for``: equal config fields and skip
  reasons for every architecture x input shape.
* ``input_specs`` for every architecture x input shape, ``param_specs``
  and ``cache_specs`` at published widths: the reference's leaf paths,
  shapes and dtypes (``jax.eval_shape`` there, fake tensors here).
* The one-card mesh: ``batch_axes`` and ``mesh_batch_size`` as the
  reference's on its (1, 1) and sweep meshes; a mesh larger than the
  card and ``make_production_mesh`` raise; importing ``launch.mesh``
  touches no CUDA state.
* ``run_one`` on fake tensors at published widths (a train, a prefill and
  a decode combination, and Whisper's long_500k skip): complete records,
  nothing allocated; the CLI refuses the TPU meshes with exit 2.
"""
import dataclasses
import os
import resource

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402

# importing repro.launch.dryrun sets XLA_FLAGS for 512 host devices, which
# takes effect only if jax is not yet initialized: initialize it first
# (as tests/test_launch_policy.py does)
jax.devices()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


def _ref_dryrun():
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return dryrun


def _spec(tree, prefix=""):
    """[(path, shape, dtype)] of a port tree of tensors."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix.lstrip("/"), tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


def _jax_spec(tree):
    return sorted(("/".join(str(getattr(p, "key", p)) for p in path),
                   tuple(v.shape), str(v.dtype))
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      tree)[0])


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_resolve_config_and_cache_len_match_the_reference(arch, shape):
    from repro_torch.launch.dryrun import cache_len_for, resolve_config

    ref = _ref_dryrun()
    cfg, skip = resolve_config(arch, shape)
    jcfg, jskip = ref.resolve_config(arch, shape)
    assert skip == jskip
    ours = dataclasses.asdict(cfg)
    # the port's fields beyond the reference's (DeepSeek's leading dense
    # layers, unrenormalised gates) hold the defaults that keep its tree
    assert ours.pop("first_dense_layers") == 0
    assert ours["moe"].pop("renormalize") is True
    assert ours == dataclasses.asdict(jcfg)
    assert cache_len_for(cfg, INPUT_SHAPES[shape]) == \
        ref.cache_len_for(jcfg, INPUT_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    for name, shape in INPUT_SHAPES.items():
        kw = dict(batch=shape.global_batch, seq_len=shape.seq_len,
                  kind=shape.kind)
        got = _spec(M.input_specs(get_config(arch), **kw))
        want = _jax_spec(JM.input_specs(j_config(arch),
                                        act_dtype=jnp.bfloat16, **kw))
        assert got == want, (arch, name)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-2b"])
def test_param_and_cache_specs_match_the_reference(arch):
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg, jcfg = get_config(arch), j_config(arch)
    assert _spec(M.param_specs(cfg)) == _jax_spec(
        JM.param_specs(jcfg, dtype=jnp.bfloat16))
    assert _spec(M.cache_specs(cfg, 4, 1024)) == _jax_spec(
        JM.cache_specs(jcfg, 4, 1024, dtype=jnp.bfloat16))
    leaves = jax.tree_util.tree_leaves(M.param_specs(cfg))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in leaves)


@pytest.mark.parametrize("sweep", [None, 1])
def test_mesh_helpers_match_the_reference(sweep):
    from repro.launch import mesh as JMesh
    from repro_torch.launch import mesh as PMesh

    mine = PMesh.make_host_mesh(n_sweep=sweep, device="cpu")
    ref = JMesh.make_host_mesh(n_sweep=sweep)
    assert mine.axis_names == tuple(ref.axis_names)
    assert mine.shape == dict(ref.shape)
    assert PMesh.batch_axes(mine) == JMesh.batch_axes(ref)
    assert PMesh.mesh_batch_size(mine) == JMesh.mesh_batch_size(ref)
    assert mine.device == torch.device("cpu") and mine.size == 1


def test_meshes_beyond_the_card_raise():
    from repro_torch.launch import mesh as PMesh

    for multi, cards in ((False, "256"), (True, "512")):
        with pytest.raises(ValueError, match=cards):
            PMesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="one card"):
        PMesh.make_host_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="one card"):
        PMesh.make_sweep_mesh(3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PMesh.make_host_mesh()


def test_mesh_module_touches_no_cuda_state():
    """launch/mesh.py makes no call at import (as the reference's
    tests/test_system.py::test_mesh_factories_are_lazy holds its
    mesh.py): only hbm_capacity asks the card, when called; its H100
    constants are the data sheet's."""
    import ast

    from repro_torch.launch import mesh

    src = open(os.path.join(REPO, "src/repro_torch/launch/mesh.py")).read()
    for node in ast.parse(src).body:
        assert not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call))
        if isinstance(node, ast.Assign):
            calls = [n for n in ast.walk(node.value)
                     if isinstance(n, ast.Call)]
            assert not calls, ast.unparse(node)
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_TF32, mesh.PEAK_FLOPS_F32,
            mesh.HBM_BW, mesh.HBM_BYTES, mesh.NVLINK_BW) == \
        (989e12, 495e12, 67e12, 3.35e12, 80e9, 450e9)
    assert mesh.EXP_RATE == 16 * 132 * 1.98e9
    if not torch.cuda.is_available():
        assert mesh.hbm_capacity() == 80e9


RECORD_KEYS = {"arch", "shape", "mesh", "params", "active_params", "status",
               "trace_s", "chips", "flops", "hbm_bytes", "collective_bytes",
               "collectives", "compute_s", "memory_s", "collective_s",
               "dominant", "model_flops", "useful_ratio", "bytes_per_device",
               "hbm_capacity", "fits", "kernels", "aten_ops"}


@pytest.mark.parametrize("arch,shape,kernels", [
    ("whisper-small", "train_4k",
     {"flash_attention": 60, "flash_attention_bwd": 36, "prox_update": 35}),
    ("qwen2-vl-2b", "prefill_32k", {"flash_attention": 28}),
    ("rwkv6-7b", "decode_32k", {"rwkv6_scan": 32}),
])
def test_run_one_on_fake_tensors(arch, shape, kernels):
    """Full widths on fake tensors: a complete record, each seam's
    launches, the argument bytes exactly the step's tensors', and the
    process's memory high-water mark moved by much less than them."""
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro.roofline import model_flops_decode, model_flops_train
    from repro_torch.launch.dryrun import run_one

    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = run_one(arch, shape, verbose=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 \
        - before
    assert rec["status"] == "ok" and set(rec) == RECORD_KEYS
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == kernels
    mem = rec["bytes_per_device"]
    assert mem["peak"] == mem["argument"] + mem["temp"]
    assert mem["temp"] >= mem["output"] > 0
    assert grown < mem["argument"] / 4
    s = INPUT_SHAPES[shape]
    cfg = _ref_dryrun().resolve_config(arch, shape)[0]
    if s.kind == "train":
        assert rec["model_flops"] == model_flops_train(
            cfg, s.global_batch * s.seq_len)
        # theta and w in bf16, the momentum in f32, the batch's inputs
        n = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
            _jax_params(arch)))
        batch = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                    for v in jax.tree_util.tree_leaves(JM.input_specs(
                        j_config(arch), batch=s.global_batch,
                        seq_len=s.seq_len, kind="train",
                        act_dtype=jnp.bfloat16)))
        assert mem["argument"] == 2 * n * 2 + 4 * n + batch
    else:
        tokens = s.global_batch * (s.seq_len if s.kind == "prefill" else 1)
        assert rec["model_flops"] == model_flops_decode(cfg, tokens)
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory")
    assert rec["collective_bytes"] == 0 and rec["chips"] == 1


def _jax_params(arch):
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    return JM.param_specs(j_config(arch), dtype=jnp.bfloat16)


def test_run_one_skips_whisper_long_500k():
    from repro_torch.launch.dryrun import run_one

    rec = run_one("whisper-small", "long_500k", verbose=False)
    ref = _ref_dryrun().run_one("whisper-small", "long_500k",
                                multi_pod=False, verbose=False)
    assert rec["status"] == ref["status"] == "skipped"
    assert rec["reason"] == ref["reason"]
    assert (rec["params"], rec["active_params"]) == \
        (ref["params"], ref["active_params"])


@pytest.mark.parametrize("mesh,cards", [("pod", "256"), ("multipod", "512")])
def test_cli_refuses_the_tpu_meshes(mesh, cards, capsys):
    from repro_torch.launch.dryrun import main

    assert main(["--arch", "phi3-mini-3.8b", "--shape", "train_4k",
                 "--mesh", mesh]) == 2
    assert cards in capsys.readouterr().err
