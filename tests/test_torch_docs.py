"""The PyTorch port's public API must stay documented, as the JAX
package's is (tests/test_docs.py): a module docstring, an ``__all__``,
and a docstring on every exported class and function and on the public
methods those classes define. Also: no module of the port imports JAX or
the JAX package."""
import ast
import importlib
import inspect
import pathlib

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

PUBLIC_MODULES = (
    "repro_torch.comm",
    "repro_torch.comm.compressors",
    "repro_torch.comm.config",
    "repro_torch.comm.ledger",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.convert",
    "repro_torch.core",
    "repro_torch.core.algorithm",
    "repro_torch.core.baselines",
    "repro_torch.core.participation",
    "repro_torch.core.permfl",
    "repro_torch.core.theory",
    "repro_torch.data.tokens",
    "repro_torch.device",
    "repro_torch.flat",
    "repro_torch.kernels.build",
    "repro_torch.kernels.compress",
    "repro_torch.kernels.compress.ops",
    "repro_torch.kernels.compress.ref",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.interface",
    "repro_torch.kernels.mamba_scan",
    "repro_torch.kernels.mamba_scan.ops",
    "repro_torch.kernels.mamba_scan.ref",
    "repro_torch.kernels.moe_router",
    "repro_torch.kernels.moe_router.ops",
    "repro_torch.kernels.moe_router.ref",
    "repro_torch.kernels.prox_update",
    "repro_torch.kernels.prox_update.ops",
    "repro_torch.kernels.quantize",
    "repro_torch.kernels.quantize.ops",
    "repro_torch.kernels.quantize.ref",
    "repro_torch.kernels.rwkv6_scan",
    "repro_torch.kernels.rwkv6_scan.ops",
    "repro_torch.kernels.rwkv6_scan.ref",
    "repro_torch.kernels.segments",
    "repro_torch.kernels.tier_update",
    "repro_torch.kernels.tier_update.ops",
    "repro_torch.kernels.tier_update.ref",
    "repro_torch.launch",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.models.attention",
    "repro_torch.models.layers",
    "repro_torch.models.mamba",
    "repro_torch.models.model",
    "repro_torch.models.moe",
    "repro_torch.models.paper_models",
    "repro_torch.models.rwkv",
    "repro_torch.models.transformer",
    "repro_torch.obs",
    "repro_torch.obs.events",
    "repro_torch.obs.health",
    "repro_torch.obs.metrics",
    "repro_torch.obs.probes",
    "repro_torch.obs.profiling",
    "repro_torch.obs.report",
    "repro_torch.obs.spans",
    "repro_torch.obs.trace",
    "repro_torch.roofline",
    "repro_torch.roofline.analysis",
    "repro_torch.roofline.kernels",
    "repro_torch.roofline.op_analysis",
    "repro_torch.scenarios",
    "repro_torch.scenarios.registry",
    "repro_torch.scenarios.runner",
    "repro_torch.scenarios.spec",
    "repro_torch.serve",
    "repro_torch.serve.engine",
    "repro_torch.serve.llm",
    "repro_torch.serve.personalized",
    "repro_torch.serve.sampler",
    "repro_torch.serve.store",
    "repro_torch.sharding",
    "repro_torch.sharding.specs",
    "repro_torch.system",
    "repro_torch.system.simulate",
    "repro_torch.system.spec",
    "repro_torch.system.timeline",
    "repro_torch.train",
    "repro_torch.train.checkpoint",
    "repro_torch.train.engine",
    "repro_torch.train.fl_trainer",
    "repro_torch.train.metrics",
    "repro_torch.train.optim",
    "repro_torch.train.store",
    "repro_torch.train.sweep",
    "repro_torch.train.train_state",
    "repro_torch.train.trainer",
)


def _public_methods(cls):
    for name, member in vars(cls).items():
        if name.startswith("_"):
            continue
        if inspect.isfunction(member):
            yield name, member
        elif isinstance(member, (classmethod, staticmethod)):
            yield name, member.__func__


@pytest.mark.parametrize("modname", PUBLIC_MODULES)
def test_public_api_is_documented(modname):
    mod = importlib.import_module(modname)
    assert (mod.__doc__ or "").strip(), f"{modname}: no module docstring"
    assert hasattr(mod, "__all__"), f"{modname}: no __all__"
    missing = []
    for name in mod.__all__:
        obj = getattr(mod, name)
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        if not (obj.__doc__ or "").strip():
            missing.append(name)
        if inspect.isclass(obj):
            missing += [f"{name}.{m}" for m, f in _public_methods(obj)
                        if not (f.__doc__ or "").strip()]
    assert not missing, f"{modname}: undocumented: {missing}"


def _top_level_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"],
    ids=lambda p: p.name if p.name == "chip_smoke.py"
    else str(p.relative_to(SRC)))
def test_imports_neither_jax_nor_the_jax_package(path):
    bad = set(_top_level_imports(path)) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path}: imports {sorted(bad)}"
