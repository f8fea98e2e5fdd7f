"""What the harness loads: no module of JAX or of the JAX package (top-
level names compared whole: ``repro_torch`` is not ``repro``), nothing of
the older benchmark suite; and no result without a card."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

LOAD_ALL = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from pathlib import Path
from bench import core
import bench.calibrate, bench.faults
for kind in ("paths", "metrics"):
    for f in sorted(Path({str(ROOT / 'bench')!r}, kind).glob("*.py")):
        if f.stem != "__init__":
            core.load(kind, f.stem)
import repro_torch.train.engine, repro_torch.train.trainer
import repro_torch.scenarios.spec, repro_torch.core, repro_torch.comm
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(out.stdout.split())
    assert "repro_torch" in top and "bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_forbidden_names_are_compared_whole():
    from bench import core
    names = ["repro_torch.train.trainer", "reprox", "torch", "jax.numpy",
             "repro.core", "benchmarks.run", "jaxlib_like"]
    assert core.forbidden_modules(names) == ["benchmarks", "jax", "repro"]
    assert core.forbidden_modules(["repro_torch", "bench.core"]) == []


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn_permfl",
         "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""
