"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
Hopper (``sm_90a``) into a shared library at first use. The library goes
into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) under a name that carries a digest of its source, of
every header it includes by a quoted ``#include`` (resolved beside the
including file, recursively) and of the flags, so an edited source or
header builds anew and an unchanged one is loaded as it is. ``nvcc``
writes to a temporary name that is renamed into place, so two processes
building at once never load a half-written library.
``-Xptxas -v`` is always on; its report (registers, spills) is kept
beside the library and returned by :func:`build_log`.

:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "KERNEL_SOURCES", "NVCC_FLAGS", "build",
           "build_log", "inlined", "load", "nvcc_path", "sources_of"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

# kernel name -> its CUDA source
KERNEL_SOURCES = {
    "prox_update": _KERNELS_DIR / "prox_update" / "csrc" / "prox_update.cu",
    "tier_update": (_KERNELS_DIR / "tier_update" / "csrc"
                    / "tier_update.cu"),
    "compress": _KERNELS_DIR / "compress" / "csrc" / "compress.cu",
    "select_hopper": (_KERNELS_DIR / "compress" / "csrc"
                      / "select_hopper.cu"),
    "flash_attention": (_KERNELS_DIR / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "flash_attention_hopper": (_KERNELS_DIR / "flash_attention" / "csrc"
                               / "flash_attention_hopper.cu"),
    "flash_attention_bwd": (_KERNELS_DIR / "flash_attention" / "csrc"
                            / "flash_attention_bwd.cu"),
    "flash_attention_bwd_hopper": (_KERNELS_DIR / "flash_attention" / "csrc"
                                   / "flash_attention_bwd_hopper.cu"),
    "moe_router": _KERNELS_DIR / "moe_router" / "csrc" / "moe_router.cu",
    "moe_router_hopper": (_KERNELS_DIR / "moe_router" / "csrc"
                          / "moe_router_hopper.cu"),
    "moe_router_bwd": (_KERNELS_DIR / "moe_router" / "csrc"
                       / "moe_router_bwd.cu"),
    "moe_router_bwd_hopper": (_KERNELS_DIR / "moe_router" / "csrc"
                              / "moe_router_bwd_hopper.cu"),
    "rwkv6_scan": _KERNELS_DIR / "rwkv6_scan" / "csrc" / "rwkv6_scan.cu",
    "rwkv6_scan_hopper": (_KERNELS_DIR / "rwkv6_scan" / "csrc"
                          / "rwkv6_scan_hopper.cu"),
    "rwkv6_scan_bwd": (_KERNELS_DIR / "rwkv6_scan" / "csrc"
                       / "rwkv6_scan_bwd.cu"),
    "rwkv6_scan_bwd_hopper": (_KERNELS_DIR / "rwkv6_scan" / "csrc"
                              / "rwkv6_scan_bwd_hopper.cu"),
    "mamba_scan": _KERNELS_DIR / "mamba_scan" / "csrc" / "mamba_scan.cu",
    "mamba_scan_bwd": (_KERNELS_DIR / "mamba_scan" / "csrc"
                       / "mamba_scan_bwd.cu"),
    "mamba_scan_hopper": (_KERNELS_DIR / "mamba_scan" / "csrc"
                          / "mamba_scan_hopper.cu"),
    "mamba_scan_bwd_hopper": (_KERNELS_DIR / "mamba_scan" / "csrc"
                              / "mamba_scan_bwd_hopper.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``). Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the CUDA "
        "kernels are built at first use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(path: Path) -> list:
    """``path`` and every file it includes by a quoted ``#include``,
    resolved beside the including file, recursively, each once, in the
    order first met."""
    out, todo = [], [Path(path)]
    while todo:
        src = todo.pop(0)
        if src in out:
            continue
        out.append(src)
        todo += [src.parent / m.decode()
                 for m in _INCLUDE.findall(src.read_bytes())]
    return out


def inlined(path: Path) -> str:
    """``path``'s text with each quoted ``#include`` line replaced by the
    included file's text (resolved beside the including file,
    recursively, each file once): one translation unit that compiles from
    any directory, as the scripts that build edited copies of a kernel
    need."""
    seen = set()

    def expand(src: Path) -> bytes:
        seen.add(src)
        return _INCLUDE.sub(
            lambda m: b"" if src.parent / m[1].decode() in seen
            else expand(src.parent / m[1].decode()).replace(
                b"#pragma once\n", b""),
            src.read_bytes())

    return expand(Path(path)).decode()


def _library(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources_of(KERNEL_SOURCES[name]):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the kernels ``names`` (default: all) that are not built
    yet, one ``nvcc`` each, started together. Returns {name: library
    path}. Raises with the compiler's output if any build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    out = {n: _library(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = todo[n]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) from building ``name``."""
    path = build([name])[name].with_suffix(".log")
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, loaded (built if needed)."""
    return ctypes.CDLL(str(build([name])[name]))
