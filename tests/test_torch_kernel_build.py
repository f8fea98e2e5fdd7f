"""The kernels' build keys, on the CPU (no ``nvcc`` is run).

``kernels/build.py`` names each library by a digest of its source, of the
headers it includes by a quoted ``#include`` and of the flags, so that an
edited header builds anew instead of loading a stale library. Checked on
temporary copies of the flash-attention sources, which share
``csrc/hopper.cuh``.
"""
import hashlib
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

CSRC = build.KERNEL_SOURCES["flash_attention_hopper"].parent


def test_sources_of_follows_quoted_includes():
    """Both Hopper attention sources include the shared header; a source
    without a quoted include is its own only file."""
    for name in ("flash_attention_hopper", "flash_attention_bwd_hopper"):
        srcs = build.sources_of(build.KERNEL_SOURCES[name])
        assert srcs == [build.KERNEL_SOURCES[name], CSRC / "hopper.cuh"]
    for name in ("flash_attention", "flash_attention_bwd", "prox_update"):
        assert build.sources_of(build.KERNEL_SOURCES[name]) == \
            [build.KERNEL_SOURCES[name]]


def test_single_source_keeps_its_library_name():
    """A library of one source is named as before headers were hashed:
    sha256 of its bytes and the flags."""
    src = build.KERNEL_SOURCES["flash_attention_bwd"]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode()).hexdigest()
    assert build._library("flash_attention_bwd").name == \
        f"libflash_attention_bwd-{digest[:12]}.so"


def test_edited_header_renames_every_library_that_includes_it(
        tmp_path, monkeypatch):
    """Editing the shared header (in a copy) renames both libraries that
    include it and no other; restoring it restores the names. A nested
    include is followed too."""
    for f in ("flash_attention_hopper.cu", "flash_attention_bwd_hopper.cu",
              "flash_attention.cu", "hopper.cuh"):
        shutil.copy(CSRC / f, tmp_path / f)
    sources = {n: tmp_path / f for n, f in (
        ("fwd", "flash_attention_hopper.cu"),
        ("bwd", "flash_attention_bwd_hopper.cu"),
        ("simt", "flash_attention.cu"))}
    monkeypatch.setattr(build, "KERNEL_SOURCES", sources)
    before = {n: build._library(n).name for n in sources}
    header = tmp_path / "hopper.cuh"
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    after = {n: build._library(n).name for n in sources}
    assert after["fwd"] != before["fwd"] and after["bwd"] != before["bwd"]
    assert after["simt"] == before["simt"]
    header.write_text(text)
    assert {n: build._library(n).name for n in sources} == before
    (tmp_path / "inner.cuh").write_text("// one\n")
    header.write_text('#include "inner.cuh"\n' + text)
    nested = build._library("bwd").name
    (tmp_path / "inner.cuh").write_text("// two\n")
    assert build._library("bwd").name != nested


def test_inlined_source_is_one_translation_unit():
    """``build.inlined`` puts the shared header's text where the source
    includes it (once, without its ``#pragma once``), so that an edited
    copy compiles from any directory; the rest of the source is kept."""
    src = build.KERNEL_SOURCES["flash_attention_bwd_hopper"]
    text = build.inlined(src)
    header = (CSRC / "hopper.cuh").read_text()
    assert '#include "' not in text and "#pragma once" not in text
    assert text.count("int make_map(") == 1
    assert header.replace("#pragma once\n", "") in text
    body = src.read_text().split('#include "hopper.cuh"')[1]
    assert text.endswith(body)
