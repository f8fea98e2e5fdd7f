"""Checkpoints of nested parameter trees: a JSON manifest + raw npy
payloads in a zip, the format of the JAX package's
``repro/train/checkpoint.py``, so each package reads the other's files.

One ``arrays/<key path with / as __>.npy`` member per leaf, named by the
leaf's key path (the nested dict's keys in sorted order, joined by
``/``), plus ``manifest.json`` holding the key list, each leaf's dtype
name, the tree structure string and the caller's metadata. A bfloat16
leaf is written as a raw 2-byte npy record (numpy has no bfloat16) with
``"bfloat16"`` in the manifest, as the reference writes it; loading
reads such a record through a 2-byte integer view into
``torch.bfloat16``, so no ``ml_dtypes`` is needed.

``restore_checkpoint`` matches payloads to a template tree *by key path*
and raises :class:`CheckpointKeyError` naming the missing and extra
paths when the key sets differ. ``load_checkpoint_arrays`` reads a
checkpoint without a template: what the serving store reloads through.
"""
from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.flat import tree_leaves

__all__ = ["CheckpointKeyError", "load_checkpoint_arrays",
           "restore_checkpoint", "save_checkpoint"]


class CheckpointKeyError(KeyError):
    """A checkpoint's key paths do not match the restore template's."""


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _as_numpy(leaf):
    """A leaf (tensor or array) as numpy; bfloat16 as 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _structure(tree) -> str:
    """The tree's structure in the reference's notation:
    ``{'a': *, 'b': {'c': *}}``."""
    if not isinstance(tree, dict):
        return "*"
    return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                           for k in sorted(tree)) + "}"


def _member(key: str) -> str:
    return f"arrays/{key.replace('/', '__')}.npy"


def save_checkpoint(path: str, tree, *, metadata: dict | None = None):
    """Write ``tree`` (a nested dict of tensors or arrays) to ``path``:
    one npy member per leaf, named by its key path, plus a JSON manifest
    with the key list, the dtypes and ``metadata``."""
    flat = {_key(p): _as_numpy(leaf) for p, leaf in tree_leaves(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        manifest = {
            "keys": list(flat),
            "dtypes": {k: name for k, (_, name) in flat.items()},
            "treedef": f"PyTreeDef({_structure(tree)})",
            "metadata": metadata or {},
        }
        zf.writestr("manifest.json", json.dumps(manifest))
        for k, (arr, _) in flat.items():
            buf = io.BytesIO()
            np.save(buf, arr)
            zf.writestr(_member(k), buf.getvalue())


def _to_tensor(arr: np.ndarray, want) -> torch.Tensor:
    if want == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 record needs 2 bytes a value, "
                             f"got {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    if want and str(arr.dtype) != want:
        arr = arr.view(np.dtype(want))
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def load_checkpoint_arrays(path: str):
    """Read a checkpoint with no template: ``({key path: CPU tensor},
    metadata)``; the caller rebuilds a structure from the key paths."""
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        dtypes = manifest.get("dtypes", {})
        arrays = {}
        for k in manifest["keys"]:
            arr = np.load(io.BytesIO(zf.read(_member(k))))
            arrays[k] = _to_tensor(arr, dtypes.get(k))
    return arrays, manifest["metadata"]


def restore_checkpoint(path: str, like_tree):
    """Restore into the structure of the nested dict ``like_tree``,
    matching every payload to its leaf by key path. Returns ``(tree of
    CPU tensors, metadata)``. Raises :class:`CheckpointKeyError` listing
    the offending paths when the checkpoint lacks template keys or
    carries extra ones."""
    arrays, metadata = load_checkpoint_arrays(path)
    paths = [p for p, _ in tree_leaves(like_tree)]
    keys = [_key(p) for p in paths]
    missing = sorted(set(keys) - set(arrays))
    extra = sorted(set(arrays) - set(keys))
    if missing or extra:
        raise CheckpointKeyError(
            f"checkpoint {path!r} does not match the template tree: "
            f"missing from checkpoint {missing or '[]'}; "
            f"extra in checkpoint {extra or '[]'}")
    out: dict = {}
    for p, k in zip(paths, keys):
        if not p:
            return arrays[k], metadata
        node = out
        for part in p[:-1]:
            node = node.setdefault(part, {})
        node[p[-1]] = arrays[k]
    return out, metadata
