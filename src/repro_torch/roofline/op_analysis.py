"""Counting a PyTorch step's work op by op: the port of the reference's
HLO walker (``repro/roofline/hlo_analysis.py``).

The reference reads its three roofline inputs off XLA's optimized HLO
text. The port runs eagerly, so :class:`OpCounter`, a
``TorchDispatchMode``, sees every aten op as it runs -- on real tensors
or on fake ones (``FakeTensorMode``: the dry run, which allocates
nothing) -- and counts:

  * FLOPs of products and convolutions, by PyTorch's formulas
    (``torch.utils.flop_counter``), each on the unit its operands' type
    runs on (bf16 / f16 on the tensor cores; float32 on the CUDA cores,
    or as TF32 where float32 matmuls may use it);
  * HBM bytes: inputs plus outputs of every op that is not a view or a
    metadata op -- the reference's fusion-boundary model, where eager
    PyTorch makes every op a boundary. In-place and index writes count
    the region they write (a view's elements, an index write's values);
  * each kernel seam's work: a seam (``repro_torch.kernels.*.ops``)
    records its family's :class:`repro_torch.roofline.kernels.Work` once
    a launch, and the aten ops beneath it (the plain version on the CPU,
    the wrapper's allocations on the card) are not counted, so the count
    is the same whichever implementation runs;
  * live bytes: storages (not views) from when an op makes them until
    they are freed, and their peak;
  * collectives: none on one card.

:func:`analyze_ops` runs a function under a counter and returns the
reference's keys (``flops``, ``hbm_bytes``, ``collective_bytes``,
``collective_bytes_by_kind``, ``collective_counts_by_kind``) with
``kernels`` (each seam's launches, bytes, FLOPs and exponentials),
``peak_bytes``, ``ops_by_unit`` (operations a unit: "bf16", "tf32",
"f32" FLOPs and "exp" exponentials, which the roofline divides by each
unit's peak), ``argument_bytes`` and ``output_bytes``.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import interface

__all__ = ["OpCounter", "analyze_ops", "storage_bytes"]

_aten = torch.ops.aten
# ops that read or write no element: allocations, aliases, metadata
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
             _aten.lift_fresh, _aten.detach, _aten.alias, _aten.set_,
             _aten.is_contiguous, _aten.sym_size, _aten.sym_stride,
             _aten.sym_numel, _aten.sym_storage_offset}
# in-place index writes: they write the values' region of ``self``
_INDEX_WRITES = {_aten.index_put_, _aten._index_put_impl_,
                 _aten.index_copy_, _aten.index_add_, _aten.scatter_,
                 _aten.scatter_add_, _aten.scatter_reduce_,
                 _aten.masked_scatter_}
# in-place writes that do not read ``self``
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.normal_,
               _aten.uniform_, _aten.random_}
_TENSOR_CORE = (torch.bfloat16, torch.float16)


def _tensors(tree, out=None) -> list:
    """The tensors of ``tree`` (nested lists, tuples and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` (nested
    lists, tuples and dicts) hold, views counted once."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (module docstring); read the
    totals with :meth:`aggregate`. Entering it also makes it the kernel
    seams' recorder."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops_by_unit = {"bf16": 0.0, "tf32": 0.0, "f32": 0.0,
                            "exp": 0.0}
        self.kernels = {}
        self.aten_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}                 # id(storage) -> bytes
        self._depth = 0                 # seams entered and not left

    def __enter__(self):
        interface.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        interface.RECORDERS.remove(self)
        return super().__exit__(*exc)

    # -- liveness ---------------------------------------------------------
    def _free(self, key):
        self.live_bytes -= self._live.pop(key)

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now until
        they are freed (a step's arguments, made before it ran)."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- kernel seams -----------------------------------------------------
    @contextlib.contextmanager
    def kernel(self, name: str, work):
        """A kernel seam's call: outermost, it adds one launch of ``name``
        and its ``work()`` (a :class:`~repro_torch.roofline.kernels.Work`)
        to the totals; the aten ops inside count only as live bytes."""
        if self._depth == 0:
            w = work()
            k = self.kernels.setdefault(name, {
                "launches": 0, "bytes": 0.0, "flops": 0.0,
                "exponentials": 0.0})
            k["launches"] += 1
            k["bytes"] += w.bytes
            k["flops"] += w.flops
            k["exponentials"] += w.exponentials
            self.hbm_bytes += w.bytes
            self.flops += w.flops
            self.ops_by_unit[w.rate] += w.passes * w.flops
            self.ops_by_unit["exp"] += w.exponentials
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    # -- aten ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        # a storage an op returns but was not given is new (an in-place
        # op's or a view's is its input's)
        given = {id(t.untyped_storage()) for t in ins}
        self.track([t for t in outs if id(t.untyped_storage()) not in given])
        if self._depth == 0 and outs:
            self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs):
        self.aten_ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            self.ops_by_unit[self._unit(ins[0].dtype)] += flops
        if func.is_view or packet in _NO_BYTES:
            return
        if packet in _INDEX_WRITES:
            # self's untouched elements move nothing: the other operands
            # are read, the values' region written
            rest = ins[1:]
            self.hbm_bytes += sum(map(_nbytes, rest)) + max(
                (_nbytes(t) for t in rest if t.is_floating_point()),
                default=0)
            return
        if packet in _OVERWRITES:
            ins = ins[1:]               # self is written, not read
        self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    @staticmethod
    def _unit(dtype) -> str:
        if dtype in _TENSOR_CORE:
            return "bf16"
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"

    def aggregate(self) -> dict:
        """The counts so far: the reference's keys, plus ``kernels``,
        ``peak_bytes``, ``ops_by_unit`` and ``aten_ops`` (ops counted)."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes_by_kind": {},
            "collective_counts_by_kind": {},
            "collective_bytes": 0.0,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "peak_bytes": self.peak_bytes,
            "ops_by_unit": dict(self.ops_by_unit),
            "aten_ops": self.aten_ops,
        }


def analyze_ops(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under an :class:`OpCounter` (the
    arguments live throughout) and return its :meth:`~OpCounter.aggregate`
    with ``argument_bytes`` (the arguments' storages) and
    ``output_bytes`` (the result's storages that are not arguments').
    Run it inside a ``FakeTensorMode`` on fake arguments to count a step
    without running it."""
    counter = OpCounter()
    counter.track((args, kw))
    arg_ids = {id(t.untyped_storage()) for t in _tensors((args, kw))}
    with counter:
        out = fn(*args, **kw)
    agg = counter.aggregate()
    agg["argument_bytes"] = storage_bytes((args, kw))
    agg["output_bytes"] = storage_bytes(
        [t for t in _tensors(out) if id(t.untyped_storage()) not in arg_ids])
    return agg
