"""What one traced step does, op by op: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

PyTorch has no HLO to parse.  ``Analysis`` watches a step as it runs (on
the meta device, in the dry run: ``launch.dryrun``) and fills an
``OpStats`` whose ``to_json()`` has ``HloStats.to_json()``'s keys:

* ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts
  over the step (its formula registry, applied in the one dispatch mode
  that also counts bytes and follows storages; equal to the mode's own
  count, ``tests/test_torch_dryrun.py``), plus the FLOPs the kernels'
  stand-ins report (``kernels.meta``), each by the formula of what
  ``FlopCounterMode`` counts for its plain version; remat's recompute
  counts again, as it runs again;
* ``hbm_bytes``: the operand and output bytes of every aten op, read by a
  ``TorchDispatchMode``, leaving out views, allocations with no data
  written (``empty`` and its kin) and metadata ops, as ``hlo_analysis``
  leaves out layout ops, and the process group's own ops; each stand-in
  counts its operands and outputs once;
* ``collective_bytes`` and ``collective_counts``: by kind under the JAX
  opcode names, as ``parallel.collectives`` reports each collective it
  sends (operand bytes; an all-gather's output).

Beside them, the storage the step holds, as ``memory_analysis()`` gives
XLA's arguments and temporaries: ``entry_bytes``, what was live when the
trace began, and ``temp_bytes``, the most the step added to it at once
(``core.memory_model.dryrun_peak_bytes`` sums them), following every
storage an op returns by weak reference until it is freed, each rounded
up to 512 bytes as the CUDA caching allocator rounds a block, so that the
peak compares with ``torch.cuda.max_memory_allocated`` over the same
step.  ``torch.distributed._tools.mem_tracker.MemTracker``
follows meta storages too, but rounds only CUDA ones (and keys its
statistics by module); with the rounding off the two peaks are equal
(``tests/test_torch_dryrun.py``).  A storage that changes size after it
is made is followed at its first size.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels import meta
from repro_torch.parallel import collectives as col

#: the CUDA caching allocator's smallest block and rounding unit
ALLOC_ROUND = 512

_aten = torch.ops.aten
# ops that read or write no data: allocations left uninitialised, aliases
# and metadata
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.new_empty.default, _aten.empty_strided.default,
               _aten.new_empty_strided.default, _aten.detach.default,
               _aten.alias.default, _aten._unsafe_view.default,
               _aten.lift_fresh.default,
               _aten.set_.source_Storage_storage_offset}


_COUNTS_BYTES: Dict[Any, bool] = {}


def _counts_bytes(func) -> bool:
    """Whether an op's operands and outputs count as traffic: an aten op
    that is no view (an output aliasing an input it does not write) and
    not in ``_NO_TRAFFIC``."""
    try:
        return _COUNTS_BYTES[func]
    except KeyError:
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        out = _COUNTS_BYTES[func] = (func.namespace == "aten" and not view
                                     and func not in _NO_TRAFFIC)
        return out


def _tensors(x, out: list) -> list:
    """The tensors of nested lists, tuples and dicts (a quicker
    ``tree_flatten`` for an op's arguments)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def alloc_bytes(nbytes: int) -> int:
    """A block's bytes as the caching allocator counts them."""
    return 0 if nbytes == 0 else -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


@dataclass
class OpStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    #: FLOPs and bytes the stand-ins reported, by op (inside the above)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    #: storage live when the trace began; the most the step added to it
    #: at once; None until a trace fills them
    entry_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes}

    def extended(self, first: "OpStats", second: "OpStats",
                 n: int) -> "OpStats":
        """A step of n microbatches from the trace of a step of two (self)
        and its counts after its first and its second microbatch: every
        microbatch after the first runs the second's ops and leaves behind
        what the second left, so the step of n adds n - 2 more of both
        (``tests/test_torch_dryrun.py``: equal to the step traced whole;
        the card's peaks: ``tests/test_torch_dryrun_memcheck.py``)."""
        k = n - 2

        def lin(a, b1, b2):
            return a + k * (b2 - b1)

        def lin_map(a, b1, b2):
            return {key: lin(a.get(key, 0), b1.get(key, 0), b2.get(key, 0))
                    for key in {*a, *b1, *b2}}

        left = max(second.temp_bytes - first.temp_bytes, 0)
        return OpStats(
            flops=lin(self.flops, first.flops, second.flops),
            hbm_bytes=lin(self.hbm_bytes, first.hbm_bytes, second.hbm_bytes),
            collective_bytes=lin_map(self.collective_bytes,
                                     first.collective_bytes,
                                     second.collective_bytes),
            collective_counts=lin_map(self.collective_counts,
                                      first.collective_counts,
                                      second.collective_counts),
            kernel_flops=lin_map(self.kernel_flops, first.kernel_flops,
                                 second.kernel_flops),
            kernel_calls=lin_map(self.kernel_calls, first.kernel_calls,
                                 second.kernel_calls),
            entry_bytes=self.entry_bytes,
            temp_bytes=self.temp_bytes + k * left)


_DECOMPOSES: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func.decompose`` runs a composite decomposition."""
    try:
        return _DECOMPOSES[func]
    except KeyError:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        out = _DECOMPOSES[func] = func is not torch.ops.prim.device.default \
            and (dk in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), dk))
        return out


_PURE: Dict[Any, bool] = {}


def _pure(func) -> bool:
    """An aten op that writes no input and whose schema marks no output
    as an alias: its outputs' metadata follows from its arguments'.  Some
    such ops alias all the same (``_unsafe_view``): ``_fresh`` checks
    each key's first output."""
    try:
        return _PURE[func]
    except KeyError:
        sch = func._schema
        out = _PURE[func] = (
            func.namespace == "aten" and not sch.is_mutable
            and len(sch.returns) > 0
            and all(r.alias_info is None and str(r.type) in ("Tensor",)
                    for r in sch.returns))
        return out


def _key(x):
    """A hashable stand-in for an op's argument, by metadata."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    hash(x)
    return x


def _fresh(out, args, kwargs):
    """(shape, stride, dtype) of an op's output where it is one tensor on a
    storage of its own, else None (``_pure``'s schema rule misses
    ``_unsafe_view``, whose output is its input's storage)."""
    if not isinstance(out, torch.Tensor):
        return None
    ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs), [])}
    if out.untyped_storage()._cdata in ins:
        return None
    return out.shape, out.stride(), out.dtype


class _Tracer(TorchDispatchMode):
    """One mode under the step: counts each aten op's FLOPs (by
    ``FlopCounterMode``'s own rules: its registry of formulas, and an op
    with a composite decomposition counted through its parts, while the op
    itself runs whole) and bytes, and follows the storages ops return.

    On meta tensors an op's FLOPs, and a pure op's output, follow from its
    arguments' metadata: an op whose metadata it has seen counts the FLOPs
    it counted then, and a pure one returns a fresh tensor of the output's
    shape, stride and dtype without running its meta kernel again (a
    model's layers repeat the same ops; PyTorch's meta kernels and
    decompositions run in Python)."""

    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats
        self.flops = 0
        self.live = 0
        self.peak = 0
        # storages followed, by address: a weak reference each, whose
        # callback frees its bytes
        self._seen: Dict[int, weakref.ref] = {}
        # by (op, arguments' metadata): (fresh output's metadata or None,
        # FLOPs)
        self._seen_ops: Dict[Any, Any] = {}

    def _free(self, key: int, nbytes: int, _ref) -> None:
        self.live -= nbytes
        del self._seen[key]

    def follow(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        nbytes = alloc_bytes(st.nbytes())
        self._seen[key] = weakref.ref(st, partial(self._free, key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _count(self, func, count, composite, args, kwargs):
        """Run the op; return its output and FLOPs."""
        flops = 0
        if composite:
            # FlopCounterMode counts a composite through its parts; the op
            # itself runs whole, as it does on the card
            with FlopCounterMode(display=False) as parts:
                func.decompose(*args, **kwargs)
            flops = parts.get_total_flops()
        out = func(*args, **kwargs)
        if count is not None:
            flops += count(*args, **kwargs, out_val=out)
        return out, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        count = flop_registry.get(func._overloadpacket)
        composite = count is None and _decomposes(func)
        pure = _pure(func)
        key = None
        if pure or composite or count is not None:
            try:
                key = (func, _key(args), _key(kwargs))
            except TypeError:
                pass
        seen = None if key is None else self._seen_ops.get(key)
        if seen is None:
            out, flops = self._count(func, count, composite, args, kwargs)
            if key is not None:
                self._seen_ops[key] = (_fresh(out, args, kwargs) if pure
                                       else None, flops)
        else:
            meta_out, flops = seen
            if meta_out is None:
                out = func(*args, **kwargs)
            else:
                shape, stride, dtype = meta_out
                out = torch.empty_strided(shape, stride, dtype=dtype,
                                          device="meta")
        self.flops += flops
        outs = _tensors(out, [])
        if _counts_bytes(func):
            self.stats.hbm_bytes += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs), outs[:]))
        for t in outs:
            self.follow(t)
        return out


class Analysis:
    """``with Analysis(live=(state, batch)) as stats: step(state, batch)``
    fills ``stats`` (an ``OpStats``) for the ops the block runs; the
    tensors of ``live`` (nested dicts, lists, tuples) count as live from
    the start.  One is open at a time."""

    def __init__(self, live: Iterable[Any] = ()):
        self.stats = OpStats()
        self._live = live

    def _kernel(self, op: str, flops: float, nbytes: int) -> None:
        s = self.stats
        s.kernel_flops[op] = s.kernel_flops.get(op, 0.0) + flops
        s.kernel_calls[op] = s.kernel_calls.get(op, 0) + 1
        s.hbm_bytes += nbytes

    def _collective(self, kind: str, nbytes: int) -> None:
        s = self.stats
        s.collective_bytes[kind] = s.collective_bytes.get(kind, 0.0) + nbytes
        s.collective_counts[kind] = s.collective_counts.get(kind, 0) + 1

    def __enter__(self) -> OpStats:
        if col.TALLY is not None or meta.TALLY is not None:
            raise RuntimeError("an Analysis is already open")
        self._tracer = _Tracer(self.stats)
        for t in _tensors(self._live, []):
            self._tracer.follow(t)
        self.stats.entry_bytes = self._tracer.live
        meta.TALLY = self._kernel
        col.TALLY = self._collective
        self._tracer.__enter__()
        return self.stats

    def snapshot(self) -> OpStats:
        """The counts so far; ``temp_bytes`` the bytes the step holds now
        over what it held when the trace began (not the most it held)."""
        s = self.stats
        return OpStats(
            flops=float(self._tracer.flops) + sum(s.kernel_flops.values()),
            hbm_bytes=s.hbm_bytes,
            collective_bytes=dict(s.collective_bytes),
            collective_counts=dict(s.collective_counts),
            kernel_flops=dict(s.kernel_flops),
            kernel_calls=dict(s.kernel_calls), entry_bytes=s.entry_bytes,
            temp_bytes=self._tracer.live - s.entry_bytes)

    def __exit__(self, *exc) -> None:
        self._tracer.__exit__(*exc)
        col.TALLY = meta.TALLY = None
        s = self.stats
        s.flops = float(self._tracer.flops) + sum(s.kernel_flops.values())
        s.temp_bytes = self._tracer.peak - s.entry_bytes

