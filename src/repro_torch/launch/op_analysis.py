"""Roofline terms and memory of a step, from the PyTorch ops it runs.

The counterpart of the reference package's `launch/hlo_analysis.py`, which
reads a compiled XLA executable's HLO text.  Here the step runs eagerly,
op by op, under one `TorchDispatchMode` (`OpCounter`), usually on fake
tensors (`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and dtypes,
no storage), and every op the dispatcher sees is counted:

  * FLOPs: `torch.utils.flop_counter`'s per-op formulas (matmuls,
    convolutions, attention; element-wise ops count 0, as the reference's
    count of `dot`s does);
  * HBM bytes: the bytes each op that moves memory reads (each input's
    distinct elements: a broadcast dimension is read once) plus the bytes
    it writes.  In eager PyTorch each op is one launch and one round trip
    to HBM, and a CUDA graph replays the same kernels, so this is the
    counterpart of the reference's "fusion boundaries are exactly the HBM
    round trips".  Views, `detach` and metadata ops count 0, an allocation
    without a fill counts 0, and an in-place indexed write (`index_put_`,
    `scatter_`, ...) counts the elements it writes, not its whole
    destination;
  * collective bytes and counts: the operand bytes of the `c10d` and
    `_c10d_functional` collectives, by the reference's names
    (`all-reduce`, ...), as `hlo_analysis` counts its operands (their
    operands and outputs are HBM bytes too, as there); `wait_tensor`
    counts nothing.  With `pod_size`, `coll_bytes_crosspod`
    holds those of the collectives whose group's ranks lie in more than
    one pod (rank // pod_size), the reference's lines.  A one-card step
    has none; the fields stay.
  * memory: the bytes of the storages the ops allocate while they live
    (a storage is freed when its last tensor dies), their peak above what
    was live before (`temp_bytes`), each rounded up to the CUDA caching
    allocator's 512-byte blocks.

Over a mesh (DTensors over a `DeviceMesh`, usually of `launch.mesh.
fake_world`) the counts are one rank's: an op on DTensors is passed on
(`NotImplemented`), and DTensor's dispatch then runs what this rank runs,
the op on its local shards and the collectives of a redistribution, each
of which is counted.  What DTensor runs to propagate shardings (the op
again on fake tensors of the global shapes, the first time each op and
layout is seen in the process) is not counted: a record does not depend
on what ran before it in the process.

Trip counts: the reference corrects XLA's count of a `while` body by its
trip count; nothing needs correcting here, since the trace runs the
Python loops themselves.
"""
from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d ops (eager and functional) by the reference's collective names.
_COLLECTIVE_OF = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_ATEN = torch.ops.aten
# Aliases that the schema does not mark as views, and ops that read only
# shapes: no HBM traffic.
_FREE = {_ATEN._unsafe_view, _ATEN.lift_fresh, _ATEN.sym_size,
         _ATEN.sym_stride, _ATEN.sym_numel, _ATEN.sym_storage_offset,
         _ATEN.is_same_size, _ATEN.empty, _ATEN.empty_like,
         _ATEN.empty_strided, _ATEN.new_empty, _ATEN.new_empty_strided,
         _ATEN.set_, _ATEN.resize_}
# Ops whose tensor inputs give the output's shape or are overwritten
# unread: only their output counts.
_WRITE_ONLY = {_ATEN.zeros_like, _ATEN.ones_like, _ATEN.full_like,
               _ATEN.new_zeros, _ATEN.new_ones, _ATEN.new_full,
               _ATEN.fill_, _ATEN.zero_, _ATEN.normal_, _ATEN.uniform_,
               _ATEN.random_, _ATEN.copy_}
# In-place indexed writes: (the argument written from, whether the
# destination's written elements are also read).
_INDEXED = {_ATEN.index_put_: ("values", False),
            _ATEN._index_put_impl_: ("values", False),
            _ATEN.index_copy_: ("source", False),
            _ATEN.index_add_: ("source", True),
            _ATEN.scatter_: ("src", False),
            _ATEN.scatter_add_: ("src", True),
            _ATEN.scatter_reduce_: ("src", True)}
# The CUDA caching allocator's block size.
_BLOCK = 512
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def _group_ranks(args) -> list[int] | None:
    """The global ranks of a collective's group: a functional collective
    names it (a string), a c10d one passes the group itself (boxed as a
    TorchScript object)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if (isinstance(a, torch.ScriptObject)
                and a._type().name().endswith("ProcessGroup")):
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(_resolve_process_group(a))
            except (ValueError, RuntimeError, KeyError):
                continue
    return None


@functools.cache
def _propagator():
    """DTensor's sharding propagator class and the method of it that runs
    an op on fake tensors of the global shapes to learn its output's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    if not hasattr(ShardingPropagator, name):
        raise RuntimeError(
            f"this torch's DTensor has no ShardingPropagator.{name}: the op "
            f"counter cannot tell its sharding propagation from a rank's ops")
    return ShardingPropagator, name


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor view reads (a dimension of
    stride 0, a broadcast, once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


@functools.cache
def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@functools.cache
def _written(func) -> tuple[int, ...]:
    """The positions of the arguments an op writes in place."""
    return tuple(i for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


@dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: dict[str, float]
    coll_bytes_total: float
    coll_bytes_crosspod: float
    coll_counts: dict[str, int]

    def seconds(self, *, peak_flops: float, hbm_bw: float, ici_bw: float
                ) -> dict[str, float]:
        """Roofline terms in seconds on one device (`ici_bw`: the
        device's link rate, NVLink on the card)."""
        return {"compute_s": self.flops / peak_flops,
                "memory_s": self.hbm_bytes / hbm_bw,
                "collective_s": self.coll_bytes_total / ici_bw}


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, collectives and live bytes of every op run
    under it (see the module's docstring).  Enter it inside a
    `FakeTensorMode` to count a step without running it.  With `split_at`
    (a tensor), `before` keeps the counts as they stood at the first op
    that writes that tensor's storage (a train step's optimizer step
    counter, which `adamw.apply` advances first: what comes before it is
    the microbatches' part).  `pod_size`: ranks a pod, for the cross-pod
    bytes."""

    def __init__(self, split_at: torch.Tensor | None = None,
                 pod_size: int | None = None):
        super().__init__()
        self.pod_size = pod_size
        self.coll_crosspod = 0.0
        self._paused = 0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0.0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.n_ops = 0
        self.live_bytes = 0       # allocated under the counter, still live
        self.peak_bytes = 0
        self.before: RooflineTerms | None = None
        self._split = (None if split_at is None
                       else split_at.untyped_storage()._cdata)
        self._live: set[int] = set()     # the storages counted live

    def __enter__(self):
        cls, name = _propagator()
        run = getattr(cls, name)
        counter = self

        def paused(prop, *a, **kw):
            counter._paused += 1
            try:
                return run(prop, *a, **kw)
            finally:
                counter._paused -= 1

        setattr(cls, name, paused)
        self._restore = lambda: setattr(cls, name, run)
        try:
            return super().__enter__()
        except BaseException:
            self._restore()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:                   # DTensor's sharding propagation
            return func(*args, **kwargs)
        if any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs))):
            return NotImplemented          # this rank's part comes back
        if func.namespace == "prim":      # metadata (`.device`, ...)
            return func(*args, **kwargs)
        if self._split is not None and self.before is None and any(
                args[i].untyped_storage()._cdata == self._split
                for i in _written(func) if i < len(args)):
            self.before = self.terms()
        out = func(*args, **kwargs)
        self.n_ops += 1
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OF.get(packet.__name__)
            if kind is None:          # `wait_tensor`: no traffic of its own
                self._allocated(ins, outs)
                return out
            self._collective(kind, args, ins)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.hbm_bytes += self._bytes(func, packet, args, kwargs, ins, outs)
        self._allocated(ins, outs)
        return out

    def _collective(self, kind: str, args, ins) -> None:
        n = sum(_distinct_bytes(t) for t in ins)
        self.coll_counts[kind] += 1
        self.coll_bytes[kind] += n
        if self.pod_size:
            ranks = _group_ranks(args)
            if ranks is None:
                raise ValueError(f"a {kind} whose group the counter cannot "
                                 f"read")
            if len({r // self.pod_size for r in ranks}) > 1:
                self.coll_crosspod += n

    @staticmethod
    def _bytes(func, packet, args, kwargs, ins, outs) -> int:
        if packet in _FREE or _is_view(func):
            return 0
        if packet in _INDEXED:
            name, reads = _INDEXED[packet]
            bound = dict(zip((a.name for a in func._schema.arguments), args))
            bound.update(kwargs)
            # scatter_'s scalar form writes one value an index.
            src = bound.get(name)
            if not isinstance(src, torch.Tensor):
                src = bound["index"]
            dest = args[0]
            written = src.numel() * dest.element_size()
            return (sum(_distinct_bytes(t) for t in ins if t is not dest)
                    + written * (2 if reads else 1))
        if packet in _WRITE_ONLY:
            if packet is _ATEN.copy_:
                return _distinct_bytes(args[1]) + _distinct_bytes(args[0])
            return sum(t.numel() * t.element_size() for t in outs)
        return (sum(_distinct_bytes(t) for t in ins)
                + sum(t.numel() * t.element_size() for t in outs))

    def _allocated(self, ins, outs) -> None:
        """Count each output storage that no input shares and no earlier op
        made: a new allocation, live until its storage is freed."""
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in held or key in self._live:
                continue
            n = -(-s.nbytes() // _BLOCK) * _BLOCK
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._live.add(key)
            weakref.finalize(s, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self.live_bytes -= n
        self._live.discard(key)

    def terms(self) -> RooflineTerms:
        return RooflineTerms(
            flops=self.flops, hbm_bytes=self.hbm_bytes,
            coll_bytes={k: v for k, v in self.coll_bytes.items() if v},
            coll_bytes_total=sum(self.coll_bytes.values()),
            coll_bytes_crosspod=self.coll_crosspod,
            coll_counts=dict(self.coll_counts))


@dataclass
class Trace:
    """What `analyze` saw: the step's result, its roofline terms (and
    those up to `split_at`'s first write, if given), the peak of the bytes
    it allocated above what was live before it (`temp_bytes`), and the ops
    it ran."""
    out: Any
    terms: RooflineTerms
    before: RooflineTerms | None
    temp_bytes: int
    n_ops: int


def analyze(fn: Callable, *args, split_at: torch.Tensor | None = None,
            pod_size: int | None = None, **kwargs) -> Trace:
    """Run `fn(*args, **kwargs)` under one `OpCounter` and return its
    result with the counts.  Call it inside a `FakeTensorMode` on fake
    tensors to size a step without allocating it."""
    counter = OpCounter(split_at, pod_size)
    with counter:
        out = fn(*args, **kwargs)
    return Trace(out=out, terms=counter.terms(), before=counter.before,
                 temp_bytes=counter.peak_bytes, n_ops=counter.n_ops)
