"""ZeRO sharding, explicit (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/zero/sharding.py``. The JAX package
states ZeRO as GSPMD layouts and XLA inserts the collectives; the port
states the same per-leaf choice and moves the data itself:

- ``zero_spec`` picks, per leaf, the largest axis divisible by the data-
  parallel degree; leaves under ``min_size`` elements, or with no such axis,
  stay replicated (the JAX package's rule);
- ``shard`` cuts rank r's slice r of that axis; ``unshard`` all-gathers the
  slices back; ``reduce_scatter`` sums a full leaf over the ranks and keeps
  rank r's slice;
- ``slice_bounds`` gives the starts and stops of rank r's slice within the
  full leaf (the offload checkpoint's region manifest);
- ``sharding_coverage`` says how many bytes the layout actually shards;
- ``chunk_spans`` cuts a flat range into the offload pipeline's work spans;
- ``elastic_split`` cuts a host array into the flat dp parts of the elastic
  checkpoint layout;
- ``ParamGather`` is stage 3's gather at use: a compute parameter holds
  rank r's slice, and each use all-gathers the full leaf (the counterpart of
  the JAX engine's sharded compute params, which XLA all-gathers where each
  leaf is used, deepspeed_tpu/runtime/engine.py:356-366). The backward
  reduce-scatters the leaf's gradient (a sum over the ranks) back to the
  slice. Under its saved-tensor hooks autograd keeps a gathered copy as its
  slice and gathers it again when the backward reads it.

The collectives run over ``group`` (a torch process group of ``dp_size``
ranks; None is the world): the data group of a mesh whose model axis is
larger than one, so that ZeRO partitions over the data-parallel ranks only.

The axis is an int (or None for a replicated leaf) where the JAX package
returns a ``PartitionSpec``.
"""

import contextlib
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def zero_spec(shape, dp_size: int, min_size: int = 1024) -> Optional[int]:
    """The axis of ``shape`` to shard over ``dp_size`` ranks, or None."""
    numel = 1
    for d in shape:
        numel *= int(d)
    if dp_size <= 1 or numel < min_size:
        return None
    best_axis, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % dp_size == 0 and d > best_dim:
            best_axis, best_dim = i, d
    return best_axis


def shard(t: torch.Tensor, axis: Optional[int], rank: int, dp_size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``axis`` (a contiguous copy in
    storage of its own: a narrow view would keep the whole leaf's storage
    alive), or ``t`` itself when the leaf is replicated."""
    if axis is None:
        return t
    n = t.shape[axis] // dp_size
    view = t.narrow(axis, rank * n, n)
    return torch.empty(view.shape, dtype=t.dtype, device=t.device).copy_(view)


def slice_bounds(shape, axis: Optional[int], rank: int, dp_size: int):
    """(starts, stops) per axis of the slice ``shard`` cuts for ``rank`` from a
    leaf of ``shape``: the whole leaf when ``axis`` is None."""
    starts, stops = [0] * len(shape), [int(d) for d in shape]
    if axis is not None:
        n = stops[axis] // dp_size
        starts[axis], stops[axis] = rank * n, (rank + 1) * n
    return starts, stops


def unshard(part: torch.Tensor, axis: Optional[int], dp_size: int, group=None) -> torch.Tensor:
    """The full leaf from every rank's slice (all-gather along ``axis``)."""
    if axis is None or dp_size <= 1:
        return part
    parts = [torch.empty_like(part) for _ in range(dp_size)]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def reduce_scatter(full: torch.Tensor, axis: int, dp_size: int, group=None) -> torch.Tensor:
    """This rank's slice along ``axis`` of the sum of ``full`` over the ranks."""
    chunks = [c.contiguous() for c in full.chunk(dp_size, dim=axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=group)
    return out


def sharding_coverage(axes, tensors):
    """(sharded_bytes, total_bytes) of the full-size ``tensors`` under the
    per-leaf ``axes`` (None = replicated)."""
    total = sharded = 0
    for axis, t in zip(axes, tensors):
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if axis is not None:
            sharded += nbytes
    return sharded, total


def chunk_spans(total: int, cap: Optional[int]):
    """Partition the flat range [0, total) into pipeline work spans of at most ``cap``
    elements: ``(lo, hi, win)`` triples where [lo, hi) is the span and ``win`` is the
    start of the fixed-width fetch window that covers it.

    Every window is exactly ``cap`` wide (the last one is right-aligned at
    ``total - cap``, overlapping its predecessor) so a single compiled fixed-width
    device slice serves every chunk of a region — the overlap re-fetches identical
    elements, which the consumer simply doesn't write twice. With ``cap`` None/0 or
    ``total <= cap`` the region stays whole: one span, window 0.
    """
    if not cap or cap <= 0 or total <= cap:
        return [(0, total, 0)]
    spans = []
    for lo in range(0, total, cap):
        hi = min(lo + cap, total)
        spans.append((lo, hi, lo if hi - lo == cap else total - cap))
    return spans


def elastic_split(arr, dp: int):
    """Split a host array into the ``dp`` flat checkpoint shards of the elastic
    optimizer-state layout (checkpoint/checkpointing.py). np.array_split
    semantics — first ``size % dp`` shards get one extra element — which is
    exactly what ``_MergedElastic`` concatenates back, so save@dp_a →
    restore@dp_b round-trips bit-exactly for any (dp_a, dp_b)."""
    return np.array_split(np.asarray(arr).reshape(-1), dp)


class _GatherAtUse(torch.autograd.Function):
    """Forward: the full leaf from every rank's slice. Backward: this rank's
    slice of the full gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, part, axis, gather):
        ctx.axis, ctx.gather = axis, gather
        # the slice, for the saved-tensor hooks' pack (not read by backward)
        ctx.ds_gathered_part = part
        return gather._all_gather(part, axis)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad.contiguous(), ctx.axis, ctx.gather.dp_size,
                               ctx.gather.group), None, None)


class ParamGather:
    """ZeRO stage 3's gather at use over ``params`` (the engine's leaves,
    each holding its slice along ``axes[i]``; None = replicated).

    ``gather(p)`` is the full leaf of ``p`` while a ``scope`` is open (the
    engine's forward and backward), through ``_GatherAtUse``; ``p`` itself
    for a replicated leaf (every leaf at one rank) or outside a scope. A model calls it
    where it uses a leaf (``models/gpt2.py`` inside each block); any other
    module gets it at each parameter attribute access (``install``).

    Counters, for the tests and the card's logs: ``gathers`` (all-gathers
    issued: forward, recompute and the backward's re-gathers),
    ``alive_bytes`` (gathered full leaves alive now) and ``peak_bytes``
    (their high-water mark since ``reset_counters``). ``whole(p)`` is the
    full leaf without grad and uncounted, at any time (a module's
    ``whole_parameters``). The gathers run over ``group`` (None: the
    world)."""

    def __init__(self, params, axes, dp_size: int, group=None):
        self._axis = {id(p): a for p, a in zip(params, axes)}
        self.dp_size = dp_size
        self.group = group
        self.sharded = dp_size > 1 and any(a is not None for a in axes)
        self._depth = 0
        self.reset_counters()

    def reset_counters(self):
        self.gathers = 0
        self.alive_bytes = 0
        self.peak_bytes = 0

    def _track(self, full):
        nbytes = full.numel() * full.element_size()
        self.gathers += 1
        self.alive_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.alive_bytes)
        weakref.finalize(full, self._release, nbytes)
        return full

    def _release(self, nbytes):
        self.alive_bytes -= nbytes

    def _all_gather(self, part, axis):
        return self._track(unshard(part, axis, self.dp_size, self.group))

    def whole(self, p):
        """The full leaf of ``p`` gathered without grad (``p``'s data where it
        is replicated)."""
        axis = self._axis.get(id(p))
        if axis is None or not self.sharded:
            return p.data
        with torch.no_grad():
            return unshard(p.detach(), axis, self.dp_size, self.group)

    def __call__(self, p):
        axis = self._axis.get(id(p))
        if axis is None or self._depth == 0:
            return p
        return _GatherAtUse.apply(p, axis, self)

    def tree(self, node):
        """``gather`` over every leaf of a nested dict / list of parameters."""
        if isinstance(node, dict):
            return {k: self.tree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(self.tree(v) for v in node)
        return self(node)

    @contextlib.contextmanager
    def scope(self, save_slices=False):
        """Gather while open. ``save_slices`` (the forward): autograd keeps
        each gathered copy it saves as the slice, and gathers it again in
        the backward; every other saved tensor passes through."""
        self._depth += 1
        hooks = (torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
                 if save_slices and self.sharded else contextlib.nullcontext())
        try:
            with hooks:
                yield
        finally:
            self._depth -= 1

    @staticmethod
    def _gather_node(fn):
        return fn if fn is not None and hasattr(fn, "ds_gathered_part") else None

    def _pack(self, t):
        # a gathered leaf, or a dtype cast of one (a float32 model over bf16
        # parameters), is saved as its slice; anything else as it is
        fn = t.grad_fn
        node = self._gather_node(fn)
        cast = None
        if node is None and fn is not None and type(fn).__name__ == "ToCopyBackward0":
            node = self._gather_node(fn.next_functions[0][0])
            cast = t.dtype
        if node is None or t.device != node.ds_gathered_part.device:
            return t
        return (_Slice, node.ds_gathered_part, node.axis, cast)

    def _unpack(self, packed):
        if not (isinstance(packed, tuple) and packed and packed[0] is _Slice):
            return packed
        _, part, axis, cast = packed
        with torch.no_grad():
            full = self._all_gather(part.detach(), axis)
        return full if cast is None else full.to(cast)

    def install(self, module):
        """The generic gather at use: every submodule that holds a sharded
        parameter answers an attribute access to it with ``gather(p)``
        (its class swapped for a subclass with that ``__getattr__``; its
        ``named_parameters`` and ``state_dict`` still hold the slices)."""
        for m in module.modules():
            if any(self._axis.get(id(p)) is not None for p in m._parameters.values()):
                m.__dict__["_ds_param_gather"] = self
                m.__class__ = _gathering_class(type(m))


_Slice = object()           # the tag of a saved-tensor slot packed as its slice
_GATHERING = {}


def _gathering_class(cls):
    if getattr(cls, "_ds_gathering", False):
        return cls
    if cls not in _GATHERING:
        def __getattr__(self, name):
            value = super(sub, self).__getattr__(name)
            gather = self.__dict__.get("_ds_param_gather")
            if gather is not None and isinstance(value, torch.nn.Parameter):
                return gather(value)
            return value

        sub = type(cls.__name__, (cls,), {"__getattr__": __getattr__, "_ds_gathering": True,
                                          "__module__": cls.__module__})
        _GATHERING[cls] = sub
    return _GATHERING[cls]
