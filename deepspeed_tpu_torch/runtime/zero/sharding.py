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
  checkpoint layout.

The axis is an int (or None for a replicated leaf) where the JAX package
returns a ``PartitionSpec``.
"""

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
