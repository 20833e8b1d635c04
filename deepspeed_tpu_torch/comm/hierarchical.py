"""Two-level collectives: the topology-aware gradient-exchange schedule.

Counterpart of ``deepspeed_tpu/comm/hierarchical.py`` over torch process
groups (``topology.CommGroups``). Every data-parallel exchange becomes three
steps:

1. **intra-slice reduce-scatter** (exact, full precision): rank ``(s, l)``
   ends up owning chunk ``l`` of its slice's sum;
2. **cross-slice exchange**, one group a chunk position: a plain all-reduce,
   or the error-feedback two-phase sign compression
   (``runtime/custom_collectives.py``) among the ``num_slices`` peers;
3. **intra-slice all-gather** reassembles the full vector.

With ``slice_size == 1`` the schedule is the flat compressed allreduce;
with ``num_slices == 1`` a flat all-reduce. The JAX functions run inside a
``shard_map`` over the mesh; these run on each rank with its own vector.
Trees are the engine's leaf lists, in the JAX package's leaf order (the
caller orders them). Error feedback for the compressed mode: ``worker_error``
over the rank's intra-slice chunk ``(n / slice_size,)`` and ``server_error``
over its cross-slice sub-chunk ``(n / dp,)``.

The bucketed forms cut the leaves into size-bounded buckets
(``bucket_partition``) and exchange each on its own: the engine issues a
bucket's first step asynchronously as soon as the backward has produced its
leaves (``runtime/engine.py``, ``comm.overlap``). Per element the reduction
is the monolithic exchange's, so the mean is bit-equal to it.
"""

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.custom_collectives import SegmentMap, compressed_exchange, padded_size
from ..runtime.zero.sharding import reduce_scatter, unshard
from ..utils.cluster import named_scope as ds_named_scope
from .topology import CommGroups, CommTopology

__all__ = [
    "flatten_tree", "unflatten_tree", "tree_size", "grad_segment_ids", "leaf_segments",
    "two_level_sum", "two_level_start", "two_level_finish", "two_level_compressed",
    "error_state_shapes", "padded_size", "bucket_vec", "bucket_unpack",
    "bucket_partition", "bucket_plan", "bucketed_error_state_shapes",
    "bucketed_two_level_mean", "bucketed_two_level_compressed",
    "GRAD_BUCKET_SCOPE",
]

# the name every bucketed exchange runs under (a profiler range here; HLO
# metadata in the JAX package), by which the anatomy pass tells a bucket's
# collectives from the rest
GRAD_BUCKET_SCOPE = "ds_grad_bucket"


# ---------------------------------------------------------------- tree plumbing
def tree_size(leaves: Sequence[torch.Tensor]) -> int:
    return sum(int(t.numel()) for t in leaves)


def flatten_tree(leaves: Sequence[torch.Tensor]):
    """Leaves -> (n,) vector plus the restore recipe (sizes, shapes)."""
    flat = torch.cat([t.reshape(-1) for t in leaves])
    return flat, ([int(t.numel()) for t in leaves], [tuple(t.shape) for t in leaves])


def unflatten_tree(vec: torch.Tensor, recipe) -> List[torch.Tensor]:
    sizes, shapes = recipe
    return [p.reshape(s) for p, s in zip(torch.split(vec[:sum(sizes)], sizes), shapes)]


def grad_segment_ids(leaves, n_pad: int) -> np.ndarray:
    """Element -> leaf-index segment map over the flattened padded vector, the
    padded tail in its own segment (the JAX function, for the comparisons
    that take its array form; the exchanges take ``leaf_segments``)."""
    sizes = [int(np.prod(t.shape)) for t in leaves]
    ids = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    if n_pad > ids.shape[0]:
        ids = np.concatenate([ids, np.full(n_pad - ids.shape[0], len(sizes), np.int32)])
    assert ids.shape[0] == n_pad, f"tree has {ids.shape[0]} elements > n_pad={n_pad}"
    return ids


def leaf_segments(sizes: Sequence[int], n_pad: int) -> SegmentMap:
    """``grad_segment_ids``'s segments as runs: one a leaf, then the padded
    tail (a segment of its own only when there is one)."""
    sizes = [int(s) for s in sizes]
    n = sum(sizes)
    assert n <= n_pad, f"tree has {n} elements > n_pad={n_pad}"
    return SegmentMap(sizes + ([n_pad - n] if n_pad > n else []))


def error_state_shapes(n_pad: int, topo: CommTopology):
    """((dp, worker_cols), (dp, server_cols)) of the compressed exchange's
    persistent error buffers on an ``n_pad``-element vector (each rank holds
    one row of each)."""
    dp = topo.dp
    assert n_pad % dp == 0
    return (dp, n_pad // topo.slice_size), (dp, n_pad // dp)


# --------------------------------------------------------------- bucketing
def bucket_partition(leaves, bucket_bytes: int):
    """Greedy deterministic partition of the leaves (in order) into
    contiguous size-bounded buckets, priced at 4 bytes an element: a leaf
    opens a new bucket when appending it would push the current one past
    ``bucket_bytes``; a leaf larger than the bound gets its own. Returns
    leaf-index lists covering every leaf once."""
    buckets, cur, cur_bytes = [], [], 0
    for i, leaf in enumerate(leaves):
        nbytes = int(np.prod(leaf.shape)) * 4
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucket_plan(leaves, bucket_bytes: int, dp: int):
    """``bucket_partition`` plus each bucket's geometry: ``[{"leaf_indices",
    "sizes", "n", "n_pad"}]``, ``n_pad`` the bucket padded to
    ``padded_size(n, dp)``."""
    plan = []
    for idxs in bucket_partition(leaves, bucket_bytes):
        sizes = tuple(int(np.prod(leaves[i].shape)) for i in idxs)
        n = sum(sizes)
        plan.append({"leaf_indices": tuple(idxs), "sizes": sizes,
                     "n": n, "n_pad": padded_size(n, dp)})
    return plan


def bucketed_error_state_shapes(plan, topo: CommTopology):
    """((dp, worker_cols), (dp, server_cols)) of the bucketed compressed
    exchange's error buffers: the per-bucket chunks back to back in plan
    order."""
    dp = topo.dp
    we_cols = sum(b["n_pad"] // topo.slice_size for b in plan)
    se_cols = sum(b["n_pad"] // dp for b in plan)
    return (dp, we_cols), (dp, se_cols)


def bucket_vec(leaves, bucket, dtype=None):
    """One bucket's padded flat vector, a new tensor (in the leaves' dtype, or
    ``dtype``)."""
    vec = torch.cat([leaves[i].reshape(-1) for i in bucket["leaf_indices"]])
    if dtype is not None:
        vec = vec.to(dtype)
    return torch.nn.functional.pad(vec, (0, bucket["n_pad"] - bucket["n"]))


def bucket_unpack(mean, bucket, leaves, out):
    """Scatter one bucket's exchanged vector back onto its leaves (each in
    its leaf's dtype)."""
    off = 0
    for i, sz in zip(bucket["leaf_indices"], bucket["sizes"]):
        out[i] = mean[off:off + sz].reshape(leaves[i].shape).to(leaves[i].dtype)
        off += sz


# ------------------------------------------------------------ per-rank bodies
def two_level_start(x: torch.Tensor, groups: CommGroups):
    """The first step of ``two_level_sum``, asynchronously: ``(work, buf)``
    whose ``wait()`` leaves in ``buf`` the intra-slice reduce-scatter
    (hierarchical) or the world sum (flat). ``two_level_finish`` completes
    it."""
    topo = groups.topo
    if groups.world is None:
        return None, x
    if not topo.is_hierarchical or topo.slice_size == 1:
        # one level only: the world (flat), or the slices of one rank
        group = groups.world if not topo.is_hierarchical else groups.dcn
        return dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group, async_op=True), x
    chunks = [c.contiguous() for c in x.chunk(topo.slice_size)]
    out = torch.empty_like(chunks[0])
    return dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=groups.ici,
                               async_op=True), out


def two_level_finish(work, buf: torch.Tensor, groups: CommGroups) -> torch.Tensor:
    if work is not None:
        work.wait()
    topo = groups.topo
    if groups.world is None or not topo.is_hierarchical or topo.slice_size == 1:
        return buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=groups.dcn)
    return unshard(buf, 0, topo.slice_size, group=groups.ici)


def two_level_sum(x: torch.Tensor, groups: CommGroups) -> torch.Tensor:
    """Exact two-level SUM of this rank's vector over the data ranks:
    reduce-scatter within the slice, all-reduce across the slices,
    all-gather within the slice (a flat all-reduce on a flat topology). The
    caller divides for a mean. ``x`` is reduced in place on a flat
    topology."""
    work, buf = two_level_start(x, groups)
    return two_level_finish(work, buf, groups)


def two_level_compressed(x: torch.Tensor, we: torch.Tensor, se: torch.Tensor,
                         groups: CommGroups, segs: SegmentMap):
    """Two-level error-feedback sign-compressed MEAN of this rank's vector.

    ``x`` (n,); ``we`` (n / slice_size,) the worker error over this rank's
    intra-slice chunk; ``se`` (n / dp,) the server error over its
    cross-slice sub-chunk; ``segs`` the scale segments of the n elements.
    Returns ``(out (n,) ~= mean over dp of x, new_we, new_se)``."""
    topo = groups.topo
    n = x.numel()
    S, L = topo.num_slices, topo.slice_size
    assert n % (S * L) == 0, f"vector size {n} must divide by dp={S * L} (pad first)"
    C = n // L
    l = groups.ici_rank
    x = x.float()
    # level 1 (intra-slice, exact): reduce-scatter, then the slice mean, so
    # that the cross-slice mean composes to the grand mean
    chunk = (reduce_scatter(x, 0, L, group=groups.ici) if L > 1 else x) / L
    # level 2: compressed over the slices, this rank's chunk at offset l * C
    my_chunk, new_we, new_se = compressed_exchange(chunk, we, se, segs, l * C, groups.dcn)
    # level 3 (intra-slice): reassemble the full mean
    out = unshard(my_chunk, 0, L, group=groups.ici) if L > 1 else my_chunk
    return out, new_we, new_se


def bucketed_two_level_mean(leaves, plan, groups: CommGroups):
    """Per-bucket exact two-level MEAN of a leaf list: each bucket through
    ``two_level_sum`` under its own ``ds_grad_bucket{k}`` scope. Bit-equal to
    the monolithic exchange (bucketing reorders issue, not math)."""
    dp = groups.topo.dp
    out = [None] * len(leaves)
    for k, bucket in enumerate(plan):
        with ds_named_scope(f"{GRAD_BUCKET_SCOPE}{k}"):
            mean = two_level_sum(bucket_vec(leaves, bucket), groups) / dp
            bucket_unpack(mean, bucket, leaves, out)
    return out


def bucketed_two_level_compressed(leaves, we, se, plan, groups: CommGroups, seg_maps):
    """Per-bucket error-feedback compressed MEAN of a leaf list:
    ``two_level_compressed`` over each bucket's padded vector, the error
    buffers laid out per bucket (``bucketed_error_state_shapes``) and each
    bucket's scale segments its own (``seg_maps``, one a plan entry). Not
    bit-equal to the monolithic compressed exchange (the segments are cut per
    bucket). Returns ``(out leaves, new_we, new_se)``."""
    topo = groups.topo
    L, dp = topo.slice_size, topo.dp
    out = [None] * len(leaves)
    new_we, new_se = [], []
    we_off = se_off = 0
    for k, bucket in enumerate(plan):
        n_pad = bucket["n_pad"]
        wcols, scols = n_pad // L, n_pad // dp
        with ds_named_scope(f"{GRAD_BUCKET_SCOPE}{k}"):
            vec = bucket_vec(leaves, bucket, torch.float32)
            mean, we_k, se_k = two_level_compressed(
                vec, we[we_off:we_off + wcols], se[se_off:se_off + scols], groups,
                seg_maps[k])
            bucket_unpack(mean, bucket, leaves, out)
        new_we.append(we_k)
        new_se.append(se_k)
        we_off += wcols
        se_off += scols
    return out, torch.cat(new_we), torch.cat(new_se)
