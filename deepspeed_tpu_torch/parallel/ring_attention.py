"""Ring attention: the sequence dimension sharded over a group of ranks
(PyTorch port).

Counterpart of ``deepspeed_tpu/parallel/ring_attention.py``. Each rank holds
a ``[B, H, T/n, D]`` slice of q, k and v; k and v rotate around the ring,
one rank on at each rotation, and each visit runs the flash kernels
(``ops/flash_attention.py``) of this rank's q against the visiting chunk,
the per-chunk ``(out, lse)`` pairs combined by the online-softmax merge
(``_merge_partial``). Each rank's attention state is O(T/n), and the
kernels only see chunk-sized operands.

The JAX ring is one program under ``shard_map``: ``lax.ppermute`` rotates
the chunks and ``jax.grad`` derives the backward ring (ppermute's transpose
is the reverse rotation). Here each rank runs its own ring over a process
group. The rotation is one ``torch.autograd.Function`` (``rotate``) on k and
v stacked into one tensor: its forward sends to rank + 1 and receives from
rank - 1 (paired ``isend`` / ``irecv``, ``parallel/pipeline_spmd.py``
``exchange``; over gloo a CUDA tensor goes through the host), its backward
sends the gradient back to rank - 1 and receives rank + 1's. One exchange a
rotation makes the backward's collectives one forced chain: rotation r's
gradient exists only once every later rotation's has come back, on every
rank alike. Each rotation runs under ``record_function("ring_rot{r}")``,
the name the JAX ring gives its ``named_scope``, so that
``utils/profile_ingest.py`` attributes it.

Causal mode has the JAX package's two schedules:

``schedule="masked"``: ranks hold contiguous chunks; rotation 0 is the
causal call on the diagonal chunk, a strictly-past chunk attends fully. A
strictly-future chunk contributes nothing: the JAX ring computes it and
gates its lse to -inf, whose merge is exactly the identity; this rank knows
on the host that the chunk is in its future, so it skips the call (the
rotation still runs on every rank).

``schedule="zigzag"`` (the default): rank i of an n-ring holds global
chunks i and 2n-1-i of size C = T/(2n) (``zigzag_shard``). Rotation 0 is
one causal call over the local [2C] block with identical segment maps
``(i C, (2n-1-i) C)`` on both sides (the kernels' segmented operand);
every later rotation is two unmasked C x C calls: the visiting low chunk
against the local high half (call A, always in the past), and call B,
``q_lo x k_lo`` when the source rank is below this one and ``q_hi x k_hi``
otherwise. JAX routes call B with ``jnp.where`` so that every rank runs one
program; here the predicate ``src < rank`` is known on the host, so the rank
branches on it. The collectives stay the same and in the same order on
every rank, and the merged result is the JAX ring's.

Dropout is exact: every call hashes global coordinates (scalar offsets, or
the segment maps), so the mask is the one-card kernel's at the global T.
"""

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..ops.flash_attention import _merge_partial, flash_attention_with_lse
from .mesh import DATA_AXIS, gather_from_group
from .pipeline_spmd import exchange

SCHEDULES = ("zigzag", "masked")


# --------------------------------------------------------------------- zigzag layout
def _zigzag_chunk_order(n: int):
    """Global chunk index (of 2n chunks) at each position of the rank-concatenated
    zigzag layout: rank i holds [chunk i, chunk 2n-1-i]."""
    order = []
    for i in range(n):
        order.extend((i, 2 * n - 1 - i))
    return order


def _zigzag_index(T: int, n: int, name: str) -> np.ndarray:
    assert T % (2 * n) == 0, f"{name}: seq {T} must be divisible by 2n={2 * n}"
    c = T // (2 * n)
    return np.concatenate([np.arange(j * c, (j + 1) * c) for j in _zigzag_chunk_order(n)])


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Reorder a contiguous global sequence dim into the zigzag ring layout.

    Splits dim ``axis`` (length T, requires ``T % 2n == 0``) into ``2n`` chunks
    and concatenates them in rank order ``[0, 2n-1, 1, 2n-2, ...]``, so that
    rank ``i``'s contiguous slice of the result holds global chunks
    ``(i, 2n-1-i)``. An index gather; the inverse is ``zigzag_unshard``."""
    idx = _zigzag_index(x.shape[axis], n, "zigzag_shard")
    return torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 2) -> torch.Tensor:
    """Inverse of ``zigzag_shard``: zigzag ring layout back to contiguous order."""
    inv = np.argsort(_zigzag_index(x.shape[axis], n, "zigzag_unshard"))
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


def ring_work_schedule(n: int, schedule: str = "zigzag"):
    """Per-(rotation, rank) work accounting for the causal ring, in units of
    ``C x C`` score blocks where ``C = T/(2n)`` (half a rank's local sequence);
    a copy of deepspeed_tpu/parallel/ring_attention.py:99-139.

    ``computed`` counts blocks the JAX ring's flash calls run (after the
    kernels' block pruning); ``useful`` counts non-masked score blocks
    (diagonal blocks are half-masked and count 1 computed / 0.5 useful). The
    masked schedule computes 4 blocks every rotation on every rank (the port
    skips the strictly-future visits, the blocks with ``useful`` 0) but only
    past-source visits are useful; zigzag computes exactly the useful blocks,
    identically on every rank. Returns ``{"schedule", "n", "rotations": [{"r",
    "computed_per_rank", "useful_min", "useful_max"}], "total_computed",
    "total_useful"}`` with totals per rank summed over rotations."""
    assert schedule in SCHEDULES, f"schedule must be one of {SCHEDULES}"
    rotations = []
    for r in range(n):
        if r == 0:
            # both schedules: one causal call on the local [2C] block; the
            # kernel prunes to 3 computed blocks (two diagonal, one full)
            computed, useful = (3.0, 2.0)
            u_min = u_max = useful
        elif schedule == "masked":
            computed = 4.0  # full [2C x 2C] visit, masked or not
            # rank i's visit r is useful iff src=(i-r)%n < i, i.e. i >= r
            u_min, u_max = 0.0, 4.0
        else:
            computed = 2.0  # two C x C calls, both fully unmasked
            u_min = u_max = 2.0
        rotations.append({"r": r, "computed_per_rank": computed,
                          "useful_min": u_min, "useful_max": u_max})
    total_computed = sum(row["computed_per_rank"] for row in rotations)
    # useful totals: rank i gets 2 (diagonal) + 4*i (past visits); the
    # average over ranks is 2 + 2(n-1), in both schedules
    total_useful = 2.0 + 2.0 * (n - 1)
    return {"schedule": schedule, "n": n, "rotations": rotations,
            "total_computed": total_computed, "total_useful": total_useful}


# ------------------------------------------------------------------------ rotation
class _Rotate(torch.autograd.Function):
    """``x`` to rank + 1 of ``group``, rank - 1's ``x`` back; the gradient
    the other way round (ppermute and its transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad.contiguous(), ctx.group, -1), None


def _exchange(x, group, step):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    rotate.exchanges += 1
    rotate.bytes += x.numel() * x.element_size()
    return exchange(x, (r + step) % n, x, (r - step) % n, group)


def rotate(x: torch.Tensor, group) -> torch.Tensor:
    """One rotation of the ring over ``group``: this rank's ``x`` goes to the
    next rank and the previous rank's comes back, differentiably. Each
    exchange, forward or backward, counts in ``rotate.exchanges`` and its
    bytes sent in ``rotate.bytes`` (set them to 0 to start a count)."""
    return _Rotate.apply(x.contiguous(), group)


rotate.exchanges = rotate.bytes = 0


class _Tie(torch.autograd.Function):
    """``x`` forward; backward, ``x``'s gradient and zeros for ``deps``: a
    rotated chunk that no call of this rank reads stays in the graph, so
    that its rotation's backward (an exchange the other ranks wait for)
    runs on every rank."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.deps))


# ------------------------------------------------------------------------- schedules
def _flash(q, k, v, causal, sm_scale, rate, seed, q_off=0, k_off=0, seg=None):
    return flash_attention_with_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                    dropout_rate=rate, dropout_seed=seed,
                                    dropout_q_offset=q_off, dropout_k_offset=k_off,
                                    q_segments=seg, k_segments=seg)


def _masked_ring(q, k, v, group, n, rank, causal, sm_scale, rate, seed):
    """Contiguous-layout ring: rank r holds positions [r*T_local, (r+1)*T_local)."""
    T_local = q.shape[2]
    o = lse = None
    kv = torch.stack([k, v])
    unread = []
    for r in range(n):
        with record_function(f"ring_rot{r}"):
            if r > 0:
                kv = rotate(kv, group)
            src = (rank - r) % n
            if causal and r > 0 and src > rank:
                # a strictly-future chunk: its merge is the identity
                unread.append(kv)
                continue
            out_r, lse_r = _flash(q, kv[0], kv[1], causal and r == 0, sm_scale, rate, seed,
                                  rank * T_local, src * T_local)
            if o is None:
                o, lse = out_r.float(), lse_r
            else:
                o, lse = _merge_partial(o, lse, out_r, lse_r)
    return _Tie.apply(o, *unread).to(q.dtype)


def _zigzag_ring(q, k, v, group, n, rank, sm_scale, rate, seed):
    """Zigzag-layout causal ring: rank i holds global chunks (i, 2n-1-i), each of
    size C = T_local/2. The masked schedule is the oracle it must match after
    ``zigzag_unshard``."""
    T_local = q.shape[2]
    assert T_local % 2 == 0, f"zigzag needs an even local seq, got {T_local}"
    C = T_local // 2
    lo_off = rank * C                 # global start of the local low (early) chunk
    hi_off = (2 * n - 1 - rank) * C   # global start of the local high (late) chunk
    q_lo, q_hi = q[:, :, :C], q[:, :, C:]

    # rotation 0: one causal call over the whole local [2C] block, identical
    # q and k segment maps (the kernels' local tile pruning is exact)
    with record_function("ring_rot0"):
        out0, lse0 = _flash(q, k, v, True, sm_scale, rate, seed, seg=(lo_off, hi_off))
        o_lo, lse_lo = out0[:, :, :C].float(), lse0[:, :, :C]
        o_hi, lse_hi = out0[:, :, C:].float(), lse0[:, :, C:]

    kv = torch.stack([k, v])
    for r in range(1, n):
        with record_function(f"ring_rot{r}"):
            kv = rotate(kv, group)
            src = (rank - r) % n
            k_lo, k_hi = kv[0][:, :, :C], kv[0][:, :, C:]
            v_lo, v_hi = kv[1][:, :, :C], kv[1][:, :, C:]
            src_lo = src * C
            src_hi = (2 * n - 1 - src) * C
            # call A: q_hi x src's low chunk, always entirely in the past
            out_a, lse_a = _flash(q_hi, k_lo, v_lo, False, sm_scale, rate, seed, hi_off, src_lo)
            o_hi, lse_hi = _merge_partial(o_hi, lse_hi, out_a, lse_a)
            # call B: the remaining past half-chunk. A past source's low chunk
            # precedes ours; a future source's high chunk precedes our high one
            if src < rank:
                out_b, lse_b = _flash(q_lo, k_lo, v_lo, False, sm_scale, rate, seed, lo_off,
                                      src_lo)
                o_lo, lse_lo = _merge_partial(o_lo, lse_lo, out_b, lse_b)
            else:
                out_b, lse_b = _flash(q_hi, k_hi, v_hi, False, sm_scale, rate, seed, hi_off,
                                      src_hi)
                o_hi, lse_hi = _merge_partial(o_hi, lse_hi, out_b, lse_b)
    return torch.cat([o_lo, o_hi], dim=2).to(q.dtype)


def ring_attention(q, k, v, group, causal: bool = False, sm_scale: Optional[float] = None,
                   dropout_rate: float = 0.0, dropout_seed=None, schedule: str = "zigzag"):
    """Attention over a sequence sharded on the ranks of ``group``.

    Args:
      q, k, v: this rank's ``[B, H, T_local, D]`` shards. The non-causal ring
        and ``schedule="masked"`` take ring order (rank r holds positions
        [r*T_local, (r+1)*T_local)); the causal ``schedule="zigzag"`` takes
        the ``zigzag_shard`` layout (rank i holds global chunks i and 2n-1-i
        of size T_local/2).
      group: the process group the sequence is sharded over (its rank
        order is the ring's); None is a ring of one rank.
      dropout_rate / dropout_seed: in-kernel attention dropout, hashed in
        global coordinates, so the mask is the one-card kernel's at the
        global T (``dropout_keep_reference``), whatever the ring's size and
        schedule.
      schedule: the causal schedule, ``"zigzag"`` or ``"masked"``; ignored
        when ``causal=False``.
    Returns this rank's ``[B, H, T_local, D]`` output (the inputs' layout).
    Differentiable in q, k, v."""
    assert schedule in SCHEDULES, f"schedule must be one of {SCHEDULES}, got {schedule!r}"
    n = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if causal and schedule == "zigzag":
        return _zigzag_ring(q, k, v, group, n, rank, sm_scale, dropout_rate, dropout_seed)
    return _masked_ring(q, k, v, group, n, rank, causal, sm_scale, dropout_rate,
                        dropout_seed)


def ring_attention_sharded(q, k, v, mesh, seq_axis: str = DATA_AXIS, causal: bool = False,
                           sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                           dropout_seed=None, schedule: str = "zigzag"):
    """Global ``[B, H, T, D]`` q, k, v in natural sequence order, the same on
    every rank -> the whole ``[B, H, T, D]`` output in natural order on every
    rank (the JAX wrapper's global array). Each rank attends with its slice
    of the sequence over ``mesh``'s ``seq_axis`` (the port's
    ``parallel.mesh.Mesh``; None is one rank), and the slices' outputs are
    all-gathered. For the causal zigzag schedule the
    wrapper converts to and from the zigzag layout, so callers always see
    natural order.

    Gradient: for a loss that every rank computes alike from the output,
    each rank's grads of q, k and v hold its own slice's rows (the gather's
    backward keeps this rank's piece); their sum over the ranks is the whole
    gradient."""
    group = None if mesh is None else mesh.group(seq_axis)
    n = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    assert q.shape[2] % n == 0, f"seq {q.shape[2]} must divide over {seq_axis}={n}"
    zig = causal and schedule == "zigzag"
    if zig:
        assert q.shape[2] % (2 * n) == 0, \
            f"zigzag needs seq {q.shape[2]} divisible by 2*{n} (use schedule='masked')"
        q, k, v = (zigzag_shard(x, n, axis=2) for x in (q, k, v))
    T_local = q.shape[2] // n
    q, k, v = (x[:, :, rank * T_local:(rank + 1) * T_local] for x in (q, k, v))
    out = ring_attention(q, k, v, group, causal=causal, sm_scale=sm_scale,
                         dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                         schedule=schedule)
    out = gather_from_group(out, 2, group)
    return zigzag_unshard(out, n, axis=2) if zig else out
