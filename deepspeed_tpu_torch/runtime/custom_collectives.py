"""Error-feedback sign-compressed allreduce over torch process groups.

Counterpart of ``deepspeed_tpu/runtime/custom_collectives.py`` (the
reference's MPI+cupy compressed allreduce, ``onebit_adam.py:104-228``):

- Phase 1: every rank sign-compresses its buffer (1 bit an element plus one
  float32 RMS scale per segment) and sends chunk *j* to server *j*: one
  ``all_to_all_single`` of **bit-packed uint8** signs (8 a byte), plus an
  ``all_gather`` of the per-segment scales.
- Server reduction: each rank averages the received sign x scale chunks,
  applies its server error feedback and re-compresses.
- Phase 2: ``all_gather`` of the packed server signs and their scales
  rebuilds the averaged buffer on every rank.

The JAX function takes the ``(dp, n)`` stacked buffers sharded over the
mesh; here each rank holds its own row: ``x`` and ``worker_error`` ``(n,)``,
``server_error`` ``(n / dp,)``. torch has no ``packbits``: the signs are
packed little-endian with shifts, bit ``i`` of byte ``j`` the sign of
element ``8 j + i`` (set = non-negative), as ``jnp.packbits(...,
bitorder="little")`` packs them. Chunks not divisible by 8 ship one int8 a
sign (callers using ``padded_size`` always divide).

Scale segments are contiguous runs of the flat vector (one a parameter
leaf, the padded tail its own): ``SegmentMap`` holds their lengths, and a
segment's sum of squares is the sum over its run, accumulated in float64,
so no scatter-add (whose float atomics on CUDA would make the sums differ
from run to run) is used, and the card and the CPU agree on a scale to
float32 rounding where the JAX package sums in float32.
With one rank (or no process group) the collectives are the identity and
the arithmetic runs all the same.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _pack_signs(pos: torch.Tensor) -> torch.Tensor:
    """(..., m) bool (True = non-negative) -> (..., m / 8) uint8, element
    ``8 j + i`` in bit ``i`` of byte ``j``."""
    bits = pos.to(torch.uint8).reshape(*pos.shape[:-1], pos.shape[-1] // 8, 8)
    out = bits[..., 0].clone()
    for i in range(1, 8):
        out |= bits[..., i] << i
    return out


def _unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_signs``: (..., m / 8) uint8 -> (..., m) float32 in
    {-1, +1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits.to(torch.float32) * 2.0 - 1.0


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row j of ``t`` (size rows) to member j; row i of the result from
    member i."""
    if _group_size(group) == 1:
        return t
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(size, *t.shape): every member's ``t`` in member order."""
    n = _group_size(group)
    if n == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _signs_collective(collective, pos: torch.Tensor, packed: bool) -> torch.Tensor:
    """``collective`` over a bool sign array, bit-packed on the wire when the
    last dim divides by 8; returns float32 {-1, +1} in the collective's
    output shape."""
    if packed:
        return _unpack_signs(collective(_pack_signs(pos)))
    signs = torch.where(pos, 1, -1).to(torch.int8)
    return collective(signs).to(torch.float32)


class SegmentMap:
    """Contiguous scale segments of a flat vector: segment ``i`` is the run
    of ``sizes[i]`` elements after the runs before it (the JAX ``seg_ids``
    array ``np.repeat(arange(len(sizes)), sizes)``). Index tensors are made
    once per range and device."""

    def __init__(self, sizes: Sequence[int]):
        self.sizes = [int(s) for s in sizes]
        self.n_segs = len(self.sizes)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        self.n = int(self.offsets[-1])
        self._cache: Dict[tuple, tuple] = {}

    @classmethod
    def from_ids(cls, seg_ids) -> "SegmentMap":
        """From a JAX-style element -> segment id array whose ids run 0, 1,
        ... in contiguous runs (``None`` is one segment)."""
        ids = np.asarray(seg_ids, np.int64)
        n_segs = int(ids.max()) + 1
        sizes = np.bincount(ids, minlength=n_segs)
        if not np.array_equal(ids, np.repeat(np.arange(n_segs), sizes)):
            raise ValueError("segment ids must be contiguous ascending runs")
        return cls(sizes.tolist())

    @classmethod
    def single(cls, n: int) -> "SegmentMap":
        return cls([n])

    def runs(self, start: int, stop: int, cut: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """``(part, segment, length)`` of the non-empty runs of ``[start,
        stop)``, split where ``start + k * cut`` falls (``part`` = k)."""
        bounds = sorted(set([start, stop]
                            + [int(o) for o in self.offsets if start < o < stop]
                            + ([start + k * cut for k in range(1, (stop - start) // cut)
                                if start + k * cut < stop] if cut else [])))
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = int(np.searchsorted(self.offsets, a, side="right")) - 1
            out.append(((a - start) // cut if cut else 0, seg, b - a))
        return out

    def _plan(self, start, stop, cut, device):
        key = (start, stop, cut, str(device))
        plan = self._cache.get(key)
        if plan is None:
            r = self.runs(start, stop, cut)
            part = torch.tensor([p for p, _, _ in r], dtype=torch.long, device=device)
            seg = torch.tensor([s for _, s, _ in r], dtype=torch.long, device=device)
            lens = torch.tensor([n for _, _, n in r], dtype=torch.long, device=device)
            counts = torch.tensor([float(n) for _, _, n in r], dtype=torch.float64,
                                  device=device)
            plan = (r, part, seg, lens, counts)
            self._cache[key] = plan
        return plan

    def rms(self, buf: torch.Tensor, start: int) -> torch.Tensor:
        """(n_segs,) float32: each segment's RMS over the part of it that
        ``buf`` (the elements ``[start, start + len(buf))``) covers, 0 for a
        segment it does not touch (the JAX ``segment_sum`` with counts
        clamped to 1)."""
        # without a cut every segment is one run of the range; the squares
        # accumulate in float64 (a float32 sum over a 51M-element embedding
        # drifts by 1e-3 relative on the CPU and differently on the card)
        r, _, seg, _, counts = self._plan(start, start + buf.numel(), None, buf.device)
        norms = torch._foreach_norm(list(torch.split(buf, [n for _, _, n in r])), 2,
                                    dtype=torch.float64)
        out = torch.zeros(self.n_segs, dtype=torch.float32, device=buf.device)
        out[seg] = torch.sqrt(torch.stack(norms) ** 2 / counts).to(torch.float32)
        return out

    def expand(self, scales: torch.Tensor, start: int, stop: int,
               cut: Optional[int] = None) -> torch.Tensor:
        """Per-element scales of ``[start, stop)``: ``scales`` (n_segs,) gives
        every element its segment's scale; ``scales`` (parts, n_segs) with
        ``cut`` gives the elements of part k row k's (the JAX
        ``take_along_axis`` over ``seg_ids``)."""
        _, part, seg, lens, _ = self._plan(start, stop, cut, scales.device)
        vals = scales[part, seg] if scales.dim() == 2 else scales[seg]
        return torch.repeat_interleave(vals, lens, output_size=stop - start)

    def expand_rows(self, scales: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """(rows, stop - start): row r gives ``[start, stop)`` the scales of
        ``scales[r]``."""
        _, _, seg, lens, _ = self._plan(start, stop, None, scales.device)
        return torch.repeat_interleave(scales[:, seg], lens, dim=1, output_size=stop - start)


def compressed_exchange(vec: torch.Tensor, we: torch.Tensor, se: torch.Tensor,
                        segs: SegmentMap, offset: int = 0, group=None):
    """The two-phase error-feedback compressed MEAN of ``vec`` over the
    members of ``group`` (the body of the JAX ``compressed_allreduce`` and of
    ``two_level_compressed``'s cross-slice level).

    ``vec`` and ``we`` are this rank's ``(m,)`` float32 buffer and worker
    error, ``m`` divisible by the group size; ``se`` its ``(m / size,)``
    server error over its server chunk; ``offset`` the position of ``vec``
    within the vector ``segs`` segments. Returns ``(out (m,), new_we,
    new_se)``."""
    size = _group_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    m = vec.numel()
    if m % size:
        raise ValueError(f"buffer size {m} must be divisible by {size} (pad first)")
    csize = m // size
    packed = csize % 8 == 0

    corrected = vec + we
    wscale = segs.rms(corrected, offset)                              # (n_segs,)
    pos = corrected >= 0
    signs = pos.to(torch.float32) * 2.0 - 1.0
    new_we = corrected - segs.expand(wscale, offset, offset + m) * signs
    del signs

    # phase 1: chunk j of my signs -> server j, bit-packed on the wire
    recv = _signs_collective(lambda t: _all_to_all(t, group), pos.reshape(size, csize),
                             packed)                                   # (size, csize)
    wscales = _all_gather(wscale, group)                               # (size, n_segs)
    lo = offset + rank * csize
    server_m = torch.mean(recv * segs.expand_rows(wscales, lo, lo + csize), dim=0)
    del recv
    corrected_s = server_m + se
    sscale = segs.rms(corrected_s, lo)
    s_pos = corrected_s >= 0
    new_se = corrected_s - segs.expand(sscale, lo, lo + csize) * (s_pos.to(torch.float32)
                                                                   * 2.0 - 1.0)

    # phase 2: every server's compressed chunk to everyone
    all_signs = _signs_collective(lambda t: _all_gather(t, group), s_pos, packed)
    sscales = _all_gather(sscale, group)                               # (size, n_segs)
    out = all_signs.reshape(m) * segs.expand(sscales, offset, offset + m, cut=csize)
    return out, new_we, new_se


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, group=None, seg_ids=None,
                         segs: Optional[SegmentMap] = None):
    """Average this rank's ``x`` (n,) over ``group`` (default: the world)
    with 1-bit compression (the JAX ``compressed_allreduce``, one row a rank).

    ``worker_error`` (n,) and ``server_error`` (n / dp,) are this rank's
    persistent error feedback; ``seg_ids`` a JAX-style element -> segment map
    (contiguous runs; None = one segment), or ``segs`` the same as a
    ``SegmentMap``. Returns ``(out (n,), new_worker_error,
    new_server_error)``."""
    if group is None and dist.is_initialized() and dist.get_world_size() > 1:
        group = dist.group.WORLD
    n = x.numel()
    if segs is None:
        segs = SegmentMap.single(n) if seg_ids is None else SegmentMap.from_ids(seg_ids)
    return compressed_exchange(x.float(), worker_error, server_error, segs, 0, group)


def padded_size(n: int, dp: int, lanes: int = 128) -> int:
    """Round ``n`` up so each of the dp server chunks is a whole multiple of
    128 elements (the JAX package's TPU lane width, kept so that the 1-bit
    state keeps the JAX checkpoint's shapes)."""
    quantum = dp * lanes
    return ((n + quantum - 1) // quantum) * quantum
