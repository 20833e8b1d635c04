"""Block-sparse attention: the CUDA kernels' wrappers, their autograd, the
host-side LUTs and the plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``.
Attention on q, k, v ``[B, H, T, D]`` over the active blocks of a
``[H, T/block, T/block]`` 0/1 layout (``SparsityConfig.make_layout``), with a
token-level causal mask inside diagonal blocks when ``causal``. The kernels
are ``csrc/block_sparse_attention.cu``: ``bs_fwd`` (replaces the TPU kernels
``_bs_fwd_kernel_res`` / ``_bs_fwd_kernel``), ``bs_dq`` (``_bs_dq_kernel*``)
and ``bs_dkv`` (``_bs_dkv_kernel*``). They read the group-1 LUTs of
``build_luts`` (the TPU file's row grouping and membership bitmasks shape
tiles for its matrix unit and do not carry over), which ``device_luts``
keeps on the card, cached by layout and device.

Each of the three kernels comes in two designs, chosen by shape alone
(``tensor_core_path``): bfloat16/float16 with D <= 128 a multiple of 8 and a
layout block that is a multiple of 64 run ``bs_fwd_tc``, ``bs_dq_tc`` and
``bs_dkv_tc`` (``csrc/block_sparse_attention_tc.cu``: TMA-fed ``wgmma``
tiles over a work list, ``build_work``, that splits a heavy row or column of
the layout across CTAs and merges the parts deterministically; the forward
and dq share one list); the rest run ``bs_fwd``, ``bs_dq`` and ``bs_dkv``. A
failed build or launch raises; nothing falls back.

``block_sparse_attention`` keeps the JAX signature. For CUDA tensors it runs
the kernels through ``_BlockSparseAttention`` (a ``torch.autograd.Function``
whose backward forms ``delta = rowsum(dO * O)`` in float32 with torch ops and
launches the two backward kernels). For CPU tensors it runs the plain
version ``block_sparse_attention_reference``. There is no other fallback.
Each launch function counts its launches in ``<function>.launches``, and
those of the tensor-core design in ``<function>.tensor_core_launches``.
"""

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import DEFAULT_MASK_VALUE

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# LUT construction (host-side, static per layout)
# ---------------------------------------------------------------------------

_MEMB_SHIFT = 24  # block index in bits 0..23, membership bitmask in bits 24..30


def build_luts(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """From [H, nb, nb] layout build forward and transposed LUTs.

    Returns (counts [H*nb], cols [H*nb, A], counts_t [H*nb], rows_t [H*nb, A_t]):
    cols[h*nb+i, :counts[...]] are the active k-block indices of q-row i (sorted);
    rows_t the active q-block indices of k-column j.
    """
    counts, packed = build_grouped_luts(layout, 1)
    counts_t, packed_t = build_grouped_luts(np.transpose(np.asarray(layout), (0, 2, 1)), 1)
    return counts, packed & ((1 << _MEMB_SHIFT) - 1), counts_t, \
        packed_t & ((1 << _MEMB_SHIFT) - 1)


def build_grouped_luts(layout: np.ndarray, group: int):
    """LUT over GROUPS of ``group`` consecutive q-rows: each group's list is the
    UNION of its rows' active k-blocks, with a per-slot membership bitmask (bit g
    set iff sub-row g of the group attends that k-block) packed into the entry's
    high bits. The TPU kernels read grouped LUTs; the CUDA kernels read group 1.

    Returns (counts [H*ng], packed [H*ng, A]) with packed = kb | memb << 24; padded
    slots have memb == 0.
    """
    layout = np.asarray(layout) != 0
    H, nb, _ = layout.shape
    if nb % group:
        raise ValueError(f"layout rows {nb} not divisible by group {group}")
    if not (nb < (1 << _MEMB_SHIFT) and group <= 7):
        raise ValueError("packed LUT limits: nb < 2^24, group <= 7")
    ng = nb // group
    per_group = []
    max_a = 1
    for h in range(H):
        for gi in range(ng):
            rows = layout[h, gi * group:(gi + 1) * group]  # [group, nb]
            act = np.nonzero(rows.any(axis=0))[0]
            max_a = max(max_a, len(act))
            per_group.append((h, gi, rows, act))
    counts = np.zeros((H * ng,), np.int32)
    packed = np.zeros((H * ng, max_a), np.int32)
    for h, gi, rows, act in per_group:
        r = h * ng + gi
        counts[r] = len(act)
        for idx, kb in enumerate(act):
            memb = int(sum(1 << g for g in range(group) if rows[g, kb]))
            packed[r, idx] = int(kb) | (memb << _MEMB_SHIFT)
    return counts, packed


class DeviceLuts(NamedTuple):
    """int32 LUTs of one layout on one card (``build_luts``), their host
    copies, and the tensor-core design's work lists built from them
    (``device_work``), cached beside them."""
    counts: torch.Tensor
    cols: torch.Tensor
    counts_t: torch.Tensor
    rows_t: torch.Tensor
    host: Tuple[np.ndarray, ...]
    work: Dict[tuple, "DeviceWork"]


# A deep model calls block_sparse_attention once per layer with the same
# layout: without this cache every call would rebuild the LUTs (Python loops
# over H*nb rows, twice) and copy them to the card. Keyed by layout bytes and
# device, bounded, least recently used out first.
_LUT_CACHE = {}
_LUT_CACHE_MAX = 32


def device_luts(layout: np.ndarray, device) -> DeviceLuts:
    layout = np.asarray(layout)
    key = (layout.shape, layout.dtype.str, layout.tobytes(), str(torch.device(device)))
    hit = _LUT_CACHE.pop(key, None)
    if hit is None:
        host = tuple(np.ascontiguousarray(a, np.int32) for a in build_luts(layout))
        hit = DeviceLuts(*(torch.from_numpy(a).to(device) for a in host), host, {})
        while len(_LUT_CACHE) >= _LUT_CACHE_MAX:
            _LUT_CACHE.pop(next(iter(_LUT_CACHE)))
    _LUT_CACHE[key] = hit  # re-insert = most recently used
    return hit


# ---------------------------------------------------------------------------
# the tensor-core design's work lists (host-side, static per layout and shape)
# ---------------------------------------------------------------------------

TC_TILE = 64        # rows of a streamed tile and of a consumer warpgroup (wgmma M)


class WorkList(NamedTuple):
    """One CTA per item. ``items`` int32 ``[n, 8]``: (line, tile, first,
    last, group, part, parts, ws) — the CTA's rows are tile ``tile`` (of
    ``rows``) of layout line ``line`` (``h * nb + r``), it walks slots
    ``[first, last)`` of that line's list, and a split line's parts share
    ``group`` (-1 for an unsplit line) with workspace slots ``ws + part``.
    ``steps``: each item's 64-row tiles of the other side; ``bound``: the
    most an item may take. Heaviest first."""
    items: np.ndarray
    steps: np.ndarray
    n_groups: int
    ws_parts: int
    bound: int


def build_work(counts, lut, nb: int, block: int, causal: bool, rows: int,
               transposed: bool, batch: int = 1, n_sm: int = 132) -> WorkList:
    """Work items of ``bs_dkv_tc`` (``transposed``: the lines are layout
    columns, ``counts_t`` / ``rows_t``) or ``bs_dq_tc`` (rows, ``counts`` /
    ``cols``) at ``rows`` rows a CTA (64 or 128, dividing ``block``).

    An item's steps are the 64-row tiles of the other side it visits: each
    block of its slots in ``block / 64`` tiles, without those the causal mask
    drops wholly (dk/dv: every query before the CTA's first key; dq: every
    key after its last query). The bound is the balanced share of all
    ``batch`` copies' steps over ``n_sm`` CTAs at once, and at least one
    slot's steps; a line whose steps exceed it is cut, at slot boundaries,
    into the fewest parts the bound allows, each as near ``steps / parts``
    as the slots allow. Items are ordered heaviest first."""
    counts = np.asarray(counts, np.int64)
    lut = np.asarray(lut, np.int64)
    L, A = lut.shape
    if block % TC_TILE or block % rows or rows % TC_TILE:
        raise ValueError(f"build_work takes 64-row tiles: block {block}, rows {rows}")
    r0 = lut[:, :, None] * block + TC_TILE * np.arange(block // TC_TILE)   # [L, A, sub]
    valid = np.arange(A)[None, :] < counts[:, None]
    own = (np.arange(L) % nb) * block
    per_tile = []
    for t in range(block // rows):
        own0 = (own + t * rows)[:, None, None]
        if not causal:
            keep = np.ones(r0.shape, bool)
        elif transposed:
            keep = r0 + TC_TILE - 1 >= own0
        else:
            keep = r0 <= own0 + rows - 1
        per_tile.append(keep.sum(-1) * valid)
    steps = np.stack(per_tile, 1)                    # [L, tiles, A]
    totals = steps.sum(-1)
    bound = max(-(-int(totals.sum()) * batch // n_sm), int(steps.max(initial=0)), 1)
    rows_out = []
    n_groups = ws = 0
    for line in range(L):
        n = int(counts[line])
        for t in range(steps.shape[1]):
            total = int(totals[line, t])
            if total <= bound:
                rows_out.append((total, line, t, 0, n, -1, 0, 1, 0))
                continue
            slot_steps = [int(x) for x in steps[line, t, :n]]
            fewest = len(_cut(slot_steps, bound))
            cap = max(-(-total // fewest), max(slot_steps))
            while len(_cut(slot_steps, cap)) > fewest:
                cap += 1
            cuts = _cut(slot_steps, cap)
            for part, (f, l, a) in enumerate(cuts):
                rows_out.append((a, line, t, f, l, n_groups, part, len(cuts), ws))
            n_groups += 1
            ws += len(cuts)
    rows_out.sort(key=lambda r: -r[0])
    items = np.array([r[1:] for r in rows_out], np.int32).reshape(-1, 8)
    return WorkList(items, np.array([r[0] for r in rows_out], np.int64), n_groups, ws, bound)


def _cut(slot_steps, cap):
    """Greedy cut of a line's slots into parts of at most ``cap`` steps:
    [(first, last, steps)]; the fewest parts any cut at ``cap`` allows."""
    cuts, first, acc = [], 0, 0
    for slot, st in enumerate(slot_steps):
        if acc and acc + st > cap:
            cuts.append((first, slot, acc))
            first, acc = slot, 0
        acc += st
    cuts.append((first, len(slot_steps), acc))
    return cuts


class DeviceWork(NamedTuple):
    """A ``WorkList`` with its items on the card."""
    items: torch.Tensor
    n_groups: int
    ws_parts: int
    rows: int


def tensor_core_path(dtype, D: int, block: int) -> bool:
    """The shape rule between each kernel's two designs: 16-bit
    operands (what ``wgmma`` multiplies), a head dim that fits one 128-wide
    tile and gives TMA rows of a multiple of 16 bytes, and a layout block of
    whole 64-row tiles."""
    return (dtype in (torch.bfloat16, torch.float16) and 8 <= D <= 128 and D % 8 == 0
            and block % TC_TILE == 0)


def cta_rows(transposed: bool, D: int, block: int) -> int:
    """Rows a CTA of the tensor-core design owns: two warpgroups (128 rows)
    where the layout block is a multiple of 128, so that they lie in one
    layout row or column, and for dk/dv (``transposed``) D <= 64, whose
    accumulators leave room for a second warpgroup; else one (64). The
    forward and dq (not ``transposed``) take the same."""
    return 128 if block % 128 == 0 and (not transposed or D <= 64) else TC_TILE


def device_work(luts: DeviceLuts, device, *, T: int, block: int, causal: bool,
                transposed: bool, batch: int, D: int) -> DeviceWork:
    """The work list of the tensor-core kernels over layout rows (the
    forward and dq) or columns (``transposed``: dk/dv) on ``luts``' card,
    built once per (side, block, causal, batch, rows, SM count) and cached
    with the LUTs."""
    rows = cta_rows(transposed, D, block)
    device = torch.device(device)
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else 132)
    key = (transposed, int(block), bool(causal), int(batch), rows, n_sm)
    hit = luts.work.get(key)
    if hit is None:
        counts, lut = (luts.host[2], luts.host[3]) if transposed else luts.host[:2]
        w = build_work(counts, lut, T // block, block, causal, rows, transposed, batch, n_sm)
        hit = luts.work[key] = DeviceWork(torch.from_numpy(w.items).to(device), w.n_groups,
                                          w.ws_parts, rows)
    return hit


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def layout_mask(layout, block: int, causal: bool, device=None) -> torch.Tensor:
    """The layout expanded to tokens, ``[H, T, T]`` bool, and with
    ``causal`` also cut to the lower triangle (q >= k)."""
    mask = torch.from_numpy(np.asarray(layout) != 0).to(device)
    mask = mask.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask = mask & torch.ones(mask.shape[1:], dtype=torch.bool, device=device).tril()
    return mask


def dense_blocksparse_attention(q, k, v, layout, block: int, causal: bool = False,
                                sm_scale: Optional[float] = None):
    """Dense-masked oracle (the JAX package's; O(T^2) memory): float32
    softmax over the masked scores, rows with no allowed key zeroed, the
    probabilities rounded to q's dtype before the product with v.
    Differentiable by autograd."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mask = layout_mask(layout, block, causal, q.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    scores = torch.where(mask, scores, torch.full((), DEFAULT_MASK_VALUE, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def block_sparse_attention_reference(q, k, v, layout, block: int, causal: bool = False,
                                     sm_scale: Optional[float] = None):
    """Plain PyTorch version of the kernels: ``(out, lse)``, rounding where
    they round (scores times sm_scale after q.k in float32, natural exp,
    dropped lanes exactly 0, probabilities rounded to v's dtype before p.v,
    the normalizer unrounded). A row with no allowed key gives out 0 and lse
    -inf. ``out`` is differentiable by autograd in q, k, v; ``lse`` is not.
    The wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds the
    kernels against it on the card."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mask = layout_mask(layout, block, causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.masked_fill(~mask, -math.inf)
    # out does not depend on the shift m, so it carries no gradient
    m = s.detach().amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    # l >= 1 wherever a lane survives (its max lane gives exp(0)): the
    # kernels' 1e-30 floor only meets rows with none, whose out is 0
    l_safe = torch.where(l > 0, l, 1.0)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(l > 0, m + torch.log(l_safe), -math.inf)[..., 0].detach()
    return out.to(q.dtype), lse


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("block_sparse_attention")
    if lib.bs_fwd.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lut = [vp, vp, i32]                               # counts, lut, width
        tail = [i32, i32, i32, i32, i32, f32, i32, i32, vp]  # BH H T D block scale causal dtype stream
        lib.bs_fwd.argtypes = [vp] * 5 + lut + tail
        lib.bs_dq.argtypes = [vp] * 6 + lut + [vp] + tail
        lib.bs_dkv.argtypes = [vp] * 6 + lut + [vp, vp] + tail
        for fn in (lib.bs_fwd, lib.bs_dq, lib.bs_dkv):
            fn.restype = ctypes.c_int
    return lib


def _lib_tc():
    lib = _build.load("block_sparse_attention_tc")
    if lib.bs_dq_tc.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # lut width, items n_items ws ws_parts arrivals n_groups rows
        work = [vp, i32] + [vp, i32, vp, i32, vp, i32, i32]
        tail = [i32, i32, i32, i32, i32, f32, i32, i32, vp]  # B H T D block scale causal dtype stream
        lib.bs_fwd_tc.argtypes = [vp] * 3 + work + [vp, vp] + tail      # q k v; out lse
        lib.bs_dq_tc.argtypes = [vp] * 6 + work + [vp] + tail           # q k v do lse delta; dq
        lib.bs_dkv_tc.argtypes = [vp] * 6 + work + [vp, vp] + tail      # ...; dk dv
        for fn in (lib.bs_fwd_tc, lib.bs_dq_tc, lib.bs_dkv_tc):
            fn.restype = ctypes.c_int
    return lib


def _check_launch(q, k, v, luts, block, do=None, lse=None, delta=None):
    """Raise on what the kernels do not take: q, k, v (and do) of one
    ``[B, H, T, D]`` shape and one dtype with D <= 256; a layout block that
    is a multiple of 16 and divides T; the LUTs of an ``[H, T/block,
    T/block]`` layout; lse and delta float32 ``[B, H, T]``; all contiguous on
    q's card."""
    if q.dim() != 4 or any(t is not None and t.shape != q.shape for t in (k, v, do)):
        raise ValueError(f"q, k, v, do must share one [B, H, T, D] shape, got "
                         f"{[tuple(t.shape) for t in (q, k, v, do) if t is not None]}")
    B, H, T, D = q.shape
    if D > 256:
        raise ValueError(f"the kernels take head_dim <= 256, got {D}")
    if block % 16 or T % block:
        raise ValueError(f"the kernels take a layout block that is a multiple of 16 and "
                         f"divides T = {T}, got {block}")
    if q.dtype not in _DTYPES or any(t is not None and t.dtype != q.dtype
                                     for t in (k, v, do)):
        raise TypeError(f"q, k, v, do must share one dtype of {tuple(_DTYPES)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (tuple(t.shape) != (B, H, T) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {(B, H, T)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    rows = H * (T // block)
    for name, c, lut in (("", luts.counts, luts.cols), ("_t", luts.counts_t, luts.rows_t)):
        if (c.dtype != torch.int32 or lut.dtype != torch.int32 or tuple(c.shape) != (rows,)
                or lut.dim() != 2 or lut.shape[0] != rows):
            raise ValueError(f"LUT{name} must be int32 counts [{rows}] and indices "
                             f"[{rows}, width] (an [H, T/block, T/block] layout)")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
                    ("delta", delta), ("counts", luts.counts), ("cols", luts.cols),
                    ("counts_t", luts.counts_t), ("rows_t", luts.rows_t)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tail(q, block, sm_scale, causal):
    B, H, T, D = q.shape
    return (B * H, H, T, D, int(block), float(sm_scale), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


class TcPlan(NamedTuple):
    """What a tensor-core entry's launch takes from the host: its work list,
    the LUT it walks and the float32 workspace floats of one part of a split
    line."""
    work: DeviceWork
    lut: torch.Tensor
    part_floats: int


def tc_plan(name: str, luts: DeviceLuts, q, *, block: int, causal: bool) -> TcPlan:
    """The plan of ``bs_fwd_tc``, ``bs_dq_tc`` or ``bs_dkv_tc`` (``name``) on
    q's shape: the forward and dq walk the layout rows (``cols``) with one
    cached work list; dk/dv the columns (``rows_t``). A part holds, over
    the CTA's rows and the padded head dim DP: the forward's unnormalised
    acc and each row's running max and sum, rows * (DP + 2); dq's sum, rows *
    DP; dk/dv's two, 2 * rows * DP."""
    B, H, T, D = q.shape
    transposed = name == "bs_dkv_tc"
    work = device_work(luts, q.device, T=T, block=block, causal=causal, transposed=transposed,
                       batch=B, D=D)
    dp = 64 if D <= 64 else 128
    part = {"bs_fwd_tc": dp + 2, "bs_dq_tc": dp, "bs_dkv_tc": 2 * dp}[name] * work.rows
    return TcPlan(work, luts.rows_t if transposed else luts.cols, part)


def _launch_tc(name, ins, luts, outs, *, block, causal, sm_scale):
    """Launch ``bs_fwd_tc``, ``bs_dq_tc`` or ``bs_dkv_tc`` (``name``) on the
    tensors ``ins`` (q, k, v, then for the backward do, lse, delta) over its
    cached work list: a float32 workspace for the split lines' parts and
    their zeroed arrival counters come with the launch."""
    q = ins[0]
    B, H, T, D = q.shape
    plan = tc_plan(name, luts, q, block=block, causal=causal)
    work = plan.work
    ws = arrivals = None
    if work.n_groups:
        ws = torch.empty(B * work.ws_parts * plan.part_floats, dtype=torch.float32,
                         device=q.device)
        arrivals = torch.zeros(B * work.n_groups, dtype=torch.int32, device=q.device)
    entry = getattr(_lib_tc(), name)
    with torch.cuda.device(q.device):
        err = entry(*(t.data_ptr() for t in ins), plan.lut.data_ptr(), plan.lut.shape[1],
                    work.items.data_ptr(), work.items.shape[0],
                    None if ws is None else ws.data_ptr(), work.ws_parts,
                    None if arrivals is None else arrivals.data_ptr(), work.n_groups,
                    work.rows, *(o.data_ptr() for o in outs), B, H, T, D, int(block),
                    float(sm_scale), int(bool(causal)), _DTYPES[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _aligned(*ts):
    """The tensor-core entries' TMA operands start on 16 bytes."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and do must start on a 16-byte boundary for the "
                             "tensor-core entries")


def block_sparse_fwd(q, k, v, luts: DeviceLuts, *, block, causal, sm_scale):
    """Launch ``bs_fwd_tc`` or ``bs_fwd`` by the shape rule
    (``tensor_core_path``): returns ``(out, lse)``, out in q's dtype and lse
    float32 ``[B, H, T]`` (natural log; -inf on rows with no allowed key)."""
    _check_launch(q, k, v, luts, block)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    tensor_cores = tensor_core_path(q.dtype, q.shape[3], block)
    if tensor_cores:
        _aligned(q, k, v)
        _launch_tc("bs_fwd_tc", (q, k, v), luts, (out, lse), block=block, causal=causal,
                   sm_scale=sm_scale)
    else:
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.bs_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), luts.counts.data_ptr(), luts.cols.data_ptr(),
                             luts.cols.shape[1], *_tail(q, block, sm_scale, causal))
        if err != 0:
            raise RuntimeError(f"bs_fwd kernel launch failed: cudaError {err}")
    block_sparse_fwd.launches += 1
    block_sparse_fwd.tensor_core_launches += tensor_cores
    return out, lse


def _aligned16(t):
    """t, or a copy of it that starts on a 16-byte boundary (a contiguous
    view may start anywhere in its storage)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def block_sparse_bwd_dq(q, k, v, do, lse, delta, luts: DeviceLuts, *, block, causal,
                        sm_scale):
    """Launch ``bs_dq_tc`` or ``bs_dq`` by the shape rule
    (``tensor_core_path``): returns dq in q's dtype. ``do`` as q; ``lse`` and
    ``delta`` contiguous float32 ``[B, H, T]``."""
    _check_launch(q, k, v, luts, block, do, lse, delta)
    dq = torch.empty_like(q)
    tensor_cores = tensor_core_path(q.dtype, q.shape[3], block)
    if tensor_cores:
        _aligned(q, k, v, do)
        _launch_tc("bs_dq_tc", (q, k, v, do, lse, delta), luts, (dq,), block=block,
                   causal=causal, sm_scale=sm_scale)
    else:
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.bs_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), luts.counts.data_ptr(),
                            luts.cols.data_ptr(), luts.cols.shape[1], dq.data_ptr(),
                            *_tail(q, block, sm_scale, causal))
        if err != 0:
            raise RuntimeError(f"bs_dq kernel launch failed: cudaError {err}")
    block_sparse_bwd_dq.launches += 1
    block_sparse_bwd_dq.tensor_core_launches += tensor_cores
    return dq


def block_sparse_bwd_dkv(q, k, v, do, lse, delta, luts: DeviceLuts, *, block, causal,
                         sm_scale):
    """Launch ``bs_dkv_tc`` or ``bs_dkv`` by the shape rule over the
    transposed LUT: returns ``(dk, dv)`` in k's dtype."""
    _check_launch(q, k, v, luts, block, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tensor_cores = tensor_core_path(q.dtype, q.shape[3], block)
    if tensor_cores:
        _aligned(q, k, v, do)
        _launch_tc("bs_dkv_tc", (q, k, v, do, lse, delta), luts, (dk, dv), block=block,
                   causal=causal, sm_scale=sm_scale)
    else:
        lib = _lib()
        with torch.cuda.device(q.device):
            err = lib.bs_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), luts.counts_t.data_ptr(),
                             luts.rows_t.data_ptr(), luts.rows_t.shape[1], dk.data_ptr(),
                             dv.data_ptr(), *_tail(q, block, sm_scale, causal))
        if err != 0:
            raise RuntimeError(f"bs_dkv kernel launch failed: cudaError {err}")
    block_sparse_bwd_dkv.launches += 1
    block_sparse_bwd_dkv.tensor_core_launches += tensor_cores
    return dk, dv


block_sparse_fwd.launches = block_sparse_fwd.tensor_core_launches = 0
block_sparse_bwd_dq.launches = block_sparse_bwd_dq.tensor_core_launches = 0
block_sparse_bwd_dkv.launches = block_sparse_bwd_dkv.tensor_core_launches = 0


# The kernels' dispatcher ops (the flop counter sees them:
# utils/flops_profiler.py) take the LUTs by a key into this registry, and the
# active block pairs of the layout as an integer the flop formula reads.
_OP_LUTS: Dict[int, DeviceLuts] = {}


def _op_key(luts: DeviceLuts) -> int:
    key = luts.work.get("op_key")
    if key is None:
        key = luts.work["op_key"] = len(_OP_LUTS)
        _OP_LUTS[key] = luts
    return key


def active_blocks(counts: np.ndarray, lut: np.ndarray, nb: int, causal: bool) -> int:
    """Active (q-block, k-block) pairs over the heads of a forward LUT
    (``build_luts``' ``counts``, ``cols``; ``nb`` blocks a row); under
    ``causal`` the pairs above the diagonal, which the kernels skip, are
    left out."""
    total = 0
    for r, n in enumerate(np.asarray(counts)):
        cols = np.asarray(lut[r, :n])
        total += int(np.count_nonzero(cols <= r % nb)) if causal else int(n)
    return total


def _active(luts: DeviceLuts, nb: int, causal: bool) -> int:
    key = ("active", nb, bool(causal))
    hit = luts.work.get(key)
    if hit is None:
        hit = luts.work[key] = active_blocks(luts.host[0], luts.host[1], nb, causal)
    return hit


@torch.library.custom_op("deepspeed_tpu_torch::bs_fwd", mutates_args=())
def _bs_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, luts_key: int,
               causal: bool, sm_scale: float, block: int,
               active: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return block_sparse_fwd(q, k, v, _OP_LUTS[luts_key], block=block, causal=causal,
                            sm_scale=sm_scale)


@_bs_fwd_op.register_fake
def _(q, k, v, luts_key, causal, sm_scale, block, active):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("deepspeed_tpu_torch::bs_bwd_dq", mutates_args=())
def _bs_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, luts_key: int, causal: bool,
              sm_scale: float, block: int, active: int) -> torch.Tensor:
    return block_sparse_bwd_dq(q, k, v, do, lse, delta, _OP_LUTS[luts_key], block=block,
                               causal=causal, sm_scale=sm_scale)


@_bs_dq_op.register_fake
def _(q, k, v, do, lse, delta, luts_key, causal, sm_scale, block, active):
    return torch.empty_like(q)


@torch.library.custom_op("deepspeed_tpu_torch::bs_bwd_dkv", mutates_args=())
def _bs_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
               lse: torch.Tensor, delta: torch.Tensor, luts_key: int, causal: bool,
               sm_scale: float, block: int, active: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return block_sparse_bwd_dkv(q, k, v, do, lse, delta, _OP_LUTS[luts_key], block=block,
                                causal=causal, sm_scale=sm_scale)


@_bs_dkv_op.register_fake
def _(q, k, v, do, lse, delta, luts_key, causal, sm_scale, block, active):
    return torch.empty_like(k), torch.empty_like(v)


class _BlockSparseAttention(torch.autograd.Function):
    """Kernel forward; backward by the dq and dk/dv kernels; each launch
    through its dispatcher op."""

    @staticmethod
    def forward(ctx, q, k, v, luts, block, causal, sm_scale):
        static = (_op_key(luts), bool(causal), float(sm_scale), int(block),
                  _active(luts, q.shape[2] // block, causal))
        out, lse = _bs_fwd_op(q, k, v, *static)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = _aligned16(g.contiguous())
        # the softmax-normalization term, in float32 from the rounded out
        delta = (do.float() * out.float()).sum(-1).contiguous()
        dq = _bs_dq_op(q, k, v, do, lse, delta, *ctx.static)
        dk, dv = _bs_dkv_op(q, k, v, do, lse, delta, *ctx.static)
        return dq, dk, dv, None, None, None, None


def block_sparse_attention(q, k, v, layout, block: int, causal: bool = False,
                           sm_scale: Optional[float] = None, interpret: Optional[bool] = None,
                           group: Optional[int] = None):
    """Block-sparse attention on ``[B, H, T, D]`` with an ``[H, T/block,
    T/block]`` layout, differentiable in q, k, v. Rows with no allowed key
    give 0. ``interpret`` and ``group`` are accepted for the JAX signature
    and have no effect: CPU tensors always take the plain version, and the
    CUDA kernels read the ungrouped LUT. CUDA tensors launch the kernels,
    which take a block that is a multiple of 16 and D <= 256 (in the design
    ``tensor_core_path`` names)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {tuple(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, T, D = q.shape
    if T % block:
        raise ValueError(f"seq len {T} must be divisible by block {block}")
    layout = np.asarray(layout)
    if layout.shape != (H, T // block, T // block):
        raise ValueError(f"layout shape {layout.shape} does not match {H} heads and "
                         f"{T // block} blocks of {block} (T = {T})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return block_sparse_attention_reference(q, k, v, layout, block, causal, sm_scale)[0]
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse attention runs on cuda or cpu, not {q.device}")
    return _BlockSparseAttention.apply(*(_aligned16(t.contiguous()) for t in (q, k, v)),
                                       device_luts(layout, q.device), int(block),
                                       bool(causal), float(sm_scale))
