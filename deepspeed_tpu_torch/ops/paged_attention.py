"""Paged decode attention: the CUDA kernels' wrapper and their plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``. The kernels
are ``csrc/paged_decode.cu`` (they replace the TPU kernel ``_decode_kernel``):
one query per slot attends over the slot's pages of the layer-major pool,
picked through the block table, with the positions at or past ``lengths[s]``
masked; the softmax is float32. Pools of float32, bfloat16 and float16 are
taken, as the JAX kernel takes any pool dtype.

Two designs, chosen by shape alone (``cluster_design``): where a head's row is
16 bytes times a power of two (``head_dim`` 8, 16, 32, 64, 128 or 256 in
16-bit types, and 4 in float32 too) ``paged_decode_cluster`` runs: each
history split across a thread-block cluster, pages staged by TMA, the splits
merged in the cluster (``cluster_plan`` gives its geometry). Other shapes run
``paged_decode``, the first design (one CTA per slot and head).

``paged_decode_attention`` launches a kernel for CUDA tensors, through the
dispatcher op ``deepspeed_tpu_torch::paged_decode``, and takes the plain
version only for tensors on the CPU; there is no other fallback.
``paged_decode_attention.launches`` counts kernel launches and
``.cluster_launches`` those of the cluster design (plain integers; set them to
0 to start a count).
"""

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STAGE_BYTES = 20480     # K + V of one stage of the cluster design's ring
_GROUP_ROW_BYTES = 2048  # at most heads_per_group * head_dim * itemsize
_MAX_GROUP = 8           # heads a CTA, one consumer warp each
_MAX_PASSES = 4          # token passes of a warp over one box
_LANE_VALUES = 16        # row values a lane holds: 3 CTAs of 6 warps an SM
_MAX_SPLITS = 8          # the portable thread-block cluster size


def paged_decode_reference(q, k_pool, v_pool, li, tables, lengths, *,
                           block_size):
    """Plain PyTorch version: gather the slot's pages by table into the flat
    ``[slots, n_head, max_blocks * block_size, head_dim]`` history, mask the
    positions at or past ``lengths``, float32 softmax over all of it, and cast
    the result to q's dtype. Runs on any device; the wrapper uses it for CPU
    tensors and ``chip_smoke.py`` holds the kernel against it on the card."""
    S, nh, _, hd = q.shape
    MB = tables.shape[1]
    ML = MB * block_size
    idx = tables.long()
    kg = k_pool[li][idx].reshape(S, ML, nh, hd).permute(0, 2, 1, 3).float()
    vg = v_pool[li][idx].reshape(S, ML, nh, hd).permute(0, 2, 1, 3).float()
    s = torch.matmul(q.float(), kg.transpose(-1, -2)) / math.sqrt(hd)
    pos = torch.arange(ML, device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vg).to(q.dtype)


def _check(q, k_pool, v_pool, li, tables, lengths, block_size):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be [slots, n_head, 1, head_dim], got {tuple(q.shape)}")
    S, nh, _, hd = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool/v_pool must share one [n_layer, num_blocks, "
                         f"block_size, n_head, head_dim] shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    n_layer, _, bs, pnh, phd = k_pool.shape
    if bs != block_size or pnh != nh or phd != hd:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} at block_size {block_size}")
    if not 0 <= li < n_layer:
        raise ValueError(f"layer {li} out of range for {n_layer} layers")
    if tables.dim() != 2 or tables.shape[0] != S or tuple(lengths.shape) != (S,):
        raise ValueError(f"tables must be [{S}, max_blocks] and lengths [{S}], "
                         f"got {tuple(tables.shape)} and {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pools must share one dtype of {tuple(_DTYPES)}, "
                        f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    devices = {t.device for t in (q, k_pool, v_pool, tables, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must be on one device, got {devices}")


def cluster_design(dtype, head_dim) -> bool:
    """The shape rule between the two designs: the cluster design stages
    pages by TMA, whose box rows (one head's ``head_dim`` values) must be a
    multiple of 16 bytes, and splits a row over the lanes of a warp in
    16-byte loads, which takes a power of two of them (``head_dim`` 8, 16,
    32, 64, 128 or 256 in 16-bit types, and 4 in float32 too)."""
    loads, rest = divmod(head_dim * dtype.itemsize, 16)
    return rest == 0 and loads & (loads - 1) == 0


@dataclass(frozen=True)
class ClusterPlan:
    """Geometry of one ``paged_decode_cluster`` launch. The grid is
    ``(splits, n_head // heads_per_group, slots)`` with clusters of
    ``splits`` CTAs, each a producer warp and one warp per head; a stage is
    ``tokens_per_box`` tokens of one page for ``heads_per_group`` heads,
    ``boxes_per_page`` such boxes a page; ``lanes`` lanes share a token's
    row, so a warp takes 32 / lanes tokens a pass."""
    heads_per_group: int
    tokens_per_box: int
    boxes_per_page: int
    splits: int
    lanes: int


@functools.lru_cache(maxsize=64)
def cluster_plan(n_head, head_dim, block_size, max_blocks, dtype) -> ClusterPlan:
    """The cluster design's geometry, from the shapes alone (never from the
    lengths, so the launch needs nothing read back from the card): the
    largest group of at most 8 heads that divides ``n_head`` within 2 KB of
    a token's row; a row as ``lanes`` x loads of 16 bytes, at most 16 values
    a lane (q and the accumulator in registers within the 96 a thread that
    three CTAs of six warps an SM allow); boxes of whole page rows within
    ``_STAGE_BYTES`` for K + V and 4 passes of the warp (GPT-2 1.5B: a whole
    page of 5 heads in bf16, half a page in float32); and up to
    ``_MAX_SPLITS`` CTAs a history. Cached: a decode step asks once per
    layer."""
    es = dtype.itemsize
    g = max(d for d in range(1, min(n_head, _MAX_GROUP) + 1)
            if n_head % d == 0 and d * head_dim * es <= _GROUP_ROW_BYTES)
    loads = head_dim * es // 16                          # 16-byte loads a row
    lanes = loads // min(loads, _LANE_VALUES * es // 16)
    row = 2 * g * head_dim * es
    boxes = -(-block_size // min(256, _MAX_PASSES * (32 // lanes), _STAGE_BYTES // row))
    tb = -(-block_size // boxes)
    return ClusterPlan(g, tb, boxes, min(_MAX_SPLITS, max_blocks), lanes)


_MAPS = {}          # (pointer, shape, dtype, device) -> the pool's TMA map


def _pool_map(lib, pool, plan):
    """The pool's TMA map, encoded once per pool: serving's pools stay put,
    so a decode step encodes nothing. The key holds everything the encoding
    reads (the box follows from the shape and dtype)."""
    key = (pool.data_ptr(), tuple(pool.shape), pool.dtype, pool.device.index)
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= 64:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(128)
        err = lib.paged_decode_pool_map(buf, pool.data_ptr(), _DTYPES[pool.dtype],
                                        *pool.shape[:3], pool.shape[3], pool.shape[4],
                                        plan.heads_per_group, plan.tokens_per_box)
        if err != 0:
            raise RuntimeError(f"paged_decode_pool_map failed: cudaError {err}")
        _MAPS[key] = buf
    return buf


def _launch(q, k_pool, v_pool, li, tables, lengths, block_size, cluster):
    """Launch ``paged_decode_cluster`` (``cluster``) or ``paged_decode`` on
    checked inputs and return the output; raises if the launch failed."""
    S, nh, _, hd = q.shape
    if hd % 2 or hd > 256:
        raise ValueError(f"the CUDA kernels take an even head_dim <= 256, got {hd}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"tables and lengths must be int32, got "
                        f"{tables.dtype} and {lengths.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    align = 16 if cluster else 2 * q.element_size()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be aligned to {align} bytes")
    lib = _lib()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if cluster:
            plan = cluster_plan(nh, hd, block_size, tables.shape[1], q.dtype)
            err = lib.paged_decode_cluster(
                q.data_ptr(), _pool_map(lib, k_pool, plan), _pool_map(lib, v_pool, plan),
                out.data_ptr(), tables.data_ptr(), lengths.data_ptr(), S, nh, hd,
                tables.shape[1], block_size, li, plan.heads_per_group,
                plan.tokens_per_box, plan.boxes_per_page, plan.splits, plan.lanes,
                1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
        else:
            st_layer, st_block, st_tok, st_head, _ = k_pool.stride()
            err = lib.paged_decode(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), S, nh, hd, tables.shape[1],
                block_size, li * st_layer, st_block, st_tok, st_head,
                1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if err != 0:
        name = "paged_decode_cluster" if cluster else "paged_decode"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def paged_decode_attention(q, k_pool, v_pool, li, tables, lengths, *,
                           block_size):
    """Decode attention through the block table.

    q [slots, n_head, 1, head_dim]; k_pool/v_pool the layer-major page pools
    [n_layer, num_blocks, block_size, n_head, head_dim] in q's dtype (float32,
    bfloat16 or float16); ``li`` the layer; tables [slots, max_blocks] int32
    page ids; lengths [slots] int32 valid history lengths (pos + 1, each
    >= 1). Returns
    [slots, n_head, 1, head_dim] in q's dtype. CUDA tensors launch the design
    the shape rule names (``cluster_design``) on the current stream (no
    synchronize); CPU tensors take the plain version; any other device
    raises."""
    li, block_size = int(li), int(block_size)
    _check(q, k_pool, v_pool, li, tables, lengths, block_size)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, li, tables, lengths,
                                      block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    return _paged_decode_op(q, k_pool, v_pool, li, tables, lengths, block_size)


paged_decode_attention.launches = paged_decode_attention.cluster_launches = 0


@torch.library.custom_op("deepspeed_tpu_torch::paged_decode", mutates_args=())
def _paged_decode_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, li: int,
                     tables: torch.Tensor, lengths: torch.Tensor,
                     block_size: int) -> torch.Tensor:
    """Both designs as one op the dispatcher sees (the byte counter, the flop
    counter and the lint's program recorder), the shape rule choosing
    between them inside it."""
    cluster = cluster_design(q.dtype, q.shape[3])
    out = _launch(q, k_pool, v_pool, li, tables, lengths, block_size, cluster)
    paged_decode_attention.launches += 1
    paged_decode_attention.cluster_launches += cluster
    return out


@_paged_decode_op.register_fake
def _(q, k_pool, v_pool, li, tables, lengths, block_size):
    return torch.empty_like(q)


def _lib():
    lib = _build.load("paged_decode")
    if lib.paged_decode.argtypes is None:
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.paged_decode.argtypes = [
            vp, vp, vp, vp, vp, vp,          # q k v out tables lengths
            i32, i32, i32, i32, i32,         # S nh hd MB BS
            i64, i64, i64, i64,              # layer offset, strides
            f32, i32, vp]                    # scale, dtype, stream
        lib.paged_decode_cluster.argtypes = [
            vp, vp, vp, vp, vp, vp,          # q, k map, v map, out, tables, lengths
            i32, i32, i32, i32, i32, i32,    # S nh hd MB BS layer
            i32, i32, i32, i32, i32,         # the plan
            f32, i32, vp]                    # scale, dtype, stream
        lib.paged_decode_pool_map.argtypes = [vp, vp, i32, i64, i64, i32, i32, i32, i32, i32]
        for fn in (lib.paged_decode, lib.paged_decode_cluster, lib.paged_decode_pool_map):
            fn.restype = ctypes.c_int
    return lib
