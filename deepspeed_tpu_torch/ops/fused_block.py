"""Fused attention half of a transformer block: the CUDA kernels' wrappers,
their autograd, and the plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_block.py``:
``x + proj(attention(qkv(layernorm(x))))``. The TPU kernel
``_fused_block_kernel`` is replaced by two entries of one of two designs,
picked by one shape rule (``tensor_core_plan``):

- the tensor-core design (``csrc/fused_block_tc.cu``; ``wgmma`` on
  TMA-staged tiles): ``fused_block_qkv_tc`` (LayerNorm + the whole qkv
  product into a head-major ``[3, B, H, T, D]`` workspace of x's dtype) and
  ``fused_block_attn_tc`` (attention over the workspace, the projection, the
  bias and the residual; two CTAs of a cluster share a q tile's heads and
  exchange their contexts). bfloat16/float16 x, E a multiple of 64, head dim
  <= 128 a multiple of 8, at the widths whose ``[64, E]`` row tile and rings
  fit a CTA's shared memory (every GPT-2 width, E 1600 included). Reaching
  device memory: the workspace and the output; not the normalized hidden
  states, the scores, the probabilities, the per-head contexts or the
  pre-residual output.
- the CUDA-core design (``csrc/fused_block.cu``), for the rest (float32
  among them): ``fused_block_kv`` (LayerNorm + the k and v thirds into a
  ``[2, B, T, E]`` workspace) and ``fused_block_q`` (LayerNorm + the q third,
  attention, projection, bias and residual; q stays on chip). Its geometry is
  a shape rule too (``cuda_core_plan``): a tile of 32 rows, or of 16 where
  two ``[32, E]`` buffers of x's dtype and the attention tiles do not fit a
  CTA's shared memory, and the head dim padded to 16, 32, 64 or 128. It
  takes float32 up to E 1688 (E 1024 and 1600 at 16 rows), 16-bit x up to
  E 3376, and head dims up to 128; ``check_limits`` names the limit of what
  it refuses (float32 at E 2048, head dims above 128).

``fused_transformer_block`` keeps the JAX signature and takes every shape the
JAX function takes. For CPU tensors it runs the plain version. For CUDA
tensors it runs the kernels through ``_FusedBlock`` (a
``torch.autograd.Function``: kernel forward; the backward differentiates
``fused_block_reference`` at the saved inputs, as the JAX ``custom_vjp``
does — there is no backward kernel in either package. It materializes
float32 ``[B, H, T, T]`` scores for the time of the backward), or raises,
before any launch, on a shape neither design takes. There is no other
fallback. Both designs take any T and B <= 65535.

The plain versions follow the entries (``fused_block_kv_plain`` /
``fused_block_q_plain``, ``fused_block_qkv_plain`` / ``fused_block_attn_plain``;
``fused_block_plain`` is the whole op). They are the kernels' arithmetic in
PyTorch (they round where the kernels round: the qkv bias is added in float32
before the one cast, and ``x + out + b_proj`` is summed in float32 and cast
once), except that they normalize each softmax row before casting the
probabilities where the kernels cast ``exp(s - running max)`` and divide the
head's context by the row sum afterwards. ``fused_block_reference`` is the JAX
package's oracle as it stands (the unfused model's rounding: cast, then add the
bias in x's dtype; three roundings around the residual). Launch functions count
their launches in ``<function>.launches``; ``fused_transformer_block.launches``
counts one per call that reached the kernels and ``.tc_launches`` those that
took the tensor-core design.
"""

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

MASK_VALUE = -1e9   # the model's dense causal mask value, applied by a select
MAX_HEAD_DIM = 128     # the CUDA-core design's widest head (DP 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ATOM = 64 * 128       # a [64 rows, 64 columns] 16-bit tile of the tensor-core design
_SMEM_MAX = 232448     # dynamic shared memory a CTA may use (227 KB)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _layer_norm_f32(x, ln_scale, ln_bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return (xf - mean) * torch.rsqrt(var + eps) * ln_scale + ln_bias


def _heads(t, n_head):
    B, T, E = t.shape
    return t.reshape(B, T, n_head, E // n_head).transpose(1, 2)


def _probs(q, k, causal, sm_scale):
    """float32 softmax of the scaled (causally masked) scores of ``[B, H, T, D]``
    q and k; the products accumulate in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full((), MASK_VALUE, device=s.device))
    return torch.softmax(s, dim=-1)


def fused_block_reference(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                          n_head: int, causal: bool = True,
                          sm_scale: Optional[float] = None, eps: float = 1e-5):
    """The JAX package's oracle in PyTorch: the unfused model's LayerNorm,
    dense attention and residual add, rounding where that path rounds.
    Differentiable by autograd; the kernel path's backward is
    ``torch.autograd.grad`` of this function."""
    dt = x.dtype
    E = x.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(E // n_head)
    h = _layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    qkv = torch.matmul(h, w_qkv.to(dt)) + b_qkv.to(dt)
    q, k, v = (_heads(t, n_head) for t in qkv.split(E, dim=-1))
    p = _probs(q, k, causal, sm_scale).to(dt)
    y = torch.matmul(p.float(), v.float()).to(dt)
    y = y.transpose(1, 2).reshape(x.shape)
    out = torch.matmul(y, w_proj.to(dt))
    return x + (out + b_proj.to(dt))


def _qkv(x, ln_scale, ln_bias, w, b, eps):
    """LayerNorm cast to x's dtype, times the weight columns ``w``: the
    product accumulates in float32, the bias is added in float32, one cast."""
    dt = x.dtype
    h = _layer_norm_f32(x, ln_scale.float(), ln_bias.float(), eps).to(dt)
    return (torch.matmul(h.float(), w.to(dt).float()) + b.float()).to(dt)


def _attend_project(x, q, k, v, w_proj, b_proj, causal, sm_scale):
    """Attention of ``[B, H, T, D]`` q, k, v (probabilities and each head's
    context cast to x's dtype), then ``x + y w_proj + b_proj`` in float32, one
    cast."""
    dt = x.dtype
    p = _probs(q, k, causal, sm_scale).to(dt)
    y = torch.matmul(p.float(), v.float()).to(dt).transpose(1, 2).reshape(x.shape)
    out = torch.matmul(y.float(), w_proj.to(dt).float())
    return (x.float() + out + b_proj.float()).to(dt)


def _default_scale(E, n_head, sm_scale):
    return 1.0 / math.sqrt(E // n_head) if sm_scale is None else sm_scale


def fused_block_kv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=1e-5):
    """Plain version of ``fused_block_kv``: the ``[2, B, T, E]`` workspace."""
    E = x.shape[-1]
    return torch.stack(_qkv(x, ln_scale, ln_bias, w_qkv[:, E:], b_qkv[E:], eps).split(E, dim=-1))


def fused_block_q_plain(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                        n_head, causal=True, sm_scale=None, eps=1e-5):
    """Plain version of ``fused_block_q`` over the workspace ``ws``."""
    E = x.shape[-1]
    q = _qkv(x, ln_scale, ln_bias, w_qkv[:, :E], b_qkv[:E], eps)
    return _attend_project(x, _heads(q, n_head), _heads(ws[0], n_head), _heads(ws[1], n_head),
                           w_proj, b_proj, causal, _default_scale(E, n_head, sm_scale))


def fused_block_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, n_head, eps=1e-5):
    """Plain version of ``fused_block_qkv_tc``: the head-major ``[3, B, H, T,
    D]`` workspace of q, k and v."""
    B, T, E = x.shape
    qkv = _qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return qkv.reshape(B, T, 3, n_head, E // n_head).permute(2, 0, 3, 1, 4).contiguous()


def fused_block_attn_plain(x, ws, w_proj, b_proj, n_head, causal=True, sm_scale=None):
    """Plain version of ``fused_block_attn_tc`` over the workspace ``ws``."""
    return _attend_project(x, ws[0], ws[1], ws[2], w_proj, b_proj, causal,
                           _default_scale(x.shape[-1], n_head, sm_scale))


def fused_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, n_head,
                      causal=True, sm_scale=None, eps=1e-5):
    """Plain PyTorch version of the whole op (either design's two entries
    together); runs on any device. The wrapper uses it for CPU tensors, and
    ``chip_smoke.py`` holds the kernels against it on the card."""
    ws = fused_block_qkv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, n_head, eps)
    return fused_block_attn_plain(x, ws, w_proj, b_proj, n_head, causal, sm_scale)


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorCorePlan:
    """Geometry of the tensor-core design's two launches. Each CTA holds a
    ``[64, E]`` tile of rows in shared memory (in the second entry the two
    CTAs of a cluster share a q tile's rows) and runs ``*_wg`` consumer
    warpgroups, each with a producer warp and a ring of TMA stages:
    ``qkv_stages`` weight tiles ``[64, nc]`` in the first entry;
    ``kv_stages`` K and V tiles, then ``proj_stages`` weight tiles in the
    same ring, in the second. ``nc`` is the ``wgmma`` N of the weight
    products: 128, or 64 where E is not a multiple of 128."""
    nc: int
    qkv_wg: int
    qkv_stages: int
    attn_wg: int
    kv_stages: int
    proj_stages: int


def _qkv_smem(E, nc, wg, stages):
    """Shared memory of ``fused_block_qkv_tc``: the row tile, the rings, their
    barriers and the row tile's, and 1 KB to align the tiles
    (``csrc/fused_block_tc.cu`` ``qkv_smem``)."""
    return (1024 + E // 64 * _ATOM + wg * stages * (nc // 64) * _ATOM
            + (wg * 2 * stages + 1) * 8)


def _attn_smem(E, D, wg, kv_stages, proj_stages):
    """Shared memory of ``fused_block_attn_tc``: the context tile, a q tile
    per warpgroup unless D is a multiple of 64 (q then lands in its head's
    columns of the context tile), the rings, their barriers and the two of
    the exchange between the cluster's CTAs, alignment (``attn_smem``)."""
    tiles = 1 if D <= 64 else 2
    q = 0 if D % 64 == 0 else wg * tiles * _ATOM
    return (1024 + E // 64 * _ATOM + q + wg * kv_stages * 2 * tiles * _ATOM
            + (wg * (2 * kv_stages + 2 * proj_stages + 2) + 2) * 8)


@functools.lru_cache(maxsize=64)
def tensor_core_plan(E: int, D: int) -> Optional[TensorCorePlan]:
    """The tensor-core design's geometry for width E and head dim D, or None
    where the design does not take them: E a multiple of 64 (the row tile is
    ``[64, 64]`` atoms), D <= 128 a multiple of 8 (TMA rows of 16 bytes, one
    or two atoms a head), and a row tile plus the smallest rings within a
    CTA's shared memory. Two warpgroups where each gets at least two stages,
    else one; at most 4 stages a ring (8 for the projection), and at least
    two for the weights. GPT-2 124M (E 768, D 64): two warpgroups, 4 stages
    in both entries; GPT-2 1.5B (E 1600, D 64): one warpgroup, 3 weight
    stages in the first entry, one K/V stage and 2 weight stages in the
    second."""
    if E < 64 or E % 64 or D < 8 or D % 8 or D > 128 or E % D:
        return None
    nc = 128 if E % 128 == 0 else 64
    tile = 1 if D <= 64 else 2      # atoms a K or V tile

    def proj_stages(kv_stages):     # the weight tiles that fit the K/V ring, at most 8
        return min(8, kv_stages * 2 * tile * 64 // nc)

    def fits(smem, ok):
        for wg in (2, 1):
            for st in (4, 3, 2, 1):
                if (wg == 1 or st >= 2) and ok(st) and smem(wg, st) <= _SMEM_MAX:
                    return wg, st
        return None

    # a weight ring keeps one wgmma group in flight and releases the stage
    # before it: two stages at least
    qkv = fits(lambda wg, st: _qkv_smem(E, nc, wg, st), lambda st: st >= 2)
    attn = fits(lambda wg, st: _attn_smem(E, D, wg, st, proj_stages(st)),
                lambda st: proj_stages(st) >= 2)
    if qkv is None or attn is None:
        return None
    return TensorCorePlan(nc, *qkv, *attn, proj_stages(attn[1]))


@dataclass(frozen=True)
class CudaCorePlan:
    """Geometry of the CUDA-core design's two launches: ``rows`` of x a CTA
    (32 or 16) and the head dim padded to ``dp`` (16, 32, 64 or 128)."""
    rows: int
    dp: int


_STAGE_BYTES = 4 * 32 * 128     # the CUDA-core design's float weight stage


def _cuda_core_q_smem(E, itemsize, rows, dp):
    """Shared memory of ``fused_block_q`` (``csrc/fused_block.cu``
    ``smem_q``): two ``[rows, E]`` buffers of x's dtype, the second shared
    with the weight stage or the float attention tiles (q ``rows x dp``, k
    and v ``64 x dp`` padded to ``dp + 1``, p ``rows x 64`` padded to 65),
    whichever is larger. The K/V entry needs less (one buffer and the
    stage)."""
    row_bytes = itemsize * rows * E
    tiles = 4 * ((rows + 128) * (dp + 1) + rows * 65)
    return row_bytes + max(row_bytes + _STAGE_BYTES, tiles)


@functools.lru_cache(maxsize=64)
def cuda_core_plan(E: int, D: int, itemsize: int) -> Optional[CudaCorePlan]:
    """The CUDA-core design's geometry for width E, head dim D and x's
    element size, or None where it does not take them: D <= 128, and the q
    entry within a CTA's shared memory at 32 rows, else at 16. float32 E 768:
    32 rows; float32 E 1024 (16 heads of 64, or 8 of 128) and bf16 E 2048:
    16 rows; float32 E 2048: None."""
    if E < 1 or D < 1 or D > MAX_HEAD_DIM:
        return None
    dp = next(p for p in (16, 32, 64, 128) if D <= p)
    for rows in (32, 16):
        if _cuda_core_q_smem(E, itemsize, rows, dp) <= _SMEM_MAX:
            return CudaCorePlan(rows, dp)
    return None


def tensor_core_design(dtype, E, n_head) -> bool:
    """The shape rule between the two designs: 16-bit x (what ``wgmma``
    multiplies) at a width and head dim that ``tensor_core_plan`` takes.
    Everything else takes the CUDA-core design, within ``check_limits``."""
    return (dtype in (torch.bfloat16, torch.float16) and n_head >= 1 and E % n_head == 0
            and tensor_core_plan(E, E // n_head) is not None)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("fused_block")
    if lib.fused_block_kv.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_block_kv.argtypes = [vp] * 6 + [i32, i32, i32, f32, i32, i32, vp]
        lib.fused_block_q.argtypes = [vp] * 9 + [i32, i32, i32, i32, f32, f32, i32, i32, i32,
                                                 vp]
        for fn in (lib.fused_block_kv, lib.fused_block_q):
            fn.restype = ctypes.c_int
    return lib


def _lib_tc():
    lib = _build.load("fused_block_tc")
    if lib.fused_block_qkv_tc.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_block_qkv_tc.argtypes = [vp] * 6 + [i32] * 4 + [f32] + [i32] * 4 + [vp]
        lib.fused_block_attn_tc.argtypes = [vp] * 5 + [i32] * 4 + [f32] + [i32] * 6 + [vp]
        for fn in (lib.fused_block_qkv_tc, lib.fused_block_attn_tc):
            fn.restype = ctypes.c_int
    return lib


def check_limits(x, n_head=None):
    """The CUDA-core design's plan for x (``cuda_core_plan``), or raise on an
    x it does not take, naming the limit. Without ``n_head``, the plan of the
    K/V entry, whose row tile the q entry's head dim does not change: the
    plan at head dim 1."""
    _check_x(x)
    E = x.shape[-1]
    if n_head is not None:
        _check_heads(E, n_head)
        D = E // n_head
        if D > MAX_HEAD_DIM:
            raise ValueError(
                f"the fused-block kernels take a head dim <= {MAX_HEAD_DIM} on the CUDA cores, "
                f"got {D}; keep this shape on the unfused path")
    plan = cuda_core_plan(E, 1 if n_head is None else E // n_head, x.element_size())
    if plan is None:
        raise ValueError(
            f"the fused-block kernels' CUDA-core design needs two [16, E] row buffers of "
            f"{x.dtype} and the attention tiles within a CTA's 227 KB of shared memory, "
            f"which E {E} exceeds; the tensor-core design takes bfloat16/float16 at E a "
            "multiple of 64 up to its shared memory (tensor_core_plan): keep this width on "
            "the unfused path")
    return plan


def _check_x(x):
    """What every path needs of x: ``[B, T, E]`` in one of the three dtypes,
    1 <= B <= 65535 (the kernels' grid), T >= 1."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {tuple(_DTYPES)}, got {x.dtype}")
    B, T, _ = x.shape
    if B < 1 or T < 1 or B > 65535:
        raise ValueError(f"the fused block takes 1 <= B <= 65535 and T >= 1, got B {B}, T {T}")


def _check_heads(E, n_head):
    if n_head < 1 or E % n_head:
        raise ValueError(f"n_embd {E} must divide by n_head {n_head}")


def _tc_plan(x, n_head):
    """The tensor-core design's plan for x, or raise."""
    _check_x(x)
    _check_heads(x.shape[-1], n_head)
    if not tensor_core_design(x.dtype, x.shape[-1], n_head):
        raise ValueError(
            f"the tensor-core fused-block design takes bfloat16/float16 x, E a multiple of 64 "
            f"and a head dim <= 128 a multiple of 8 within its shared memory "
            f"(tensor_core_plan); got {x.dtype}, E {x.shape[-1]}, {n_head} heads")
    return tensor_core_plan(x.shape[-1], x.shape[-1] // n_head)


def _check_operands(x, **named):
    """Each named (tensor, dtype, shape) contiguous on x's card."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, (t, dtype, shape) in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device {x.device}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(**named):
    """The tensor-core entries' TMA operands start on 16 bytes."""
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the tensor-core "
                             "entries")


def _aligned16(t):
    """t, or a copy of it that starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_block_kv(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-5):
    """Launch ``fused_block_kv``: the ``[2, B, T, E]`` K/V workspace in x's
    dtype. ``w_qkv`` ``[E, 3E]`` in x's dtype; ``ln_scale``, ``ln_bias`` ``[E]``
    and ``b_qkv`` ``[3E]`` float32; all contiguous on x's card. Its row tile
    is its own plan's (``check_limits`` without heads)."""
    rows = check_limits(x).rows
    B, T, E = x.shape
    f32 = torch.float32
    _check_operands(x, ln_scale=(ln_scale, f32, (E,)), ln_bias=(ln_bias, f32, (E,)),
                    w_qkv=(w_qkv, x.dtype, (E, 3 * E)), b_qkv=(b_qkv, f32, (3 * E,)))
    lib = _lib()
    ws = torch.empty((2, B, T, E), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_block_kv(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                                 w_qkv.data_ptr(), b_qkv.data_ptr(), ws.data_ptr(),
                                 B, T, E, float(eps), rows, _DTYPES[x.dtype],
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_kv kernel launch failed: cudaError {err}")
    fused_block_kv.launches += 1
    return ws


def fused_block_q(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, *, n_head,
                  causal=True, sm_scale=None, eps=1e-5):
    """Launch ``fused_block_q``: the block's output in x's dtype, from x and
    the workspace ``fused_block_kv`` wrote for it. ``w_proj`` ``[E, E]`` in
    x's dtype, ``b_proj`` ``[E]`` float32."""
    rows = check_limits(x, n_head).rows
    B, T, E = x.shape
    f32 = torch.float32
    _check_operands(x, ws=(ws, x.dtype, (2, B, T, E)),
                    ln_scale=(ln_scale, f32, (E,)), ln_bias=(ln_bias, f32, (E,)),
                    w_qkv=(w_qkv, x.dtype, (E, 3 * E)), b_qkv=(b_qkv, f32, (3 * E,)),
                    w_proj=(w_proj, x.dtype, (E, E)), b_proj=(b_proj, f32, (E,)))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(E // n_head)
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.fused_block_q(x.data_ptr(), ws.data_ptr(), ln_scale.data_ptr(),
                                ln_bias.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
                                w_proj.data_ptr(), b_proj.data_ptr(), out.data_ptr(),
                                B, T, E, int(n_head), float(sm_scale), float(eps),
                                int(bool(causal)), rows, _DTYPES[x.dtype],
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_q kernel launch failed: cudaError {err}")
    fused_block_q.launches += 1
    return out


def fused_block_qkv_tc(x, ln_scale, ln_bias, w_qkv, b_qkv, *, n_head, eps=1e-5):
    """Launch ``fused_block_qkv_tc``: the head-major ``[3, B, H, T, D]``
    workspace of q, k and v in x's dtype. Operands as ``fused_block_kv``'s;
    x bfloat16 or float16 at a shape ``tensor_core_plan`` takes."""
    plan = _tc_plan(x, n_head)
    B, T, E = x.shape
    f32 = torch.float32
    _check_operands(x, ln_scale=(ln_scale, f32, (E,)), ln_bias=(ln_bias, f32, (E,)),
                    w_qkv=(w_qkv, x.dtype, (E, 3 * E)), b_qkv=(b_qkv, f32, (3 * E,)))
    _check_aligned(x=x, w_qkv=w_qkv)
    lib = _lib_tc()
    ws = torch.empty((3, B, n_head, T, E // n_head), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_block_qkv_tc(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                                     w_qkv.data_ptr(), b_qkv.data_ptr(), ws.data_ptr(), B, T, E,
                                     int(n_head), float(eps), plan.nc, plan.qkv_wg,
                                     plan.qkv_stages, _DTYPES[x.dtype],
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_qkv_tc kernel launch failed: cudaError {err}")
    fused_block_qkv_tc.launches += 1
    return ws


def fused_block_attn_tc(x, ws, w_proj, b_proj, *, n_head, causal=True, sm_scale=None):
    """Launch ``fused_block_attn_tc``: the block's output in x's dtype, from x
    and the workspace ``fused_block_qkv_tc`` wrote for it."""
    plan = _tc_plan(x, n_head)
    B, T, E = x.shape
    _check_operands(x, ws=(ws, x.dtype, (3, B, n_head, T, E // n_head)),
                    w_proj=(w_proj, x.dtype, (E, E)), b_proj=(b_proj, torch.float32, (E,)))
    _check_aligned(x=x, ws=ws, w_proj=w_proj)
    lib = _lib_tc()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.fused_block_attn_tc(ws.data_ptr(), x.data_ptr(), w_proj.data_ptr(),
                                      b_proj.data_ptr(), out.data_ptr(), B, T, E, int(n_head),
                                      float(_default_scale(E, n_head, sm_scale)),
                                      int(bool(causal)), plan.nc, plan.attn_wg, plan.kv_stages,
                                      plan.proj_stages, _DTYPES[x.dtype],
                                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_attn_tc kernel launch failed: cudaError {err}")
    fused_block_attn_tc.launches += 1
    return out


fused_block_kv.launches = 0
fused_block_q.launches = 0
fused_block_qkv_tc.launches = 0
fused_block_attn_tc.launches = 0


# The four launches as dispatcher ops, so that the flop counter sees them
# (utils/flops_profiler.py).
@torch.library.custom_op("deepspeed_tpu_torch::fused_block_qkv_tc", mutates_args=())
def _qkv_tc_op(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
               w_qkv: torch.Tensor, b_qkv: torch.Tensor, n_head: int,
               eps: float) -> torch.Tensor:
    return fused_block_qkv_tc(x, ln_scale, ln_bias, w_qkv, b_qkv, n_head=n_head, eps=eps)


@_qkv_tc_op.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, n_head, eps):
    B, T, E = x.shape
    return x.new_empty((3, B, n_head, T, E // n_head))


@torch.library.custom_op("deepspeed_tpu_torch::fused_block_attn_tc", mutates_args=())
def _attn_tc_op(x: torch.Tensor, ws: torch.Tensor, w_proj: torch.Tensor,
                b_proj: torch.Tensor, n_head: int, causal: bool,
                sm_scale: float) -> torch.Tensor:
    return fused_block_attn_tc(x, ws, w_proj, b_proj, n_head=n_head, causal=causal,
                               sm_scale=sm_scale)


@_attn_tc_op.register_fake
def _(x, ws, w_proj, b_proj, n_head, causal, sm_scale):
    return torch.empty_like(x)


@torch.library.custom_op("deepspeed_tpu_torch::fused_block_kv", mutates_args=())
def _kv_op(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
           w_qkv: torch.Tensor, b_qkv: torch.Tensor, eps: float) -> torch.Tensor:
    return fused_block_kv(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)


@_kv_op.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    return x.new_empty((2, *x.shape))


@torch.library.custom_op("deepspeed_tpu_torch::fused_block_q", mutates_args=())
def _q_op(x: torch.Tensor, ws: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
          w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
          b_proj: torch.Tensor, n_head: int, causal: bool, sm_scale: float,
          eps: float) -> torch.Tensor:
    return fused_block_q(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                         n_head=n_head, causal=causal, sm_scale=sm_scale, eps=eps)


@_q_op.register_fake
def _(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, n_head, causal, sm_scale, eps):
    return torch.empty_like(x)


def _reference_backward(ctx, g):
    """Gradients of ``fused_block_reference`` at the saved inputs, for the
    inputs that need one."""
    n_head, causal, sm_scale, eps = ctx.static
    needs = ctx.needs_input_grad[:7]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        ref = fused_block_reference(*inputs, n_head, causal, sm_scale, eps)
        wanted = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(ref, wanted, g))
    return (*(next(grads) if n else None for n in needs), None, None, None, None)


class _FusedBlock(torch.autograd.Function):
    """Kernel forward over the operands cast as the TPU launcher casts them
    (weights to x's dtype, LayerNorm parameters and biases to float32), in
    the design the shape rule picks, each launch through its dispatcher op;
    backward by autograd of
    ``fused_block_reference`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                n_head, causal, sm_scale, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj)
        ctx.static = (n_head, causal, sm_scale, eps)
        xc = x.contiguous()
        scale, bias, bq, bp = (t.float().contiguous() for t in (ln_scale, ln_bias, b_qkv, b_proj))
        wq, wp = (t.to(x.dtype).contiguous() for t in (w_qkv, w_proj))
        if tensor_core_design(x.dtype, x.shape[-1], n_head):
            xc, wq, wp = (_aligned16(t) for t in (xc, wq, wp))
            ws = _qkv_tc_op(xc, scale, bias, wq, bq, n_head, eps)
            out = _attn_tc_op(xc, ws, wp, bp, n_head, causal, sm_scale)
            fused_transformer_block.tc_launches += 1
        else:
            ws = _kv_op(xc, scale, bias, wq, bq, eps)
            out = _q_op(xc, ws, scale, bias, wq, bq, wp, bp, n_head, causal, sm_scale, eps)
        fused_transformer_block.launches += 1
        return out

    backward = staticmethod(_reference_backward)


class _PlainBlock(torch.autograd.Function):
    """The CPU path keeps the kernel path's contract: the forward values of
    the plain version, the gradients of ``fused_block_reference``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                n_head, causal, sm_scale, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj)
        ctx.static = (n_head, causal, sm_scale, eps)
        return fused_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                                 n_head, causal, sm_scale, eps)

    backward = staticmethod(_reference_backward)


def fused_transformer_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                            n_head: int, causal: bool = True,
                            sm_scale: Optional[float] = None, eps: float = 1e-5,
                            block_q: Optional[int] = None,
                            interpret: Optional[bool] = None):
    """``x + proj(attention(qkv(layernorm(x))))``, differentiable in all
    seven tensor arguments.

    ``x`` ``[B, T, E]``; ``ln_scale``, ``ln_bias`` ``[E]``; ``w_qkv``
    ``[E, 3E]`` (the fused ``[q | k | v]`` layout, GPT-2's ``c_attn_w``);
    ``b_qkv`` ``[3E]``; ``w_proj`` ``[E, E]``; ``b_proj`` ``[E]``. No
    attention dropout. ``block_q`` and ``interpret`` are accepted for the JAX
    signature and ignored: the kernels choose their own tiles and take any T,
    and CPU tensors always take the plain version. CUDA tensors launch the
    kernels of the design ``tensor_core_design`` picks, or raise, before any
    launch, on a shape neither design takes."""
    _check_x(x)
    B, T, E = x.shape
    _check_heads(E, n_head)
    for name, t, shape in (("ln_scale", ln_scale, (E,)), ("ln_bias", ln_bias, (E,)),
                           ("w_qkv", w_qkv, (E, 3 * E)), ("b_qkv", b_qkv, (3 * E,)),
                           ("w_proj", w_proj, (E, E)), ("b_proj", b_proj, (E,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device {x.device}, got {t.device}")
    static = (int(n_head), bool(causal), float(_default_scale(E, n_head, sm_scale)), float(eps))
    if x.device.type == "cpu":
        return _PlainBlock.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, *static)
    if x.device.type != "cuda":
        raise ValueError(f"the fused block runs on cuda or cpu, not {x.device}")
    if not tensor_core_design(x.dtype, E, n_head):
        check_limits(x, n_head)
    return _FusedBlock.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, *static)


fused_transformer_block.launches = 0
fused_transformer_block.tc_launches = 0
