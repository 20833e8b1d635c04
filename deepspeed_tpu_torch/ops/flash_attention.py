"""Flash attention: the CUDA kernels' wrappers, their autograd, and the plain
versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. The kernels
are ``csrc/flash_attention.cu``: the forward (replaces the TPU kernel
``_fwd_kernel``), dq (``_bwd_dq_kernel``) and dk/dv (``_bwd_dkv_kernel``).
They take q, k, v ``[B, H, T, D]`` with one T, in float32, bfloat16 or
float16, any T, and an even D <= 256.

Each comes in two designs, chosen by shape alone (``_tensor_core_path``):
bfloat16/float16 with D <= 128 a multiple of 8 run the tensor-core kernels
(``flash_fwd_tc``, ``flash_bwd_dq_tc``, ``flash_bwd_dkv_tc``: TMA-fed
``wgmma`` tiles); float32 and the other head dims the CUDA-core kernels
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``). A failed build or
launch raises; nothing falls back.

``flash_attention`` and ``flash_attention_with_lse`` keep the JAX signatures.
For CUDA tensors they run the kernels through the custom op
``deepspeed_tpu_torch::flash_fwd`` (``FLASH_FWD_OP``: the forward kernel,
visible to the dispatcher, so that a selective-checkpoint policy can keep its
``(out, lse)``; its autograd saves ``(q, k, v, out, lse)``, forms
``delta = rowsum(dO * O) - g_lse`` with torch ops and launches the two
backward kernels through their ops ``deepspeed_tpu_torch::flash_bwd_dq`` and
``flash_bwd_dkv``, which the flop counter sees: utils/flops_profiler.py). For CPU tensors they run the plain version
(``flash_attention_reference``: dense float32 softmax, autograd for the
backward). There is no other fallback. Each launch function counts its
launches in ``<function>.launches`` (a plain integer; set it to 0 to start a
count), and those that ran the tensor-core design in
``<function>.tensor_core_launches``.

Global coordinates: every call places its local positions in the global
sequence, for the causal mask and the dropout hash. A side is contiguous at a
scalar offset (``dropout_q_offset`` / ``dropout_k_offset``), or two halves at
two offsets (``q_segments`` / ``k_segments``, the JAX package's segmented (7,)
seed operand ``[seed, q_off0, k_off0, q_half, q_off1, k_half, k_off1]``, which
the sequence-parallel ring's zigzag layout needs): local ``p < half`` maps to
``off0 + p``, the rest to ``off1 + p - half`` (``_global_positions``). The
kernels take the same map as four more integers (``Params`` in the source);
a contiguous side has its half boundary past every position
(``_NO_HALF``). Those that ran a segmented map count in
``<function>.segmented_launches``.

The TPU package's ``_RESIDENT_T_LIMIT`` / ``_flash_attention_chunked`` and
its v5e block table exist for the TPU's scoped VMEM: the CUDA kernels take
any T directly, so they are not carried over.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_M32 = 0xFFFFFFFF
# the half boundary of a contiguous side: past every position, so that the
# first segment's offset always applies
_NO_HALF = 2**31 - 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dense_attention(q, k, v, causal=False, sm_scale=None, bias=None, dropout_keep=None):
    """Dense attention on ``[B, H, T, D]`` with a float32 softmax; the
    probabilities are cast to q's dtype before the product with v.
    ``bias``: additive key bias ``[B, 1, T_k]``; ``dropout_keep``: a pre-scaled
    multiplicative mask on the probabilities (``dropout_keep_reference``)."""
    out, _ = _dense(q, k, v, causal, sm_scale, bias, dropout_keep,
                    torch.arange(q.shape[2], device=q.device),
                    torch.arange(k.shape[2], device=q.device))
    return out


def _segments(offset, segments, T):
    """``(off0, half, off1)`` of one side of a call: contiguous at ``offset``
    (``segments`` None), or the two halves of its T local positions at the
    global starts ``segments = (off0, off1)``, the first half ``T // 2`` long."""
    if segments is None:
        return int(offset), _NO_HALF, 0
    return int(segments[0]), T // 2, int(segments[1])


def _global_positions(T, seg, device=None):
    """The global coordinate of each of T local positions under the map
    ``seg = (off0, half, off1)``: ``off0 + p`` below ``half``, else
    ``off1 + p - half`` (int64)."""
    off0, half, off1 = seg
    p = torch.arange(T, dtype=torch.int64, device=device)
    return p + torch.where(p < half, off0, off1 - half)


def _dense(q, k, v, causal, sm_scale, bias, keep, qp, kp):
    """Dense attention with the causal mask in the global coordinates ``qp``
    and ``kp`` of the q and k positions."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        scores = scores + bias.float().reshape(bias.shape[0], 1, 1, -1)
    if causal:
        scores = torch.where(qp[:, None] >= kp[None, :], scores,
                             torch.full((), DEFAULT_MASK_VALUE, device=q.device))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = probs * keep.to(probs.dtype)
    out = torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)
    return out, lse


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _dropout_bits(seed_u32, bh_u32, q_pos, k_pos):
    """The TPU kernels' coordinate hash in int64 arithmetic masked to 32 bits
    (torch's uint32 ops are limited). Inputs broadcast; returns int64 values
    in [0, 2**32)."""
    x = (_mul32(q_pos & _M32, 0x9E3779B1) + _mul32(k_pos & _M32, 0x85EBCA77)
         + _mul32(bh_u32 & _M32, 0xC2B2AE3D) + (seed_u32 & _M32)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def _keep_mask(seed, B, H, T_q, T_k, rate, qp=None, kp=None, device=None):
    """The pre-scaled keep mask at the global coordinates ``qp`` / ``kp``
    (int64, default the local positions)."""
    if qp is None:
        qp = torch.arange(T_q, dtype=torch.int64, device=device)
    if kp is None:
        kp = torch.arange(T_k, dtype=torch.int64, device=device)
    bh = torch.arange(B * H, dtype=torch.int64, device=device)[:, None, None]
    bits = _dropout_bits(int(seed) & _M32, bh, qp[None, :, None], kp[None, None, :])
    keep = (bits >= _keep_threshold(rate)).to(torch.float32)
    return (keep / (1.0 - rate)).reshape(B, H, T_q, T_k)


def dropout_keep_reference(seed, B, H, T_q, T_k, rate: float, device=None):
    """``[B, H, T_q, T_k]`` pre-scaled keep mask, bit for bit the stream the
    kernels (and the TPU kernels) draw for this seed."""
    return _keep_mask(seed, B, H, T_q, T_k, rate, device=device)


def _merge_partial(o, lse, o_new, lse_new):
    """Online-softmax merge of normalized partials (float32 accumulator)."""
    lse_out = torch.logaddexp(lse, lse_new)
    o_out = (o * torch.exp(lse - lse_out)[..., None]
             + o_new.float() * torch.exp(lse_new - lse_out)[..., None])
    return o_out, lse_out


def flash_attention_reference(q, k, v, causal=False, sm_scale=None, bias=None,
                              dropout_rate=0.0, dropout_seed=None, q_offset=0,
                              k_offset=0, q_segments=None, k_segments=None):
    """Plain PyTorch version of the kernels: ``(out, lse)`` from dense
    attention with the keep mask of the same hash, ``lse`` the natural-log
    logsumexp of the scaled (biased, masked) scores; the mask and the hash in
    the global coordinates of ``*_offset`` / ``*_segments`` (module
    docstring). Differentiable by autograd in q, k, v; runs on any device.
    The wrappers use it for CPU tensors, and ``chip_smoke.py`` holds the
    kernels against it on the card."""
    qp = _global_positions(q.shape[2], _segments(q_offset, q_segments, q.shape[2]), q.device)
    kp = _global_positions(k.shape[2], _segments(k_offset, k_segments, k.shape[2]), q.device)
    keep = None
    if dropout_rate > 0:
        B, H, T, _ = q.shape
        keep = _keep_mask(dropout_seed, B, H, T, k.shape[2], dropout_rate, qp, kp,
                          device=q.device)
    if bias is not None:
        bias = bias.detach()
    return _dense(q, k, v, causal, sm_scale, bias, keep, qp, kp)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _tensor_core_path(dtype, D) -> bool:
    """The shape rule between the two designs of each kernel: 16-bit
    operands (what ``wgmma`` multiplies) and a head dim that fits one
    128-wide tile and gives TMA rows of a multiple of 16 bytes."""
    return dtype in (torch.bfloat16, torch.float16) and D <= 128 and D % 8 == 0


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        vp, i32, f32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
        tail = [i32, i32, i32, i32,          # BH H T D
                f32, f32, i32,               # sm_scale, op_scale, causal
                f32, u32, u32, i32, i32,     # rate, threshold, seed, q_off, k_off
                i32, i32, i32, i32,          # q_half, q_off1, k_half, k_off1
                i32, vp]                     # dtype, stream
        lib.flash_fwd.argtypes = lib.flash_fwd_tc.argtypes = [vp] * 6 + tail
        lib.flash_bwd_dq.argtypes = lib.flash_bwd_dq_tc.argtypes = [vp] * 8 + tail
        lib.flash_bwd_dkv.argtypes = lib.flash_bwd_dkv_tc.argtypes = [vp] * 9 + tail
        for fn in (lib.flash_fwd, lib.flash_fwd_tc, lib.flash_bwd_dq, lib.flash_bwd_dq_tc,
                   lib.flash_bwd_dkv, lib.flash_bwd_dkv_tc):
            fn.restype = ctypes.c_int
    return lib


def _check_launch(q, k, v, do=None, lse=None, delta=None, bias=None):
    """Raise on what the kernels do not take: q, k, v (and do) of one
    ``[B, H, T, D]`` shape and one dtype with an even D <= 256; lse and delta
    float32 ``[B, H, T]``; bias float32 ``[B, T]``; all contiguous on q's card."""
    if q.dim() != 4 or any(t is not None and t.shape != q.shape for t in (k, v, do)):
        raise ValueError(f"q, k, v, do must share one [B, H, T, D] shape, got "
                         f"{[tuple(t.shape) for t in (q, k, v, do) if t is not None]}")
    B, H, T, D = q.shape
    if D % 2 or D > 256:
        raise ValueError(f"the kernels take an even head_dim <= 256, got {D}")
    if q.dtype not in _DTYPES or any(t is not None and t.dtype != q.dtype
                                     for t in (k, v, do)):
        raise TypeError(f"q, k, v, do must share one dtype of {tuple(_DTYPES)}")
    for name, t, shape in (("lse", lse, (B, H, T)), ("delta", delta, (B, H, T)),
                           ("bias", bias, (B, T))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse),
                    ("delta", delta), ("bias", bias)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the second halves of a call with both sides contiguous
_CONTIGUOUS = (_NO_HALF, 0, _NO_HALF, 0)


def _tail(q, H, sm_scale, causal, rate, seed, q_off, k_off, halves=_CONTIGUOUS):
    """The entries' arguments after the pointers; ``halves`` is
    ``(q_half, q_off1, k_half, k_off1)`` (``_CONTIGUOUS``: no second half)."""
    BH, T, D = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    return (BH, H, T, D, sm_scale, sm_scale * LOG2E, int(bool(causal)), float(rate),
            _keep_threshold(rate) if rate > 0 else 0, int(seed or 0) & _M32,
            int(q_off), int(k_off), *(int(x) for x in halves), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(launcher, name, q, tensors, causal, sm_scale, rate, seed, q_off, k_off, halves):
    """Launch ``<name>_tc`` or ``<name>`` by the shape rule
    (``_tensor_core_path``) on the data pointers of ``tensors`` (None stays a
    null pointer), count it on ``launcher``, and raise if the launch failed."""
    tensor_cores = _tensor_core_path(q.dtype, q.shape[3])
    entry = getattr(_lib(), f"{name}_tc" if tensor_cores else name)
    with torch.cuda.device(q.device):
        err = entry(*(None if t is None else t.data_ptr() for t in tensors),
                    *_tail(q, q.shape[1], sm_scale, causal, rate, seed, q_off, k_off, halves))
    if err != 0:
        raise RuntimeError(f"{entry.__name__} kernel launch failed: cudaError {err}")
    launcher.launches += 1
    launcher.tensor_core_launches += tensor_cores
    launcher.segmented_launches += tuple(halves) != _CONTIGUOUS


def flash_attention_fwd(q, k, v, *, causal, sm_scale, bias=None, dropout_rate=0.0,
                        dropout_seed=None, q_offset=0, k_offset=0, halves=_CONTIGUOUS):
    """Launch ``flash_fwd_tc`` or ``flash_fwd`` by the shape rule
    (``_tensor_core_path``): returns ``(out, lse)``, out in q's dtype and lse
    float32 ``[B, H, T]`` (natural log). q, k, v contiguous ``[B, H, T, D]``
    on one card; bias contiguous float32 ``[B, T]`` or None; ``halves`` the
    second segments ``(q_half, q_off1, k_half, k_off1)`` of a segmented call."""
    _check_launch(q, k, v, bias=bias)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(flash_attention_fwd, "flash_fwd", q, (q, k, v, bias, out, lse), causal,
            sm_scale, dropout_rate, dropout_seed, q_offset, k_offset, halves)
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale, bias=None,
                           dropout_rate=0.0, dropout_seed=None, q_offset=0, k_offset=0,
                           halves=_CONTIGUOUS):
    """Launch ``flash_bwd_dq_tc`` or ``flash_bwd_dq`` by the shape rule:
    returns dq in q's dtype. ``do`` as q; ``lse`` and ``delta`` contiguous
    float32 ``[B, H, T]``."""
    _check_launch(q, k, v, do, lse, delta, bias)
    dq = torch.empty_like(q)
    _launch(flash_attention_bwd_dq, "flash_bwd_dq", q, (q, k, v, do, lse, delta, bias, dq),
            causal, sm_scale, dropout_rate, dropout_seed, q_offset, k_offset, halves)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale, bias=None,
                            dropout_rate=0.0, dropout_seed=None, q_offset=0, k_offset=0,
                            halves=_CONTIGUOUS):
    """Launch ``flash_bwd_dkv_tc`` or ``flash_bwd_dkv`` by the shape rule:
    returns ``(dk, dv)`` in k's dtype."""
    _check_launch(q, k, v, do, lse, delta, bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_attention_bwd_dkv, "flash_bwd_dkv", q,
            (q, k, v, do, lse, delta, bias, dk, dv), causal, sm_scale, dropout_rate,
            dropout_seed, q_offset, k_offset, halves)
    return dk, dv


for _f in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _f.launches = _f.tensor_core_launches = _f.segmented_launches = 0
del _f


@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor], causal: bool, sm_scale: float, rate: float,
                  seed: int, q_off: int, k_off: int, q_half: int = _NO_HALF, q_off1: int = 0,
                  k_half: int = _NO_HALF, k_off1: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel as an op the dispatcher sees, so that a
    selective-checkpoint policy can keep its (out, lse) instead of replaying
    it (runtime/activation_checkpointing/checkpointing.py). The last four
    integers are the second segments of a segmented call (their defaults: none)."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                               dropout_rate=rate, dropout_seed=seed, q_offset=q_off,
                               k_offset=k_off, halves=(q_half, q_off1, k_half, k_off1))


@_flash_fwd_op.register_fake
def _(q, k, v, bias, causal, sm_scale, rate, seed, q_off, k_off, *halves):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, bias, *kw = inputs
    ctx.save_for_backward(q, k, v, *output, bias)
    ctx.kw = tuple(kw)


@torch.library.custom_op("deepspeed_tpu_torch::flash_bwd_dq", mutates_args=())
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                     lse: torch.Tensor, delta: torch.Tensor, bias: Optional[torch.Tensor],
                     causal: bool, sm_scale: float, rate: float, seed: int, q_off: int,
                     k_off: int, q_half: int = _NO_HALF, q_off1: int = 0,
                     k_half: int = _NO_HALF, k_off1: int = 0) -> torch.Tensor:
    """The dq kernel as an op the dispatcher sees (the flop counter counts
    it: utils/flops_profiler.py)."""
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
                                  bias=bias, dropout_rate=rate, dropout_seed=seed,
                                  q_offset=q_off, k_offset=k_off,
                                  halves=(q_half, q_off1, k_half, k_off1))


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, bias, causal, sm_scale, rate, seed, q_off, k_off, *halves):
    return torch.empty_like(q)


@torch.library.custom_op("deepspeed_tpu_torch::flash_bwd_dkv", mutates_args=())
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor, bias: Optional[torch.Tensor],
                      causal: bool, sm_scale: float, rate: float, seed: int, q_off: int,
                      k_off: int, q_half: int = _NO_HALF, q_off1: int = 0,
                      k_half: int = _NO_HALF, k_off1: int = 0) -> Tuple[torch.Tensor,
                                                                       torch.Tensor]:
    """The dk/dv kernel as an op the dispatcher sees."""
    return flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
                                   bias=bias, dropout_rate=rate, dropout_seed=seed,
                                   q_offset=q_off, k_offset=k_off,
                                   halves=(q_half, q_off1, k_half, k_off1))


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, bias, causal, sm_scale, rate, seed, q_off, k_off, *halves):
    return torch.empty_like(k), torch.empty_like(v)


def _flash_backward(ctx, g_out, g_lse):
    """The two backward kernels, each through its op. Both outputs are
    differentiable: an lse cotangent folds into delta."""
    q, k, v, out, lse, bias = ctx.saved_tensors
    kw = ctx.kw
    do = torch.zeros_like(out) if g_out is None else g_out.contiguous()
    # delta = rowsum(dO * O): the softmax-normalization term; an lse
    # cotangent adds g_lse * p to dS, i.e. it subtracts from delta
    delta = (do.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    args = (q, k, v, do, lse, delta, bias, *kw)
    dq = _flash_bwd_dq_op(*args)
    dk, dv = _flash_bwd_dkv_op(*args)
    return (dq, dk, dv) + (None,) * (1 + len(kw))


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)
FLASH_FWD_OP = torch.ops.deepspeed_tpu_torch.flash_fwd.default


def _attend(q, k, v, causal, sm_scale, bias, rate, seed, q_off, k_off, q_seg=None,
            k_seg=None):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {tuple(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, T, D = q.shape
    if D % 2 or D > 256:
        raise ValueError(f"head_dim must be even and <= 256, got {D}")
    rate = float(rate)
    if rate > 0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    qmap, kmap = _segments(q_off, q_seg, T), _segments(k_off, k_seg, T)
    if causal and (q_seg is not None or k_seg is not None):
        # the kernels prune causal tiles in local coordinates: exact only
        # when both sides share one map that keeps the local order (the
        # zigzag ring's [chunk i, chunk 2n-1-i], JAX flash_attention.py:676-678)
        if qmap != kmap or qmap[0] + qmap[1] > qmap[2]:
            raise ValueError(
                f"causal segmented attention needs identical q and k segments with "
                f"off0 + T // 2 <= off1, got q {q_seg}, k {k_seg} at T {T}")
    elif causal and int(q_off) != int(k_off):
        # the JAX kernels mask such a call in local coordinates without
        # dropout and in global ones only inside their diagonal k-block band
        # with it, so no single answer exists to match (fault C1)
        raise ValueError(
            f"causal attention with unequal offsets (q {q_off}, k {k_off}) is not "
            "supported: the JAX kernels give no single answer there, and the "
            "sequence-parallel ring (ROADMAP.md item 14) never makes such a call")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if bias is not None:
        # a padding mask, never learned: no gradient (the JAX wrapper's
        # stop_gradient)
        bias = bias.detach().to(torch.float32).reshape(B, T).contiguous()
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, bias, rate, seed,
                                         q_off, k_off, q_seg, k_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return _flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(), bias, bool(causal),
                         float(sm_scale), rate, int(seed) if rate > 0 else 0, qmap[0], kmap[0],
                         qmap[1], qmap[2], kmap[1], kmap[2])


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None, block_k=None,
                    interpret=None, bias=None, dropout_rate=0.0, dropout_seed=None):
    """Flash attention on ``[B, H, T, D]`` tensors, differentiable in q, k, v.

    ``bias``: optional additive key bias, any shape that reshapes to
    ``[B, T]`` (the BERT padding mask ``[B, 1, 1, T]`` included); it gets no
    gradient. ``dropout_rate`` / ``dropout_seed``: attention dropout on the
    probabilities by the coordinate hash (``dropout_keep_reference`` gives
    the mask). ``block_q``, ``block_k`` and ``interpret`` are accepted for the
    JAX signature and ignored: the kernels choose their own tiles, and CPU
    tensors always take the plain version. CUDA tensors launch the kernels."""
    out, _ = _attend(q, k, v, causal, sm_scale, bias, dropout_rate, dropout_seed, 0, 0)
    return out


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None, block_q=None,
                             block_k=None, interpret=None, dropout_rate=0.0,
                             dropout_seed=None, dropout_q_offset=0, dropout_k_offset=0,
                             q_segments=None, k_segments=None):
    """``(out, lse)``, both differentiable; ``lse`` is the natural-log
    logsumexp of the scaled scores ``[B, H, T]``. ``dropout_*_offset`` place
    this call's positions in global coordinates (the dropout hash and the
    causal mask); a causal call must give equal offsets (else ``ValueError``,
    fault C1). ``q_segments`` / ``k_segments``: an ``(off0, off1)`` pair
    declares that side's local sequence two halves at those global starts
    (the zigzag ring's layout; it overrides that side's offset); a causal
    call needs both, identical, with ``off0 + T // 2 <= off1``, so that the
    kernels' local tile pruning stays exact (else ``ValueError``).
    ``block_q``, ``block_k`` and ``interpret`` are ignored, as in
    ``flash_attention``."""
    return _attend(q, k, v, causal, sm_scale, None, dropout_rate, dropout_seed,
                   dropout_q_offset, dropout_k_offset, q_segments, k_segments)
