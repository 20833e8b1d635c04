"""Fused attention half of a transformer block: the CUDA kernels' wrappers,
their autograd, and the plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_block.py``:
``x + proj(attention(qkv(layernorm(x))))`` without the normalized hidden
states, q, the scores, the probabilities or the pre-residual output reaching
device memory. The TPU kernel ``_fused_block_kernel`` is replaced by the two
entries of ``csrc/fused_block.cu``: ``fused_block_kv`` (LayerNorm + the k and
v thirds of the qkv product into a ``[2, B, T, E]`` workspace of x's dtype)
and ``fused_block_q`` (LayerNorm + the q third, attention over the workspace,
the projection, the bias and the residual).

``fused_transformer_block`` keeps the JAX signature. For CUDA tensors it runs
the kernels through ``_FusedBlock`` (a ``torch.autograd.Function``: kernel
forward; the backward differentiates ``fused_block_reference`` at the saved
inputs, as the JAX ``custom_vjp`` does — there is no backward kernel in
either package. It materializes float32 ``[B, H, T, T]`` scores for the time of
the backward). For CPU tensors it runs the plain version. There is no other
fallback: outside the kernels' limits it raises.

Limits of the kernels (checked before any launch): x ``[B, T, E]`` in
float32, bfloat16 or float16, contiguous, on one card; any T; ``E`` divisible
by ``n_head``; ``E * itemsize <= 3072`` (E <= 1536 in bfloat16/float16,
E <= 768 in float32: two ``[32, E]`` buffers of x's dtype share a CTA's shared
memory); head dim ``E / n_head <= 64``; B <= 65535.

``fused_block_plain`` is the kernels' arithmetic in PyTorch (it rounds where
the kernels round: the qkv bias is added in float32 before the one cast, and
``x + out + b_proj`` is summed in float32 and cast once), except that it
normalizes each softmax row before casting the probabilities where the
kernel casts ``exp(s - running max)`` and divides the head's context by the
row sum afterwards. ``fused_block_reference`` is the JAX package's oracle as
it stands (the unfused model's rounding: cast, then add the bias in x's
dtype; three roundings around the residual). Launch functions count their
launches in ``<function>.launches``; ``fused_transformer_block.launches``
counts one per call that reached the kernels.
"""

import ctypes
import math
from typing import Optional

import torch

from . import _build

MASK_VALUE = -1e9   # the model's dense causal mask value, applied by a select
MAX_ROW_BYTES = 3072
MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def fused_block_kv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=1e-5):
    """Plain version of ``fused_block_kv``: the ``[2, B, T, E]`` workspace."""
    dt = x.dtype
    E = x.shape[-1]
    h = _layer_norm_f32(x, ln_scale.float(), ln_bias.float(), eps).to(dt)
    kv = (torch.matmul(h.float(), w_qkv[:, E:].to(dt).float()) + b_qkv[E:].float()).to(dt)
    return torch.stack(kv.split(E, dim=-1))


def fused_block_q_plain(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                        n_head, causal=True, sm_scale=None, eps=1e-5):
    """Plain version of ``fused_block_q`` over the workspace ``ws``."""
    dt = x.dtype
    E = x.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(E // n_head)
    h = _layer_norm_f32(x, ln_scale.float(), ln_bias.float(), eps).to(dt)
    q = (torch.matmul(h.float(), w_qkv[:, :E].to(dt).float()) + b_qkv[:E].float()).to(dt)
    q, k, v = _heads(q, n_head), _heads(ws[0], n_head), _heads(ws[1], n_head)
    p = _probs(q, k, causal, sm_scale).to(dt)
    y = torch.matmul(p.float(), v.float()).to(dt)
    y = y.transpose(1, 2).reshape(x.shape)
    out = torch.matmul(y.float(), w_proj.to(dt).float())
    return (x.float() + out + b_proj.float()).to(dt)


def fused_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, n_head,
                      causal=True, sm_scale=None, eps=1e-5):
    """Plain PyTorch version of the two kernels together; runs on any
    device. The wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds
    the kernels against it on the card."""
    ws = fused_block_kv_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, eps)
    return fused_block_q_plain(x, ws, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                               n_head, causal, sm_scale, eps)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("fused_block")
    if lib.fused_block_kv.argtypes is None:
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_block_kv.argtypes = [vp] * 6 + [i32, i32, i32, f32, i32, vp]
        lib.fused_block_q.argtypes = [vp] * 9 + [i32, i32, i32, i32, f32, f32, i32, i32, vp]
        for fn in (lib.fused_block_kv, lib.fused_block_q):
            fn.restype = ctypes.c_int
    return lib


def check_limits(x, n_head=None):
    """Raise on an x the kernels do not take (see the module docstring);
    without ``n_head``, on what the K/V entry does not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, E], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be one of {tuple(_DTYPES)}, got {x.dtype}")
    B, T, E = x.shape
    if B < 1 or T < 1 or B > 65535:
        raise ValueError(f"the fused-block kernels take 1 <= B <= 65535 and T >= 1, "
                         f"got B {B}, T {T}")
    if E * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(
            f"the fused-block kernels take E * itemsize <= {MAX_ROW_BYTES} bytes "
            f"(E <= {MAX_ROW_BYTES // x.element_size()} in {x.dtype}), got E {E}: "
            "keep this width on the unfused path")
    if n_head is None:
        return
    if n_head < 1 or E % n_head:
        raise ValueError(f"n_embd {E} must divide by n_head {n_head}")
    if E // n_head > MAX_HEAD_DIM:
        raise ValueError(f"the fused-block kernels take a head dim <= {MAX_HEAD_DIM}, "
                         f"got {E // n_head}")


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


def fused_block_kv(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps=1e-5):
    """Launch ``fused_block_kv``: the ``[2, B, T, E]`` K/V workspace in x's
    dtype. ``w_qkv`` ``[E, 3E]`` in x's dtype; ``ln_scale``, ``ln_bias`` ``[E]``
    and ``b_qkv`` ``[3E]`` float32; all contiguous on x's card."""
    check_limits(x)
    B, T, E = x.shape
    f32 = torch.float32
    _check_operands(x, ln_scale=(ln_scale, f32, (E,)), ln_bias=(ln_bias, f32, (E,)),
                    w_qkv=(w_qkv, x.dtype, (E, 3 * E)), b_qkv=(b_qkv, f32, (3 * E,)))
    lib = _lib()
    ws = torch.empty((2, B, T, E), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_block_kv(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                                 w_qkv.data_ptr(), b_qkv.data_ptr(), ws.data_ptr(),
                                 B, T, E, float(eps), _DTYPES[x.dtype],
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
    check_limits(x, n_head)
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
                                int(bool(causal)), _DTYPES[x.dtype],
                                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_q kernel launch failed: cudaError {err}")
    fused_block_q.launches += 1
    return out


fused_block_kv.launches = 0
fused_block_q.launches = 0


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
    (weights to x's dtype, LayerNorm parameters and biases to float32);
    backward by autograd of ``fused_block_reference`` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                n_head, causal, sm_scale, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj)
        ctx.static = (n_head, causal, sm_scale, eps)
        xc = x.contiguous()
        scale, bias, bq, bp = (t.float().contiguous() for t in (ln_scale, ln_bias, b_qkv, b_proj))
        wq, wp = (t.to(x.dtype).contiguous() for t in (w_qkv, w_proj))
        ws = fused_block_kv(xc, scale, bias, wq, bq, eps=eps)
        out = fused_block_q(xc, ws, scale, bias, wq, bq, wp, bp, n_head=n_head,
                            causal=causal, sm_scale=sm_scale, eps=eps)
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
    kernels, or raise outside their limits."""
    check_limits(x, n_head)
    B, T, E = x.shape
    for name, t, shape in (("ln_scale", ln_scale, (E,)), ("ln_bias", ln_bias, (E,)),
                           ("w_qkv", w_qkv, (E, 3 * E)), ("b_qkv", b_qkv, (3 * E,)),
                           ("w_proj", w_proj, (E, E)), ("b_proj", b_proj, (E,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device {x.device}, got {t.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(E // n_head)
    static = (int(n_head), bool(causal), float(sm_scale), float(eps))
    if x.device.type == "cpu":
        return _PlainBlock.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, *static)
    if x.device.type != "cuda":
        raise ValueError(f"the fused block runs on cuda or cpu, not {x.device}")
    return _FusedBlock.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, *static)


fused_transformer_block.launches = 0
