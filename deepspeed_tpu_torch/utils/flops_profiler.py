"""Flops and bytes of a PyTorch program, the port's own kernels included
(PyTorch port of ``deepspeed_tpu/utils/flops_profiler.py``).

The JAX profiler reads XLA's cost analysis of a compiled program. Eager
PyTorch has none: this module counts what a call dispatches.

- **Flops** by ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
  scaled-dot-product attention) and every kernel entry of the port, each a
  dispatcher op (``deepspeed_tpu_torch::*``) with a formula registered here
  (``register_kernel_formulas``). A kernel launched through ``ctypes``
  outside an op would be invisible; none is. Elementwise work (LayerNorm,
  GELU, softmax, the optimizer) is not counted, where XLA counts it.
- **Bytes** by ``ByteCounterMode``, a dispatch mode: an op moves the bytes
  of its tensor inputs and outputs (each read or written once; a kernel
  op's operands and outputs are the bytes its launch must move), a view or
  an allocation moves none. The count is of the eager ops as dispatched,
  with no fusion, so it is an upper bound of what a fused program moves.

Kernel formulas (B: batch, H: heads, T: sequence, D: head dim, E: width):

- flash forward (``flash_fwd``): ``4·B·H·Tq·Tk·D``, as the flop counter
  counts scaled-dot-product attention's forward (two products);
- flash backward: torch's SDPA-backward convention, five products of
  ``2·B·H·T²·D``: the dk/dv kernel's four (the score recompute, dP, dV,
  dK; ``flash_bwd_dkv``) and the dq kernel's dQ (``flash_bwd_dq``, whose own
  recompute of the scores and dP the convention counts once);
- block-sparse (``bs_fwd``, ``bs_bwd_dq``, ``bs_bwd_dkv``): the same
  formulas over the layout's active blocks only, ``block² `` pairs each
  (under ``causal`` the blocks above the diagonal are skipped and not
  counted; a diagonal block counts whole);
- fused block (``fused_block_qkv_tc`` / ``fused_block_kv``,
  ``fused_block_attn_tc`` / ``fused_block_q``): the qkv product
  ``2·B·T·E·3E``, attention ``4·B·H·T²·D`` and the projection ``2·B·T·E²``
  (the CUDA-core design's kv launch the k and v thirds of the qkv product,
  its q launch the q third, attention and the projection).

``profile(fn, *args)`` runs ``fn`` once on concrete tensors, or on meta
tensors (no data: the shapes are what matter, as the JAX profiler's
``ShapeDtypeStruct`` inputs), and reports flops, bytes, intensity, argument,
output and temp bytes (temp: the caching allocator's high-water mark over the
call above what the call leaves allocated, on the card; None elsewhere) and
``optimal_seconds`` at a given peak.
"""

from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# kernel op name -> its flop formula over shapes
KERNEL_FLOPS: Dict[str, Any] = {}
_REGISTERED = []


def _attention_flops(B, H, Tq, Tk, D, products):
    return 2 * products * B * H * Tq * Tk * D


def _flash_fwd_flops(q_shape, k_shape, *args, out_shape=None, **kw):
    B, H, Tq, D = q_shape
    return _attention_flops(B, H, Tq, k_shape[2], D, 2)


def _flash_bwd_dq_flops(q_shape, k_shape, *args, out_shape=None, **kw):
    B, H, Tq, D = q_shape
    return _attention_flops(B, H, Tq, k_shape[2], D, 1)


def _flash_bwd_dkv_flops(q_shape, k_shape, *args, out_shape=None, **kw):
    B, H, Tq, D = q_shape
    return _attention_flops(B, H, Tq, k_shape[2], D, 4)


def _bs_flops(products):
    def formula(q_shape, k_shape, v_shape, *args, out_shape=None, block=None, active=None,
                **kw):
        # the ops' last two integer arguments: the layout block and the
        # active block pairs over the heads
        if block is None:
            block, active = args[-2], args[-1]
        B, D = q_shape[0], q_shape[3]
        return 2 * products * B * int(active) * int(block) ** 2 * D
    return formula


def _fused_qkv_flops(x_shape, *args, out_shape=None, **kw):
    B, T, E = x_shape
    return 2 * B * T * E * 3 * E


def _fused_kv_flops(x_shape, *args, out_shape=None, **kw):
    B, T, E = x_shape
    return 2 * B * T * E * 2 * E


def _fused_attn_flops(n_head_pos, q_third):
    def formula(x_shape, *args, out_shape=None, **kw):
        B, T, E = x_shape
        H = int(args[n_head_pos])
        flops = _attention_flops(B, H, T, T, E // H, 2) + 2 * B * T * E * E
        return flops + (2 * B * T * E * E if q_third else 0)
    return formula


def register_kernel_formulas():
    """Register every kernel op's flop formula with the flop counter (once;
    imports the ops modules, which define the ops)."""
    if _REGISTERED:
        return
    _REGISTERED.append(True)
    from torch.utils.flop_counter import register_flop_formula

    from ..ops import block_sparse_attention, flash_attention, fused_block  # noqa: F401
    ops = torch.ops.deepspeed_tpu_torch
    table = {
        "flash_fwd": _flash_fwd_flops,
        "flash_bwd_dq": _flash_bwd_dq_flops,
        "flash_bwd_dkv": _flash_bwd_dkv_flops,
        "bs_fwd": _bs_flops(2),
        "bs_bwd_dq": _bs_flops(1),
        "bs_bwd_dkv": _bs_flops(4),
        "fused_block_qkv_tc": _fused_qkv_flops,
        "fused_block_attn_tc": _fused_attn_flops(3, False),
        "fused_block_kv": _fused_kv_flops,
        "fused_block_q": _fused_attn_flops(7, True),
    }
    for name, formula in table.items():
        register_flop_formula(getattr(ops, name))(formula)
        KERNEL_FLOPS[name] = formula


def gpt2_train_flops(n_embd, n_layer, n_head, vocab_size, seq, batch, remat=False,
                     flash=True, tp=1) -> int:
    """What the flop counter counts for one forward and backward of the
    port's GPT-2 (``models/gpt2.py``: the chunked cross-entropy) on
    ``batch`` sequences of ``seq`` tokens, with no remat or remat "dots":

    - the block products, 2·B·T·12E² a layer forward and twice that
      backward;
    - the head, 2·B·T·E·V four times: the forward, its recompute in the
      chunked loss's backward, and the backward's two products;
    - attention a layer: ``flash`` the kernel ops (the forward 4·B·H·T²·D,
      twice under "dots", which replays it; the backward 10·B·H·T²·D, the
      SDPA-backward convention), else the plain version's products (the
      same forward, the backward's four products 8·B·H·T²·D).
    Other policies keep other products; they raise. ``tp`` > 1: one
    tensor-parallel rank's count — its n_head/tp heads, its 1/tp of the
    block products' columns or rows, and its vocab/tp block of the
    vocab-parallel head (the same four products)."""
    if remat not in (False, None, "dots"):
        raise ValueError(f"gpt2_train_flops: remat {remat!r} (no remat or 'dots' only)")
    e, L, bt, tp = int(n_embd), int(n_layer), int(batch) * int(seq), int(tp)
    att = 4 * int(batch) * (int(n_head) // tp) * int(seq) ** 2 * (e // int(n_head))
    blocks = L * 3 * 2 * bt * 12 * e * e // tp
    head = 4 * 2 * bt * e * (int(vocab_size) // tp)
    fwd = L * att * (2 if remat == "dots" else 1)
    bwd = L * (att * 10 // 4 if flash else 2 * att)
    return blocks + head + fwd + bwd


# ------------------------------------------------------------------ bytes
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _io_bytes(args, kwargs, out) -> int:
    """An op's bytes: each tensor operand read once, each output written
    once."""
    return sum(_nbytes(t) for t in pytree.tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor))


_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "alias"}


class ByteCounterMode(TorchDispatchMode):
    """Sum of the bytes each dispatched op moves: its tensor inputs and
    outputs, none for a view or an allocation. ``total`` and ``by_op``
    after the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            b = 0
        else:
            b = _io_bytes(args, kwargs, out)
        self.total += b
        self.by_op[f"{func.namespace}.{name}"] += b
        return out


def count(fn, *args):
    """Run ``fn(*args)`` once under the flop and byte counters: returns
    (output, flops, bytes, {op: flops})."""
    from torch.utils.flop_counter import FlopCounterMode
    register_kernel_formulas()
    flops = FlopCounterMode(display=False)
    moved = ByteCounterMode()
    with flops, moved:
        out = fn(*args)
    per_op = {str(k): int(v) for k, v in flops.get_flop_counts().get("Global", {}).items()}
    return out, float(flops.get_total_flops()), float(moved.total), per_op


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages among a tree's tensors."""
    seen, total = set(), 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            key = (t.device, t.untyped_storage().data_ptr()) if t.device.type != "meta" \
                else id(t)
            if key not in seen:
                seen.add(key)
                total += _nbytes(t)
    return total


def profile(fn, *args, peak_tflops: Optional[float] = None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and report its cost.

    ``args`` may be concrete tensors or meta tensors (no data needed). Keys:
    ``flops`` (the counted products and kernel ops), ``bytes_accessed`` (the
    dispatched ops' operands and outputs), ``arithmetic_intensity``,
    ``argument_bytes`` / ``output_bytes`` (the distinct storages of the
    inputs and the output), ``temp_bytes`` (on the card: the allocator's
    peak over the call minus what stays allocated after it; None
    elsewhere), ``flops_by_op`` and, with ``peak_tflops``,
    ``optimal_seconds`` = flops / peak."""
    cuda = any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in pytree.tree_leaves(args))
    if cuda:
        # the allocator's counters move at allocation, on the host: no fence
        torch.cuda.reset_peak_memory_stats()
    out, flops, nbytes, per_op = count(fn, *args)
    temp = None
    if cuda:
        temp = max(torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated(), 0)
    report = {
        "flops": flops,
        "bytes_accessed": nbytes,
        "arithmetic_intensity": flops / nbytes if nbytes else 0.0,
        "argument_bytes": _tensor_bytes(args),
        "output_bytes": _tensor_bytes(out),
        "temp_bytes": temp,
        "flops_by_op": per_op,
    }
    if peak_tflops:
        report["optimal_seconds"] = flops / (peak_tflops * 1e12)
    return report


def mfu(report: Dict[str, Any], seconds: float, peak_tflops: float) -> float:
    """Model-flops utilization of a measured run: counted flops / (time * peak)."""
    return report["flops"] / (seconds * peak_tflops * 1e12)


def format_report(report: Dict[str, Any], title: str = "profile") -> str:
    def eng(v):
        for unit in ("", "K", "M", "G", "T", "P"):
            if abs(v) < 1000:
                return f"{v:7.2f} {unit}"
            v /= 1000.0
        return f"{v:7.2f} E"

    temp = report.get("temp_bytes")
    lines = [f"--- {title} ---",
             f"flops                : {eng(report['flops'])}",
             f"bytes accessed       : {eng(report['bytes_accessed'])}B",
             f"arithmetic intensity : {report['arithmetic_intensity']:.1f} flops/B",
             f"argument bytes       : {eng(float(report['argument_bytes']))}B",
             f"output bytes         : {eng(float(report['output_bytes']))}B",
             "temp bytes           : " + (f"{eng(float(temp))}B" if temp is not None
                                          else "not measured (no card)")]
    if "optimal_seconds" in report:
        lines.append(f"optimal step time    : {report['optimal_seconds'] * 1e3:.2f} ms")
    if "params" in report:
        lines.append(f"params               : {eng(float(report['params']))}")
    return "\n".join(lines)
