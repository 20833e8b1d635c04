"""Programs recorded at the dispatcher: the port's counterpart of
``deepspeed_tpu/utils/hlo.py``.

The JAX package audits a jitted program through its optimized HLO text.
Eager PyTorch has no ahead-of-time artifact, so a *program* here is one
executed call, recorded op by op by a ``TorchDispatchMode``
(``record(fn, *args)``). Each ``OpRecord`` keeps

- the op's name (``aten::mm``, ``c10d::allreduce_``, the port's kernel ops
  ``deepspeed_tpu_torch::*``) and its collective kind, if any;
- the dtype (in HLO spelling: ``f32``, ``bf16`` ...) and shape of every
  tensor input and output, with the ordinal of its storage;
- which inputs the op mutates and which input each output aliases, from the
  op's schema (``Tensor(a!)``).

The mode sees what the dispatcher sees: the ``c10d::*`` collectives (as
torch's ``CommDebugMode`` counts them, a world-1 gloo group and the fake
process group included), the port's kernel ops, and the backward's ops,
which run under the same mode. Ops a kernel issues inside its own op are not
recorded: the op is the unit, as a custom call is in the HLO.

The readers the lint passes and the observatories use:

- ``collective_counts`` / ``collective_results`` / ``collective_bytes``:
  the c10d ops under JAX's kinds (``allreduce_`` -> ``all-reduce``,
  ``reduce_scatter_`` and ``_reduce_scatter_base_`` -> ``reduce-scatter``,
  ``allgather_`` and ``_allgather_base_`` -> ``all-gather``, ``alltoall_``
  -> ``all-to-all``); a result is what one participant receives;
- ``f32_dots_with_lowp_operands`` (``hlo.py:723``): float32 matrix products
  with an operand converted from bf16/f16 (through views and copies);
- ``lossy_convert_roundtrips`` (``hlo.py:742``): d1 -> d2 -> d1 conversions
  through a narrower d2;
- ``input_output_aliases`` (``hlo.py:466``): which program outputs share
  storage with which program inputs;
- ``kernel_counts``: the port's kernel ops by name.

The readers of XLA text alone (instruction layouts, the temp-allocation
estimate, async start/done pairs, replica groups) have no counterpart: no
program text exists, and a recorded op is already one launch on one group.
"""

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

# torch dtype -> HLO element type, so reports and manifests read as JAX's
DTYPE_NAMES = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
               torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
               torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
               torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128"}
_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "bf16": 2, "f16": 2,
                "s32": 4, "f32": 4, "s64": 8, "f64": 8, "c64": 8, "c128": 16}

# c10d op name -> JAX's collective kind
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
    "recv_": "collective-permute",
}
# the c10d ops whose first argument holds the parts of ONE result per entry
_GATHERED = {"allgather_", "allgather_coalesced_", "alltoall_"}

# matrix products and their matrix operands' positions (``matmul`` and
# ``linear`` decompose into these before the dispatcher's Python key)
DOT_OPS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
           "addbmm": (1, 2), "dot": (0, 1), "mv": (0, 1), "addmv": (1, 2)}
# ops that move or re-lay values without computing: a dot fed through them
# is fed by their input's producer
_LAYOUT_OPS = {"_unsafe_view", "clone", "contiguous", "_reshape_alias", "lift_fresh",
               "alias", "detach", "copy"}


def dtype_name(dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def dtype_bytes(dt) -> Optional[int]:
    """Bytes an element of an HLO element-type name (or a torch dtype)."""
    if isinstance(dt, torch.dtype):
        dt = dtype_name(dt)
    return _DTYPE_BYTES.get(dt)


def _elements(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def storage_key(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (its data pointer; a meta tensor's
    storage object)."""
    if t.device.type == "meta":
        return id(t)
    return t.untyped_storage().data_ptr()


class TensorInfo:
    """One tensor operand or result of a recorded op."""
    __slots__ = ("dtype", "shape", "storage")

    def __init__(self, t: torch.Tensor, storages: Dict[int, int]):
        self.dtype = dtype_name(t.dtype)
        self.shape = tuple(int(d) for d in t.shape)
        key = storage_key(t)
        self.storage = storages.setdefault(key, len(storages))

    @property
    def elements(self) -> int:
        return _elements(self.shape)

    @property
    def nbytes(self) -> int:
        return self.elements * (_DTYPE_BYTES.get(self.dtype) or 0)

    def __repr__(self):
        return f"{self.dtype}{list(self.shape)}"


class OpRecord:
    """One dispatched op of a recorded program.

    ``name`` is ``namespace::op`` (``aten::mm``); ``inputs`` / ``outputs``
    the tensors among its arguments and results, flattened in order;
    ``mutates`` the input positions it writes, ``aliases`` {output position:
    input position} for results that alias an input; ``kind`` the
    collective kind of a c10d op (else None) and ``results`` what one
    participant receives from it, ``[(dtype, elements)]``; ``sources`` the
    producing op's index of each input (None: made outside the call) and ``convert`` ``(from, to)`` for a dtype cast."""
    __slots__ = ("index", "name", "inputs", "outputs", "mutates", "aliases", "kind",
                 "results", "sources", "convert")

    def __init__(self, index, name):
        self.index, self.name = index, name
        self.inputs: List[TensorInfo] = []
        self.outputs: List[TensorInfo] = []
        self.mutates: List[int] = []
        self.aliases: Dict[int, int] = {}
        self.kind: Optional[str] = None
        self.results: List[Tuple[str, int]] = []
        self.sources: List[Optional[int]] = []
        self.convert: Optional[Tuple[str, str]] = None

    @property
    def op(self) -> str:
        return self.name.split("::", 1)[-1]

    @property
    def namespace(self) -> str:
        return self.name.split("::", 1)[0]

    def __repr__(self):
        return f"{self.name}@{self.index}({self.inputs} -> {self.outputs})"


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _arg_positions(func, args, kwargs):
    """[(argument schema, flat tensor positions)] for each schema argument."""
    out, pos = [], 0
    for i, a in enumerate(func._schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(a.name)
        n = len(_tensors(val))
        out.append((a, list(range(pos, pos + n))))
        pos += n
    return out


def _collective_results(op, args, out):
    if op in ("all_reduce", "all_reduce_coalesced", "reduce_scatter_tensor",
              "reduce_scatter_tensor_coalesced", "all_gather_into_tensor",
              "all_gather_into_tensor_coalesced", "all_to_all_single"):
        targets = [[t] for t in _tensors(out)]
    elif op in _GATHERED:
        targets = [_tensors(parts) for parts in args[0]] if op != "alltoall_" \
            else [_tensors(args[0])]
    else:
        targets = [[t] for t in _tensors(args[0])]
    res = []
    for parts in targets:
        if parts:
            res.append((dtype_name(parts[0].dtype), sum(t.numel() for t in parts)))
    return res


class ProgramRecorder(TorchDispatchMode):
    """A dispatch mode that records every op into ``ops``. Never enter it
    around a CUDA-graph capture: a recorded program runs eagerly."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._storages: Dict[int, int] = {}
        # tensor -> the index of the op that produced it (views and copies
        # pass their input's producer on)
        self._producer = WeakTensorKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        op = func._overloadpacket.__name__
        rec = OpRecord(len(self.ops), f"{ns}::{op}")
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        rec.inputs = [TensorInfo(t, self._storages) for t in ins]
        rec.outputs = [TensorInfo(t, self._storages) for t in outs]
        rec.sources = [self._producer.get(t) for t in ins]
        if ns in ("c10d", "_c10d_functional") and op in COLLECTIVE_KINDS:
            rec.kind = COLLECTIVE_KINDS[op]
            rec.results = _collective_results(op, args, out)
            if ns == "c10d":
                # c10d's in-place ops carry no alias annotation: they write
                # their first argument
                rec.mutates = list(range(len(_tensors(args[0]))))
        else:
            sets = {}
            for a, positions in _arg_positions(func, args, kwargs):
                info = a.alias_info
                if info is None:
                    continue
                if info.is_write:
                    rec.mutates += positions
                for s in info.before_set:
                    sets.setdefault(s, positions)
            for j, r in enumerate(func._schema.returns[:len(outs)]):
                if r.alias_info is not None:
                    for s in r.alias_info.before_set:
                        if sets.get(s):
                            rec.aliases[j] = sets[s][0]
        if op == "_to_copy" and ins and outs and ins[0].dtype != outs[0].dtype:
            rec.convert = (dtype_name(ins[0].dtype), dtype_name(outs[0].dtype))
        transparent = (func.is_view or op in _LAYOUT_OPS) and ins and rec.sources
        for t in outs:
            self._producer[t] = rec.sources[0] if transparent else rec.index
        self.ops.append(rec)
        return out


class Program:
    """One recorded call: its ops, the infos of its tensor arguments
    (``args``, flat) and results (``outs``), the arguments' storage keys
    (``arg_keys``), the ordinal of every storage key seen (``storages``),
    and the call's result."""

    def __init__(self, ops, arg_infos, out_infos, result, arg_keys, storages):
        self.ops = ops
        self.args = arg_infos
        self.outs = out_infos
        self.result = result
        self.arg_keys = arg_keys
        self.storages = storages      # storage key -> ordinal


def record(fn, *args, **kwargs) -> Program:
    """Run ``fn(*args, **kwargs)`` once under a ``ProgramRecorder``."""
    rec = ProgramRecorder()
    tensors = _tensors((args, kwargs))
    arg_infos = [TensorInfo(t, rec._storages) for t in tensors]
    with rec:
        result = fn(*args, **kwargs)
    out_infos = [TensorInfo(t, rec._storages) for t in _tensors(result)]
    return Program(rec.ops, arg_infos, out_infos, result,
                   [storage_key(t) for t in tensors], rec._storages)


# ------------------------------------------------------------------ readers
def _ops(program) -> List[OpRecord]:
    return program.ops if isinstance(program, Program) else list(program)


def collective_counts(program) -> Dict[str, int]:
    """{collective kind -> op count}."""
    return dict(Counter(r.kind for r in _ops(program) if r.kind is not None))


def collective_results(program, kind=None) -> List[Tuple[str, str, int]]:
    """[(kind, dtype, elements)] of every collective op's results (what one
    participant receives); ``kind`` filters to one kind."""
    return [(r.kind, dt, n) for r in _ops(program) if r.kind is not None
            and (kind is None or r.kind == kind) for dt, n in r.results]


def collective_bytes(program) -> int:
    """Per-participant collective bytes: each result's size."""
    return sum(n * (_DTYPE_BYTES.get(dt) or 0) for _k, dt, n in collective_results(program))


def kernel_counts(program, namespace="deepspeed_tpu_torch") -> Dict[str, int]:
    """{kernel op -> count} of the port's kernel ops."""
    return dict(Counter(r.op for r in _ops(program) if r.namespace == namespace))


def f32_dots_with_lowp_operands(program, lowp=("bf16", "f16")) -> List[Tuple[str, List[str]]]:
    """[(dot, [the converts feeding it])] for every float32 matrix product
    with a matrix operand produced (through views and copies) by a
    ``_to_copy`` from ``lowp``. Names are ``op@index``."""
    ops = _ops(program)
    hits = []
    for r in ops:
        pos = DOT_OPS.get(r.op)
        if r.namespace != "aten" or pos is None or not r.outputs \
                or r.outputs[0].dtype != "f32":
            continue
        fed = []
        for p in pos:
            src = r.sources[p] if p < len(r.sources) else None
            if src is not None and ops[src].convert is not None \
                    and ops[src].convert[0] in lowp:
                fed.append(f"{ops[src].op}@{src}")
        if fed:
            hits.append((f"{r.op}@{r.index}", fed))
    return hits


def lossy_convert_roundtrips(program) -> List[Tuple[str, Tuple[str, str, str]]]:
    """[(first convert, (d1, d2, d1))] for every conversion d2 -> d1 of a
    value that a conversion d1 -> d2 produced, where d2 is narrower than d1."""
    ops = _ops(program)
    hits = []
    for r in ops:
        if r.convert is None or not r.sources or r.sources[0] is None:
            continue
        up = ops[r.sources[0]]
        if up.convert is None:
            continue
        (d1, d2), (src, dst) = up.convert, r.convert
        if d2 == src and d1 == dst and (_DTYPE_BYTES.get(d2) or 0) < (_DTYPE_BYTES.get(d1) or 0):
            hits.append((f"{up.op}@{up.index}", (d1, d2, d1)))
    return hits


def input_output_aliases(program: Program) -> Dict[int, List[int]]:
    """{flat input position -> [flat output positions sharing its storage]}."""
    out: Dict[int, List[int]] = {}
    for i, a in enumerate(program.args):
        hits = [j for j, o in enumerate(program.outs) if o.storage == a.storage]
        if hits:
            out[i] = hits
    return out


def written_storages(program: Program) -> set:
    """Storage ordinals some op of the program wrote."""
    return {r.inputs[i].storage for r in program.ops for i in r.mutates
            if i < len(r.inputs)}


def fresh_outputs(program: Program) -> List[int]:
    """Flat output positions whose storage no input of the call had."""
    seen = {a.storage for a in program.args}
    return [j for j, o in enumerate(program.outs) if o.storage not in seen]
