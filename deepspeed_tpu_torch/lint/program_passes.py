"""Program lint passes over recorded calls (the port's counterpart of
``deepspeed_tpu/lint/program_passes.py``).

The JAX passes read a jitted program's AOT artifact. Eager PyTorch has none,
so ``ProgramArtifact.capture(name, fn, args, manifest)`` runs ``fn(*args)``
once under the dispatcher recorder (``utils/op_record.py``), on the device
its tensors are on, and keeps the recorded ops, the storages of its inputs
and outputs, and what the manifest's in-place state was before and after.
The passes keep JAX's pass ids, rules and manifest keys:

``donation``
    ``{"check_unusable": bool, "min_undonated_bytes": int|None,
    "inplace_args": [tensors], "inplace": {class: getter}}``. The port's
    counterpart of a donated buffer is a state tensor the program must
    update **in place** (parameters, master, moments, the accumulator,
    serving's KV pools). ``inplace_args`` names such tensors among the
    arguments: ``unusable-donation`` flags one that no recorded op wrote
    (subject ``prog#arg<i>``, its flat tensor position in ``args``, as JAX's
    donated-argument index). ``inplace`` names the state an engine holds by a
    getter of its tensors, called before and after the call:
    ``unusable-donation`` flags a tensor whose storage the call replaced
    instead of writing it (``prog#<class>[i]``). ``undonated-aliasable`` flags an input of at least
    ``min_undonated_bytes`` that is not declared in place but whose shape and
    dtype a freshly allocated output has: as in JAX, such an input is taken
    to die after the call, and the fresh output is a second copy of it at
    the peak (subject ``prog#arg<i>``, the flat tensor position in ``args``).

``collectives`` / ``any_reduction`` / ``strict`` / ``small_element_threshold``
    The collective budget over the recorded c10d ops under JAX's kinds,
    counting only ops whose largest result exceeds the threshold (256
    elements): ``{kind: {"min", "max", "dtypes"}}``; ``any_reduction``
    budgets all-reduce and reduce-scatter together; with ``strict`` a large
    collective of a kind without a budget is ``undeclared-collective``.

``compute_dtype``
    With "bf16"/"f16": ``f32-dot-in-lowp-region`` flags a float32 ``mm`` /
    ``bmm`` / ``addmm`` (``linear`` and ``matmul`` dispatch as these) with an
    operand converted from that dtype (``prog#dot<i>``), ``lossy-convert-roundtrip`` a d1 -> d2 -> d1
    conversion through a narrower d2 (``prog#convert<i>``). The recorder
    sees the author's dtypes on every device, so the JAX split between the
    optimized and the pre-backend module, and the CPU's widening of
    low-precision wire dtypes, have no counterpart here.
"""

from ..utils import op_record
from .model import Violation

SMALL_ELEMENT_THRESHOLD = 256
REDUCTION_OPS = ("all-reduce", "reduce-scatter")


def _state(getter):
    return [t for t in getter() if t is not None]


class ProgramArtifact:
    """One recorded call: its ops, argument and output infos, the in-place
    state's storages before and after, and the manifest."""

    def __init__(self, name, program, manifest, inplace=None, inplace_args=()):
        self.name = name
        self.program = program
        self.manifest = dict(manifest or {})
        # {class: [(storage before, storage after or None, dtype, shape)]}
        self.inplace = dict(inplace or {})
        # flat positions of the arguments declared in place
        self.inplace_args = list(inplace_args)

    @property
    def ops(self):
        return self.program.ops

    @classmethod
    def capture(cls, name, fn, args, manifest=None):
        """Run ``fn(*args)`` once under the recorder. The declared in-place
        state is read before the call and kept alive through it, so a
        replacement can never reuse a replaced tensor's address."""
        manifest = dict(manifest or {})
        donation = manifest.get("donation", {})
        getters = dict(donation.get("inplace") or {})
        declared = list(donation.get("inplace_args") or ())
        tensors = op_record._tensors(args)
        inplace_args = [i for i, t in enumerate(tensors) if any(t is d for d in declared)]
        before = {k: _state(g) for k, g in getters.items()}
        before_keys = {k: [op_record.storage_key(t) for t in v] for k, v in before.items()}
        program = op_record.record(fn, *args)
        inplace = {}
        for k, g in getters.items():
            after = _state(g)
            rows = []
            for i, t in enumerate(before[k]):
                a = op_record.storage_key(after[i]) if i < len(after) else None
                rows.append((before_keys[k][i], a, op_record.dtype_name(t.dtype),
                             tuple(int(d) for d in t.shape)))
            inplace[k] = rows
        del before
        return cls(name, program, manifest, inplace, inplace_args)


class DonationPass:
    pass_id = "program-donation"

    def run(self, artifact):
        man = artifact.manifest.get("donation", {})
        out = []
        if man.get("check_unusable", True):
            out += self._unusable(artifact)
        min_bytes = man.get("min_undonated_bytes")
        if min_bytes is not None:
            out += self._undonated(artifact, int(min_bytes))
        return out

    def _unusable(self, artifact):
        prog = artifact.program
        written = op_record.written_storages(prog)
        out = []
        for i in artifact.inplace_args:
            a = prog.args[i]
            if a.storage in written:
                continue
            out.append(Violation(
                self.pass_id, "unusable-donation", f"{artifact.name}#arg{i}",
                f"{artifact.name}: arg {i} ({a.dtype}{list(a.shape)}) is declared "
                "in place but no op of the call wrote it — the update went to a "
                "new buffer and the declaration is a no-op",
                details={"shape": list(a.shape), "dtype": a.dtype, "bytes": a.nbytes}))
        for cls in sorted(artifact.inplace):
            for i, (before, after, dt, shape) in enumerate(artifact.inplace[cls]):
                if after == before:
                    continue
                nbytes = op_record._elements(shape) * (op_record.dtype_bytes(dt) or 0)
                out.append(Violation(
                    self.pass_id, "unusable-donation", f"{artifact.name}#{cls}[{i}]",
                    f"{artifact.name}: {cls}[{i}] ({dt}{list(shape)}) is declared "
                    "in place but the call replaced its storage — the old and the "
                    "new buffer are both live at the peak",
                    details={"shape": list(shape), "dtype": dt, "bytes": nbytes}))
        return out

    def _undonated(self, artifact, min_bytes):
        prog = artifact.program
        declared = {before for rows in artifact.inplace.values()
                    for before, _a, _d, _s in rows}
        declared |= {prog.arg_keys[i] for i in artifact.inplace_args}
        fresh = {(prog.outs[j].dtype, prog.outs[j].shape)
                 for j in op_record.fresh_outputs(prog)}
        out = []
        seen = set()
        for i, a in enumerate(prog.args):
            if a.storage in seen:
                continue
            seen.add(a.storage)
            if a.nbytes < min_bytes or (a.dtype, a.shape) not in fresh:
                continue
            if prog.arg_keys[i] in declared:
                continue
            out.append(Violation(
                self.pass_id, "undonated-aliasable", f"{artifact.name}#arg{i}",
                f"{artifact.name}: arg {i} ({a.dtype}{list(a.shape)}, {a.nbytes} bytes) "
                "matches a freshly allocated output's shape/dtype but is not "
                f"updated in place — ~{a.nbytes} bytes of avoidable peak memory",
                details={"shape": list(a.shape), "dtype": a.dtype,
                         "hbm_waste_bytes": a.nbytes}))
        return out


def _large_collectives(artifact):
    """[(kind, [dtypes of large results], max elements)] per collective op
    whose largest result crosses the size threshold."""
    threshold = artifact.manifest.get("small_element_threshold", SMALL_ELEMENT_THRESHOLD)
    out = []
    for r in artifact.ops:
        if r.kind is None:
            continue
        big = [(dt, n) for dt, n in r.results if n > threshold]
        if big:
            out.append((r.kind, sorted({dt for dt, _ in big}), max(n for _, n in big)))
    return out


class CollectiveBudgetPass:
    pass_id = "program-collectives"

    def run(self, artifact):
        man = artifact.manifest
        budgets = dict(man.get("collectives", {}))
        any_red = man.get("any_reduction")
        strict = bool(man.get("strict", True))
        large = _large_collectives(artifact)
        out = []

        counts = {}
        dtypes_seen = {}
        for op, dts, _n in large:
            counts[op] = counts.get(op, 0) + 1
            dtypes_seen.setdefault(op, set()).update(dts)

        red_count = sum(counts.get(op, 0) for op in REDUCTION_OPS)
        for op in sorted(set(counts) | set(budgets)):
            budget = budgets.get(op)
            n = counts.get(op, 0)
            covered_by_red = any_red is not None and op in REDUCTION_OPS
            if budget is None and covered_by_red:
                continue
            if budget is None:
                if strict and n > 0:
                    out.append(Violation(
                        self.pass_id, "undeclared-collective",
                        f"{artifact.name}#{op}",
                        f"{artifact.name}: {n} large {op} op(s) appear but the "
                        "manifest declares no budget for the op",
                        details={"count": n,
                                 "dtypes": sorted(dtypes_seen.get(op, ()))}))
                continue
            lo = budget.get("min", 0)
            hi = budget.get("max")
            if n < lo:
                out.append(Violation(
                    self.pass_id, "count-missing", f"{artifact.name}#{op}",
                    f"{artifact.name}: expected >= {lo} large {op}, found {n}",
                    details={"count": n, "min": lo}))
            if hi is not None and n > hi:
                out.append(Violation(
                    self.pass_id, "count-exceeded", f"{artifact.name}#{op}",
                    f"{artifact.name}: expected <= {hi} large {op}, found {n}",
                    details={"count": n, "max": hi}))
            allowed = budget.get("dtypes")
            if allowed:
                bad = sorted(dtypes_seen.get(op, set()) - set(allowed))
                if bad:
                    out.append(Violation(
                        self.pass_id, "comm-dtype", f"{artifact.name}#{op}",
                        f"{artifact.name}: {op} carries {bad} on the wire but "
                        f"the manifest allows only {sorted(allowed)}",
                        details={"found": bad, "allowed": sorted(allowed)}))
        if any_red is not None:
            lo = any_red.get("min", 0)
            hi = any_red.get("max")
            subj = f"{artifact.name}#any-reduction"
            if red_count < lo:
                out.append(Violation(
                    self.pass_id, "count-missing", subj,
                    f"{artifact.name}: expected >= {lo} large reduction "
                    f"collective(s) (all-reduce/reduce-scatter), found {red_count}",
                    details={"count": red_count, "min": lo}))
            if hi is not None and red_count > hi:
                out.append(Violation(
                    self.pass_id, "count-exceeded", subj,
                    f"{artifact.name}: expected <= {hi} large reduction "
                    f"collective(s), found {red_count}",
                    details={"count": red_count, "max": hi}))
            allowed = any_red.get("dtypes")
            if allowed:
                seen = set()
                for op in REDUCTION_OPS:
                    seen |= dtypes_seen.get(op, set())
                bad = sorted(seen - set(allowed))
                if bad:
                    out.append(Violation(
                        self.pass_id, "comm-dtype", subj,
                        f"{artifact.name}: reduction collectives carry {bad} "
                        f"but the manifest allows only {sorted(allowed)}",
                        details={"found": bad, "allowed": sorted(allowed)}))
        return out


class DtypePromotionPass:
    pass_id = "program-dtype"

    def run(self, artifact):
        compute = artifact.manifest.get("compute_dtype")
        if compute not in ("bf16", "f16"):
            return []
        out = []
        dots = op_record.f32_dots_with_lowp_operands(artifact.program, lowp=(compute,))
        for i, (dot_name, operands) in enumerate(dots):
            out.append(Violation(
                self.pass_id, "f32-dot-in-lowp-region",
                f"{artifact.name}#dot{i}",
                f"{artifact.name}: f32 matrix product fed by conversion(s) from "
                f"{compute} — a product the author may believe runs on the "
                "low-precision tensor cores was widened",
                details={"op": dot_name, "operands": operands}))
        trips = op_record.lossy_convert_roundtrips(artifact.program)
        for i, (name, chain) in enumerate(trips):
            out.append(Violation(
                self.pass_id, "lossy-convert-roundtrip",
                f"{artifact.name}#convert{i}",
                f"{artifact.name}: value round-trips {'->'.join(chain)} — the "
                "narrowing leg truncates mantissa and usually marks a dtype "
                "boundary drawn in the wrong place",
                details={"op": name, "chain": list(chain)}))
        return out


PROGRAM_PASSES = (DonationPass(), CollectiveBudgetPass(), DtypePromotionPass())


def run_program_passes(artifacts, passes=PROGRAM_PASSES):
    out = []
    for artifact in artifacts:
        for p in passes:
            out.extend(p.run(artifact))
    return out
