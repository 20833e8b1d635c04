"""Memory observatory (PyTorch port of ``deepspeed_tpu/utils/hbm.py``):
attribute the card's bytes three ways and reconcile them.

**measured** — the caching allocator (``device_memory_stats`` over
``torch.cuda.memory_stats``; a step's temp peak is
``utils/flops_profiler.py`` ``profile``'s ``temp_bytes``: the allocator's
peak over the call above what it leaves resident).

**live** (in place of the JAX module's ``classify_program``, which reads the
optimized HLO's entry layout) — each class of the engine's
``memory_manifest()`` measured from its live tensors, deduplicated by
storage (``measure_classes``): no program text exists in eager PyTorch, and
the tensors the engine holds are the resident state itself.

**modeled** — the closed-form ZeRO predictor (``modeled_classes``, PAPER.md's
2Ψ/2Ψ/12Ψ accounting) over the manifest's geometry, copied.

``reconcile`` gates live against modeled (``HBM_REL_TOL`` 0.02); ``forecast``
and ``smallest_fitting_delta`` predict a training config's peak against the
card's memory (``torch.cuda.mem_get_info``, or ``budget_gib``);
``oom_forensics`` builds the flight recorder's memory block, with a summary
of ``torch.cuda.memory._snapshot()`` on the card. ``hbm_main`` renders,
diffs and forecasts reports on disk.

``sweep_entry`` / ``sweep_registry`` run the same over the lint registry's
engines (``lint/registry.py``), each program recorded once at the
dispatcher (``lint/program_passes.py``): per program, the bytes of each
manifest class its ops touched and of the arguments outside every class,
and on the card the allocator's peak over the call above what it leaves
(``temp_size_in_bytes``), where the JAX function reads the optimized entry
layout and ``memory_analysis``.

Left out: ``forecast_round5`` (JAX line 410) re-derives a TPU v5e round's
measured OOM frontier, a TPU's numbers.
"""

import argparse
import json
import sys
from collections import Counter
from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

HBM_REPORT_VERSION = 1
HBM_REPORT_KIND = "hbm_engine_report"
HBM_SWEEP_KIND = "hbm_report"

# live-vs-modeled reconciliation gate: relative slack for real divergence
# (scalar optimizer fields, padding), absolute slack so tiny classes aren't
# gated at sub-buffer granularity
HBM_REL_TOL = 0.02
HBM_ABS_TOL = 1024

CLASS_PRIORITY = ("params", "master", "optimizer", "grads", "comm_ef",
                  "kv_pool", "draft_params", "draft_pool")

# torch dtype -> the JAX module's (HLO) element-type names, so signatures key alike
_DTYPE_NAME = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
               torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
               torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
               torch.bool: "pred"}

GIB = 2 ** 30


# --------------------------------------------------------------- measured
def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's counters of one CUDA device (default: the
    current one) with the JAX keys ``bytes_in_use`` / ``peak_bytes_in_use``
    added to torch's own, or None where CUDA is not in use (the CPU, as the
    JAX CPU backend). A host read of the allocator's bookkeeping: no device
    work, no synchronization. The package's one ``memory_stats`` read."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    return stats


# ----------------------------------------------------------------- signatures
def leaf_signature(leaf):
    """(dtype name, shape, bytes) of one manifest leaf (a tensor, a meta
    tensor for an abstract one). A ZeRO rank's leaves are its slices, so the
    shape is the local one, as the JAX module signs a leaf by its shard."""
    shape = tuple(int(d) for d in leaf.shape)
    n = 1
    for d in shape:
        n *= d
    return (_DTYPE_NAME.get(leaf.dtype, str(leaf.dtype)), shape, n * leaf.element_size())


def _leaves(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def manifest_signatures(manifest):
    """(signatures, class_bytes) of a ``memory_manifest()`` dict:
    ``signatures[cls]`` the Counter of (dtype, shape) leaf signatures,
    ``class_bytes[cls]`` the class's total bytes on this device."""
    signatures, class_bytes = {}, {}
    for cls, tree in (manifest.get("classes") or {}).items():
        counter = Counter()
        total = 0
        for leaf in _leaves(tree):
            dt, shape, b = leaf_signature(leaf)
            counter[(dt, shape)] += 1
            total += b
        signatures[cls] = counter
        class_bytes[cls] = total
    return signatures, class_bytes


def measure_classes(manifest) -> Dict[str, int]:
    """Each class's bytes as the card holds them: its live tensors'
    storages, each counted once across all classes (in ``CLASS_PRIORITY``
    order; a storage two classes share counts in the first). Meta tensors
    (declared, not resident) count nothing."""
    seen = set()
    out = {}
    classes = manifest.get("classes") or {}
    order = [c for c in CLASS_PRIORITY if c in classes] + \
        [c for c in classes if c not in CLASS_PRIORITY]
    for cls in order:
        total = 0
        for leaf in _leaves(classes[cls]):
            if leaf.device.type == "meta":
                continue
            storage = leaf.untyped_storage()
            key = (str(leaf.device), storage.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            total += storage.nbytes()
        out[cls] = total
    return out


# ---------------------------------------------------------------- modeled
def modeled_classes(geometry) -> Dict[str, int]:
    """Closed-form per-device byte prediction per class from a manifest's
    geometry dict — the ZeRO accounting (params Ψ·bytes, grads Ψ·bytes/dp at
    stage ≥ 2, master 4Ψ/dp + moments 8Ψ/dp at stage ≥ 1, i.e. the paper's
    2Ψ/2Ψ/12Ψ split) with the engine's measured sharded-coverage fraction in
    place of the ideal 1/dp, plus shape-derived sizes for auxiliary buffers
    (comm error-feedback, paged KV pools)."""
    kind = geometry.get("kind", "training")
    out: Dict[str, int] = {}
    if kind == "serving":
        psi = int(geometry["psi"])
        ib = int(geometry["param_itemsize"])
        pf = float(geometry.get("param_per_device_fraction", 1.0))
        out["params"] = int(round(psi * ib * pf))
        g = geometry.get("pool")
        if g:
            pool = (2 * g["n_layer"] * g["num_blocks"] * g["block_size"]
                    * g["n_head"] * g["head_dim"] * g["itemsize"])
            out["kv_pool"] = int(pool // max(int(g.get("shard_factor", 1)), 1))
        d = geometry.get("draft")
        if d:
            out["draft_params"] = int(d["psi"] * d["param_itemsize"])
            dp_ = d["pool"]
            out["draft_pool"] = int(2 * dp_["n_layer"] * dp_["num_blocks"]
                                    * dp_["block_size"] * dp_["n_head"]
                                    * dp_["head_dim"] * dp_["itemsize"])
        return out
    if kind == "decode":
        out["params"] = int(geometry["psi"]) * int(geometry["param_itemsize"])
        return out
    if kind == "pipeline_local":
        # instruction-executor pipeline: per-stage LOCAL programs — the live
        # param working set of any one program is the largest stage subtree
        out["params"] = int(geometry["stage_param_bytes_max"])
        return out

    psi = int(geometry["psi"])
    dp = max(int(geometry.get("dp", 1)), 1)
    stage = int(geometry.get("zero_stage", 0))
    zsf = geometry.get("zero_sharded_fraction")
    zsf = 1.0 if zsf is None else float(zsf)

    def frac(threshold):
        # sharded coverage zsf of the bytes scale 1/dp, the rest replicate
        if stage >= threshold and dp > 1:
            return 1.0 - zsf + zsf / dp
        return 1.0

    out["params"] = int(round(psi * int(geometry["param_itemsize"]) * frac(3)))
    if not geometry.get("fused", False) or geometry.get("offload", False):
        # two-jit / accumulation / offload paths hand grads between programs
        # as a resident buffer; the fused step keeps the grad tree internal so
        # XLA frees each leaf as the optimizer consumes it (PERF.md round 5)
        out["grads"] = int(round(psi * int(geometry["grad_itemsize"])
                                 * frac(2)))
    if geometry.get("offload", False):
        pass          # master + moments live in host DRAM: zero device bytes
    elif geometry.get("external_master", False):
        # client-owned flat shard: master + m1 + m2 fp32, replicated (client
        # state does not mirror the param tree, so ZeRO cannot scatter it)
        out["optimizer"] = int(3 * int(geometry["master_numel"]) * 4)
    else:
        out["master"] = int(round(4 * psi * frac(1)))
        out["optimizer"] = int(round(8 * psi * frac(1)))
    ef = int(geometry.get("comm_ef_bytes", 0))
    if ef:
        out["comm_ef"] = ef
    return out


def reconcile(parsed, modeled, class_bytes=None, rel_tol=HBM_REL_TOL,
              abs_tol=HBM_ABS_TOL):
    """Per-class reconciliation verdicts (the JAX function's; in the port
    ``parsed`` is the live attribution, ``measure_classes``). A class is
    gated when it was observed (parsed > 0); a modeled-but-never-observed
    class is ``unobserved``, which is not drift. Returns ``(classes, ok)``."""
    classes = {}
    ok = True
    for cls in sorted(set(parsed) | set(modeled)):
        p = int(parsed.get(cls, 0))
        m = int(modeled.get(cls, 0))
        row = {"parsed_bytes": p, "modeled_bytes": m}
        if class_bytes is not None:
            row["manifest_bytes"] = int(class_bytes.get(cls, 0))
        if p == 0 and m > 0:
            row["status"] = "unobserved"
        elif abs(p - m) <= max(abs_tol, rel_tol * max(p, m)):
            row["status"] = "ok"
        else:
            row["status"] = "drift"
            ok = False
        classes[cls] = row
    return classes, ok


# --------------------------------------------------------------- forecast
# Activation residency per remat policy, in units of n_embd-equivalents per
# token-layer at 2 bytes (the JAX module's table: 'dots' = 8 is the GPT-2
# block's saved products, qkv 3E + attention projection input E + mlp fc
# output 4E; the others its calibration). Model-structure multiples, not a
# measurement of the card.
REMAT_ACT_UNITS = {"none": 3, "flash": 3, "attn": 4, "dots": 8,
                   "dots+attn": 10, "dots+attn-lean": 12}

# an allowance for cuBLAS workspaces and the caching allocator's
# fragmentation at the 1.5B scale (an allowance, not a measurement)
FORECAST_WORKSPACE_BYTES = 1 * GIB


def _budget_bytes(config) -> int:
    """The forecast's memory budget: ``budget_gib`` when the config names
    one, else the card's total memory (``torch.cuda.mem_get_info``)."""
    if config.get("budget_gib"):
        return int(round(float(config["budget_gib"]) * GIB))
    if not torch.cuda.is_available():
        raise ValueError("forecast: no budget_gib in the config and no card to read "
                         "the memory of")
    return int(torch.cuda.mem_get_info()[1])


def gpt2_param_count(n_embd, n_layer, vocab_size, n_positions, tp=1):
    """Exact GPT-2 Ψ: wte + wpe + per-block (12E² + 13E) + final LN (2E).
    ``tp`` > 1: one tensor-parallel rank's Ψ — its slices of the split
    leaves (wte's rows; c_attn, c_fc and the c_proj weights: 12E²/tp + 7E/tp
    a block) and the replicated ones whole (wpe; LayerNorms and the c_proj
    biases: 6E a block; the final LN)."""
    e, tp = int(n_embd), int(tp)
    return (int(vocab_size) * e // tp + int(n_positions) * e
            + int(n_layer) * ((12 * e * e + 7 * e) // tp + 6 * e) + 2 * e)


def forecast(config) -> Dict[str, Any]:
    """Feasibility predicate for one training config — per-card peak memory
    prediction and fit/OOM verdict, without building or running anything.

    ``config`` keys: ``model`` {n_embd, n_layer, vocab_size, n_positions,
    psi?}, ``remat`` (REMAT_ACT_UNITS key), ``batch_per_device``, ``seq_len``,
    ``ce_chunk`` (0 = unchunked), ``external_master_shards`` (0 = internal
    12Ψ/dp master+opt with ``dp``), ``dp``, ``budget_gib`` (default: the
    card's memory).

    The prediction is BINARY by design: margins near the cliff are not
    comparable to the allocator's real peak. The JAX module's function,
    with the budget read from the card."""
    m = config["model"]
    e, layers = int(m["n_embd"]), int(m["n_layer"])
    vocab, positions = int(m["vocab_size"]), int(m["n_positions"])
    psi = int(m.get("psi") or gpt2_param_count(e, layers, vocab, positions))
    remat = str(config.get("remat", "none"))
    if remat not in REMAT_ACT_UNITS:
        raise ValueError(f"unknown remat policy {remat!r}; expected one of "
                         f"{sorted(REMAT_ACT_UNITS)}")
    batch = int(config["batch_per_device"])
    seq = int(config.get("seq_len", positions))
    chunk = int(config.get("ce_chunk", 0)) or seq
    shards = int(config.get("external_master_shards", 0))
    dp = max(int(config.get("dp", 1)), 1)
    budget = _budget_bytes(config)

    params_b = 2 * psi                                   # bf16 compute params
    opt_frac = (1.0 / shards) if shards else (1.0 / dp)
    master_opt_b = int(round(12 * psi * opt_frac))       # fp32 master + Adam
    acts_b = REMAT_ACT_UNITS[remat] * batch * seq * layers * e * 2
    logits_b = batch * chunk * vocab * 4                 # f32 CE chunk
    total = (params_b + master_opt_b + acts_b + logits_b
             + FORECAST_WORKSPACE_BYTES)
    return {
        "psi": psi,
        "classes": {"params": params_b, "master_opt": master_opt_b,
                    "activations": acts_b, "logits": logits_b,
                    "workspace": FORECAST_WORKSPACE_BYTES},
        "predicted_peak_bytes": int(total),
        "budget_bytes": budget,
        "fits": total <= budget,
        "headroom_bytes": int(budget - total),
    }


def smallest_fitting_delta(config) -> List[Dict[str, Any]]:
    """Single-knob config deltas predicted to fit, for an OOMed config —
    ordered cheapest-change first (chunk the CE loss, then a leaner remat
    policy, then smaller batch). Empty when the config already fits or no
    single knob rescues it."""
    base = forecast(config)
    if base["fits"]:
        return []
    out = []
    m = config["model"]
    seq = int(config.get("seq_len", int(m["n_positions"])))
    chunk = int(config.get("ce_chunk", 0)) or seq
    for cand in (256, 128, 64):
        if cand < chunk:
            trial = dict(config, ce_chunk=cand)
            f = forecast(trial)
            if f["fits"]:
                out.append({"change": "ce_chunk", "value": cand,
                            "predicted_peak_bytes": f["predicted_peak_bytes"]})
                break
    units = REMAT_ACT_UNITS[str(config.get("remat", "none"))]
    leaner = sorted(((u, p) for p, u in REMAT_ACT_UNITS.items() if u < units),
                    reverse=True)
    for _u, policy in leaner:
        f = forecast(dict(config, remat=policy))
        if f["fits"]:
            out.append({"change": "remat", "value": policy,
                        "predicted_peak_bytes": f["predicted_peak_bytes"]})
            break
    for b in range(int(config["batch_per_device"]) - 1, 0, -1):
        f = forecast(dict(config, batch_per_device=b))
        if f["fits"]:
            out.append({"change": "batch_per_device", "value": b,
                        "predicted_peak_bytes": f["predicted_peak_bytes"]})
            break
    return out


# ----------------------------------------------------------- OOM forensics
def allocator_summary() -> Dict[str, Any]:
    """A summary of the caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``): segments, reserved and allocated
    bytes, the largest free block inside a segment. Raises where no card is
    in use: there is no allocator to read."""
    snap = torch.cuda.memory._snapshot()
    segments = snap.get("segments", [])
    reserved = sum(int(s["total_size"]) for s in segments)
    allocated = sum(int(b["size"]) for s in segments for b in s.get("blocks", [])
                    if b.get("state") == "active_allocated")
    free = [int(b["size"]) for s in segments for b in s.get("blocks", [])
            if b.get("state") == "inactive"]
    return {"segments": len(segments), "reserved_bytes": reserved,
            "allocated_bytes": allocated, "largest_free_block_bytes": max(free, default=0)}


def oom_forensics(snapshot) -> Dict[str, Any]:
    """Flight-recorder memory block: the per-class resident bytes largest
    first, the allocator's watermarks and, on the card, its snapshot's
    summary (``allocator_summary``), and — when the engine registered a
    forecastable config — the smallest single-knob deltas predicted to fit."""
    classes = dict(snapshot.get("classes") or {})
    out = {
        "classes": {c: int(b) for c, b in classes.items()},
        "largest_classes": [
            {"class": c, "bytes": int(b)}
            for c, b in sorted(classes.items(), key=lambda kv: (-kv[1], kv[0]))
        ],
    }
    measured = snapshot.get("measured")
    if measured:
        out["measured"] = {k: int(v) for k, v in measured.items()
                           if isinstance(v, (int, float))}
        out["allocator"] = allocator_summary()
    if snapshot.get("temp_peak_bytes"):
        out["compiled_temp_bytes_peak"] = int(snapshot["temp_peak_bytes"])
    cfg = snapshot.get("forecast_config")
    if cfg:
        try:
            f = forecast(cfg)
            out["forecast"] = {"predicted_peak_bytes": f["predicted_peak_bytes"],
                               "budget_bytes": f["budget_bytes"],
                               "fits": f["fits"]}
            if not f["fits"]:
                out["fitting_deltas"] = smallest_fitting_delta(cfg)
        except Exception as e:           # forensics must never mask the crash
            out["forecast_error"] = repr(e)
    return out


# ------------------------------------------------------------ engine report
def engine_report(engine, rel_tol=HBM_REL_TOL, abs_tol=HBM_ABS_TOL) -> Dict[str, Any]:
    """Live + modeled attribution of one engine (a training or a serving
    engine with ``memory_manifest()``): the classes measured from its
    tensors, the geometry's model, the verdicts, and the allocator's bytes
    in use beside them. The counterpart of the JAX module's ``sweep_entry``
    for one built engine."""
    manifest = engine.memory_manifest()
    _, class_bytes = manifest_signatures(manifest)
    live = measure_classes(manifest)
    geometry = dict(manifest.get("geometry") or {})
    modeled = modeled_classes(geometry) if geometry else {}
    classes, ok = reconcile(live, modeled, class_bytes, rel_tol=rel_tol, abs_tol=abs_tol)
    return {"version": HBM_REPORT_VERSION, "kind": HBM_REPORT_KIND, "geometry": geometry,
            "classes": classes, "manifest_bytes": sum(class_bytes.values()),
            "measured": device_memory_stats(), "reconciled": ok, "ok": ok}


def _storage_keys(tree):
    return {(str(t.device), t.untyped_storage().data_ptr()): t.untyped_storage().nbytes()
            for t in _leaves(tree) if t.device.type != "meta"}


def program_attribution(artifact, manifest) -> Dict[str, Any]:
    """The memory a recorded program touched (``lint/program_passes.py``
    ``ProgramArtifact``): ``by_class`` the bytes of each manifest class, its
    live tensors counted where the program's ops read or wrote their
    storage, then its arguments by (dtype, shape) signature against each
    class's leaves, as the JAX module's ``classify_program`` signs an entry
    layout (a serving program's fresh pools are ``kv_pool``);
    ``other_bytes`` the arguments no class claims; ``parameter_bytes`` both."""
    from .op_record import storage_key
    prog = artifact.program
    touched = {t.storage for r in prog.ops for t in r.inputs + r.outputs}
    touched |= {a.storage for a in prog.args}
    ordinal = prog.storages
    classes = manifest.get("classes") or {}
    signatures, _ = manifest_signatures(manifest)
    remaining = {cls: Counter(sig) for cls, sig in signatures.items()}
    by_class, claimed = {cls: 0 for cls in classes}, set()
    for cls, tree in classes.items():
        for t in _leaves(tree):
            key = storage_key(t) if t.device.type != "meta" else None
            if key is None or key in claimed or ordinal.get(key) not in touched:
                continue
            claimed.add(key)
            dt, shape, _ = leaf_signature(t)
            remaining[cls][(dt, shape)] -= 1
            by_class[cls] += t.untyped_storage().nbytes()
    other = 0
    for key, a in zip(prog.arg_keys, prog.args):
        if key in claimed:
            continue
        claimed.add(key)
        cls = next((c for c in remaining if remaining[c][(a.dtype, a.shape)] > 0), None)
        if cls is None:
            other += a.nbytes
        else:
            remaining[cls][(a.dtype, a.shape)] -= 1
            by_class[cls] += a.nbytes
    return {"by_class": by_class, "other_bytes": other,
            "parameter_bytes": sum(by_class.values()) + other}


def sweep_entry(entry, builders=None, device="cuda", rel_tol=HBM_REL_TOL,
                abs_tol=HBM_ABS_TOL) -> Dict[str, Any]:
    """Live + modeled attribution of one lint-registry entry, with each of
    its programs' attribution (``program_attribution``) and, on the card,
    its temp bytes."""
    from ..lint.registry import entry_world
    if builders is None:
        from ..lint.registry import BUILDERS as builders
    with entry_world(entry):
        return _sweep_entry(entry, builders, device, rel_tol, abs_tol)


def _sweep_entry(entry, builders, device, rel_tol, abs_tol):
    from ..lint.program_passes import ProgramArtifact
    engine, batch = builders[entry](device)
    manifest = engine.memory_manifest()
    _, class_bytes = manifest_signatures(manifest)
    programs = {}
    for name, fn, args, man in engine.lint_programs(batch):
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        artifact = ProgramArtifact.capture(f"{entry}:{name}", fn, args, man)
        rep = program_attribution(artifact, manifest)
        rep["measured"] = ({"temp_size_in_bytes": max(torch.cuda.max_memory_allocated()
                                                      - torch.cuda.memory_allocated(), 0)}
                           if cuda else {})
        programs[name] = rep
    live = measure_classes(manifest)
    geometry = dict(manifest.get("geometry") or {})
    modeled = modeled_classes(geometry) if geometry else {}
    classes, ok = reconcile(live, modeled, class_bytes, rel_tol=rel_tol, abs_tol=abs_tol)
    return {
        "geometry": geometry,
        "classes": classes,
        "programs": programs,
        "activations": {"measured_temp_bytes_max": max(
            (p["measured"].get("temp_size_in_bytes", 0) for p in programs.values()),
            default=0)},
        "reconciled": ok,
    }


def sweep_registry(entries=None, device="cuda", rel_tol=HBM_REL_TOL,
                   abs_tol=HBM_ABS_TOL) -> Dict[str, Any]:
    """The sweep over the lint registry (default: every ported entry; the
    others are listed under ``skipped``)."""
    from ..lint.registry import PORTED, UNPORTED
    names = list(entries) if entries else PORTED
    out_entries, errors = {}, []
    for entry in names:
        try:
            out_entries[entry] = sweep_entry(entry, device=device, rel_tol=rel_tol,
                                             abs_tol=abs_tol)
        except Exception as e:      # one entry's failure is reported, not fatal
            errors.append(f"{entry}: sweep failed: {e!r}")
    drift = sorted(e for e, rep in out_entries.items() if not rep["reconciled"])
    return {
        "version": HBM_REPORT_VERSION,
        "kind": HBM_SWEEP_KIND,
        "tolerance": {"rel": rel_tol, "abs": abs_tol},
        "entries": out_entries,
        "skipped": {} if entries else dict(UNPORTED),
        "drift_entries": drift,
        "errors": sorted(errors),
        "ok": not errors and not drift,
    }


def stable_projection(report) -> Dict[str, Any]:
    """The pinnable slice of a report: per-class live/modeled bytes and
    verdicts, without the allocator's watermarks (they move with the
    allocator). Takes an engine report or a ``{"entries": {name: report}}``
    set of them (the JAX function's sweep shape)."""
    entries = {}
    for entry, rep in report.get("entries", {"engine": report}).items():
        entries[entry] = {
            "classes": rep["classes"],
            "reconciled": rep["reconciled"],
            "programs": {
                name: {"by_class": p["by_class"], "other_bytes": p["other_bytes"],
                       "parameter_bytes": p["parameter_bytes"]}
                for name, p in rep.get("programs", {}).items()
            },
        }
    return {
        "version": report.get("version", HBM_REPORT_VERSION),
        "kind": report.get("kind", HBM_REPORT_KIND) + "_golden",
        "tolerance": report.get("tolerance", {"rel": HBM_REL_TOL, "abs": HBM_ABS_TOL}),
        "entries": entries,
        "drift_entries": sorted(e for e, r in entries.items() if not r["reconciled"]),
        "ok": report.get("ok", True),
    }


def diff_reports(old, new, rel_tol=HBM_REL_TOL,
                 abs_tol=HBM_ABS_TOL) -> Dict[str, Any]:
    """Cross-run regression gate over two reports (engine reports, or
    ``{"entries": {name: report}}`` sets of them, or their projections): any
    class whose live bytes GREW beyond tolerance, any entry that newly
    drifted, and any entry/class that disappeared. The same verdicts as the
    JAX module's over its sweep reports (``parsed_bytes`` is read where
    ``live_bytes`` is absent)."""
    regressions = []
    o_entries = old.get("entries", {"engine": old} if "classes" in old else {})
    n_entries = new.get("entries", {"engine": new} if "classes" in new else {})
    for entry in sorted(o_entries):
        if entry not in n_entries:
            regressions.append(f"{entry}: entry disappeared")
            continue
        o_rep, n_rep = o_entries[entry], n_entries[entry]
        if o_rep.get("reconciled", True) and not n_rep.get("reconciled", True):
            regressions.append(f"{entry}: newly drifted "
                               "(parsed vs modeled out of tolerance)")
        o_cls = o_rep.get("classes", {})
        n_cls = n_rep.get("classes", {})
        for cls in sorted(o_cls):
            ob = int(o_cls[cls].get("parsed_bytes", 0))
            nb = int(n_cls.get(cls, {}).get("parsed_bytes", 0))
            if nb > ob + max(abs_tol, rel_tol * ob):
                regressions.append(
                    f"{entry}/{cls}: parsed bytes grew {ob} -> {nb} "
                    f"(+{nb - ob})")
    return {"version": HBM_REPORT_VERSION, "kind": "hbm_diff",
            "regressions": regressions, "ok": not regressions}


# ------------------------------------------------------------------- CLI
def _load_json(path):
    with open(path) as f:
        return json.load(f)


def hbm_main(argv=None):
    """The memory observatory's CLI over reports on disk: ``--report PATH``
    renders an engine report (``engine_report``, saved as JSON), ``--diff A
    B`` gates two of them, ``--forecast CONFIG.json`` predicts a training
    config's peak; with none of them, the sweep over the lint registry
    (``--entry``, ``--device``). Exit 1 on drift, a failed entry or a
    regression."""
    parser = argparse.ArgumentParser(
        prog="hbm", description="memory attribution: live vs modeled per class; "
                                "offline OOM feasibility forecasts")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON on stdout")
    parser.add_argument("--out", metavar="PATH", help="also write the JSON report to PATH")
    parser.add_argument("--report", metavar="PATH", help="render a saved engine report")
    parser.add_argument("--tolerance", type=float, default=HBM_REL_TOL,
                        help="live-vs-modeled relative tolerance (default: %(default)s)")
    parser.add_argument("--forecast", metavar="CONFIG",
                        help="feasibility forecast of a JSON training config")
    parser.add_argument("--budget-gib", type=float, default=0.0,
                        help="override the forecast config's memory budget")
    parser.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                        help="compare two reports; exit 1 on byte growth beyond "
                             "tolerance")
    parser.add_argument("--entry", action="append", metavar="NAME",
                        help="limit the registry sweep to a lint-registry entry "
                             "(repeatable; default: every ported entry)")
    parser.add_argument("--device", default="cuda",
                        help="device of the registry sweep's engines (default: cuda)")
    args = parser.parse_args(argv)

    if args.diff:
        report = diff_reports(_load_json(args.diff[0]), _load_json(args.diff[1]),
                              rel_tol=args.tolerance)
    elif args.forecast:
        cfg = _load_json(args.forecast)
        if args.budget_gib:
            cfg["budget_gib"] = args.budget_gib
        report = forecast(cfg)
        report.update({"version": HBM_REPORT_VERSION, "kind": "hbm_forecast", "ok": True})
        if not report["fits"]:
            report["fitting_deltas"] = smallest_fitting_delta(cfg)
    elif args.report:
        report = _load_json(args.report)
    else:
        from .logging import log_to_stderr
        log_to_stderr()      # stdout belongs to the report
        report = sweep_registry(args.entry, device=args.device, rel_tol=args.tolerance)

    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.json:
        sys.stdout.write(text)
    else:
        _print_report(report)
    return 0 if report.get("ok", True) else 1


def _print_report(report):
    kind = report.get("kind")
    if kind == HBM_REPORT_KIND:
        print(f"[{'ok' if report['reconciled'] else 'DRIFT'}] "
              f"manifest {report['manifest_bytes']:,} B")
        for cls, row in sorted(report["classes"].items()):
            print(f"  {cls:<14} live {row['parsed_bytes']:>14,} B  "
                  f"modeled {row['modeled_bytes']:>14,} B  [{row['status']}]")
    elif kind == "hbm_forecast":
        for cls, b in sorted(report["classes"].items()):
            print(f"  {cls:<12} {b / GIB:>8.3f} GiB")
        print(f"predicted peak {report['predicted_peak_bytes'] / GIB:.3f} GiB "
              f"vs budget {report['budget_bytes'] / GIB:.2f} GiB -> "
              f"{'FITS' if report['fits'] else 'OOM'}")
        for d in report.get("fitting_deltas", []):
            print(f"  delta: {d['change']} -> {d['value']} "
                  f"({d['predicted_peak_bytes'] / GIB:.3f} GiB)")
    elif kind == HBM_SWEEP_KIND:
        for entry, rep in sorted(report["entries"].items()):
            print(f"[{'ok' if rep['reconciled'] else 'DRIFT'}] {entry}")
            for cls, row in sorted(rep["classes"].items()):
                print(f"  {cls:<14} live {row['parsed_bytes']:>14,} B  "
                      f"modeled {row['modeled_bytes']:>14,} B  [{row['status']}]")
        for entry, item in sorted(report.get("skipped", {}).items()):
            print(f"skipped {entry} ({item})")
        for e in report["errors"]:
            print(f"ERROR {e}")
    elif kind == "hbm_diff":
        for r in report["regressions"]:
            print(f"REGRESSION {r}")
        print(f"{len(report['regressions'])} regression(s)")


if __name__ == "__main__":
    sys.exit(hbm_main())
