"""Measured-time profile observatory: ingest the profiler's Chrome trace and
reconcile it against the counted cost (PyTorch port of
``deepspeed_tpu/utils/profile_ingest.py``).

The telemetry session's trace window (``utils/telemetry.py``) writes a
``torch.profiler`` Chrome trace, ``trace_<run>_host<h>/trace.json``. This
module reads it back:

- **device slices** (``device_slices``) are the kernel, memcpy and memset
  events of the GPU streams (on the CPU, where the device is the host, the
  outermost ``cpu_op`` events of each thread); each is attributed to the
  watched program whose ``ds_program/<name>`` range holds it (the module key
  JAX takes from ``hlo_module``) and to the innermost engine scope
  (``named_scope``, ``utils/cluster.py``: ``ds_fwd_bwd``,
  ``ds_apply_update``, ...) that holds it: the GPU-side ranges
  (``gpu_user_annotation``) on the card, the host ranges on the CPU;
- **collectives** are NCCL kernels (and the JAX package's collective op
  names, for reports read across packages);
- ``summarize_slices`` (copied) classifies them into compute / collective /
  host gap per scope and per program, with exposure by interval algebra;
- ``reconcile_profile`` (copied, with a kernel-count class) holds the
  measured view against the session's catalog (``catalog_from_watchdog``:
  each program's counted flops) and the session's counters, and the trace's
  kernel slices against the wrappers' launch counters, within
  ``PROFILE_REL_TOL``;
- ``diff_reports``, ``to_profile_trace_events`` and ``profile_main`` as in
  JAX; ``run_reconcile`` traces the port's own small GPT-2 engine.

Parsing is stdlib JSON; an unreadable trace, or one with no device slice on
the card, raises ``ProfileParseError`` instead of yielding zeros.
"""

import argparse
import glob
import gzip
import json
import os
import re
import sys

PROFILE_REPORT_VERSION = 1
PROFILE_REPORT_KIND = "profile_report"
PROFILE_RECONCILE_KIND = "profile_reconcile"
PROFILE_DIFF_KIND = "profile_diff"

# measured-vs-predicted-vs-derived reconciliation slack for the gated
# machine-independent pairs (counts, flops, wire bytes)
PROFILE_REL_TOL = 0.05
# step-wall sanity gate: measured trace extent vs telemetry's host step wall.
# Generous on purpose: profiler overhead and the window's first/last step
# edges land inside it.
PROFILE_STEP_WALL_REL_TOL = 0.5

# the named scopes the engines thread (the JAX package's set)
SCOPE_RE = re.compile(
    r"(ds_grad_bucket\d+|ds_fwd_bwd|ds_accumulate|ds_apply_update"
    r"|ring_rot\d+|ds_offload_\w+|ds_pipe_\w+)")
_BUCKET_SCOPE_RE = re.compile(r"ds_grad_bucket(\d+)")
# the range each watched program's calls run in (utils/telemetry.py)
PROGRAM_SCOPE_PREFIX = "ds_program/"

# collective op-name prefixes of the JAX package's traces, and NCCL's kernels
COLLECTIVE_PREFIXES = ("all-to-all", "all-gather", "all-reduce",
                       "reduce-scatter", "collective-permute")

# the device-side event categories of a Kineto trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_TRACE_DIR_RE = re.compile(r"^trace_(?P<run>[^_]+)_host(?P<host>\d+)$")


class ProfileParseError(ValueError):
    """A trace file or directory that cannot be ingested — malformed JSON,
    truncated gzip, a JSON object that is not a trace bundle, or a card's
    trace with no device slice. The parser refuses loudly instead of
    returning a silently-empty report."""


# ----------------------------------------------------------------- discovery
def scan_trace_dirs(trace_dir):
    """The per-run trace directories under a ``telemetry.trace_dir``:
    ``[{"run", "host", "path"}]`` sorted by (run, host); the layout is
    ``trace_<run>_host<h>/``. A trace written straight into ``trace_dir``
    (``run_id=""``) reports as ``{"run": "", "host": 0}``."""
    out = []
    if not os.path.isdir(trace_dir):
        return out
    if find_trace_files(trace_dir):
        out.append({"run": "", "host": 0, "path": trace_dir})
    for name in sorted(os.listdir(trace_dir)):
        m = _TRACE_DIR_RE.match(name)
        path = os.path.join(trace_dir, name)
        if m and os.path.isdir(path):
            out.append({"run": m.group("run"), "host": int(m.group("host")),
                        "path": path})
    out.sort(key=lambda d: (d["run"], d["host"]))
    return out


def find_trace_files(path):
    """Chrome-trace JSON files directly under one trace directory
    (``trace.json``, or any ``*.json`` / ``*.json.gz``), sorted. Accepts a
    file path too."""
    if os.path.isfile(path):
        return [path]
    files = []
    for pat in ("*.json", "*.json.gz"):
        files.extend(glob.glob(os.path.join(path, pat)))
    return sorted(files)


def load_trace(path):
    """Parse one Chrome-trace JSON (plain or gzipped). Raises
    :class:`ProfileParseError` on unreadable input or when the payload is
    not a ``traceEvents`` bundle."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
                data = json.load(f)
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                data = json.load(f)
    except (OSError, EOFError, ValueError) as e:
        raise ProfileParseError(f"unreadable trace {path!r}: {e}") from e
    if not isinstance(data, dict) or not isinstance(data.get("traceEvents"), list):
        raise ProfileParseError(
            f"{path!r} is not a trace bundle (no traceEvents list)")
    return data


def load_trace_dir(path):
    """Load every trace file of one trace dir and return ``(merged event
    list, [file paths])``. Raises :class:`ProfileParseError` when the
    directory holds no trace file."""
    files = find_trace_files(path)
    if not files:
        raise ProfileParseError(f"no trace files under {path!r} (expected trace.json)")
    events = []
    for f in files:
        events.extend(load_trace(f)["traceEvents"])
    return events, files


# ------------------------------------------------------------ classification
def _complete(events, cats):
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        try:
            ts = float(e["ts"])
            dur = float(e.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        out.append((ts, dur, str(e.get("name", "")), e))
    return out


def _outermost(rows):
    """The rows no other row of the same thread holds (host ops nest)."""
    out = []
    ends = {}
    for ts, dur, name, e in sorted(rows, key=lambda r: (r[0], -r[1])):
        key = (e.get("pid"), e.get("tid"))
        if ts < ends.get(key, float("-inf")):
            continue
        ends[key] = ts + dur
        out.append((ts, dur, name, e))
    return out


def _innermost(ranges, ts):
    """Name of the shortest range holding time ``ts``, or None."""
    best = None
    for a, dur, name in ranges:
        if a <= ts <= a + dur and (best is None or dur < best[0]):
            best = (dur, name)
    return best[1] if best else None


def device_slices(events, device="cuda"):
    """The device-timeline slices of a trace, ``[{"module", "op", "ts",
    "dur", "scope", "stream"}]`` in timestamp order: on the card the kernel,
    memcpy and memset events (``DEVICE_CATS``), attributed by the GPU-side
    ranges (``gpu_user_annotation``); on the CPU the outermost ``cpu_op``
    events, attributed by the host ranges (``user_annotation``).
    ``module`` is the watched program (``ds_program/<name>`` range; "" when
    none holds the slice), ``scope`` the innermost engine scope or None.
    On the card, a trace with no device slice raises
    :class:`ProfileParseError`."""
    if device == "cuda":
        rows = _complete(events, DEVICE_CATS)
        ann = _complete(events, ("gpu_user_annotation",))
        if not rows:
            raise ProfileParseError("the trace holds no kernel, memcpy or memset event "
                                    "on a GPU stream")
    else:
        rows = _outermost(_complete(events, ("cpu_op",)))
        ann = _complete(events, ("user_annotation",))
    progs = [(a, d, n[len(PROGRAM_SCOPE_PREFIX):]) for a, d, n, _ in ann
             if n.startswith(PROGRAM_SCOPE_PREFIX)]
    scopes = []
    for a, d, n, _ in ann:
        m = SCOPE_RE.search(n)
        if m and not n.startswith(PROGRAM_SCOPE_PREFIX):
            scopes.append((a, d, m.group(1)))
    out = []
    for ts, dur, name, e in rows:
        out.append({"module": _innermost(progs, ts) or "", "op": name, "ts": ts,
                    "dur": dur, "scope": _innermost(scopes, ts),
                    "stream": e.get("tid")})
    out.sort(key=lambda s: (s["ts"], s["op"]))
    return out


def is_collective_op(op_name):
    """True for a collective slice: an NCCL kernel, or a JAX collective
    instruction name (``all-reduce.8``, ...)."""
    return op_name.startswith(COLLECTIVE_PREFIXES) or "nccl" in op_name.lower()


def slice_scope(s, catalog=None):
    """Named scope of one device slice, or None: the range that held it
    (``device_slices``), else the catalog's, else a scope named in the op."""
    if s.get("scope"):
        return s["scope"]
    if catalog:
        prog = catalog.get(s["module"])
        if prog:
            scope = prog.get("scopes", {}).get(s["op"])
            if scope:
                return scope
    m = SCOPE_RE.search(s["op"])
    return m.group(1) if m else None


def slice_level(s, catalog=None):
    """"ici" or "dcn" for a collective slice: the catalog's classification
    where it has one, else "ici" (one node)."""
    if catalog:
        prog = catalog.get(s["module"])
        if prog:
            row = prog.get("collectives", {}).get(s["op"])
            if row:
                return row["level"]
    return "ici"


def kernel_counts(slice_names, names):
    """Per name of ``names``: the slices (``summarize_slices``'
    ``slice_names``: op name -> count) whose op name holds it."""
    return {n: sum(c for op, c in slice_names.items() if n in op) for n in names}


# ------------------------------------------------------------- interval math
def _union(intervals):
    """Merge (start, end) intervals; returns the disjoint sorted union."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _union_len(merged):
    return sum(b - a for a, b in merged)


def _subtract_len(merged_a, merged_b):
    """Total length of ``A \\ B`` for two disjoint sorted interval unions —
    the measured-exposure primitive (collective wire time not covered by
    compute)."""
    total = 0.0
    j = 0
    for a, b in merged_a:
        cur = a
        while j < len(merged_b) and merged_b[j][1] <= cur:
            j += 1
        k = j
        while cur < b:
            if k >= len(merged_b) or merged_b[k][0] >= b:
                total += b - cur
                cur = b
            else:
                lo, hi = merged_b[k]
                if lo > cur:
                    total += lo - cur
                cur = max(cur, min(hi, b))
                k += 1
    return total


def _us(x):
    """Deterministic microsecond rounding (same contract as anatomy._us —
    report fields are pure functions of the input trace)."""
    return round(x, 3)


# ------------------------------------------------------------------ catalog
def catalog_from_watchdog(watchdog):
    """{program: its facts} over a telemetry ``CompileWatchdog``: each
    watched program's counted flops (its newest signature's record). No
    program text exists, so the scope and collective catalogs are empty and
    the predicted wire bytes and exposure 0."""
    catalog = {}
    for name, sigs in watchdog.records.items():
        if not sigs:
            continue
        rec = list(sigs.values())[-1]
        catalog[name] = {
            "program": name,
            "scopes": {},
            "collectives": {},
            "flops": float(rec.flops),
            "wire_ici": 0,
            "wire_dcn": 0,
            "predicted_exposed_ici_us": 0.0,
            "predicted_exposed_dcn_us": 0.0,
        }
    return catalog


# ------------------------------------------------------------- summarization
def summarize_slices(slices, catalog=None, devices=1, steps=1,
                     peak_tflops=None):
    """The measured profile report over one window's device slices.

    Interval math runs on the union timeline across all device streams (the
    union is the quantity step wall actually pays). Exposure mirrors the anatomy pricing rule: exposed DCN is DCN wire
    time no compute covers; exposed ICI is ICI wire time covered by neither
    compute nor in-flight DCN (the cross-level overlap the bucketed exchange
    exists to create — docs/overlap.md)."""
    devices = max(int(devices), 1)
    steps = max(int(steps), 1)
    compute_iv, ici_iv, dcn_iv, all_iv = [], [], [], []
    bucket_iv = {}     # bucket -> {"ici": [...], "dcn": [...]}
    scope_rows = {}    # scope -> {"busy_us", "collective_us", "slices"}
    per_program = {}   # module -> {"slices", "intervals", "coll_counts"}
    slice_names = {}
    for s in slices:
        slice_names[s["op"]] = slice_names.get(s["op"], 0) + 1
        iv = (s["ts"], s["ts"] + s["dur"])
        all_iv.append(iv)
        coll = is_collective_op(s["op"])
        if not coll and catalog:
            prog = catalog.get(s["module"])
            if prog and s["op"] in prog.get("collectives", {}):
                coll = True
        scope = slice_scope(s, catalog) or "unattributed"
        row = scope_rows.setdefault(scope, {"busy_us": 0.0,
                                            "collective_us": 0.0, "slices": 0})
        row["busy_us"] += s["dur"]
        row["slices"] += 1
        pp = per_program.setdefault(s["module"], {
            "slices": 0, "intervals": [], "collective_counts": {}})
        pp["slices"] += 1
        pp["intervals"].append(iv)
        if coll:
            row["collective_us"] += s["dur"]
            level = slice_level(s, catalog)
            (ici_iv if level == "ici" else dcn_iv).append(iv)
            pp["collective_counts"][s["op"]] = (
                pp["collective_counts"].get(s["op"], 0) + 1)
            m = _BUCKET_SCOPE_RE.search(scope)
            if m:
                bucket_iv.setdefault(int(m.group(1)),
                                     {"ici": [], "dcn": []})[level].append(iv)
        else:
            compute_iv.append(iv)
    comp_u, ici_u, dcn_u = _union(compute_iv), _union(ici_iv), _union(dcn_iv)
    all_u = _union(all_iv)
    extent = (all_u[-1][1] - all_u[0][0]) if all_u else 0.0
    comp_or_dcn = _union(compute_iv + dcn_iv)
    buckets = {}
    for k, ivs in sorted(bucket_iv.items()):
        b_ici, b_dcn = _union(ivs["ici"]), _union(ivs["dcn"])
        buckets[str(k)] = {
            "collective_ici_us": _us(_union_len(b_ici)),
            "collective_dcn_us": _us(_union_len(b_dcn)),
            "exposed_ici_us": _us(_subtract_len(b_ici, comp_or_dcn)),
            "exposed_dcn_us": _us(_subtract_len(b_dcn, comp_u)),
        }
    programs = {}
    collective_counts = {}
    for module, pp in sorted(per_program.items()):
        busy_us = _union_len(_union(pp["intervals"]))
        row = {"slices": pp["slices"], "busy_us": _us(busy_us)}
        info = (catalog or {}).get(module)
        if pp["collective_counts"]:
            collective_counts[module] = dict(sorted(
                pp["collective_counts"].items()))
        if info:
            row["program"] = info["program"]
            row["flops"] = info["flops"]
            if peak_tflops and busy_us > 0:
                # per-program measured MFU: the watchdog's counted flops x
                # the window's executions over the program's busy wall on the
                # union timeline, against the stated peak
                row["measured_mfu"] = round(
                    (info["flops"] * steps)
                    / (busy_us * 1e-6 * peak_tflops * 1e12), 12)
        programs[module] = row
    measured_mfu = None
    if peak_tflops and extent > 0 and catalog:
        # same convention as TelemetrySession's rolling MFU: one program
        # execution contributes its counted flops once, priced against the
        # stated peak over the window's wall extent
        window_flops = sum(catalog[m]["flops"] * steps
                           for m in per_program if m in catalog)
        if window_flops > 0:
            measured_mfu = round(
                window_flops / (extent * 1e-6 * peak_tflops * 1e12), 12)
    return {
        "version": PROFILE_REPORT_VERSION,
        "kind": PROFILE_REPORT_KIND,
        "devices": devices,
        "steps": steps,
        "classes": {
            "compute": {"busy_us": _us(_union_len(comp_u))},
            "collective_ici": {
                "busy_us": _us(_union_len(ici_u)),
                "exposed_us": _us(_subtract_len(ici_u, comp_or_dcn)),
            },
            "collective_dcn": {
                "busy_us": _us(_union_len(dcn_u)),
                "exposed_us": _us(_subtract_len(dcn_u, comp_u)),
            },
            "host_gap": {"gap_us": _us(extent - _union_len(all_u))},
        },
        "step_wall_us": _us(extent / steps),
        "extent_us": _us(extent),
        "measured_mfu": measured_mfu,
        "total_slices": len(slices),
        "scopes": {k: {"busy_us": _us(v["busy_us"]),
                       "collective_us": _us(v["collective_us"]),
                       "slices": v["slices"]}
                   for k, v in sorted(scope_rows.items())},
        "buckets": buckets,
        "programs": programs,
        "collective_counts": collective_counts,
        "slice_names": slice_names,
    }


def measured_collective_counts(report, catalog):
    """Per-level measured collective executions per step per device —
    the machine-independent measured basis the reconciliation gates. Every
    collective of a program runs once per device per step, so the trace's
    slice count divided by (devices x steps) must equal the catalog's
    collective count."""
    denom = report["devices"] * report["steps"]
    counts = {"ici": 0.0, "dcn": 0.0}
    for module, ops in report.get("collective_counts", {}).items():
        prog = catalog.get(module, {})
        for op, c in ops.items():
            row = prog.get("collectives", {}).get(op)
            level = row["level"] if row else "ici"
            counts[level] += c / denom
    return {k: round(v, 6) for k, v in counts.items()}


# ------------------------------------------------------------ reconciliation
def _within(a, b, rel_tol):
    return abs(a - b) <= rel_tol * max(abs(a), abs(b), 1e-12)


def reconcile_profile(measured, catalog, derived, rel_tol=PROFILE_REL_TOL,
                      entry="", kernels=None):
    """Pin the three views against each other, per class, hbm-style.

    ``measured`` is a :func:`summarize_slices` report; ``catalog`` the
    watchdog catalog (:func:`catalog_from_watchdog`); ``derived`` the
    telemetry session's per-step counter view::

        {"flops_per_step", "wire_ici_per_step", "wire_dcn_per_step",
         "step_wall_ms" (optional)}

    Gated, machine-independent pairs per class:

    * ``compute`` — predicted flops/step (catalog, one execution per program
      per step) vs derived flops/step (the proxies' counters); measured
      compute busy time must be observed (>0) for the class to gate at all.
    * ``collective_ici`` / ``collective_dcn`` — measured slice executions per
      step per device vs the catalog's collective count, AND predicted
      vs derived wire bytes/step.
    * ``step_wall`` — measured trace extent per step vs telemetry's host step
      wall, at :data:`PROFILE_STEP_WALL_REL_TOL` (real seconds both, so gated
      only as a sanity check and excluded from the golden projection).
    * ``kernels`` (the port's, optional) — ``{name: launches}`` of the
      wrappers' launch counters over the window against the trace's kernel
      slices whose name holds ``name`` (``kernel_counts``): exactly equal.

    In the port the catalog holds no program text: its collective counts and
    wire bytes are 0, so the collective classes hold the measured NCCL
    kernels against that (a drift when the trace shows some). Verdicts: ``ok`` / ``drift`` / ``unobserved`` (the
    measured side saw nothing a prediction exists for — e.g. a trace window
    that closed before the program ran)."""
    classes = {}
    ok = True
    pred_flops = sum(p["flops"] for p in catalog.values())
    pred_counts = {"ici": 0, "dcn": 0}
    pred_wire = {"ici": 0, "dcn": 0}
    pred_exposed = {"ici": 0.0, "dcn": 0.0}
    for p in catalog.values():
        for row in p["collectives"].values():
            pred_counts[row["level"]] += 1
        pred_wire["ici"] += p["wire_ici"]
        pred_wire["dcn"] += p["wire_dcn"]
        pred_exposed["ici"] += p["predicted_exposed_ici_us"]
        pred_exposed["dcn"] += p["predicted_exposed_dcn_us"]
    meas_counts = measured_collective_counts(measured, catalog)

    row = {
        "measured_busy_us": measured["classes"]["compute"]["busy_us"],
        "predicted_flops_per_step": round(pred_flops, 3),
        "derived_flops_per_step": round(float(derived["flops_per_step"]), 3),
    }
    if row["measured_busy_us"] <= 0 and pred_flops > 0:
        row["status"] = "unobserved"
    elif _within(pred_flops, derived["flops_per_step"], rel_tol):
        row["status"] = "ok"
    else:
        row["status"] = "drift"
        ok = False
    classes["compute"] = row

    for level in ("ici", "dcn"):
        mc = meas_counts[level]
        pc = pred_counts[level]
        dw = int(derived[f"wire_{level}_per_step"])
        pw = pred_wire[level]
        row = {
            "measured_count_per_step_per_device": mc,
            "predicted_instruction_count": pc,
            "predicted_wire_bytes_per_step": pw,
            "derived_wire_bytes_per_step": dw,
            "measured_busy_us":
                measured["classes"][f"collective_{level}"]["busy_us"],
            "measured_exposed_us":
                measured["classes"][f"collective_{level}"]["exposed_us"],
            "predicted_exposed_us": _us(pred_exposed[level]),
        }
        if mc == 0 and pc > 0:
            row["status"] = "unobserved"
        elif _within(mc, pc, rel_tol) and _within(pw, dw, rel_tol):
            row["status"] = "ok"
        else:
            row["status"] = "drift"
            ok = False
        classes[f"collective_{level}"] = row

    if kernels:
        counted = kernel_counts(measured.get("slice_names", {}), kernels)
        row = {"measured": counted, "counted": dict(kernels)}
        if counted == dict(kernels):
            row["status"] = "ok"
        else:
            row["status"] = "drift"
            ok = False
        classes["kernels"] = row

    row = {"measured_step_wall_ms": round(measured["step_wall_us"] / 1e3, 6)}
    derived_wall = derived.get("step_wall_ms")
    if derived_wall:
        row["derived_step_wall_ms"] = round(float(derived_wall), 6)
        if _within(measured["step_wall_us"] / 1e3, derived_wall,
                   PROFILE_STEP_WALL_REL_TOL):
            row["status"] = "ok"
        else:
            row["status"] = "drift"
            ok = False
    else:
        row["status"] = "unobserved"
    classes["step_wall"] = row

    return {
        "version": PROFILE_REPORT_VERSION,
        "kind": PROFILE_RECONCILE_KIND,
        "entry": entry,
        "tolerance": {"rel": rel_tol,
                      "step_wall_rel": PROFILE_STEP_WALL_REL_TOL},
        "classes": classes,
        "scopes_observed": sorted(s for s in measured.get("scopes", {})
                                  if s != "unattributed"),
        "buckets_observed": sorted(measured.get("buckets", {}), key=int),
        "measured": measured,
        "ok": ok,
    }


def stable_projection(report):
    """The golden-pinnable slice of a reconcile report: verdicts, collective
    execution/instruction counts, wire bytes, flops, scope and bucket
    coverage — all pure functions of the compiled programs and the pinned
    8-device CPU mesh. Every wall-clock field (busy/exposed/step-wall
    microseconds) is excluded: those move with the machine; the structural
    facts must not."""
    classes = {}
    for cls, row in report["classes"].items():
        if cls == "step_wall":
            continue  # both sides are real seconds — never golden material
        keep = {k: v for k, v in row.items()
                if not k.endswith("_us") and not k.endswith("_ms")}
        classes[cls] = keep
    return {
        "version": report["version"],
        "kind": report["kind"] + "_golden",
        "entry": report["entry"],
        "tolerance": report["tolerance"],
        "classes": classes,
        "scopes_observed": report["scopes_observed"],
        "buckets_observed": report["buckets_observed"],
        "collective_counts": report["measured"]["collective_counts"],
        "ok": report["ok"],
    }


def diff_reports(old, new, rel_tol=PROFILE_REL_TOL):
    """Cross-run regression gate over two reconcile reports (full or golden
    projection): any class verdict that left ``ok``, any measured collective
    count or wire-byte growth beyond tolerance, any scope or bucket that
    disappeared from coverage."""
    regressions = []
    o_cls = old.get("classes", {})
    n_cls = new.get("classes", {})
    for cls in sorted(o_cls):
        o_row = o_cls[cls]
        n_row = n_cls.get(cls)
        if n_row is None:
            regressions.append(f"{cls}: class disappeared")
            continue
        if o_row.get("status") == "ok" and n_row.get("status") != "ok":
            regressions.append(
                f"{cls}: verdict regressed ok -> {n_row.get('status')}")
        for key in ("measured_count_per_step_per_device",
                    "predicted_wire_bytes_per_step"):
            ov, nv = o_row.get(key), n_row.get(key)
            if ov is None or nv is None:
                continue
            if nv > ov + rel_tol * max(abs(ov), 1e-12):
                regressions.append(f"{cls}/{key}: grew {ov} -> {nv}")
    for field in ("scopes_observed", "buckets_observed"):
        gone = sorted(set(old.get(field, [])) - set(new.get(field, [])))
        if gone:
            regressions.append(f"{field}: lost {gone}")
    return {"version": PROFILE_REPORT_VERSION, "kind": PROFILE_DIFF_KIND,
            "regressions": regressions, "ok": not regressions}


# -------------------------------------------------------------- merged timeline
def to_profile_trace_events(slices, catalog=None, predicted_reports=None):
    """Merged measured-vs-predicted Perfetto timeline: pid 0 carries the
    predicted schedule (one roofline-floor + exposed-comm thread pair per
    program, the tracks ``utils/anatomy.py`` draws), pinned ABOVE pid 1's
    measured device timeline (one thread per class) via process_sort_index.
    Measured slices are re-based to the window start so the two timebases
    align at 0."""
    from .trace_event import (complete_slice, process_name_event,
                              process_sort_index_event, thread_meta_events,
                              trace_envelope)
    events = [process_name_event(0, "predicted schedule"),
              process_sort_index_event(0, 0),
              process_name_event(1, "measured trace"),
              process_sort_index_event(1, 1)]
    if predicted_reports:
        from .anatomy import program_schedule_events
        for i, rep in enumerate(sorted(predicted_reports,
                                       key=lambda r: r["name"])):
            events += program_schedule_events(
                rep, pid=0, floor_tid=2 * i, comm_tid=2 * i + 1,
                sort_base=2 * i, label_prefix=rep["name"] + " ")
    class_tid = {"compute": 0, "collective_ici": 1, "collective_dcn": 2}
    for tid, name in ((0, "compute"), (1, "collective ici"),
                      (2, "collective dcn")):
        events += thread_meta_events(1, tid, name, sort_index=tid)
    t0 = min((s["ts"] for s in slices), default=0.0)
    for s in slices:
        coll = is_collective_op(s["op"])
        if not coll and catalog:
            prog = catalog.get(s["module"])
            coll = bool(prog and s["op"] in prog.get("collectives", {}))
        cls = (f"collective_{slice_level(s, catalog)}" if coll else "compute")
        args = {"module": s["module"]}
        scope = slice_scope(s, catalog)
        if scope:
            args["scope"] = scope
        events.append(complete_slice(
            1, class_tid[cls], _us(s["ts"] - t0), _us(s["dur"]), s["op"],
            cls.replace("_", "-"), args,
            cname="bad" if cls == "collective_dcn"
            else ("thread_state_iowait" if coll else None)))
    return trace_envelope(events, "ds-tpu profile",
                          measured_slices=len(slices),
                          trace_version=PROFILE_REPORT_VERSION)


# ---------------------------------------------------------- reconcile runner
RECONCILE_ENTRY = "gpt2_small"
RECONCILE_TRACE_STEPS = (3, 6)
RECONCILE_TOTAL_STEPS = 7
RECONCILE_MODEL = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=4,
                       use_flash_attention=True)


def run_reconcile(rel_tol=PROFILE_REL_TOL, trace_dir=None, device=None):
    """Train the port's small GPT-2 (``RECONCILE_MODEL``, ZeRO-2, Adam,
    bf16) with a profile-enabled trace window, ingest the window's trace and
    reconcile measured against predicted and derived, the flash kernels'
    slices against their launch counters on the card. Returns (report,
    slices, catalog). ``device``: cuda unless the caller asks for the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from .. import initialize
    from ..device import resolve_device
    from ..models.gpt2 import GPT2Config, GPT2Model
    from ..ops import flash_attention as fa

    device = resolve_device(device)
    own_dir = trace_dir is None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="ds_profile_reconcile_")
    model = GPT2Model(GPT2Config(**RECONCILE_MODEL), device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    engine, _, _, _ = initialize(model=model, device=device, config_params={
        "train_batch_size": 4, "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
        "telemetry": {"enabled": True, "trace_dir": trace_dir,
                      "trace_steps": list(RECONCILE_TRACE_STEPS),
                      "anatomy": {"enabled": True,
                                  "chip": "cpu-test" if device.type == "cpu" else ""},
                      "profile": {"enabled": True, "reconcile_tolerance": rel_tol}}})
    try:
        session = engine.telemetry
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, RECONCILE_MODEL["vocab_size"], size=(
            4, RECONCILE_MODEL["n_positions"])).astype(np.int64)).to(device)
        labels = torch.roll(tokens, -1, 1)
        a, b = RECONCILE_TRACE_STEPS
        launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                     fa.flash_attention_bwd_dkv)
        base = None
        for step in range(RECONCILE_TOTAL_STEPS):
            if step == a:
                base = [f.launches for f in launchers]
            if step == b:
                moved = [f.launches - c for f, c in zip(launchers, base)]
            loss = engine(tokens, labels)
            engine.backward(loss)
            engine.step()
        catalog = catalog_from_watchdog(session.watchdog)
        prof = session.last_profile
        if prof is None:
            raise ProfileParseError("the trace window closed without an ingest")
        classes = prof["reconcile"]["classes"]
        kernels = (dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), moved))
                   if device.type == "cuda" else None)
        report = reconcile_profile(prof, catalog, {
            "flops_per_step": classes["compute"]["derived_flops_per_step"],
            "wire_ici_per_step": 0, "wire_dcn_per_step": 0,
            "step_wall_ms": classes["step_wall"].get("derived_step_wall_ms")},
            rel_tol=rel_tol, entry=RECONCILE_ENTRY, kernels=kernels)
        report["entry"] = RECONCILE_ENTRY
        events, _files = load_trace_dir(session.trace_output_dir)
        slices = device_slices(events, device=device.type)
        return report, slices, catalog
    finally:
        engine.telemetry.close()
        if own_dir:
            shutil.rmtree(trace_dir, ignore_errors=True)


# ------------------------------------------------------------------- CLI
def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _resolve_source(path):
    """A positional source can be a trace file, a trace dir, or a telemetry
    ``trace_dir`` holding per-run dirs — pick the newest run."""
    if os.path.isfile(path):
        return path
    if find_trace_files(path):
        return path
    runs = scan_trace_dirs(path)
    candidates = [r["path"] for r in runs if find_trace_files(r["path"])]
    if candidates:
        return candidates[-1]
    raise ProfileParseError(
        f"no trace files under {path!r} — expected a Chrome-trace JSON, a "
        "trace dir or a telemetry trace_dir with trace_<run>_host<h>/ subdirs")


def profile_main(argv=None):
    """The measured-time observatory's CLI. Default mode ingests a trace (dir
    or file) into the ``--json`` report; ``--reconcile`` runs the traced
    small GPT-2 window (``run_reconcile``, on ``--device``) and gates
    measured vs predicted vs derived (exit 1 on drift); ``--diff A B`` is
    the host-only cross-run regression gate."""
    parser = argparse.ArgumentParser(
        prog="profile",
        description="profiler-trace ingestion: classify device slices per "
                    "scope, reconcile measured/predicted/derived step time")
    parser.add_argument("source", nargs="?", metavar="TRACE",
                        help="trace file, profiler dir, or telemetry "
                             "trace_dir (newest namespaced run wins)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON on stdout")
    parser.add_argument("--out", metavar="PATH",
                        help="also write the JSON report to PATH")
    parser.add_argument("--golden-out", metavar="PATH",
                        help="write the stable (golden-pinnable) projection "
                             "of a --reconcile report to PATH")
    parser.add_argument("--timeline", metavar="PATH",
                        help="write the merged measured-vs-predicted "
                             "Perfetto trace")
    parser.add_argument("--reconcile", action="store_true",
                        help="run the traced small GPT-2 window and gate "
                             "measured vs predicted vs derived (exit 1 on "
                             "drift)")
    parser.add_argument("--device", default=None,
                        help="device of --reconcile (default: cuda)")
    parser.add_argument("--host-ops", action="store_true",
                        help="ingest a CPU trace: the outermost host ops are "
                             "the slices")
    parser.add_argument("--tolerance", type=float, default=PROFILE_REL_TOL,
                        help="reconciliation relative tolerance "
                             "(default: %(default)s)")
    parser.add_argument("--devices", type=int, default=1,
                        help="device count normalizing ingested slice counts "
                             "(default: 1)")
    parser.add_argument("--steps", type=int, default=1,
                        help="optimizer steps the ingested window spans "
                             "(default: 1; --reconcile derives it)")
    parser.add_argument("--peak-tflops", type=float, default=0.0,
                        help="peak TFLOP/s pricing measured MFU (default: "
                             "off)")
    parser.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                        help="compare two reconcile reports; exit 1 on any "
                             "regression")
    args = parser.parse_args(argv)

    slices = catalog = None
    if args.diff:
        report = diff_reports(_load_json(args.diff[0]),
                              _load_json(args.diff[1]),
                              rel_tol=args.tolerance)
    elif args.reconcile:
        try:
            report, slices, catalog = run_reconcile(rel_tol=args.tolerance,
                                                    device=args.device)
        except ProfileParseError as e:
            print(f"ERROR {e}", file=sys.stderr)
            return 1
    else:
        if not args.source:
            parser.error("a TRACE source is required unless --reconcile or "
                         "--diff is given")
        try:
            source = _resolve_source(args.source)
            events, files = load_trace_dir(source) \
                if not os.path.isfile(source) \
                else (load_trace(source)["traceEvents"], [source])
            slices = device_slices(events, device="cpu" if args.host_ops else "cuda")
            report = summarize_slices(
                slices, devices=args.devices, steps=args.steps,
                peak_tflops=args.peak_tflops or None)
            report["source"] = sorted(os.path.relpath(f, args.source)
                                      if not os.path.isfile(args.source)
                                      else f for f in files)
        except ProfileParseError as e:
            print(f"ERROR {e}", file=sys.stderr)
            return 1

    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.golden_out and report.get("kind") == PROFILE_RECONCILE_KIND:
        with open(args.golden_out, "w") as f:
            f.write(json.dumps(stable_projection(report), indent=2,
                               sort_keys=True) + "\n")
    if args.timeline and slices is not None:
        from .trace_event import serialize_trace
        with open(args.timeline, "w") as f:
            f.write(serialize_trace(to_profile_trace_events(slices, catalog=catalog)))
    if args.json:
        sys.stdout.write(text)
    else:
        _print_report(report)
    return 0 if report.get("ok", True) else 1


def _print_report(report):
    kind = report.get("kind")
    if kind == PROFILE_RECONCILE_KIND:
        for cls, row in sorted(report["classes"].items()):
            print(f"{cls}: [{row['status']}]")
            for k, v in sorted(row.items()):
                if k != "status":
                    print(f"  {k:<36} {v}")
        print(f"scopes: {', '.join(report['scopes_observed']) or '(none)'}; "
              f"buckets: {', '.join(report['buckets_observed']) or '(none)'}")
        print("reconciled" if report["ok"] else "DRIFT")
    elif kind == PROFILE_DIFF_KIND:
        for r in report["regressions"]:
            print(f"REGRESSION {r}")
        print(f"{len(report['regressions'])} regression(s)")
    elif kind == PROFILE_REPORT_KIND:
        for cls, row in sorted(report["classes"].items()):
            facts = "  ".join(f"{k} {v}" for k, v in sorted(row.items())
                              if v is not None)
            print(f"{cls}: {facts}")
        print(f"step wall {report['step_wall_us']}us over "
              f"{report['steps']} step(s), {report['total_slices']} device "
              f"slice(s)")
        for scope, row in sorted(report["scopes"].items()):
            print(f"  scope {scope:<18} busy {row['busy_us']:>12}us  "
                  f"collective {row['collective_us']:>12}us")
        for k, row in sorted(report["buckets"].items(), key=lambda kv:
                             int(kv[0])):
            print(f"  bucket {k}: exposed ici {row['exposed_ici_us']}us / "
                  f"dcn {row['exposed_dcn_us']}us")


if __name__ == "__main__":
    sys.exit(profile_main())
