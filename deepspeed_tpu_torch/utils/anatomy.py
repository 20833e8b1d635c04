"""Step-time anatomy: roofline ledger and measured overlap per program
(PyTorch port of ``deepspeed_tpu/utils/anatomy.py``).

The JAX module analyzes the optimized HLO text of each compiled program:
its collectives' ``-start``/``-done`` windows, priced by the roofline. Eager
PyTorch has no program text. ``analyze_program`` here takes a program
record instead: its counted flops and bytes (``utils/flops_profiler.py``,
the telemetry watchdog's record) and, when a trace window measured it, its
device slices (``utils/profile_ingest.py`` ``device_slices``). Each NCCL
kernel slice is a collective row, its overlap the part of its interval that
compute kernels on other streams cover, the rest exposed; at world 1 there
is none, so the exposed collective time is 0. With the roofline floors
(``utils/roofline.py``) that gives the compute floor, the HBM floor, the
exposed collective seconds, the predicted step floor and the MFU ceiling.

``opportunities``, ``program_schedule_events``, ``to_anatomy_trace_events``
and ``comm_compare`` are copied; ``anatomy_main`` renders saved reports, or
sweeps the lint registry (``registry_reports``: each program of each ported
entry run once under the flop and byte counters and recorded at the
dispatcher). A recorded program's collectives (the communication entries
run at 8 ranks in a fake process group) become rows of their own: the
level by their group against the slices (``_registry_slice_sets``), the
bytes what one rank receives, priced at the spec's link rate and counted
exposed whole, since a recording measures no overlap. ``comm_compare`` over
the sweep's entries compares the exchanges' exposed cross-slice time; its
overlap clause needs measured windows, so the sweep reports it and does
not gate on it.
"""

import argparse
import json
import re
import sys

from .profile_ingest import _union, is_collective_op
from .roofline import roofline
from .trace_event import (complete_slice, process_name_event, serialize_trace,
                          thread_meta_events, trace_envelope)

ANATOMY_REPORT_VERSION = 1
ANATOMY_REPORT_KIND = "anatomy_report"

# zero-overlap collectives below this wire size are noise (scalar loss
# all-reduces, norm all-reduces), not optimization opportunities
DEFAULT_OPPORTUNITY_MIN_BYTES = 1024

_BUCKET_RE = re.compile(r"ds_grad_bucket(\d+)")


def _us(seconds):
    """Deterministic microsecond rounding for report/timeline fields."""
    return round(seconds * 1e6, 3)


def _covered(a, b, merged):
    """Length of [a, b) covered by a disjoint sorted interval union."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi in merged)


def _field(record, key):
    return float(record[key] if isinstance(record, dict) else getattr(record, key))


def recorded_collectives(program, slice_sets):
    """``[(kind, level, bytes)]`` of a recorded program's collectives
    (``utils/op_record.py``): ``ici`` when the op's group lies in one slice
    set (one rank's group: its ranks, or none), else ``dcn``."""
    from .op_record import dtype_bytes
    sets = [frozenset(x) for x in slice_sets]
    rows = []
    for r in program.ops:
        if r.kind is None:
            continue
        group = set(r.group or ())
        intra = len(sets) <= 1 or not group or any(group <= x for x in sets)
        rows.append((r.kind, "ici" if intra else "dcn",
                     sum(n * (dtype_bytes(dt) or 0) for dt, n in r.results)))
    return rows


def analyze_program(record, spec, slices=None, name="", recorded=None):
    """The anatomy of one program from its record (``flops`` and
    ``hbm_bytes``: a dict or the watchdog's ``CompileRecord``) and, when
    given, its measured device slices (``[{"op", "ts", "dur", "stream",
    "scope"}]``, microseconds).

    Returns ``{"name", "flops", "hbm_bytes", "collectives": [...],
    "wire_bytes": {"ici", "dcn"}, "exposed_s": {"ici", "dcn"},
    "roofline": {...}}``, the JAX report's keys. Each collective row (an NCCL
    kernel slice) carries ``{"instruction", "op", "line", "level", "bytes",
    "async", "zero_overlap", "bucket", "comm_s", "overlap_s",
    "exposed_s"}``: its bytes are None (no program text gives them), it is
    ``async`` (its own stream), and its overlap is what the compute slices
    of the other streams cover of it. ``recorded`` (``recorded_collectives``)
    adds a row a recorded collective, priced at the link rate of its level
    and exposed whole."""
    from .profile_ingest import is_collective_op
    flops = _field(record, "flops")
    hbm_bytes = _field(record, "hbm_bytes")
    slices = list(slices or ())
    compute = [s for s in slices if not is_collective_op(s["op"])]
    rows = []
    for i, s in enumerate(sorted((s for s in slices if is_collective_op(s["op"])),
                                 key=lambda s: s["ts"])):
        a, b = s["ts"], s["ts"] + s["dur"]
        others = _union((c["ts"], c["ts"] + c["dur"]) for c in compute
                        if c.get("stream") != s.get("stream"))
        comm_s = s["dur"] * 1e-6
        overlap_s = _covered(a, b, others) * 1e-6
        m = _BUCKET_RE.search(s.get("scope") or "")
        rows.append({
            "instruction": s["op"], "op": "nccl", "line": i, "level": "ici",
            "bytes": None, "async": True, "zero_overlap": overlap_s <= 0.0,
            "bucket": int(m.group(1)) if m else None,
            "comm_s": comm_s, "overlap_s": overlap_s, "exposed_s": comm_s - overlap_s,
        })
    wire = {"ici": 0, "dcn": 0}
    for kind, level, nbytes in recorded or ():
        comm_s = nbytes / (spec.link_gbps(level) * 1e9)
        wire[level] += nbytes
        rows.append({
            "instruction": f"{kind}.{len(rows)}", "op": kind, "line": len(rows),
            "level": level, "bytes": nbytes, "async": False, "zero_overlap": True,
            "bucket": None, "comm_s": comm_s, "overlap_s": 0.0, "exposed_s": comm_s,
        })
    exposed = {lvl: sum(r["exposed_s"] for r in rows if r["level"] == lvl)
               for lvl in ("ici", "dcn")}
    return {
        "name": name,
        "flops": flops,
        "hbm_bytes": hbm_bytes,
        "collectives": rows,
        "wire_bytes": wire,
        "exposed_s": exposed,
        "roofline": roofline(flops, hbm_bytes, exposed["ici"], exposed["dcn"], spec),
    }


def opportunities(reports, min_bytes=DEFAULT_OPPORTUNITY_MIN_BYTES):
    """Named optimization opportunities: every zero-overlap collective moving
    at least ``min_bytes`` (a measured row, whose bytes no program text
    gives, counts whatever its size), sorted largest wire first, then most
    exposed. Each row names the program and the collective."""
    out = []
    for report in reports:
        for r in report["collectives"]:
            if not r["zero_overlap"] or (r["bytes"] is not None
                                         and r["bytes"] < min_bytes):
                continue
            if r["bytes"] is None:
                hint = ("NCCL kernel with no compute kernel beside it on another "
                        "stream — issue independent compute before waiting on it")
            elif not r["async"]:
                hint = ("synchronous collective — no -start/-done window exists; "
                        "restructure so independent compute can overlap the wire")
            else:
                hint = ("async window hides nothing — schedule independent "
                        "compute between -start and -done")
            out.append({
                "program": report["name"], "instruction": r["instruction"],
                "op": r["op"], "level": r["level"], "bytes": r["bytes"],
                "exposed_us": _us(r["exposed_s"]), "hint": hint,
            })
    out.sort(key=lambda o: (-(o["bytes"] or 0),
                            -o["exposed_us"] if o["bytes"] is None else 0.0,
                            o["program"], o["instruction"]))
    return out


def _program_json(report):
    """The deterministic per-program report block (seconds -> rounded µs)."""
    rf = report["roofline"]
    return {
        "name": report["name"],
        "flops": report["flops"],
        "hbm_bytes": report["hbm_bytes"],
        "wire_bytes": dict(report["wire_bytes"]),
        "collectives": [{
            "instruction": r["instruction"], "op": r["op"],
            "level": r["level"], "bytes": r["bytes"], "async": r["async"],
            "zero_overlap": r["zero_overlap"], "bucket": r["bucket"],
            "comm_us": _us(r["comm_s"]),
            "overlap_us": _us(r["overlap_s"]),
            "exposed_us": _us(r["exposed_s"]),
        } for r in report["collectives"]],
        "roofline": {
            "compute_floor_us": _us(rf["compute_floor_s"]),
            "hbm_floor_us": _us(rf["hbm_floor_s"]),
            "exposed_ici_us": _us(rf["exposed_ici_s"]),
            "exposed_dcn_us": _us(rf["exposed_dcn_s"]),
            "predicted_floor_us": _us(rf["predicted_floor_s"]),
            "mfu_ceiling": round(rf["mfu_ceiling"], 4),
        },
        "memory": report.get("memory"),
    }


def program_schedule_events(report, pid, floor_tid=0, comm_tid=1,
                            sort_base=0, label_prefix=""):
    """The predicted-schedule track pair of ONE program report: the binding
    compute/HBM floor slice on ``floor_tid``, the exposed collectives laid end
    to end after it on ``comm_tid``. Shared between ``to_anatomy_trace_events``'
    per-program processes and ``utils/profile_ingest.py``'s merged
    measured-vs-predicted timeline (which stacks every program's pair inside
    one "predicted schedule" process, hence the tid/label knobs)."""
    rf = report["roofline"]
    events = []
    events += thread_meta_events(pid, floor_tid,
                                 label_prefix + "roofline floor",
                                 sort_index=sort_base)
    events += thread_meta_events(pid, comm_tid, label_prefix + "exposed comm",
                                 sort_index=sort_base + 1)
    bound_s = max(rf["compute_floor_s"], rf["hbm_floor_s"])
    binding = ("compute floor"
               if rf["compute_floor_s"] >= rf["hbm_floor_s"]
               else "hbm floor")
    events.append(complete_slice(
        pid, floor_tid, 0, _us(bound_s), binding, "roofline",
        {"compute_floor_us": _us(rf["compute_floor_s"]),
         "hbm_floor_us": _us(rf["hbm_floor_s"]),
         "mfu_ceiling": round(rf["mfu_ceiling"], 4)}))
    ts = _us(bound_s)
    for r in report["collectives"]:
        if r["exposed_s"] <= 0:
            continue
        dur = _us(r["exposed_s"])
        events.append(complete_slice(
            pid, comm_tid, ts, dur, f"{r['op']} ({r['level']})",
            "exposed-comm",
            {"instruction": r["instruction"], "bytes": r["bytes"],
             "zero_overlap": r["zero_overlap"],
             "overlap_us": _us(r["overlap_s"])},
            cname="terrible" if r["zero_overlap"] else "bad"))
        ts += dur
    return events


def to_anatomy_trace_events(reports):
    """Predicted-schedule Perfetto timeline: one process per program (sorted),
    thread 0 carrying the binding compute/HBM floor slice, thread 1 the
    exposed collectives laid end to end after it — the picture of where the
    model says the step time must go. Zero-overlap collectives render in the
    alert color."""
    events = []
    for pid, report in enumerate(sorted(reports, key=lambda r: r["name"])):
        events.append(process_name_event(pid, report["name"]))
        events += program_schedule_events(report, pid)
    return trace_envelope(events, "ds-tpu anatomy",
                          programs=len(reports),
                          trace_version=ANATOMY_REPORT_VERSION)


def comm_compare(entry_reports):
    """The flat-vs-hierarchical-vs-compressed-vs-overlap exchange comparison
    (the JAX function): summed exposed cross-slice time and wire bytes per
    registry entry, plus each mode's reduction over the flat exchange.
    ``ok`` iff every two-level mode exposes strictly less cross-slice time
    than flat, AND the bucketed overlap exposes strictly less than the
    monolithic hierarchical exchange with exactly zero exposed intra-slice
    time on its bucket-tagged collectives."""
    modes = {"flat": "standard", "hierarchical": "comm_hierarchical",
             "compressed": "comm_compressed", "overlap": "comm_overlap"}
    if not all(entry in entry_reports for entry in modes.values()):
        return None
    out = {}
    for mode, entry in modes.items():
        reports = entry_reports[entry]
        out[mode] = {
            "entry": entry,
            "exposed_dcn_us": _us(sum(r["exposed_s"]["dcn"] for r in reports)),
            "exposed_ici_us": _us(sum(r["exposed_s"]["ici"] for r in reports)),
            "wire_dcn_bytes": sum(r["wire_bytes"]["dcn"] for r in reports),
            "wire_ici_bytes": sum(r["wire_bytes"]["ici"] for r in reports),
        }
    out["overlap"]["grad_ici_exposed_us"] = _us(sum(
        c["exposed_s"] for r in entry_reports["comm_overlap"]
        for c in r["collectives"]
        if c["bucket"] is not None and c["level"] == "ici"))
    flat_dcn = out["flat"]["exposed_dcn_us"]
    reductions = {}
    for mode in ("hierarchical", "compressed", "overlap"):
        reductions[mode] = (round(1.0 - out[mode]["exposed_dcn_us"] / flat_dcn, 4)
                            if flat_dcn > 0 else 0.0)
    out["exposed_dcn_reduction_vs_flat"] = reductions
    out["ok"] = (flat_dcn > out["hierarchical"]["exposed_dcn_us"]
                 and flat_dcn > out["compressed"]["exposed_dcn_us"]
                 and (out["hierarchical"]["exposed_dcn_us"]
                      > out["overlap"]["exposed_dcn_us"])
                 and out["overlap"]["grad_ici_exposed_us"] == 0.0)
    return out


def _registry_slice_sets():
    """Rank slice sets of the registry's communication entries: the same
    2-slice factorization of 8 ranks they train on (``dcn_slices: 2``)."""
    from ..comm.topology import CommTopology, derive_num_slices
    from ..lint.registry import ENTRY_WORLD
    n = ENTRY_WORLD["comm_hierarchical"]
    topo = CommTopology(n, derive_num_slices(n, process_count=1))
    return [frozenset(g) for g in topo.ici_groups]


def registry_reports(entries=None, spec=None, device="cuda", by_entry=None):
    """``(reports, errors)``: ``analyze_program`` of every program of the
    lint registry's entries (default: the ported ones), each run once under
    the flop and byte counters (``utils/flops_profiler.py`` ``count``) and
    recorded at the dispatcher, on ``device``; no trace window, so its
    collective rows are the recorded ones (``recorded_collectives``).
    ``by_entry``, a dict, also gets each entry's reports."""
    from ..lint import registry
    from .flops_profiler import count
    from .op_record import record
    slice_sets = _registry_slice_sets()
    reports, errors = [], []
    for entry in (list(entries) if entries else registry.PORTED):
        try:
            with registry.entry_world(entry):
                engine, batch = registry.build_entry(entry, device)
                mine = []
                for name, fn, args, _man in engine.lint_programs(batch):
                    prog = record(count, fn, *args)
                    _, flops, nbytes, _ = prog.result
                    mine.append(analyze_program(
                        {"flops": flops, "hbm_bytes": nbytes}, spec, name=f"{entry}:{name}",
                        recorded=recorded_collectives(prog, slice_sets)))
            reports += mine
            if by_entry is not None:
                by_entry[entry] = mine
        except Exception as e:      # one entry's failure is reported, not fatal
            errors.append(f"{entry}: capture failed: {e!r}")
    return reports, errors


def anatomy_main(argv=None):
    """The anatomy report: ``--report PATH`` renders saved ``analyze_program``
    reports (a JSON list, or ``{"programs": [...]}``); without it, the
    sweep over the lint registry's programs (``--entry``, ``--device``,
    priced by ``--chip``). Prints each program's floor and the
    opportunities, writes ``--timeline`` (the predicted schedule) and
    ``--out`` (the JSON report). Exit 1 when an entry fails to capture."""
    parser = argparse.ArgumentParser(
        prog="anatomy", description="roofline ledger and measured overlap per program")
    parser.add_argument("--report", metavar="PATH",
                        help="saved analyze_program reports (JSON); default: sweep the "
                             "lint registry")
    parser.add_argument("--entry", action="append", metavar="NAME",
                        help="limit the sweep to a lint-registry entry (repeatable)")
    parser.add_argument("--device", default="cuda",
                        help="device of the sweep's engines (default: cuda)")
    parser.add_argument("--chip", default="",
                        help="chip spec to price against ('' detects the card)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON on stdout")
    parser.add_argument("--out", metavar="PATH", help="also write the JSON report to PATH")
    parser.add_argument("--timeline", metavar="PATH",
                        help="write the predicted-schedule Perfetto trace")
    parser.add_argument("--comm-compare-out", metavar="PATH",
                        help="write the flat-vs-hierarchical comparison JSON")
    parser.add_argument("--opportunity-min-bytes", type=int,
                        default=DEFAULT_OPPORTUNITY_MIN_BYTES,
                        help="ignore zero-overlap collectives below this wire size "
                             "(default: %(default)s)")
    args = parser.parse_args(argv)
    errors = []
    compare = None
    if args.report:
        with open(args.report) as f:
            saved = json.load(f)
        reports = saved["programs"] if isinstance(saved, dict) else saved
    else:
        from .logging import log_to_stderr
        from .roofline import resolve_spec
        log_to_stderr()      # stdout belongs to the report
        by_entry = {}
        reports, errors = registry_reports(args.entry, resolve_spec(args.chip), args.device,
                                           by_entry=by_entry)
        compare = comm_compare(by_entry)
    reports = sorted(reports, key=lambda r: r["name"])
    report = {
        "version": ANATOMY_REPORT_VERSION,
        "kind": ANATOMY_REPORT_KIND,
        "programs": [_program_json(r) for r in reports],
        "opportunities": opportunities(reports, min_bytes=args.opportunity_min_bytes),
        "comm_compare": compare,
        "errors": sorted(errors),
        "ok": not errors,
    }
    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.comm_compare_out:
        with open(args.comm_compare_out, "w") as f:
            f.write(json.dumps(compare, indent=2, sort_keys=True) + "\n")
    if args.timeline:
        with open(args.timeline, "w") as f:
            f.write(serialize_trace(to_anatomy_trace_events(reports)))
    if args.json:
        sys.stdout.write(text)
    else:
        for r in report["programs"]:
            rf = r["roofline"]
            print(f"{r['name']}: floor {rf['predicted_floor_us']}us "
                  f"(compute {rf['compute_floor_us']}us, hbm "
                  f"{rf['hbm_floor_us']}us, exposed ici "
                  f"{rf['exposed_ici_us']}us / dcn {rf['exposed_dcn_us']}us) "
                  f"mfu ceiling {rf['mfu_ceiling']}")
        for o in report["opportunities"]:
            print(f"OPPORTUNITY {o['program']}#{o['instruction']}: {o['op']} "
                  f"({o['level']}, {o['bytes']} B, {o['exposed_us']}us "
                  f"exposed) — {o['hint']}")
        if compare is not None:
            red = compare["exposed_dcn_reduction_vs_flat"]
            print(f"comm compare: flat {compare['flat']['exposed_dcn_us']}us exposed DCN; "
                  f"hierarchical -{round(red['hierarchical'] * 100, 2)}%, compressed "
                  f"-{round(red['compressed'] * 100, 2)}%, overlap "
                  f"-{round(red['overlap'] * 100, 2)}% (recorded, overlap not measured)")
        for e in report["errors"]:
            print(f"ERROR {e}")
        print(f"{len(report['programs'])} program(s), "
              f"{len(report['opportunities'])} opportunity(ies)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(anatomy_main())
