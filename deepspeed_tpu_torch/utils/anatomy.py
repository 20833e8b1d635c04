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
are copied; ``anatomy_main`` renders saved reports, or sweeps the lint
registry (``registry_reports``: each program of each ported entry run once
under the flop and byte counters). The flat-against-hierarchical comparison
across entries (``comm_compare``, ``_registry_slice_sets``) comes with the
communication modes' entries (ROADMAP.md item 18): every ported entry runs
at one rank.
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


def analyze_program(record, spec, slices=None, name=""):
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
    of the other streams cover of it."""
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
    exposed = {"ici": sum(r["exposed_s"] for r in rows), "dcn": 0.0}
    return {
        "name": name,
        "flops": flops,
        "hbm_bytes": hbm_bytes,
        "collectives": rows,
        "wire_bytes": {"ici": 0, "dcn": 0},
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


def registry_reports(entries=None, spec=None, device="cuda"):
    """``(reports, errors)``: ``analyze_program`` of every program of the
    lint registry's entries (default: the ported ones), each run once under
    the flop and byte counters (``utils/flops_profiler.py`` ``count``) on
    ``device``; no trace window, so no measured collective rows."""
    from ..lint import registry
    from .flops_profiler import count
    reports, errors = [], []
    for entry in (list(entries) if entries else registry.PORTED):
        try:
            engine, batch = registry.build_entry(entry, device)
            for name, fn, args, _man in engine.lint_programs(batch):
                _, flops, nbytes, _ = count(fn, *args)
                reports.append(analyze_program({"flops": flops, "hbm_bytes": nbytes}, spec,
                                               name=f"{entry}:{name}"))
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
    parser.add_argument("--opportunity-min-bytes", type=int,
                        default=DEFAULT_OPPORTUNITY_MIN_BYTES,
                        help="ignore zero-overlap collectives below this wire size "
                             "(default: %(default)s)")
    args = parser.parse_args(argv)
    errors = []
    if args.report:
        with open(args.report) as f:
            saved = json.load(f)
        reports = saved["programs"] if isinstance(saved, dict) else saved
    else:
        from .logging import log_to_stderr
        from .roofline import resolve_spec
        log_to_stderr()      # stdout belongs to the report
        reports, errors = registry_reports(args.entry, resolve_spec(args.chip), args.device)
    reports = sorted(reports, key=lambda r: r["name"])
    report = {
        "version": ANATOMY_REPORT_VERSION,
        "kind": ANATOMY_REPORT_KIND,
        "programs": [_program_json(r) for r in reports],
        "opportunities": opportunities(reports, min_bytes=args.opportunity_min_bytes),
        "errors": sorted(errors),
        "ok": not errors,
    }
    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
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
        for e in report["errors"]:
            print(f"ERROR {e}")
        print(f"{len(report['programs'])} program(s), "
              f"{len(report['opportunities'])} opportunity(ies)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(anatomy_main())
