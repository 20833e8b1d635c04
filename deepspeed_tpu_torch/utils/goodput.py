"""PyTorch port: a copy of ``deepspeed_tpu/utils/goodput.py`` (lines 1-619:
``RunLedger``, ``fleet_goodput``, ``goodput_timeline``, render/diff and
``goodput_main``), host-only; the bundles are the JAX package's byte for
byte. The training engine carves the ``AsyncCheckpointer`` snapshot fence
(``resilience/async_ckpt.py`` ``last_stall_ms``) as ``checkpoint_stall``.

Run-lifecycle goodput observatory: the badput ledger.

Every other observatory in the repo accounts for one subsystem — step anatomy
(Anatomy/*), pipeline bubbles (Pipeline/Goodput/*), serving requests
(Serving/*), cluster hangs/stragglers (Cluster/*), resilience events. None of
them answers the run-level question: of the wall-clock between engine
construction and exit, what fraction was productive training, and where did
the rest go? That fraction — *goodput* — is the metric that decides whether a
fleet can run on preemptible capacity, and both Google's ML Goodput
methodology and the MegaScale production-diagnostics work converged on the
same shape for it: one goodput number plus an exhaustive, mutually-exclusive
badput decomposition.

:class:`RunLedger` is that decomposition. It opens at engine construction and
classifies every wall-clock interval of the run into exactly one of a closed
taxonomy:

==================  ===========================================================
class               source of truth
==================  ===========================================================
``init``            engine construction -> first train step (minus compile)
``compile``         compile-watchdog record seconds (CompileWatchdog)
``productive_step`` step wall remaining after all carve-outs
``checkpoint_stall``AsyncCheckpointer snapshot-fence time (``last_stall_ms``)
``restart_replay``  steps re-run between the restore point and the pre-crash
                    step (flight-recorder ``first_bad_step``)
``hang``            steps during which the cluster hang watchdog fired
``straggler_skew``  this host's dispatch time above the fleet median
                    (cluster heartbeat dispatch column)
``eval``            forward-only evaluation intervals
``host_gap``        residual — wall not claimed by any other class
==================  ===========================================================

The partition invariant — asserted in tests/unit/test_goodput.py — is that
the class seconds sum to the run wall-clock exactly (to float tolerance) with
no interval double-counted. It holds *by construction*: the ledger keeps a
single monotonic cursor; every boundary event classifies the span since the
cursor, carve-outs are clamped to the span, and the remainder goes to the
interval's base class. There is no second clock to disagree with.

Everything here is host-side arithmetic over timestamps other layers already
took: no jax import, no device fetch, nothing under the AST no-host-sync
guard. With ``telemetry.goodput`` enabled the lowered step program is
HLO-instruction-identical to a build without it.

Surfaces: per-run JSON beside the flight-recorder dumps
(``goodput_<run>_host<h>.json``), ``Run/Goodput/*`` scalars through
``TelemetrySession.end_step``, the ``ds-tpu goodput`` CLI (render one run,
fleet-merge a directory, ``--diff`` two runs with a per-class delta table and
a ``--tolerance`` exit-code contract), and a Perfetto run-timeline track via
utils/trace_event.py. See docs/goodput.md.
"""

import argparse
import json
import os
import re
import time

from .trace_event import (serialize_trace, trace_envelope, load_bundle,
                          process_name_event, thread_meta_events,
                          complete_slice, counter_event)

GOODPUT_LEDGER_VERSION = 1

# The closed badput taxonomy. Order is the render/report order: lifecycle
# first, then the step-time carve-outs, then the residual.
BADPUT_CLASSES = (
    "init",
    "compile",
    "productive_step",
    "checkpoint_stall",
    "restart_replay",
    "hang",
    "straggler_skew",
    "eval",
    "host_gap",
)

# Matches numerics._sanitize_token: the run token never contains '_' because
# '_' is the ledger-name field separator.
_TOKEN_RE = re.compile(r"[^A-Za-z0-9.-]+")

# Both the legacy anonymous name (goodput__host0.json, empty run token) and
# the run-namespaced name parse; anonymous ledgers group under run key "".
LEDGER_NAME_RE = re.compile(
    r"goodput_(?P<run>[^_]*)_host(?P<host>\d+)\.json$")


def _sanitize_token(s):
    return _TOKEN_RE.sub("-", str(s)).strip("-")


class RunLedger:
    """Single-host run-lifecycle ledger with an exact wall-clock partition.

    One monotonic cursor walks the run; :meth:`close` classifies the span
    since the cursor into a base class minus clamped carve-outs. The engine
    drives it (construction -> ``close("init", ...)``; each
    ``_finish_step`` -> :meth:`close_step`; eval -> :meth:`close` pairs;
    shutdown -> :meth:`finalize`), but the ledger itself never reads a clock
    source other than ``clock()`` — tests inject a fake clock and the
    partition invariant must hold for any event stream.
    """

    def __init__(self, run_id="", host=0, ledger_dir=None, eval_tag="eval",
                 interval_capacity=4096, persist_every=16, clock=None,
                 wall=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._wall = wall if wall is not None else time.time
        self.run_id = _sanitize_token(run_id)
        self.host = int(host)
        self.ledger_dir = ledger_dir or None
        self.eval_tag = str(eval_tag) or "eval"
        self.interval_capacity = max(int(interval_capacity), 16)
        self.persist_every = max(int(persist_every), 1)
        self.t0 = self._clock()
        self.wall_start = self._wall()
        self._cursor = self.t0
        self.class_seconds = {c: 0.0 for c in BADPUT_CLASSES}
        self.intervals = []          # [t0_rel, t1_rel, cls] contiguous spans
        self.intervals_dropped = 0
        self.steps = 0
        self.replay_steps = 0
        self.hang_steps = 0
        self.checkpoint_stalls = 0
        self.replay_until = -1       # steps <= this are restart replay
        self.finalized = False

    # ------------------------------------------------------------ recording

    def _append_interval(self, t0_rel, t1_rel, cls):
        if t1_rel <= t0_rel:
            return
        # merge with the previous interval when contiguous and same-class so
        # carve-heavy runs don't fragment the timeline
        if self.intervals and self.intervals[-1][2] == cls \
                and abs(self.intervals[-1][1] - t0_rel) < 1e-9:
            self.intervals[-1][1] = t1_rel
            return
        if len(self.intervals) >= self.interval_capacity:
            self.intervals.pop(0)
            self.intervals_dropped += 1
        self.intervals.append([t0_rel, t1_rel, cls])

    def close(self, base_cls, carve=None):
        """Classify the span since the cursor: each ``carve`` entry
        (class -> seconds) is clamped to what remains of the span, the
        remainder goes to ``base_cls``. Returns the span length. The span is
        consumed exactly once — this is the partition invariant's engine."""
        if base_cls not in self.class_seconds:
            raise ValueError(f"unknown badput class {base_cls!r}")
        now = self._clock()
        span = max(now - self._cursor, 0.0)
        start = self._cursor - self.t0
        remaining = span
        # carve-outs are laid down in taxonomy order so the interval list is
        # deterministic for a given event stream
        if carve:
            for cls in carve:
                if cls not in self.class_seconds:
                    raise ValueError(f"unknown badput class {cls!r}")
            for cls in BADPUT_CLASSES:
                want = float(carve.get(cls, 0.0) or 0.0)
                if want <= 0.0 or cls == base_cls:
                    continue
                got = min(want, remaining)
                if got <= 0.0:
                    continue
                self.class_seconds[cls] += got
                self._append_interval(start, start + got, cls)
                start += got
                remaining -= got
        if remaining > 0.0:
            self.class_seconds[base_cls] += remaining
            self._append_interval(start, start + remaining, base_cls)
        self._cursor = now
        return span

    def close_step(self, global_step, carve=None, hang=False):
        """Close one train-step interval. Replay steps (``global_step`` at or
        below :meth:`set_replay_until`'s bound) bill their remainder to
        ``restart_replay``; a step during which the hang watchdog fired bills
        its remainder to ``hang`` — a stalled step produced nothing, so none
        of its wall is productive."""
        if hang:
            base = "hang"
            self.hang_steps += 1
        elif global_step <= self.replay_until:
            base = "restart_replay"
            self.replay_steps += 1
        else:
            base = "productive_step"
        had_stall = bool(carve and carve.get("checkpoint_stall", 0.0) > 0.0)
        if had_stall:
            self.checkpoint_stalls += 1
        self.steps += 1
        span = self.close(base, carve)
        # the engine has no shutdown hook, so the on-disk ledger refreshes
        # itself: every Nth step, plus every step that paid a checkpoint fence
        # (those are the steps a post-mortem asks about)
        if self.ledger_dir and (had_stall
                                or self.steps % self.persist_every == 0):
            self.persist()
        return span

    def close_eval(self):
        """Close a forward-only evaluation interval (the caller closed the
        preceding span as ``host_gap`` when eval began)."""
        return self.close("eval")

    def set_replay_until(self, step):
        """Arm restart-replay billing: steps re-run at or below ``step`` are
        badput — work the run already paid for once before the crash."""
        self.replay_until = int(step)

    def finalize(self, persist=True):
        """Close the residual span as ``host_gap``, optionally persist, and
        return the summary. Idempotent."""
        if not self.finalized:
            self.close("host_gap")
            self.finalized = True
        if persist:
            self.persist()
        return self.summary()

    # ------------------------------------------------------------ reporting

    def wall_seconds(self):
        return max(self._clock() - self.t0, 0.0)

    def accounted_seconds(self):
        return sum(self.class_seconds.values())

    def goodput_fraction(self):
        acct = self.accounted_seconds()
        if acct <= 0.0:
            return 0.0
        return self.class_seconds["productive_step"] / acct

    def summary(self):
        """The ledger header without the interval list — what scalars, the
        fleet merge, and embedded dump copies carry."""
        return {
            "version": GOODPUT_LEDGER_VERSION,
            "kind": "goodput",
            "run": self.run_id,
            "host": self.host,
            "eval_tag": self.eval_tag,
            "wall_start": self.wall_start,
            "wall_s": self.accounted_seconds(),
            "steps": self.steps,
            "replay_steps": self.replay_steps,
            "hang_steps": self.hang_steps,
            "checkpoint_stalls": self.checkpoint_stalls,
            "class_seconds": dict(self.class_seconds),
            "goodput_fraction": self.goodput_fraction(),
        }

    def to_dict(self):
        d = self.summary()
        d["intervals"] = [list(iv) for iv in self.intervals]
        d["intervals_dropped"] = self.intervals_dropped
        return d

    def scalar_items(self):
        """``Run/Goodput/*`` scalar (name, value) pairs for end_step. The
        ``eval`` class is surfaced under the configured tag so an eval-heavy
        consumer can rename it without forking the taxonomy."""
        items = [("Run/Goodput/goodput_fraction", self.goodput_fraction()),
                 ("Run/Goodput/wall_seconds", self.accounted_seconds())]
        for cls in BADPUT_CLASSES:
            name = self.eval_tag if cls == "eval" else cls
            items.append((f"Run/Goodput/{name}_seconds",
                          self.class_seconds[cls]))
        return items

    def ledger_path(self):
        if not self.ledger_dir:
            return None
        return os.path.join(
            self.ledger_dir, f"goodput_{self.run_id}_host{self.host}.json")

    def persist(self):
        """Write the per-run ledger JSON beside the flight-recorder dumps.
        Atomic rename so a reader (or a crash) never sees a torn file."""
        path = self.ledger_path()
        if path is None:
            return None
        os.makedirs(self.ledger_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


# ------------------------------------------------------------ fleet merge


def scan_ledger_dir(ledger_dir, run=None):
    """Map run key -> {host: ledger dict} for every parseable ledger file in
    ``ledger_dir``. ``run`` filters to one run key."""
    runs = {}
    if not ledger_dir or not os.path.isdir(ledger_dir):
        return runs
    for name in sorted(os.listdir(ledger_dir)):
        m = LEDGER_NAME_RE.match(name)
        if not m:
            continue
        if run is not None and m.group("run") != run:
            continue
        try:
            with open(os.path.join(ledger_dir, name)) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if data.get("kind") != "goodput":
            continue
        runs.setdefault(m.group("run"), {})[int(m.group("host"))] = data
    return runs


def fleet_goodput(by_host):
    """Merge per-host ledgers into the rank-0 fleet view: class seconds and
    step counts sum across hosts (host-seconds, the unit fleet capacity is
    bought in), the fleet goodput fraction is productive host-seconds over
    total host-seconds, and the per-host breakdown rides along so a single
    bad host stays attributable."""
    hosts = sorted(by_host)
    class_seconds = {c: 0.0 for c in BADPUT_CLASSES}
    per_host = {}
    steps = replay = hangs = stalls = 0
    for h in hosts:
        led = by_host[h]
        for cls in BADPUT_CLASSES:
            class_seconds[cls] += float(
                led.get("class_seconds", {}).get(cls, 0.0))
        steps += int(led.get("steps", 0))
        replay += int(led.get("replay_steps", 0))
        hangs += int(led.get("hang_steps", 0))
        stalls += int(led.get("checkpoint_stalls", 0))
        per_host[str(h)] = {
            "wall_s": led.get("wall_s", 0.0),
            "goodput_fraction": led.get("goodput_fraction", 0.0),
            "class_seconds": dict(led.get("class_seconds", {})),
        }
    total = sum(class_seconds.values())
    frac = class_seconds["productive_step"] / total if total > 0 else 0.0
    run_keys = {led.get("run", "") for led in by_host.values()}
    return {
        "version": GOODPUT_LEDGER_VERSION,
        "kind": "goodput_fleet",
        "run": sorted(run_keys)[0] if run_keys else "",
        "n_hosts": len(hosts),
        "hosts": hosts,
        "wall_s": total,
        "steps": steps,
        "replay_steps": replay,
        "hang_steps": hangs,
        "checkpoint_stalls": stalls,
        "class_seconds": class_seconds,
        "goodput_fraction": frac,
        "per_host": per_host,
    }


def _median_step_seconds(records):
    """Median per-step cost from the dump's per-record monotonic stamps —
    robust to the occasional outlier interval (a mid-run recompile, a fence)
    that would skew the span-wide mean. None when fewer than two stamped
    records exist."""
    gaps = []
    prev_mono = prev_step = None
    for rec in records:
        mono, step = rec.get("mono"), rec.get("step")
        if mono is None or step is None:
            continue
        if prev_mono is not None and int(step) > int(prev_step):
            gaps.append((float(mono) - float(prev_mono))
                        / (int(step) - int(prev_step)))
        prev_mono, prev_step = mono, step
    if not gaps:
        return None
    gaps.sort()
    return gaps[(len(gaps) - 1) // 2]


def estimate_replay_seconds(bundle, resume_step):
    """Price restart-replay badput from a flight-recorder dump alone: the
    dump's monotonic step stamps give seconds-per-step (median inter-record
    gap when per-step stamps exist, span-wide mean otherwise); the replay
    runs from the restore point to the first bad step (or, absent one, the
    last recorded step). Returns (replay_steps, replay_seconds) or (0, 0.0)
    for legacy dumps without span fields."""
    span = bundle.get("span") if isinstance(bundle, dict) else None
    if not isinstance(span, dict):
        return 0, 0.0
    steps_spanned = int(span.get("steps_spanned", 0) or 0)
    mono = float(span.get("mono_end", 0.0)) - float(span.get("mono_start", 0.0))
    if steps_spanned <= 0 or mono <= 0.0:
        return 0, 0.0
    per_step = _median_step_seconds(bundle.get("steps", []))
    if per_step is None:
        per_step = mono / steps_spanned
    first_bad = bundle.get("first_bad_step")
    last_step = int(span.get("last_step", 0) or 0)
    stop = int(first_bad) if first_bad is not None else last_step
    replay_steps = max(stop - int(resume_step), 0)
    return replay_steps, replay_steps * per_step


# ------------------------------------------------------------ Perfetto


def goodput_trace_events(ledger):
    """One Perfetto track per host: a complete slice per ledger interval named
    by its badput class, plus a cumulative goodput-fraction counter sampled at
    every interval edge. Timebase is microseconds since the ledger opened."""
    host = int(ledger.get("host", 0))
    pid = 1000 + host
    run = ledger.get("run", "")
    events = [process_name_event(pid, f"Run goodput host{host}"
                                       + (f" [{run}]" if run else ""))]
    events.extend(thread_meta_events(pid, 0, "run lifecycle", sort_index=0))
    productive = 0.0
    total = 0.0
    for t0_rel, t1_rel, cls in ledger.get("intervals", []):
        ts = int(round(t0_rel * 1e6))
        dur = int(round((t1_rel - t0_rel) * 1e6))
        events.append(complete_slice(
            pid, 0, ts, dur, cls, "goodput", {"class": cls},
            cname="good" if cls == "productive_step" else None))
        total += t1_rel - t0_rel
        if cls == "productive_step":
            productive += t1_rel - t0_rel
        events.append(counter_event(
            pid, 0, int(round(t1_rel * 1e6)), "goodput_fraction",
            {"fraction": round(productive / total, 6) if total > 0 else 0.0}))
    return events


def goodput_timeline(ledger, out_path):
    trace = trace_envelope(goodput_trace_events(ledger),
                           "ds-tpu goodput",
                           run=ledger.get("run", ""),
                           host=ledger.get("host", 0))
    payload = serialize_trace(trace)
    with open(out_path, "w") as f:
        f.write(payload)
    return len(payload)


# ------------------------------------------------------------ CLI


def _load_goodput(path, run=None):
    """Resolve a CLI path operand to a goodput view: a ledger file, a
    flight-recorder dump embedding one, or a directory of per-host ledgers
    (fleet-merged when more than one host is present)."""
    if os.path.isdir(path):
        runs = scan_ledger_dir(path, run=run)
        if not runs:
            raise FileNotFoundError(
                f"no goodput ledgers (goodput_<run>_host<h>.json) in {path}")
        if run is None and len(runs) > 1:
            raise ValueError(
                "multiple runs in directory: "
                + ", ".join(repr(k) for k in sorted(runs))
                + " — pick one with --run")
        by_host = runs[run if run is not None else next(iter(runs))]
        if len(by_host) == 1:
            return next(iter(by_host.values()))
        return fleet_goodput(by_host)
    led = load_bundle(path, "goodput")
    if led is None:
        raise ValueError(f"{path} is not a goodput ledger "
                         "(and embeds none under its 'goodput' key)")
    return led


def _fmt_row(cls, sec, total):
    pct = 100.0 * sec / total if total > 0 else 0.0
    return f"  {cls:<18} {sec:>12.3f} s {pct:>7.2f}%"


def render_goodput(led):
    """Human-readable single-run (or fleet) report."""
    lines = []
    kind = led.get("kind", "goodput")
    head = f"run={led.get('run', '')!r}"
    if kind == "goodput_fleet":
        head += f" hosts={led.get('n_hosts', 0)}"
    else:
        head += f" host={led.get('host', 0)}"
    total = float(led.get("wall_s", 0.0))
    lines.append(f"goodput ledger: {head}")
    lines.append(f"  wall {total:.3f} s over {led.get('steps', 0)} steps "
                 f"({led.get('replay_steps', 0)} replayed, "
                 f"{led.get('hang_steps', 0)} hung, "
                 f"{led.get('checkpoint_stalls', 0)} checkpoint stalls)")
    cs = led.get("class_seconds", {})
    for cls in BADPUT_CLASSES:
        lines.append(_fmt_row(cls, float(cs.get(cls, 0.0)), total))
    lines.append(f"  goodput_fraction   {led.get('goodput_fraction', 0.0):.4f}")
    return "\n".join(lines)


def diff_goodput(a, b, tolerance=0.0):
    """Per-class delta between two ledgers (b relative to a). The regressing
    class is the badput class whose share of wall grew the most; ``regressed``
    is True when b's goodput fraction fell more than ``tolerance`` below
    a's — the CI exit-code contract."""
    a_total = float(a.get("wall_s", 0.0)) or 1.0
    b_total = float(b.get("wall_s", 0.0)) or 1.0
    deltas = {}
    worst_cls, worst_delta = None, 0.0
    for cls in BADPUT_CLASSES:
        a_pct = float(a.get("class_seconds", {}).get(cls, 0.0)) / a_total
        b_pct = float(b.get("class_seconds", {}).get(cls, 0.0)) / b_total
        deltas[cls] = {
            "a_seconds": float(a.get("class_seconds", {}).get(cls, 0.0)),
            "b_seconds": float(b.get("class_seconds", {}).get(cls, 0.0)),
            "a_share": a_pct,
            "b_share": b_pct,
            "share_delta": b_pct - a_pct,
        }
        if cls != "productive_step" and b_pct - a_pct > worst_delta:
            worst_cls, worst_delta = cls, b_pct - a_pct
    a_frac = float(a.get("goodput_fraction", 0.0))
    b_frac = float(b.get("goodput_fraction", 0.0))
    return {
        "version": GOODPUT_LEDGER_VERSION,
        "kind": "goodput_diff",
        "a_goodput_fraction": a_frac,
        "b_goodput_fraction": b_frac,
        "fraction_delta": b_frac - a_frac,
        "tolerance": float(tolerance),
        "regressed": b_frac < a_frac - float(tolerance),
        "regressing_class": worst_cls,
        "classes": deltas,
    }


def render_diff(diff):
    lines = ["goodput diff (b vs a):",
             f"  {'class':<18} {'a (s)':>10} {'b (s)':>10} {'Δshare':>9}"]
    for cls in BADPUT_CLASSES:
        d = diff["classes"][cls]
        mark = "  <-- regressing" if cls == diff["regressing_class"] else ""
        lines.append(f"  {cls:<18} {d['a_seconds']:>10.3f} "
                     f"{d['b_seconds']:>10.3f} "
                     f"{100.0 * d['share_delta']:>+8.2f}%{mark}")
    lines.append(f"  goodput_fraction   {diff['a_goodput_fraction']:>10.4f} "
                 f"{diff['b_goodput_fraction']:>10.4f} "
                 f"{100.0 * diff['fraction_delta']:>+8.2f}%")
    verdict = "REGRESSED" if diff["regressed"] else "ok"
    lines.append(f"  verdict: {verdict} "
                 f"(tolerance {diff['tolerance']:.4f})")
    return "\n".join(lines)


def goodput_main(argv=None):
    """``ds-tpu goodput`` — render one run's badput ledger (file, embedding
    dump, or per-host directory with fleet merge), export its Perfetto
    run-timeline, or diff two runs. Exit code: 0 clean; 1 when ``--diff``
    finds the goodput fraction regressed beyond ``--tolerance`` (so external
    CI can gate on run efficiency without parsing JSON); 2 on bad operands."""
    p = argparse.ArgumentParser(
        prog="ds-tpu goodput",
        description="Render, export, or diff run-lifecycle goodput ledgers.")
    p.add_argument("path", nargs="?", default=None,
                   help="ledger JSON, flight-recorder dump embedding one, or "
                        "a directory of per-host ledgers (fleet merge)")
    p.add_argument("--run", default=None,
                   help="run key when the directory holds several runs")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                   help="diff two ledgers/directories: per-class delta table "
                        "naming the regressing class")
    p.add_argument("--tolerance", type=float, default=0.0,
                   help="allowed goodput-fraction drop before --diff exits "
                        "nonzero (absolute, e.g. 0.02)")
    p.add_argument("--json", default=None, metavar="OUT",
                   help="also write the rendered view (or diff) as JSON")
    p.add_argument("--timeline", default=None, metavar="OUT",
                   help="write the Perfetto run-timeline trace JSON")
    args = p.parse_args(argv)

    try:
        if args.diff is not None:
            a = _load_goodput(args.diff[0], run=args.run)
            b = _load_goodput(args.diff[1], run=args.run)
            diff = diff_goodput(a, b, tolerance=args.tolerance)
            print(render_diff(diff))
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(diff, f, indent=2, sort_keys=True)
                    f.write("\n")
            return 1 if diff["regressed"] else 0
        if args.path is None:
            p.error("a ledger path is required unless --diff is given")
        led = _load_goodput(args.path, run=args.run)
    except (OSError, ValueError) as e:
        print(f"ds-tpu goodput: {e}")
        return 2
    print(render_goodput(led))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(led, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.timeline:
        if "intervals" not in led:
            print("ds-tpu goodput: --timeline needs a single-host ledger "
                  "with its interval list (fleet merges carry none)")
            return 2
        goodput_timeline(led, args.timeline)
        print(f"wrote {args.timeline}")
    return 0
