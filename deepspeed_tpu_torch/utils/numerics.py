"""The flight recorder and its dump reader (PyTorch port of the host parts of
``deepspeed_tpu/utils/numerics.py``): ``_sanitize_token``, ``default_run_id``
and ``FlightRecorder`` (lines 188-438; the bundle's HBM forensics block is
item 22b), the dump reader (lines 618-704) for auto-resume
(``resilience/auto_resume.py``), ``merge_first_bad`` and ``summarize_dump``
(lines 671-734) for the cluster post-mortem. Host file I/O only, copied. The
numerics observatory itself (``NumericsMonitor``, the in-graph sentinel, the
subtree index, the desync audit) is ROADMAP.md item 22b.
"""

import atexit
import json
import os
import re
import signal
import socket
import time
from collections import deque

from .logging import logger

NUMERICS_DUMP_VERSION = 1


def _sanitize_token(s):
    """Filename-safe token: anything outside [A-Za-z0-9.-] collapses to '-'.
    Underscores are excluded on purpose — they are the dump-name field
    separator, so a run id containing one would break the scan regex."""
    return re.sub(r"[^A-Za-z0-9.-]+", "-", str(s)).strip("-")


def default_run_id():
    """Run identity for dump namespacing when several hosts (or several
    launches) share one dump_dir. All ranks of one `ds-tpu` launch derive the
    same id (from the coordinator address the launcher exports), so their
    dumps group into one run; unrelated launches get distinct ids."""
    rid = os.environ.get("DS_RUN_ID")
    if rid:
        return _sanitize_token(rid)
    coord = os.environ.get("DS_COORDINATOR_ADDRESS")
    if coord:
        return "run-" + _sanitize_token(coord)
    node = _sanitize_token(socket.gethostname()) or "node"
    return f"{node}-p{os.getpid()}"


class FlightRecorder:
    """Bounded per-host ring buffer of step records + structured events that
    dumps a JSON post-mortem bundle when triggered."""

    def __init__(self, capacity=256, dump_dir=None, telemetry=None, host_id=0,
                 pipeline_trace=None, request_trace=None, run_id=None,
                 cluster=None):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.telemetry = telemetry
        # optional PipelineTracer: its span bundle rides along in every dump so
        # ``ds-tpu timeline`` can reconstruct the schedule of a dead run
        self.pipeline_trace = pipeline_trace
        # optional serving RequestTracer (serve/request_trace.py): same deal,
        # for ``ds-tpu serve-timeline`` on a dead serving host's dump
        self.request_trace = request_trace
        # optional ClusterMonitor (utils/cluster.py): heartbeat history +
        # clock-offset estimates ride along so ``ds-tpu cluster-dump`` and
        # ``ds-tpu timeline --cluster`` can merge per-host dumps coherently
        self.cluster = cluster
        # run_id="" keeps the legacy un-namespaced dump names (tests and the
        # crash-sim write those directly); None picks the launch-wide default
        self.run_id = _sanitize_token(run_id) if run_id is not None \
            else default_run_id()
        self.host_id = int(host_id)
        # wall/monotonic anchor pair taken once: every per-step monotonic
        # stamp converts to wall-clock as wall0 + (mono - mono0), so the
        # dump's span fields stay consistent even across NTP slews
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        self.steps = deque(maxlen=self.capacity)
        self.events = deque(maxlen=max(self.capacity * 4, 64))
        self.dump_count = 0
        self.last_dump_path = None
        self._pending_anomaly = False
        self._installed = False

    # -- recording ---------------------------------------------------------
    def record_step(self, record):
        # monotonic stamp per record: the dump's "span" header prices
        # seconds-per-step for restart-replay badput (utils/goodput.py)
        record.setdefault("mono", time.perf_counter())
        self.steps.append(record)

    def record_event(self, name, payload, step=None):
        self.events.append({"event": name, "step": step, "payload": payload,
                            "time": time.time()})

    def note_anomaly(self):
        self._pending_anomaly = True

    # -- bundle assembly ---------------------------------------------------
    def first_bad_step(self):
        for rec in self.steps:
            if rec.get("anomaly") or rec.get("overflow"):
                return rec
        return None

    def bundle(self, reason, detail=None):
        bad = self.first_bad_step()
        compile_records = []
        if self.telemetry is not None and getattr(self.telemetry, "watchdog", None):
            for prog, sigs in self.telemetry.watchdog.records.items():
                for rec in sigs.values():
                    compile_records.append({
                        "program": prog,
                        "compile_seconds": rec.compile_seconds,
                        "count": rec.count,
                    })
        out = {
            "version": NUMERICS_DUMP_VERSION,
            "reason": reason,
            "detail": detail,
            "host": self.host_id,
            "time": time.time(),
            "first_bad_step": bad.get("step") if bad else None,
            "offending_subtree": (bad.get("anomaly") or {}).get("subtree")
                                 if bad else None,
            "loss_scale_trajectory": [[r.get("step"), r.get("loss_scale")]
                                      for r in self.steps
                                      if r.get("loss_scale") is not None],
            "steps": list(self.steps),
            "events": list(self.events),
            "compile_records": compile_records,
        }
        span = self._span()
        if span is not None:
            out["span"] = span
        if self.run_id:
            out["run"] = self.run_id
        if self.pipeline_trace is not None:
            out["pipeline_trace"] = self.pipeline_trace.bundle()
        if self.request_trace is not None:
            out["serving_request_trace"] = self.request_trace.bundle()
        if self.cluster is not None:
            out["cluster"] = self.cluster.bundle()
        # (the HBM forensics block, "hbm", is ROADMAP.md item 22b)
        if self.telemetry is not None:
            # measured-time observatory: the last closed trace window's
            # summary rides along so a post-mortem sees what the device
            # timeline actually did (guarded like hbm — forensics must never
            # block the dump)
            prof_snapper = getattr(self.telemetry, "profile_snapshot", None)
            if prof_snapper is not None:
                try:
                    prof = prof_snapper()
                except Exception:
                    prof = None
                if prof is not None:
                    out["profile"] = prof
            # alert plane: rules/fired/active state + the full metric ring
            # (utils/alerts.py) — a page-severity alert triggers this dump,
            # so the bundle must carry the evidence it fired on
            alert_snapper = getattr(self.telemetry, "alerts_snapshot", None)
            if alert_snapper is not None:
                try:
                    alerts = alert_snapper()
                except Exception:
                    alerts = None
                if alerts is not None:
                    out["alerts"] = alerts
        return out

    def _span(self):
        """Monotonic + wall-clock extent of the recorded step ring, or None
        when no step carries a stamp (records fed in by hand, old callers).
        ``steps_spanned`` counts step *intervals* — the step-number delta when
        both ends know their step, else stamped records minus one — so
        (mono_end - mono_start) / steps_spanned is seconds-per-step; that is
        how ``goodput.estimate_replay_seconds`` prices restart-replay badput
        from a dump alone."""
        stamped = [r for r in self.steps if r.get("mono") is not None]
        if not stamped:
            return None
        first, last = stamped[0], stamped[-1]
        first_step, last_step = first.get("step"), last.get("step")
        if first_step is not None and last_step is not None:
            spanned = int(last_step) - int(first_step)
        else:
            spanned = len(stamped) - 1
        return {
            "mono_start": float(first["mono"]),
            "mono_end": float(last["mono"]),
            "wall_start": self._wall0 + (float(first["mono"]) - self._mono0),
            "wall_end": self._wall0 + (float(last["mono"]) - self._mono0),
            "first_step": first_step,
            "last_step": last_step,
            "steps_spanned": spanned,
        }

    # -- triggering --------------------------------------------------------
    def trigger(self, reason, detail=None, quiet=False):
        # the SummaryMonitor's JSONL streams are block-buffered; a crash
        # post-mortem is exactly when the last pre-crash scalars/events
        # matter, so force them to disk before (and regardless of) the dump
        mon = getattr(self.telemetry, "monitor", None) \
            if self.telemetry is not None else None
        if mon is not None:
            try:
                mon.flush()
            except Exception:  # dump/flush failure must never kill the job
                pass
        if not self.dump_dir:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            prefix = f"numerics_dump_{self.run_id}_" if self.run_id \
                else "numerics_dump_"
            path = os.path.join(
                self.dump_dir,
                f"{prefix}host{self.host_id}_{self.dump_count}.json")
            with open(path, "w") as f:
                json.dump(self.bundle(reason, detail), f, default=float)
            self.dump_count += 1
            self.last_dump_path = path
            self._pending_anomaly = False
            if not quiet:
                logger.warning("numerics: flight recorder dumped post-mortem "
                               f"({reason}) -> {path}")
            return path
        except OSError as e:  # dump failure must never kill the training job
            if not quiet:
                logger.warning(f"numerics: dump failed: {e}")
            return None

    def install(self, install_signal_handlers=False):
        if self._installed:
            return
        self._installed = True
        atexit.register(self._atexit_dump)
        if install_signal_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.getsignal(sig)

                    def _handler(signum, frame, _prev=prev):
                        self.trigger("signal", {"signum": signum})
                        if callable(_prev):
                            _prev(signum, frame)
                        else:
                            signal.signal(signum, signal.SIG_DFL)
                            signal.raise_signal(signum)

                    signal.signal(sig, _handler)
                except (ValueError, OSError):
                    pass  # not the main thread / unsupported platform

    def _atexit_dump(self):
        # Only dump at exit when an anomaly was seen but never dumped — a
        # healthy run must leave the dump dir untouched. quiet: log streams
        # may already be closed this late in interpreter shutdown.
        if self._pending_anomaly and self.dump_count == 0:
            self.trigger("atexit", quiet=True)


# --------------------------------------------------------- numerics monitor

# Both the legacy name (numerics_dump_host0_0.json) and the run-namespaced
# name (numerics_dump_<run>_host0_0.json) parse; legacy dumps group under the
# empty run key "". The run token never contains '_'.
DUMP_NAME_RE = re.compile(
    r"numerics_dump_(?:(?P<run>[^_]+)_)?host(?P<host>\d+)_(?P<idx>\d+)\.json$")


def scan_dump_dir_runs(dump_dir):
    """Group the flight-recorder dumps in ``dump_dir`` by run.

    Returns ``{run_key: [entry, ...]}`` where each entry is
    ``{"host", "index", "path", "mtime"}`` and each run's entries are sorted
    by (index, host). Legacy un-namespaced dumps land under run key ``""``.
    Pure host file I/O."""
    runs = {}
    if not dump_dir or not os.path.isdir(dump_dir):
        return runs
    for name in os.listdir(dump_dir):
        m = DUMP_NAME_RE.match(name)
        if not m:
            continue
        path = os.path.join(dump_dir, name)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        runs.setdefault(m.group("run") or "", []).append({
            "host": int(m.group("host")),
            "index": int(m.group("idx")),
            "path": path,
            "mtime": mtime,
        })
    for entries in runs.values():
        entries.sort(key=lambda e: (e["index"], e["host"]))
    return runs


def load_run_bundles(dump_dir, run=None):
    """Load the newest bundle per host for one run of a shared dump_dir.

    Picks the most recently written run when ``run`` is None. Returns
    ``(run_key, {host: bundle})``; torn dumps are skipped (an older intact
    dump from the same host wins, if any)."""
    runs = scan_dump_dir_runs(dump_dir)
    if not runs:
        return run, {}
    if run is None:
        run = max(runs, key=lambda k: max(e["mtime"] for e in runs[k]))
    elif run not in runs:
        return run, {}
    by_host = {}
    for entry in runs[run]:  # ascending (index, host): last intact one wins
        try:
            with open(entry["path"]) as f:
                by_host[entry["host"]] = json.load(f)
        except (OSError, ValueError):
            continue
    return run, by_host


def scan_dump_dir(dump_dir):
    """Newest flight-recorder bundle in ``dump_dir``, or None when the dir
    holds none. Dumps are grouped by run (see scan_dump_dir_runs); the most
    recently written run wins, then the highest (dump index, host) within it —
    the recorder numbers dumps monotonically per host. Pure host file I/O —
    the auto-resume path (resilience/auto_resume.py) calls this before any
    engine exists."""
    runs = scan_dump_dir_runs(dump_dir)
    if not runs:
        return None
    run = max(runs, key=lambda k: max(e["mtime"] for e in runs[k]))
    best = runs[run][-1]  # entries sorted by (index, host)
    try:
        with open(best["path"]) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # a torn dump must not block resume


def merge_first_bad(bundles_by_host):
    """Merged (first_bad_step, first_bad_host) over per-host bundles: the
    minimum first bad step across the fleet, ties broken by lowest host.
    Returns (None, None) when no host recorded a bad step."""
    best = None
    for host in sorted(bundles_by_host):
        s = summarize_dump(bundles_by_host[host])
        step = s.get("first_bad_step")
        if step is None:
            continue
        key = (step, host)
        if best is None or key < best:
            best = key
    return best if best is not None else (None, None)


def summarize_dump(bundle):
    """Derive the headline facts from a dump bundle, recomputing anything a
    partial/old bundle is missing."""
    steps = bundle.get("steps", [])
    first_bad = bundle.get("first_bad_step")
    offending = bundle.get("offending_subtree")
    if first_bad is None:
        for rec in steps:
            if rec.get("anomaly") or rec.get("overflow"):
                first_bad = rec.get("step")
                offending = (rec.get("anomaly") or {}).get("subtree")
                break
    return {
        "reason": bundle.get("reason"),
        "detail": bundle.get("detail"),
        "host": bundle.get("host"),
        "first_bad_step": first_bad,
        "offending_subtree": offending,
        "steps_recorded": len(steps),
        "events_recorded": len(bundle.get("events", [])),
        # None for legacy dumps written before the span header existed
        "span": bundle.get("span"),
        "loss_scale_trajectory": bundle.get("loss_scale_trajectory", []),
        "desync": next((e["payload"]["divergence"]
                        for e in bundle.get("events", [])
                        if e.get("event") == "desync_audit"
                        and (e.get("payload") or {}).get("divergence")), None),
        "compile_records": bundle.get("compile_records", []),
    }
