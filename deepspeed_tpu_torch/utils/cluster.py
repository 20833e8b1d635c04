"""Cluster observatory: cross-host aggregation, hang/straggler detection,
merged fleet timelines.

PyTorch port of ``deepspeed_tpu/utils/cluster.py`` (lines 1-1016), host-only
and copied but for four seams: ``named_scope`` (lines 122-131) enters a
``torch.profiler.record_function`` range where JAX enters
``jax.named_scope``, recording the host ``ScopeTracker`` entry as before;
``host_allgather`` (lines 154-182, ``multihost_utils``) is
``torch.distributed.all_gather_object`` over a gloo group (the default group
when its backend is gloo, else one made for it), or ``[row]`` at world 1;
``_process_index`` / ``_process_count`` (lines 582-591) are the
``torch.distributed`` rank and world size; the heartbeat's HBM column reads
``torch.cuda.memory_stats`` (``utils/telemetry.py`` ``hbm_stats``). Scopes
are entered at run time on every call (eager PyTorch has no trace time).

Every observatory before this one (telemetry scalars, the numerics flight
recorder, step-time anatomy, the serving request ledger) is strictly
per-host. This module is the cross-host plane that rides the gloo CPU world
`runtime/dist.py` already initialises (docs/cluster.md):

1. **Heartbeat aggregation** — each host contributes its end_step record
   (step wall ms, host-local dispatch wall ms, wire bytes per level, HBM
   watermark) through a small allgather on the host CPU backend. Every host
   derives the same global view from the identical matrix; host 0 emits the
   `Cluster/*` scalars: step skew, the straggler host (named by the same
   median-ratio divergence rule the pipeline observatory uses, with the
   LOWER-middle median so a two-host world can still name one), fleet wire
   totals, HBM peak. The straggler rule runs on the DISPATCH wall: blocking
   collectives equalise the end-to-end step wall across hosts (everyone
   waits for the slowest), so only the host-local window before the first
   blocking fetch attributes the skew to the host that caused it.

2. **Hang watchdog** — a per-host daemon thread arms a deadline around each
   step. On expiry it captures all-thread Python stacks plus the
   last-entered named scope (``ds_grad_bucket{k}``, ``ds_fwd_bwd``, …),
   writes a flight-recorder-format dump through the host's FlightRecorder,
   and best-effort signals peers by dropping an epoch marker file in the
   shared dump_dir — so every host dumps a coherent epoch and a silent hang
   becomes a cross-host post-mortem.

3. **Post-mortem assembly** — ``ds-tpu cluster-dump`` merges the per-host
   dumps of one run into a single report naming the first host to stall and
   the scope it died in; ``ds-tpu timeline --cluster`` merges per-host
   pipeline trace bundles onto per-host track groups, aligned with
   heartbeat-estimated clock offsets.

4. **Fleet serving rollups** — per-replica latency histograms are mergeable
   fixed-bin sketches (serve/request_trace.HistogramSketch), so
   ``fleet_latency_summary`` combines N replicas' distributions exactly and
   deterministically into fleet-level percentiles.

Everything here is host-side: with ``telemetry.cluster`` enabled the
compiled step stays HLO-instruction-identical (tested). Scope entries for
in-graph scopes are recorded when the scope is entered on the host — i.e. at
trace time — so a hang names the program region most recently traced; a hang
inside compilation points at the exact scope being built.

Invariant shared with utils/numerics.py and enforced by
tests/test_torch_no_sync_guard.py: this module performs NO host
synchronisation of device values.
"""

import argparse
import contextlib
import json
import os
import re
import sys
import threading
import time
import traceback
from collections import deque

from .logging import logger
from .numerics import _sanitize_token, default_run_id
from .trace_event import serialize_trace, trace_envelope

CLUSTER_BUNDLE_VERSION = 1
CLUSTER_KIND = "cluster"

# Heartbeat row layout: one row per host, allgathered every
# heartbeat_interval steps. Columns are plain host floats. ``step_ms`` is the
# end-to-end step wall — in a multi-host world the blocking collectives
# equalise it across hosts (everyone waits for the slowest), so it carries
# the global skew but cannot ATTRIBUTE it. ``dispatch_ms`` is the host-local
# wall from the previous step boundary to this host's first blocking fetch
# (telemetry.mark_step_dispatched): a slow host shows up there asymmetrically,
# so the straggler rule runs on that column.
HEARTBEAT_FIELDS = ("step", "wall_s", "step_ms", "dispatch_ms",
                    "wire_bytes_ici", "wire_bytes_dcn", "hbm_peak_bytes")
(COL_STEP, COL_WALL, COL_STEP_MS, COL_DISPATCH_MS, COL_WIRE_ICI,
 COL_WIRE_DCN, COL_HBM) = range(len(HEARTBEAT_FIELDS))

# Peer hang markers: cluster_hang_<run>_e<epoch>_host<h>.json in the shared
# dump_dir. The run token never contains '_' (numerics._sanitize_token).
MARKER_RE = re.compile(
    r"cluster_hang_(?P<run>[^_]+)_e(?P<epoch>\d+)_host(?P<host>\d+)\.json$")


# ------------------------------------------------------------- scope tracker


class ScopeTracker:
    """Host-side ledger of the last-entered named scope. Thread-safe: the
    training thread enters scopes, the watchdog thread reads them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last = None  # (name, monotonic entry time)

    def enter(self, name):
        with self._lock:
            self._last = (str(name), time.monotonic())

    def last_scope(self):
        """{"name", "age_s"} of the most recently entered scope, or None."""
        with self._lock:
            if self._last is None:
                return None
            name, t0 = self._last
        return {"name": name, "age_s": max(time.monotonic() - t0, 0.0)}


_DEFAULT_TRACKER = ScopeTracker()


def default_tracker():
    return _DEFAULT_TRACKER


@contextlib.contextmanager
def named_scope(name, tracker=None):
    """A ``torch.profiler.record_function`` range that also records the
    entry host-side, so a hang dump can name the scope; the range names the
    region in a profiler trace as ``jax.named_scope`` does in XLA's."""
    import torch
    (tracker if tracker is not None else _DEFAULT_TRACKER).enter(name)
    with torch.profiler.record_function(name):
        yield


# --------------------------------------------------------------- stack dumps


def all_thread_stacks(limit=40):
    """{thread label: [frames]} for every live Python thread. Pure host
    introspection — safe to call from the watchdog thread mid-hang."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'thread')}-{ident}"
        stack = [f"{fs.filename}:{fs.lineno}:{fs.name}"
                 for fs in traceback.extract_stack(frame)]
        out[label] = stack[-limit:]
    return out


# --------------------------------------------------------- heartbeat algebra


_ALLGATHER_WARNED = [False]


def host_allgather(row):
    """Allgather one heartbeat row across hosts on the CPU backend.

    Returns [n_hosts][len(row)] of host floats (row h = host h's
    contribution, identical on every host). Single-process worlds shortcut
    to [row]; a failed allgather degrades to the local row with a one-shot
    warning — the cluster view collapses to local-only rather than killing
    the step loop."""
    row = [float(v) for v in row]
    n = _process_count()
    if n <= 1:
        return [row]
    try:
        import torch.distributed as dist
        mat = [None] * n
        dist.all_gather_object(mat, row, group=_gloo_group())
        return [[float(v) for v in r] for r in mat]
    except Exception as e:
        if not _ALLGATHER_WARNED[0]:
            _ALLGATHER_WARNED[0] = True
            logger.warning(
                f"cluster: heartbeat allgather failed ({e!r}); falling back "
                "to local-only view")
        return [row]


_GLOO = {}


def _gloo_group():
    """The host CPU world: the default group when its backend is gloo, else a
    gloo group over every rank, made at the first heartbeat of a process
    group (every rank reaches it together), so no heartbeat travels through
    NCCL and the card."""
    import torch.distributed as dist
    world = dist.group.WORLD
    if _GLOO.get("world") is not world:
        _GLOO["world"] = world
        _GLOO["group"] = (None if dist.get_backend() == "gloo"
                          else dist.new_group(backend="gloo"))
    return _GLOO["group"]


def _median_low(vals):
    """Lower-middle median: an actually-observed value, and — unlike the
    upper-middle median the pipeline observatory uses per stage — it lets a
    2-host world name a straggler (upper-middle would pick the straggler
    itself as the baseline, so the ratio could never exceed 1)."""
    ordered = sorted(vals)
    return ordered[(len(ordered) - 1) // 2]


def find_straggler_host(per_host_ms, threshold=3.0):
    """Median-ratio divergence rule over per-host walls (callers feed the
    host-local dispatch column): the slowest host is the straggler when its
    time exceeds ``threshold`` x the (lower-middle) median. Returns
    {"host", "ratio"} or None."""
    vals = [float(v) for v in per_host_ms]
    if len(vals) < 2:
        return None
    med = _median_low(vals)
    if med <= 0.0:
        return None
    worst = max(range(len(vals)), key=lambda i: (vals[i], i))
    ratio = vals[worst] / med
    if ratio > float(threshold):
        return {"host": worst, "ratio": ratio}
    return None


def derive_cluster_stats(matrix, threshold=3.0):
    """Global per-step view from one allgathered heartbeat matrix. Skew
    scalars come from the end-to-end step wall; straggler attribution comes
    from the host-local dispatch wall (see HEARTBEAT_FIELDS)."""
    step_ms = [float(r[COL_STEP_MS]) for r in matrix]
    dispatch_ms = [float(r[COL_DISPATCH_MS]) for r in matrix]
    med = _median_low(step_ms)
    return {
        "step": int(matrix[0][COL_STEP]),
        "hosts": len(matrix),
        "step_ms_max": max(step_ms),
        "step_ms_min": min(step_ms),
        "step_ms_median": med,
        "step_skew": (max(step_ms) / med) if med > 0 else 1.0,
        "dispatch_ms_max": max(dispatch_ms),
        "wire_bytes_ici_total": sum(float(r[COL_WIRE_ICI]) for r in matrix),
        "wire_bytes_dcn_total": sum(float(r[COL_WIRE_DCN]) for r in matrix),
        "hbm_peak_bytes_max": max(float(r[COL_HBM]) for r in matrix),
        "straggler": find_straggler_host(dispatch_ms, threshold),
    }


def estimate_clock_offsets(heartbeats):
    """Per-host wall-clock offset (seconds, relative to host 0) from the
    heartbeat history: every host snapshots time.time() at the same
    heartbeat, so the median over heartbeats of (wall_h - wall_0) estimates
    host h's clock skew, robust to the odd delayed snapshot. Returns a list
    indexed by host; offsets[0] == 0.0."""
    deltas = {}
    for mat in heartbeats:
        if not mat:
            continue
        w0 = float(mat[0][COL_WALL])
        for h, row in enumerate(mat):
            deltas.setdefault(h, []).append(float(row[COL_WALL]) - w0)
    return [_median_low(deltas[h]) if deltas.get(h) else 0.0
            for h in range(len(deltas))]


# ------------------------------------------------------------- hang watchdog


class HangWatchdog:
    """Per-host hang detector. ``arm(step)`` before dispatching a step,
    ``disarm()`` when it completes; a daemon thread fires when an armed
    deadline expires — capturing all-thread stacks plus the last-entered
    named scope, dumping through the host's FlightRecorder, and dropping an
    epoch marker in the shared dump_dir so peers dump the same epoch. Peer
    markers are polled by the same thread; a peer-signalled fire dumps but
    writes no marker of its own (no marker ping-pong). Fires at most once
    per epoch (= armed step) per host."""

    def __init__(self, recorder=None, deadline_s=60.0, dump_dir=None,
                 host_id=0, run_id=None, signal_peers=True, tracker=None,
                 poll_s=None):
        self.recorder = recorder
        self.deadline_s = float(deadline_s)
        self.dump_dir = dump_dir or (recorder.dump_dir
                                     if recorder is not None else None)
        self.host_id = int(host_id)
        if run_id is None:
            run_id = recorder.run_id if recorder is not None \
                else default_run_id()
        self.run_id = _sanitize_token(run_id) or "norun"
        self.signal_peers = bool(signal_peers)
        self.tracker = tracker if tracker is not None else _DEFAULT_TRACKER
        self.poll_s = float(poll_s) if poll_s else \
            min(max(self.deadline_s / 5.0, 0.02), 0.5)
        self.fired = []  # fire payloads, for summaries and the hang-sim
        self._lock = threading.Lock()
        self._armed_at = None
        self._step = None
        self._fired_epochs = set()
        self._seen_markers = set()
        self._stop = threading.Event()
        self._thread = None

    # -- arming ------------------------------------------------------------
    def arm(self, step):
        with self._lock:
            self._armed_at = time.monotonic()
            self._step = int(step)
        self._ensure_thread()

    def disarm(self):
        with self._lock:
            self._armed_at = None

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"ds-hang-watchdog-h{self.host_id}")
        self._thread.start()

    # -- the watchdog thread -----------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed_at, step = self._armed_at, self._step
            if armed_at is not None:
                waited = time.monotonic() - armed_at
                if waited > self.deadline_s:
                    self._fire("deadline", epoch=step, step=step,
                               waited_s=waited)
            if self.signal_peers and self.dump_dir:
                self._scan_peer_markers()

    def _scan_peer_markers(self):
        try:
            names = os.listdir(self.dump_dir)
        except OSError:
            return
        for name in sorted(names):
            m = MARKER_RE.match(name)
            if not m or name in self._seen_markers:
                continue
            if m.group("run") != self.run_id:
                continue
            host = int(m.group("host"))
            if host == self.host_id:
                continue
            self._seen_markers.add(name)
            try:
                with open(os.path.join(self.dump_dir, name)) as f:
                    marker = json.load(f)
            except (OSError, ValueError):
                marker = {}
            epoch = int(m.group("epoch"))
            self._fire("peer_signal", epoch=epoch,
                       step=marker.get("step", epoch), peer=host,
                       peer_scope=marker.get("last_scope"))

    def _fire(self, origin, epoch, step, waited_s=None, peer=None,
              peer_scope=None):
        key = int(epoch) if epoch is not None else -1
        with self._lock:
            if key in self._fired_epochs:
                return
            self._fired_epochs.add(key)
        scope = self.tracker.last_scope() if self.tracker is not None else None
        payload = {
            "origin": origin,
            "epoch": key,
            "step": step,
            "host": self.host_id,
            "deadline_s": self.deadline_s,
            "waited_s": waited_s,
            "last_scope": scope["name"] if scope else None,
            "scope_age_s": scope["age_s"] if scope else None,
            "peer": peer,
            "peer_scope": peer_scope,
            "threads": all_thread_stacks(),
        }
        self.fired.append(payload)
        logger.error(
            f"cluster: HANG detected on host {self.host_id} at step {step} "
            f"({origin}), last scope: {payload['last_scope']}")
        if self.recorder is not None:
            self.recorder.record_event("hang", payload, step)
            self.recorder.note_anomaly()
            self.recorder.trigger("hang", {
                "origin": origin, "epoch": key, "step": step,
                "host": self.host_id, "last_scope": payload["last_scope"]})
        if origin != "peer_signal":
            self._write_marker(key, step, payload["last_scope"])

    def _write_marker(self, epoch, step, last_scope):
        if not (self.signal_peers and self.dump_dir):
            return
        name = f"cluster_hang_{self.run_id}_e{epoch}_host{self.host_id}.json"
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = os.path.join(self.dump_dir, name + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"epoch": epoch, "step": step,
                           "host": self.host_id, "last_scope": last_scope,
                           "time": time.time()}, f)
            os.replace(tmp, os.path.join(self.dump_dir, name))
        except OSError as e:  # best-effort: peers just won't be signalled
            logger.warning(f"cluster: peer hang marker failed: {e}")


# ------------------------------------------------------------ cluster monitor


class ClusterMonitor:
    """Per-host coordinator of the cluster plane: heartbeats every
    ``heartbeat_interval`` steps, ``Cluster/*`` scalars from host 0, the
    hang watchdog armed around each step, and the bundle that rides along in
    flight-recorder dumps. All host-side."""

    def __init__(self, telemetry=None, monitor=None, recorder=None,
                 heartbeat_interval=1, hang_deadline_s=0.0,
                 straggler_threshold=3.0, signal_peers=True, dump_dir=None,
                 run_id=None, host_id=None, n_hosts=None, tracker=None,
                 heartbeat_capacity=512, allgather=None, warmup_steps=1):
        self.telemetry = telemetry
        self.monitor = monitor if monitor is not None else \
            (telemetry.monitor if telemetry is not None else None)
        self.recorder = recorder
        self.heartbeat_interval = max(int(heartbeat_interval), 1)
        self.straggler_threshold = float(straggler_threshold)
        # the first step(s) pay multi-second compiles: arming a deadline or
        # naming a straggler there would only ever flag compile-time jitter
        self.warmup_steps = max(int(warmup_steps), 0)
        self.host_id = int(host_id) if host_id is not None \
            else _process_index()
        self.n_hosts = int(n_hosts) if n_hosts is not None \
            else _process_count()
        self.tracker = tracker if tracker is not None else _DEFAULT_TRACKER
        self._allgather = allgather if allgather is not None else host_allgather
        self.heartbeats = deque(maxlen=max(int(heartbeat_capacity), 8))
        self.stragglers = deque(maxlen=64)
        self.last_stats = None
        # dispatch-skew integral for the goodput ledger: seconds THIS host's
        # dispatch wall sat above the fleet lower-middle median, sampled at
        # heartbeat steps (utils/goodput.py bills them as straggler_skew)
        self.last_local_skew_s = 0.0
        self.skew_integral_s = 0.0
        # when the engine's run ledger is attached, every flight-recorder
        # dump's cluster bundle carries this host's goodput summary, so the
        # cluster plane can merge a fleet goodput view post-mortem
        self.goodput = None
        self.watchdog = None
        if hang_deadline_s and float(hang_deadline_s) > 0:
            self.watchdog = HangWatchdog(
                recorder=recorder, deadline_s=float(hang_deadline_s),
                dump_dir=dump_dir or (recorder.dump_dir
                                      if recorder is not None else None),
                host_id=self.host_id, run_id=run_id,
                signal_peers=signal_peers, tracker=self.tracker)

    # -- step hooks (called by the engine around each optimizer step) -------
    def on_step_begin(self, step):
        if self.watchdog is not None and int(step) >= self.warmup_steps:
            self.watchdog.arm(step)

    def on_step_end(self, step):
        if self.watchdog is not None:
            self.watchdog.disarm()
        if int(step) % self.heartbeat_interval != 0:
            return None
        stats = self.heartbeat(step)
        if self.telemetry is not None:
            # the allgather above is a cross-host rendezvous: restart the
            # dispatch window after it, so waiting for a slow peer's heartbeat
            # is not charged to this host's next step (telemetry docstring)
            self.telemetry.rebase_dispatch_window()
        return stats

    # -- heartbeats ---------------------------------------------------------
    def local_row(self, step):
        t = self.telemetry
        step_ms = float(t.last_step_ms or 0.0) if t is not None else 0.0
        # host-local dispatch wall; falls back to the step wall when the
        # engine never marked a dispatch boundary (older call sites)
        dispatch_ms = step_ms
        if t is not None and getattr(t, "last_dispatch_ms", None) is not None:
            dispatch_ms = float(t.last_dispatch_ms)
        wire_ici = float(t.last_wire_bytes_ici) if t is not None else 0.0
        wire_dcn = float(t.last_wire_bytes_dcn) if t is not None else 0.0
        from .telemetry import hbm_stats
        stats = hbm_stats()
        hbm = float((stats or {}).get("peak_bytes_in_use", 0))
        return [float(step), time.time(), step_ms, dispatch_ms,
                wire_ici, wire_dcn, hbm]

    def heartbeat(self, step):
        return self.ingest(self._allgather(self.local_row(step)), step)

    def ingest(self, matrix, step):
        """Fold one allgathered heartbeat matrix into the history and derive
        the global view. Every host computes the same stats from the same
        matrix; only host 0 emits scalars (the "rank 0 derives" contract)."""
        matrix = [[float(v) for v in row] for row in matrix]
        self.heartbeats.append(matrix)
        stats = derive_cluster_stats(matrix, self.straggler_threshold)
        if int(step) < self.warmup_steps:
            # compile steps: dispatch walls are dominated by per-host compile
            # jitter — naming a straggler from them would be noise
            stats["straggler"] = None
        self.last_stats = stats
        # goodput's straggler_skew source: this host's dispatch wall above the
        # fleet lower-middle median (same column and median rule the straggler
        # namer uses). Warmup steps are excluded for the same reason.
        self.last_local_skew_s = 0.0
        if int(step) >= self.warmup_steps and 0 <= self.host_id < len(matrix):
            dispatch = [row[3] for row in matrix]
            skew_ms = dispatch[self.host_id] - _median_low(dispatch)
            if skew_ms > 0:
                self.last_local_skew_s = skew_ms / 1000.0
                self.skew_integral_s += self.last_local_skew_s
        strag = stats["straggler"]
        if strag is not None:
            event = {"step": int(step), "host": int(strag["host"]),
                     "ratio": float(strag["ratio"])}
            self.stragglers.append(event)
            if self.recorder is not None:
                self.recorder.record_event("cluster_straggler", event,
                                           int(step))
        if self.monitor is not None and self.host_id == 0:
            self._emit(stats, int(step))
        return stats

    def _emit(self, stats, step):
        mon = self.monitor
        mon.add_scalar("Cluster/hosts", stats["hosts"], step)
        mon.add_scalar("Cluster/step_ms_max", stats["step_ms_max"], step)
        mon.add_scalar("Cluster/step_ms_median", stats["step_ms_median"], step)
        mon.add_scalar("Cluster/step_skew", stats["step_skew"], step)
        mon.add_scalar("Cluster/wire_bytes_ici_total",
                       stats["wire_bytes_ici_total"], step)
        mon.add_scalar("Cluster/wire_bytes_dcn_total",
                       stats["wire_bytes_dcn_total"], step)
        mon.add_scalar("Cluster/hbm_peak_bytes_max",
                       stats["hbm_peak_bytes_max"], step)
        strag = stats["straggler"]
        mon.add_scalar("Cluster/straggler_host",
                       strag["host"] if strag else -1, step)
        if strag is not None:
            mon.event("cluster_straggler", dict(strag, step=step), step)

    # -- reporting ----------------------------------------------------------
    def clock_offsets(self):
        return estimate_clock_offsets(list(self.heartbeats))

    def bundle(self):
        out = {
            "version": CLUSTER_BUNDLE_VERSION,
            "kind": CLUSTER_KIND,
            "host": self.host_id,
            "n_hosts": self.n_hosts,
            "fields": list(HEARTBEAT_FIELDS),
            "heartbeat_interval": self.heartbeat_interval,
            "heartbeats": [[list(row) for row in m] for m in self.heartbeats],
            "stragglers": list(self.stragglers),
            "clock_offsets_s": self.clock_offsets(),
            "skew_integral_s": self.skew_integral_s,
        }
        if self.goodput is not None:
            out["goodput"] = self.goodput.summary()
        return out

    def summary(self):
        last = self.last_stats or {}
        return {
            "hosts": self.n_hosts,
            "heartbeats": len(self.heartbeats),
            "step_skew": last.get("step_skew"),
            "straggler_host": (self.stragglers[-1]["host"]
                               if self.stragglers else None),
            "straggler_events": len(self.stragglers),
            "watchdog_fired": len(self.watchdog.fired)
            if self.watchdog is not None else 0,
            "dumps": self.recorder.dump_count
            if self.recorder is not None else 0,
        }

    def stop(self):
        if self.watchdog is not None:
            self.watchdog.stop()


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _process_count():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# ------------------------------------------------------- fleet serving rollup


def fleet_latency_sketches(bundles):
    """Merge the ``latency_sketches`` of N replica request-trace bundles into
    one HistogramSketch per metric. Identical fixed-bin geometry on every
    replica makes the merge exact: fleet percentiles equal the percentiles
    of the concatenated request stream."""
    from ..serve.request_trace import HistogramSketch
    merged = {}
    for b in bundles:
        for metric, d in ((b or {}).get("latency_sketches") or {}).items():
            sk = HistogramSketch.from_dict(d)
            if metric in merged:
                merged[metric].merge_from(sk)
            else:
                merged[metric] = sk
    return merged


def fleet_latency_summary(bundles, ps=(50, 95, 99)):
    """Fleet-level latency percentiles from N replica bundles, in the same
    flat shape RequestTracer.latency_summary emits for one replica — the
    metrics substrate a fleet router's SLO gate reads."""
    out = {}
    merged = fleet_latency_sketches(bundles)
    for metric in sorted(merged):
        sk = merged[metric]
        if not sk.count:
            continue
        for p in ps:
            out[f"{metric}_p{p:g}"] = sk.percentile(p)
    return out


def fleet_serving_totals(bundles):
    """Sum the scheduled-work ``totals`` and lifecycle ``counts`` of N replica
    request-trace bundles into one fleet rollup. Integer-exact (token and
    request counters, no floats), so the speculation economics
    (drafted/accepted/wasted_draft_tokens) survive the fleet fold instead of
    being silently dropped next to the latency-sketch merge."""
    totals = {}
    counts = {}
    for b in bundles:
        for k, v in ((b or {}).get("totals") or {}).items():
            totals[k] = totals.get(k, 0) + int(v)
        for k, v in ((b or {}).get("counts") or {}).items():
            counts[k] = counts.get(k, 0) + int(v)
    return {"totals": totals, "counts": counts}


# ----------------------------------------------------------- merged timeline


def merged_cluster_trace(pipe_bundles, offsets_s=None):
    """Merge per-host pipeline_trace bundles into one Perfetto trace: host h's
    events land in process (track group) h, timestamps shifted by -offset_s[h]
    so every host renders on host 0's clock."""
    from .pipeline_trace import to_trace_events
    offsets_s = offsets_s or {}
    events = []
    offsets_us = {}
    for h in sorted(pipe_bundles):
        sub = to_trace_events(pipe_bundles[h])
        shift_us = int(round(-float(offsets_s.get(h, 0.0)) * 1e6))
        offsets_us[str(h)] = -shift_us
        for ev in sub["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = h
            if "ts" in ev:
                ev["ts"] = int(ev["ts"]) + shift_us
            events.append(ev)
    return trace_envelope(events, "ds-tpu timeline --cluster",
                          hosts=sorted(pipe_bundles),
                          clock_offsets_us=offsets_us)


def cluster_timeline(dump_dir, output, run=None):
    """Back end of ``ds-tpu timeline --cluster <dump_dir>``: load one run's
    per-host flight-recorder dumps, estimate clock offsets from the embedded
    heartbeat history, and write the merged trace."""
    from .numerics import load_run_bundles
    run_key, by_host = load_run_bundles(dump_dir, run=run)
    if not by_host:
        print(f"ds-tpu timeline --cluster: no flight-recorder dumps in "
              f"{dump_dir}" + (f" for run '{run}'" if run else ""),
              file=sys.stderr)
        return 2
    pipe = {}
    heartbeats = []
    for h in sorted(by_host):
        pt = by_host[h].get("pipeline_trace")
        if pt:
            pipe[h] = pt
        hb = (by_host[h].get("cluster") or {}).get("heartbeats") or []
        if len(hb) > len(heartbeats):
            heartbeats = hb
    if not pipe:
        print(f"ds-tpu timeline --cluster: no pipeline_trace bundles in the "
              f"dumps of run '{run_key}' (enable telemetry.pipeline_trace)",
              file=sys.stderr)
        return 2
    offs = estimate_clock_offsets(heartbeats)
    offsets = {h: (offs[h] if h < len(offs) else 0.0) for h in pipe}
    trace = merged_cluster_trace(pipe, offsets)
    with open(output, "w") as f:
        f.write(serialize_trace(trace))
    print(f"wrote {len(trace['traceEvents'])} trace events "
          f"({len(pipe)} host track group(s), run '{run_key}', clock offsets "
          f"{[round(offsets[h] * 1e3, 3) for h in sorted(offsets)]} ms) "
          f"-> {output}")
    return 0


# -------------------------------------------------------------- cluster-dump


def assemble_cluster_report(by_host, run_key=""):
    """Merge one run's per-host dump bundles into a single post-mortem:
    which host stalled first (deadline-origin hang events ordered by epoch,
    then clock-offset-corrected wall time, then host id), the scope it died
    in, the merged first-bad-step, and the straggler history."""
    from .numerics import merge_first_bad
    hosts = sorted(by_host)
    heartbeats = []
    stragglers = []
    for h in hosts:
        cb = by_host[h].get("cluster") or {}
        if len(cb.get("heartbeats") or []) > len(heartbeats):
            heartbeats = cb["heartbeats"]
        if not stragglers and cb.get("stragglers"):
            stragglers = cb["stragglers"]
    offs = estimate_clock_offsets(heartbeats)
    hangs = []
    for h in hosts:
        for ev in by_host[h].get("events", []):
            if ev.get("event") != "hang":
                continue
            p = ev.get("payload") or {}
            hangs.append({
                "host": h,
                "origin": p.get("origin"),
                "epoch": p.get("epoch"),
                "step": p.get("step"),
                "scope": p.get("last_scope"),
                "_t": float(ev.get("time") or 0.0)
                - (offs[h] if h < len(offs) else 0.0),
            })
    primaries = [g for g in hangs if g["origin"] == "deadline"] or hangs
    first = min(primaries, key=lambda g: (
        g["epoch"] if g["epoch"] is not None else 1 << 60, g["_t"],
        g["host"])) if primaries else None
    for g in hangs:
        g.pop("_t", None)
    fb_step, fb_host = merge_first_bad(by_host)
    # rank-0 fleet goodput: when the per-host cluster bundles (or the dumps
    # themselves) carry run-ledger summaries, fold them into one fleet view
    # with the per-host breakdown (utils/goodput.fleet_goodput)
    goodput_by_host = {}
    for h in hosts:
        led = (by_host[h].get("goodput")
               or (by_host[h].get("cluster") or {}).get("goodput"))
        if isinstance(led, dict) and led.get("kind") == "goodput":
            goodput_by_host[h] = led
    fleet_gp = None
    if goodput_by_host:
        from .goodput import fleet_goodput
        fleet_gp = fleet_goodput(goodput_by_host)
    # fleet alert plane (utils/alerts.py): when any host's dump carries an
    # alerts block, merge them — the report names the first-firing host +
    # rule, i.e. where the incident started
    alerts_fleet = None
    if any(isinstance(by_host[h].get("alerts"), dict) for h in hosts):
        from .alerts import merge_fleet_alerts
        alerts_fleet = merge_fleet_alerts(by_host)
    return {
        "version": 1,
        "kind": "cluster_report",
        "run": run_key,
        "hosts": hosts,
        "n_dumps": len(by_host),
        "hangs": hangs,
        "first_stall": ({"host": first["host"], "step": first["step"],
                         "scope": first["scope"], "origin": first["origin"]}
                        if first else None),
        "first_bad_step": fb_step,
        "first_bad_host": fb_host,
        "stragglers": stragglers,
        "goodput": fleet_gp,
        "alerts_fleet": alerts_fleet,
    }


def cluster_dump_main(argv=None):
    """Entry point for ``ds-tpu cluster-dump <dump_dir>``."""
    parser = argparse.ArgumentParser(
        prog="ds-tpu cluster-dump",
        description="Assemble one run's per-host flight-recorder dumps into "
                    "a single cluster post-mortem naming the first host to "
                    "stall and the scope it died in.")
    parser.add_argument("dump_dir", help="shared dump directory")
    parser.add_argument("--run", default=None,
                        help="assemble this run instead of the newest one")
    parser.add_argument("--json", action="store_true",
                        help="print the machine-readable report instead")
    args = parser.parse_args(argv)

    from .numerics import load_run_bundles
    run_key, by_host = load_run_bundles(args.dump_dir, run=args.run)
    if not by_host:
        print(f"no flight-recorder dumps in {args.dump_dir}"
              + (f" for run '{args.run}'" if args.run else ""),
              file=sys.stderr)
        return 2
    report = assemble_cluster_report(by_host, run_key=run_key or "")

    if args.json:
        print(json.dumps(report, indent=2, default=float))
        return 0

    print(f"cluster post-mortem: {args.dump_dir} "
          f"(run '{report['run']}', {len(report['hosts'])} host(s), "
          f"{report['n_dumps']} dump(s))")
    fs = report["first_stall"]
    if fs:
        print(f"  first stall    : host {fs['host']} at step {fs['step']} "
              f"in scope '{fs['scope']}' ({fs['origin']})")
    else:
        print("  first stall    : none recorded")
    for g in report["hangs"]:
        print(f"  host {g['host']:<4}: hang ({g['origin']}) at step "
              f"{g['step']}, last scope '{g['scope']}'")
    print(f"  first bad step : {report['first_bad_step']}"
          + (f" (host {report['first_bad_host']})"
             if report["first_bad_host"] is not None else ""))
    if report["stragglers"]:
        last = report["stragglers"][-1]
        print(f"  stragglers     : {len(report['stragglers'])} event(s), "
              f"last: host {last['host']} at step {last['step']} "
              f"({last['ratio']:.2f}x median)")
    return 0


# ------------------------------------------------------------------ hang-sim


def hang_sim_main(argv=None):
    """``ds-tpu hang-sim``: deterministic two-host hang rehearsal, fully
    in-process. Host 1 stalls inside ``ds_grad_bucket1`` with a short
    deadline; host 0 idles in ``ds_fwd_bwd`` with a deadline that cannot
    expire, so only the peer marker can make it dump — exercising detection,
    the cross-host signal, both dumps, and the cluster-dump report. The
    transcript contains no wall-clock values, so its bytes are pinned as a
    golden in scripts/lint.sh."""
    parser = argparse.ArgumentParser(
        prog="ds-tpu hang-sim",
        description="Deterministic two-host hang/watchdog rehearsal.")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="write the transcript JSON here")
    parser.add_argument("--dump-dir", default="/tmp/ds_tpu_hang_sim_dumps",
                        help="scratch dump directory (cleaned first)")
    parser.add_argument("--deadline", type=float, default=0.25,
                        help="host 1's hang deadline in seconds")
    args = parser.parse_args(argv)

    from .numerics import FlightRecorder, load_run_bundles
    from .pipeline_trace import simulated_bundle

    run = "hangsim"
    dump_dir = args.dump_dir
    os.makedirs(dump_dir, exist_ok=True)
    for name in os.listdir(dump_dir):  # stale state would corrupt the replay
        if name.startswith(("numerics_dump_", "cluster_hang_")):
            try:
                os.unlink(os.path.join(dump_dir, name))
            except OSError:
                pass

    class _StaticBundle:
        def __init__(self, b):
            self._b = b

        def bundle(self):
            return self._b

    stall_step = 3
    hosts = (0, 1)
    trackers, monitors, recorders, watchdogs = {}, {}, {}, {}
    for h in hosts:
        trackers[h] = ScopeTracker()
        pipe = simulated_bundle(4, 2, step=stall_step)
        pipe["host"] = h
        monitors[h] = ClusterMonitor(
            heartbeat_interval=1, straggler_threshold=3.0,
            host_id=h, n_hosts=2, tracker=trackers[h],
            allgather=lambda row: [row])
        recorders[h] = FlightRecorder(
            capacity=16, dump_dir=dump_dir, host_id=h, run_id=run,
            pipeline_trace=_StaticBundle(pipe), cluster=monitors[h])
        monitors[h].recorder = recorders[h]

    # synthetic heartbeat history: host 1's wall clock runs 1.5 ms behind
    # host 0's, so the merged timeline must shift its track group forward
    for s in range(stall_step + 1):
        wall0 = 1000.0 + float(s)
        matrix = [[float(s), wall0, 12.0, 9.0, 1024.0, 2048.0, 0.0],
                  [float(s), wall0 - 0.0015, 13.5, 10.0, 1024.0, 2048.0, 0.0]]
        for h in hosts:
            monitors[h].ingest(matrix, s)

    # per-host goodput ledgers on a FAKE clock (utils/goodput.py): 1s of
    # init then four 1s steps, host 1's stall step billed to ``hang``. The
    # ledgers ride the cluster bundles into both dumps, so the merged report
    # must carry the rank-0 fleet goodput view — with deterministic seconds,
    # keeping the transcript byte-pinnable.
    from .goodput import RunLedger
    ledgers = {}
    for h in hosts:
        cell = [0.0]

        def _clock(cell=cell):
            return cell[0]

        led = RunLedger(run_id=run, host=h, clock=_clock,
                        wall=lambda: 1000.0)
        cell[0] = 1.0
        led.close("init")
        for s in range(stall_step + 1):
            cell[0] += 1.0
            led.close_step(s, hang=(h == 1 and s == stall_step))
        led.finalize(persist=False)
        ledgers[h] = led
        monitors[h].goodput = led

    # host 1: short deadline, stalled inside a grad-bucket collective.
    # host 0: un-expirable deadline — only the peer signal can fire it.
    trackers[0].enter("ds_fwd_bwd")
    trackers[1].enter("ds_grad_bucket1")
    watchdogs[1] = HangWatchdog(
        recorder=recorders[1], deadline_s=args.deadline, dump_dir=dump_dir,
        host_id=1, run_id=run, tracker=trackers[1], poll_s=0.05)
    watchdogs[0] = HangWatchdog(
        recorder=recorders[0], deadline_s=3600.0, dump_dir=dump_dir,
        host_id=0, run_id=run, tracker=trackers[0], poll_s=0.05)
    t_armed = time.monotonic()
    for h in hosts:
        watchdogs[h].arm(stall_step)

    deadline_wall = t_armed + max(args.deadline * 40.0, 15.0)
    while time.monotonic() < deadline_wall:
        if all(recorders[h].dump_count >= 1 for h in hosts):
            break
        time.sleep(0.02)
    for h in hosts:
        watchdogs[h].stop()

    run_key, by_host = load_run_bundles(dump_dir, run=run)
    report = assemble_cluster_report(by_host, run_key=run_key or "")

    fired = sorted((p for h in hosts for p in watchdogs[h].fired),
                   key=lambda p: p["host"])
    dumps = [{"host": p["host"], "origin": p["origin"], "epoch": p["epoch"],
              "step": p["step"], "last_scope": p["last_scope"]}
             for p in fired]
    detected = any(
        p["origin"] == "deadline" and p["host"] == 1
        and p["waited_s"] is not None
        and p["waited_s"] <= args.deadline + 2.0
        for p in watchdogs[1].fired)
    # the fleet goodput view must survive the dump -> merge round trip with
    # the stalled host's hang second attributed (7 productive host-seconds
    # of 10 total -> 0.7)
    gp = report.get("goodput")
    goodput_attributed = bool(
        gp is not None and gp.get("kind") == "goodput_fleet"
        and gp.get("n_hosts") == 2 and gp.get("hang_steps") == 1
        and abs(gp["class_seconds"]["hang"] - 1.0) < 1e-9
        and abs(gp["goodput_fraction"] - 0.7) < 1e-9)
    ok = (detected
          and len(dumps) == 2
          and all(recorders[h].dump_count >= 1 for h in hosts)
          and goodput_attributed
          and report["first_stall"] == {"host": 1, "step": stall_step,
                                        "scope": "ds_grad_bucket1",
                                        "origin": "deadline"})
    transcript = {
        "version": 1,
        "kind": "hang_sim",
        "scenario": "two-host stalled-collective rehearsal",
        "deadline_s": args.deadline,
        "stalled_host": 1,
        "stall_step": stall_step,
        "detected_within_deadline": bool(detected),
        "goodput_attributed": goodput_attributed,
        "dumps": dumps,
        "report": report,
        "ok": bool(ok),
    }

    print(f"hang-sim: stall injected on host 1 at step {stall_step} "
          f"(deadline {args.deadline}s)")
    for d in dumps:
        print(f"  host {d['host']}: dumped ({d['origin']}), last scope "
              f"'{d['last_scope']}'")
    fs = report["first_stall"]
    if fs:
        print(f"  cluster-dump: first stall host {fs['host']} in scope "
              f"'{fs['scope']}'")
    if gp is not None:
        print(f"  fleet goodput: {gp['goodput_fraction']:.2f} over "
              f"{gp['n_hosts']} hosts ({gp['hang_steps']} hung step(s))")
    print(f"hang-sim: {'OK' if ok else 'FAILED'}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(transcript, f, indent=2, sort_keys=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(cluster_dump_main())
