"""Numerics observatory: the sentinel, the desync audit and the flight
recorder (PyTorch port of ``deepspeed_tpu/utils/numerics.py``).

1. **Sentinel bucketing** (JAX lines 52-119): ``SubtreeIndex`` maps the
   engine's leaves to named parameter subtrees; ``bucket_sumsq`` and
   ``bucket_nonfinite`` fold per-leaf statistics into per-subtree vectors on
   the device, inside the engine's update. The subtree names are JAX's for
   the same model: they come from the same tree paths (``subtree_name`` on
   the module's ``params_tree()`` with sorted keys, whose torch pytree keys
   carry ``.key`` / ``.idx`` as JAX's do). The vectors leave the device with
   the step's one loss fetch (``TelemetrySession.fetch_window``), never
   through a fetch of their own.
2. **Desync audit** (JAX lines 122-185): ``leaf_checksum`` is bitwise JAX's
   uint32 sum of a leaf's bit patterns, wrapping mod 2^32; CUDA torch has no
   reliable uint32 sum, so the patterns are widened to int64, summed (exact
   while the leaf has fewer than 2^31 elements, which is checked) and
   reduced mod 2^32. ``compare_audit_rows`` is the host comparator over the
   ``[replicas, n_subtrees]`` matrix an audit step's all-gather returns.
3. **Flight recorder** (JAX lines 188-438), with the bundle's HBM forensics
   block (``utils/hbm.py`` ``oom_forensics``); copied host code.
4. ``NumericsMonitor`` (JAX lines 441-616): the host coordinator, copied.
5. The dump reader (JAX lines 618-734) for auto-resume
   (``resilience/auto_resume.py``) and the cluster post-mortem, and its
   command line ``inspect_dump_main`` (``ds-tpu-torch inspect-dump``; JAX
   lines 737-826), copied.

This module performs no host synchronisation of its own: the device helpers
return tensors, and the host parts read values the engine already fetched.
"""

import argparse
import atexit
import json
import math
import os
import re
import signal
import socket
import time
from collections import deque

import torch

from .logging import logger

NUMERICS_DUMP_VERSION = 1

# ------------------------------------------------------------------ subtrees


def subtree_name(path, depth=1):
    """Join the first ``depth`` components of a tree key path (JAX's
    ``DictKey.key`` / ``SequenceKey.idx`` / ``GetAttrKey.name``, or torch
    pytree's ``MappingKey.key`` / ``SequenceKey.idx`` / ``GetAttrKey.name``)."""
    parts = []
    for p in path[:depth]:
        key = getattr(p, "key", None)
        if key is None:
            key = getattr(p, "idx", None)
        if key is None:
            key = getattr(p, "name", None)
        if key is None:
            key = p
        parts.append(str(key))
    return "/".join(parts) if parts else "<root>"


class SubtreeIndex:
    """Static mapping of leaves to named parameter subtrees: ``names`` in
    the order of their first leaf in the tree, ``leaf_buckets[i]`` the
    subtree of leaf ``i`` (in the order the leaves are handed to
    ``bucket_sumsq``)."""

    __slots__ = ("names", "leaf_buckets", "_members")

    def __init__(self, names, leaf_buckets):
        self.names = list(names)
        self.leaf_buckets = list(leaf_buckets)
        self._members = {}

    @property
    def n(self):
        return len(self.names)

    def members(self, device):
        """Per subtree, the int64 indices of its leaves on ``device``
        (built once a device)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        hit = self._members.get(key)
        if hit is None:
            hit = self._members[key] = [
                torch.tensor([i for i, b in enumerate(self.leaf_buckets) if b == j],
                             dtype=torch.long, device=device)
                for j in range(self.n)]
        return hit


def build_subtree_index(tree, depth=1, positions=False):
    """The index of a tree's leaves (nested dicts, lists, tuples), walked
    as ``jax.tree_util`` walks it: dict keys sorted. Names come in the order
    of their first leaf. ``positions``: the tree's leaves are the positions
    (ints) at which the device helpers receive them (the engine's parameter
    order, which differs from the tree's), and ``leaf_buckets`` follows
    those positions."""
    from torch.utils import _pytree as pytree

    def by_key(node):
        if isinstance(node, dict):
            return {k: by_key(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            return type(node)(by_key(n) for n in node)
        return node

    pairs = pytree.tree_flatten_with_path(by_key(tree))[0]
    names, name_to_id = [], {}
    buckets = [None] * len(pairs)
    for k, (path, leaf) in enumerate(pairs):
        name = subtree_name(path, depth)
        if name not in name_to_id:
            name_to_id[name] = len(names)
            names.append(name)
        buckets[int(leaf) if positions else k] = name_to_id[name]
    return SubtreeIndex(names, buckets)


# ------------------------------------------------------------- device math


def _segment(vals, index):
    """Per-subtree sums of a per-leaf vector, each a sum over its members
    in leaf order (deterministic, unlike an atomic scatter)."""
    return torch.stack([vals.index_select(0, m).sum() for m in index.members(vals.device)])


def leaf_sumsq(leaves):
    """float32 ``[n_leaves]``: each leaf's sum of squares."""
    return torch.stack([torch.sum(torch.square(t.float())) for t in leaves])


def leaf_nonfinite(leaves):
    """int64 ``[n_leaves]``: each leaf's count of inf and nan elements."""
    return torch.stack([torch.count_nonzero(~torch.isfinite(t)) for t in leaves])


def bucket_sumsq(leaves, index, per_leaf=None):
    """Per-subtree sum of squares (float32 ``[index.n]``) of a list of
    tensors in the index's leaf order; ``per_leaf`` the leaves' own sums
    when already formed (the engine's, after its cross-rank sum)."""
    vals = leaf_sumsq(leaves) if per_leaf is None else per_leaf
    return _segment(vals, index)


def bucket_nonfinite(leaves, index, per_leaf=None):
    """Per-subtree nonfinite element count (int64 ``[index.n]``; JAX's
    int32 counts, widened)."""
    vals = leaf_nonfinite(leaves) if per_leaf is None else per_leaf
    return _segment(vals, index)


_CHECKSUM_MAX_ELEMENTS = 1 << 31    # n * (2^32 - 1) stays below 2^63


def leaf_checksum(leaf):
    """Bitwise JAX's ``leaf_checksum``: the uint32 sum, wrapping mod 2^32,
    of a tensor's bit patterns (bool as 0/1; 8-byte dtypes folded to 4
    bytes first, floats to float32, integers to int32), as an int64 0-d
    tensor in [0, 2^32). The patterns are widened to int64 and summed
    exactly, which holds below 2^31 elements (else ValueError)."""
    if leaf.numel() >= _CHECKSUM_MAX_ELEMENTS:
        raise ValueError(f"leaf_checksum: {leaf.numel()} elements overflow the int64 "
                         "sum of 32-bit patterns")
    x = leaf.detach().contiguous()
    if x.dtype == torch.bool:
        bits = x.to(torch.int64)
    else:
        if x.element_size() == 8:
            x = x.to(torch.float32) if x.is_floating_point() else x.to(torch.int32)
        size = x.element_size()
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]
        mask = (1 << (8 * size)) - 1
        bits = x.view(view).to(torch.int64) & mask
    return torch.remainder(bits.sum(), 1 << 32)


# --------------------------------------------------------- host-side compare


def compare_audit_rows(matrix, names, slice_rows=None):
    """Host comparator for the audit all-gather result (JAX lines 143-185).

    `matrix` is a [replicas, n_subtrees] array of uint32 checksums (already
    fetched by the engine). Returns None when every replica agrees, else a
    dict naming the FIRST diverging subtree and which replicas disagree with
    replica 0. `slice_rows` (optional) groups the replicas by slice and
    classifies the divergence as "intra_slice" or "cross_slice"."""
    rows = [[int(v) for v in row] for row in matrix]
    if len(rows) <= 1:
        return None
    n = len(rows[0])
    for j in range(n):
        col = [row[j] for row in rows]
        if any(c != col[0] for c in col):
            div = {
                "subtree": names[j] if j < len(names) else f"<{j}>",
                "index": j,
                "checksums": col,
                "diverging_replicas": [i for i, c in enumerate(col) if c != col[0]],
            }
            if slice_rows and len(slice_rows) > 1:
                intra = any(
                    any(col[r] != col[grp[0]] for r in grp if r < len(col))
                    for grp in slice_rows if grp and grp[0] < len(col))
                div["level"] = "intra_slice" if intra else "cross_slice"
                ref = col[slice_rows[0][0]] if slice_rows[0][0] < len(col) else col[0]
                div["diverging_slices"] = [
                    s for s, grp in enumerate(slice_rows)
                    if grp and grp[0] < len(col) and col[grp[0]] != ref]
            return div
    return None


# ------------------------------------------------------------ flight recorder


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
        snap = None
        if self.telemetry is not None:
            snapper = getattr(self.telemetry, "memory_snapshot", None)
            if snapper is not None:
                try:
                    snap = snapper()
                except Exception:  # forensics must never block the dump
                    snap = None
        if snap is not None:
            try:
                from .hbm import oom_forensics
                out["hbm"] = oom_forensics(snap)
            except Exception:
                out["hbm"] = {"error": "oom_forensics failed", "snapshot": snap}
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


class NumericsMonitor:
    """Host-side coordinator: consumes the per-step sentinel stats (already
    fetched through the telemetry loss ride-along), feeds the journal,
    monitor scalars/events, and the flight recorder, and decides triggers."""

    def __init__(self, index, *, monitor=None, telemetry=None, journal=None,
                 recorder=None, audit_interval=0, consecutive_skip_trigger=8,
                 trigger_on_nonfinite_loss=True):
        self.index = index
        self.monitor = monitor
        self.telemetry = telemetry
        self.journal = journal
        self.recorder = recorder
        self.audit_interval = int(audit_interval)
        self.consecutive_skip_trigger = int(consecutive_skip_trigger)
        self.trigger_on_nonfinite_loss = bool(trigger_on_nonfinite_loss)
        self.anomaly_count = 0
        self.audit_runs = 0
        self.audit_seconds = 0.0
        self.desync = None
        self.last_record = None
        self._warned = 0
        if journal is not None:
            journal.emit = self._on_journal_event

    # -- plumbing ----------------------------------------------------------
    def _on_journal_event(self, ev, step):
        if self.monitor is not None:
            self.monitor.event("loss_scale", ev, step)
        if self.recorder is not None:
            self.recorder.record_event("loss_scale", ev, step)

    def _scalar(self, tag, value, step):
        if self.monitor is not None:
            self.monitor.add_scalar(tag, value, step)

    # -- per-step commit ---------------------------------------------------
    def commit_step(self, step, stats, *, loss=None, overflowed=False,
                    grad_norm=None):
        """All inputs are HOST values (the engine fetched them alongside the
        loss). `stats` maps sentinel keys to per-subtree vectors, or is None
        on paths that produce no sentinel (e.g. a pure-eval step)."""
        if self.journal is not None:
            self.journal.record(step, overflowed)
        loss_scale = self.journal.cur_scale if self.journal is not None else None

        names = self.index.names
        anomaly = None
        record = {"step": step, "overflow": bool(overflowed), "loss": loss,
                  "loss_scale": loss_scale, "grad_norm": grad_norm,
                  "subtrees": names}

        if stats is not None:
            gss = [float(v) for v in stats.get("grad_sumsq", [])]
            wss = [float(v) for v in stats.get("weight_sumsq", [])]
            uss = [float(v) for v in stats.get("update_sumsq", [])]
            nonfinite = [int(v) for v in stats.get("grad_nonfinite", [])]

            record["grad_norm_per_subtree"] = [
                math.sqrt(max(v, 0.0)) for v in gss]
            if wss:
                record["weight_norm_per_subtree"] = [
                    math.sqrt(max(v, 0.0)) for v in wss]
            if uss and wss:
                record["update_ratio_per_subtree"] = [
                    (math.sqrt(max(u, 0.0)) / math.sqrt(w))
                    if w > 0.0 else 0.0
                    for u, w in zip(uss, wss)]
            record["nonfinite_total"] = sum(nonfinite)
            record["nonfinite_per_subtree"] = nonfinite

            for j, name in enumerate(names):
                if j < len(gss):
                    self._scalar(f"Numerics/grad_norm/{name}",
                                 record["grad_norm_per_subtree"][j], step)
                if j < len(wss):
                    self._scalar(f"Numerics/weight_norm/{name}",
                                 record["weight_norm_per_subtree"][j], step)
                if "update_ratio_per_subtree" in record and j < len(uss):
                    self._scalar(f"Numerics/update_ratio/{name}",
                                 record["update_ratio_per_subtree"][j], step)

            bad = [j for j, c in enumerate(nonfinite) if c > 0]
            if bad:
                anomaly = {"kind": "nonfinite_grad",
                           "subtree": names[bad[0]],
                           "count": nonfinite[bad[0]],
                           "per_subtree": {names[j]: nonfinite[j] for j in bad}}

        if loss is not None and not math.isfinite(loss):
            if anomaly is None:
                anomaly = {"kind": "nonfinite_loss", "subtree": None}
            anomaly["nonfinite_loss"] = True

        record["anomaly"] = anomaly
        self.last_record = record
        if self.recorder is not None:
            self.recorder.record_step(record)

        if anomaly is not None:
            self.anomaly_count += 1
            if self.recorder is not None:
                self.recorder.note_anomaly()
            if self._warned < 3:
                self._warned += 1
                logger.warning(
                    f"numerics: anomaly at step {step}: {anomaly['kind']}"
                    + (f" in subtree '{anomaly['subtree']}'"
                       if anomaly.get("subtree") else ""))

        # triggers
        if self.recorder is not None:
            if (self.trigger_on_nonfinite_loss and loss is not None
                    and not math.isfinite(loss)):
                self.recorder.trigger("nonfinite_loss", {"step": step})
            elif (self.journal is not None and self.consecutive_skip_trigger > 0
                  and self.journal.skip_streak == self.consecutive_skip_trigger):
                self.recorder.trigger(
                    "consecutive_overflow_skips",
                    {"step": step, "streak": self.journal.skip_streak})
        return record

    # -- audit -------------------------------------------------------------
    def audit_due(self, step):
        return self.audit_interval > 0 and step > 0 \
            and step % self.audit_interval == 0

    def commit_audit(self, step, matrix, names, seconds=0.0, slice_rows=None):
        """`matrix` is the host-fetched [replicas, n] checksum matrix;
        `slice_rows` (optional, CommTopology.slice_rows) classifies any
        divergence per network level (intra_slice vs cross_slice)."""
        self.audit_runs += 1
        self.audit_seconds += float(seconds)
        divergence = compare_audit_rows(matrix, names, slice_rows=slice_rows)
        payload = {"replicas": len(matrix), "subtrees": len(names),
                   "seconds": seconds,
                   "divergence": divergence}
        if self.monitor is not None:
            self.monitor.event("desync_audit", payload, step)
        if self.recorder is not None:
            self.recorder.record_event("desync_audit", payload, step)
        if divergence is not None:
            self.desync = dict(divergence, step=step)
            level = divergence.get("level")
            logger.error(
                f"numerics: CROSS-RANK DESYNC at step {step}: subtree "
                f"'{divergence['subtree']}' disagrees on replicas "
                f"{divergence['diverging_replicas']}"
                + (f" (level: {level})" if level else ""))
            if self.recorder is not None:
                self.recorder.note_anomaly()
                self.recorder.trigger("desync", dict(divergence, step=step))
        return divergence

    # -- reporting ---------------------------------------------------------
    def summary(self):
        return {
            "anomaly_count": self.anomaly_count,
            "journal_events": len(self.journal.events)
            if self.journal is not None else 0,
            "audit_runs": self.audit_runs,
            "audit_seconds": self.audit_seconds,
            "desync": self.desync is not None,
            "dumps": self.recorder.dump_count if self.recorder is not None else 0,
        }



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


def _inspect_dump_dir(dump_dir, run, as_json):
    """Directory mode: merge the newest run's per-host dumps into one view."""
    run_key, by_host = load_run_bundles(dump_dir, run=run)
    if not by_host:
        print(f"no flight-recorder dumps in {dump_dir}"
              + (f" for run '{run}'" if run else ""))
        return 2
    fb_step, fb_host = merge_first_bad(by_host)
    summaries = {h: summarize_dump(by_host[h]) for h in sorted(by_host)}
    if as_json:
        print(json.dumps({
            "run": run_key,
            "hosts": {str(h): summaries[h] for h in summaries},
            "first_bad_step": fb_step,
            "first_bad_host": fb_host,
        }, indent=2, default=float))
        return 0
    print(f"numerics post-mortem: {dump_dir} "
          f"(run '{run_key}', {len(by_host)} host(s))")
    print(f"  first bad step : {fb_step}")
    print(f"  first bad host : {fb_host}")
    for h in sorted(summaries):
        s = summaries[h]
        print(f"  host {h:<4}: reason={s['reason']} "
              f"first_bad_step={s['first_bad_step']} "
              f"subtree={s['offending_subtree']} "
              f"steps={s['steps_recorded']} events={s['events_recorded']}")
    return 0


def inspect_dump_main(argv=None):
    """Entry point for `ds-tpu-torch inspect-dump <dump.json | dump_dir>`."""
    parser = argparse.ArgumentParser(
        prog="ds-tpu-torch inspect-dump",
        description="Summarize a numerics flight-recorder post-mortem bundle, "
                    "or merge a directory of per-host dumps.")
    parser.add_argument("dump", help="path to a numerics_dump_*.json bundle, "
                                     "or a dump directory of per-host bundles")
    parser.add_argument("--run", default=None,
                        help="directory mode: inspect this run instead of the "
                             "newest one")
    parser.add_argument("--json", action="store_true",
                        help="print the machine-readable summary instead")
    args = parser.parse_args(argv)

    if os.path.isdir(args.dump):
        return _inspect_dump_dir(args.dump, args.run, args.json)

    with open(args.dump) as f:
        bundle = json.load(f)
    s = summarize_dump(bundle)

    if args.json:
        print(json.dumps(s, indent=2, default=float))
        return 0

    print(f"numerics post-mortem: {args.dump}")
    print(f"  trigger reason    : {s['reason']}")
    if s["detail"]:
        print(f"  trigger detail    : {s['detail']}")
    print(f"  host              : {s['host']}")
    print(f"  first bad step    : {s['first_bad_step']}")
    print(f"  offending subtree : {s['offending_subtree']}")
    print(f"  steps recorded    : {s['steps_recorded']}")
    print(f"  events recorded   : {s['events_recorded']}")
    if s.get("span"):
        sp = s["span"]
        mono = float(sp.get("mono_end", 0.0)) - float(sp.get("mono_start", 0.0))
        print(f"  step span         : steps {sp.get('first_step')}"
              f"..{sp.get('last_step')} over {mono:.3f}s "
              f"({sp.get('steps_spanned')} interval(s))")
    if s["desync"]:
        d = s["desync"]
        print(f"  DESYNC            : subtree '{d.get('subtree')}' on replicas "
              f"{d.get('diverging_replicas')}")
    traj = s["loss_scale_trajectory"]
    if traj:
        print("  loss-scale trajectory (step, scale):")
        shown = traj if len(traj) <= 16 else traj[:8] + traj[-8:]
        for step, scale in shown:
            print(f"    {step:>8}  {scale}")
        if len(traj) > 16:
            print(f"    ... ({len(traj)} points total)")
    if s["compile_records"]:
        print("  compile records:")
        for rec in s["compile_records"]:
            print(f"    {rec['program']}: {rec['count']} run(s), "
                  f"{rec['compile_seconds']:.3f}s compile")
    return 0
