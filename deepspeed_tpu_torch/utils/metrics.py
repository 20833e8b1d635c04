"""PyTorch port: a copy of ``deepspeed_tpu/utils/metrics.py`` (lines 1-520:
the catalog, ``MetricStore``, ``merge_host_rings``, the OpenMetrics export
and ``metrics_main``), host-only and unchanged in behaviour; the catalog and
the exported text are the JAX package's byte for byte.

Unified metric catalog + per-host time-series ring (docs/metrics.md).

Every scalar name any observatory emits (``Telemetry/*``, ``Numerics/*``,
``Pipeline/*``, ``Serving/*`` including ``Serving/Fleet/*`` and
``Serving/Spec/*``, ``Cluster/*``, ``Run/Goodput/*``, ``Memory/*``,
``Profile/*``, ``Anatomy/*``, ``Train/*``, ``Alerts/*``) is declared ONCE
here with its unit, direction (lower/higher-is-better/neutral), class and a
one-line description. The catalog is the single source of truth for "which
way is worse" — bench.py derives its regression directions from it (no
private LOWER_IS_BETTER list survives anywhere else) and the alert plane
(utils/alerts.py) uses it to orient ``delta`` regression rules.

``MetricStore`` is the router: attached to a ``SummaryMonitor`` (monitor.py)
it sees every ``add_scalar`` on every rank, validates the name against the
catalog (warn-once on unknown names; a strict mode for tests turns drift
into an error), and keeps a bounded per-metric time-series ring. The ring
has FIXED geometry (``ring_len`` observations per metric), so per-host rings
are exactly mergeable across hosts through the existing flight-recorder /
cluster dump plane — same discipline as the serving latency sketches: merging
is a lossless union keyed by (host, step), never a lossy reduction.

Everything here is pure host bookkeeping: no jax import, no device work, no
blocking primitives (pinned by tests/test_torch_no_sync_guard.py). The step
programs are HLO-instruction-identical with the router attached or not.

``ds-tpu metrics`` lists the catalog or exports the latest observations as
OpenMetrics text for external scrapers.
"""

import json
import os
import re
from collections import deque

from .logging import logger

# directions: which way is WORSE. "neutral" metrics carry no regression
# semantics (identifiers, configuration echoes, context gauges).
LOWER = "lower_is_better"
HIGHER = "higher_is_better"
NEUTRAL = "neutral"

CATALOG_VERSION = 1
DEFAULT_RING_LEN = 512


class UnknownMetricError(KeyError):
    """Raised in strict mode when a scalar is emitted under an undeclared
    name — the catalog drift guard (tests) turns schema bypass into a
    failure instead of a silently untyped metric."""


class MetricSpec:
    """One declared metric (exact name) or metric family (``Prefix/*``)."""

    __slots__ = ("pattern", "unit", "direction", "klass", "description")

    def __init__(self, pattern, unit, direction, klass, description):
        if direction not in (LOWER, HIGHER, NEUTRAL):
            raise ValueError(f"bad direction {direction!r} for {pattern!r}")
        self.pattern = pattern
        self.unit = unit
        self.direction = direction
        self.klass = klass
        self.description = description

    @property
    def is_family(self):
        return self.pattern.endswith("/*")

    def matches(self, name):
        if self.is_family:
            return name.startswith(self.pattern[:-1])
        return name == self.pattern

    def to_dict(self):
        return {"pattern": self.pattern, "unit": self.unit,
                "direction": self.direction, "class": self.klass,
                "description": self.description}


def _spec(pattern, unit, direction, klass, description):
    return MetricSpec(pattern, unit, direction, klass, description)


# The declarations. Exact names win over families; among families the
# LONGEST matching prefix wins (``Serving/Fleet/Latency/*`` over
# ``Serving/Fleet/*``). Units follow the scalar's own convention (ms, bytes,
# fraction in [0,1], count, 1/s). Classes group metrics for rendering and
# export: time / throughput / bytes / count / fraction / gauge.
_DECLARATIONS = (
    # -- engine training scalars (runtime/engine.py) -----------------------
    _spec("Train/Samples/train_loss", "loss", LOWER, "gauge",
          "training loss at the sample axis"),
    _spec("Train/Samples/lr", "1", NEUTRAL, "gauge",
          "learning rate of param group 0"),
    _spec("Train/Samples/loss_scale", "1", NEUTRAL, "gauge",
          "dynamic fp16 loss scale (host journal shadow)"),
    _spec("Train/Samples/grad_norm", "1", NEUTRAL, "gauge",
          "global gradient norm after clipping"),
    # -- telemetry step metrics (utils/telemetry.py end_step) --------------
    _spec("Telemetry/Samples/step_time_ms", "ms", LOWER, "time",
          "end-to-end optimizer step wall time"),
    _spec("Telemetry/Samples/samples_per_sec", "1/s", HIGHER, "throughput",
          "training throughput over the last step"),
    _spec("Telemetry/Samples/mfu", "fraction", HIGHER, "fraction",
          "rolling model FLOPS utilization over compile-free steps"),
    _spec("Telemetry/Samples/wire_bytes", "bytes", NEUTRAL, "bytes",
          "collective bytes moved by the last step (all links)"),
    _spec("Telemetry/Samples/wire_bytes_ici", "bytes", NEUTRAL, "bytes",
          "intra-slice (ICI) collective bytes of the last step"),
    _spec("Telemetry/Samples/wire_bytes_dcn", "bytes", NEUTRAL, "bytes",
          "cross-slice (DCN) collective bytes of the last step"),
    _spec("Telemetry/Samples/hbm_in_use_bytes", "bytes", LOWER, "bytes",
          "device HBM currently in use (backend watermark)"),
    _spec("Telemetry/Samples/hbm_peak_bytes", "bytes", LOWER, "bytes",
          "device HBM peak watermark"),
    _spec("Telemetry/Samples/compile_count", "count", LOWER, "count",
          "cumulative program compiles seen by the watchdog"),
    # -- HBM observatory (docs/hbm.md): per-class resident bytes -----------
    _spec("Memory/*", "bytes", LOWER, "bytes",
          "per-class resident HBM attribution from the engine manifest"),
    # -- step anatomy (docs/anatomy.md): roofline attribution --------------
    _spec("Anatomy/compute_ms", "ms", NEUTRAL, "time",
          "roofline compute floor of the measured step"),
    _spec("Anatomy/hbm_bound_ms", "ms", NEUTRAL, "time",
          "roofline HBM-bandwidth floor of the measured step"),
    _spec("Anatomy/exposed_ici_ms", "ms", LOWER, "time",
          "un-overlapped ICI collective time attributed to the step"),
    _spec("Anatomy/exposed_dcn_ms", "ms", LOWER, "time",
          "un-overlapped DCN collective time attributed to the step"),
    _spec("Anatomy/host_gap_ms", "ms", LOWER, "time",
          "measured wall minus every device-side floor (host stall)"),
    _spec("Anatomy/predicted_floor_ms", "ms", NEUTRAL, "time",
          "max of the roofline floors — the step's predicted best case"),
    _spec("Anatomy/mfu_ceiling", "fraction", NEUTRAL, "fraction",
          "MFU the roofline model admits for this step shape"),
    # -- pipeline schedule goodput (docs/pipeline-trace.md) ----------------
    _spec("Pipeline/Goodput/bubble_seconds", "s", LOWER, "time",
          "schedule bubble (idle) seconds within one pipeline step"),
    _spec("Pipeline/Goodput/bubble_fraction", "fraction", LOWER, "fraction",
          "bubble share of the pipeline step"),
    _spec("Pipeline/Goodput/*", "s", NEUTRAL, "time",
          "per-phase seconds of the pipeline schedule decomposition"),
    # -- run-lifecycle goodput ledger (docs/goodput.md) --------------------
    _spec("Run/Goodput/goodput_fraction", "fraction", HIGHER, "fraction",
          "productive share of the run's accounted wall-clock"),
    _spec("Run/Goodput/wall_seconds", "s", NEUTRAL, "time",
          "total accounted run wall-clock"),
    _spec("Run/Goodput/productive_step_seconds", "s", HIGHER, "time",
          "wall-clock billed to productive training steps"),
    _spec("Run/Goodput/checkpoint_stall_seconds", "s", LOWER, "time",
          "caller-thread wall-clock lost to checkpoint fences"),
    _spec("Run/Goodput/restart_replay_seconds", "s", LOWER, "time",
          "wall-clock re-paying steps lost to a restart"),
    _spec("Run/Goodput/hang_seconds", "s", LOWER, "time",
          "wall-clock inside watchdog-detected hangs"),
    _spec("Run/Goodput/straggler_skew_seconds", "s", LOWER, "time",
          "wall-clock this host spent above the fleet median dispatch"),
    _spec("Run/Goodput/host_gap_seconds", "s", LOWER, "time",
          "wall-clock in unattributed host gaps"),
    _spec("Run/Goodput/*", "s", NEUTRAL, "time",
          "remaining badput classes (init, compile, eval tag)"),
    # -- serving engine (docs/serving.md) ----------------------------------
    _spec("Serving/Latency/*", "ms", LOWER, "time",
          "request latency percentile summary (TTFT/TPOT/queue/e2e)"),
    _spec("Serving/PrefixCache/hit_rate", "fraction", HIGHER, "fraction",
          "prefix-cache token hit rate"),
    _spec("Serving/PrefixCache/hit_tokens", "count", HIGHER, "count",
          "prefill tokens served from the prefix cache"),
    _spec("Serving/PrefixCache/*", "count", NEUTRAL, "count",
          "prefix-cache occupancy counters (parked blocks, evictions)"),
    _spec("Serving/Spec/acceptance_rate", "fraction", HIGHER, "fraction",
          "speculative-draft token acceptance rate"),
    _spec("Serving/Spec/accepted_tokens", "count", HIGHER, "count",
          "draft tokens accepted by the target model"),
    _spec("Serving/Spec/wasted_draft_tokens", "count", LOWER, "count",
          "draft tokens rejected by the target model"),
    _spec("Serving/Spec/target_steps_per_token", "1", LOWER, "gauge",
          "target-model program executions per emitted token"),
    _spec("Serving/Spec/*", "count", NEUTRAL, "count",
          "speculative decoding counters (drafted tokens)"),
    _spec("Serving/Waste/replayed_tokens", "count", LOWER, "count",
          "scheduled tokens re-computed after preemption"),
    _spec("Serving/Waste/fraction", "fraction", LOWER, "fraction",
          "replayed share of all scheduled tokens"),
    _spec("Serving/Pool/fragmentation", "fraction", LOWER, "fraction",
          "paged KV pool fragmentation"),
    _spec("Serving/occupancy", "fraction", HIGHER, "fraction",
          "decode batch slot occupancy"),
    _spec("Serving/waiting", "count", LOWER, "count",
          "requests waiting for admission"),
    _spec("Serving/free_blocks", "count", HIGHER, "count",
          "free KV pool blocks"),
    _spec("Serving/tok_s", "1/s", HIGHER, "throughput",
          "sampled tokens per second"),
    _spec("Serving/goodput_tok_s", "1/s", HIGHER, "throughput",
          "tokens per second of requests that finished"),
    _spec("Serving/ttft_ms", "ms", LOWER, "time",
          "per-request time to first token"),
    _spec("Serving/ttft_iters", "count", LOWER, "count",
          "per-request engine iterations to first token"),
    # -- fleet router (docs/serving.md): merged across replicas ------------
    _spec("Serving/Fleet/Latency/*", "ms", LOWER, "time",
          "fleet-merged latency percentiles"),
    _spec("Serving/Fleet/Goodput/fraction", "fraction", HIGHER, "fraction",
          "fleet-merged serving goodput fraction"),
    _spec("Serving/Fleet/shed", "count", LOWER, "count",
          "requests shed by admission control (cumulative)"),
    _spec("Serving/Fleet/finished", "count", HIGHER, "count",
          "requests finished fleet-wide (cumulative)"),
    _spec("Serving/Fleet/waiting", "count", LOWER, "count",
          "requests waiting fleet-wide"),
    _spec("Serving/Fleet/running", "count", NEUTRAL, "count",
          "requests running fleet-wide"),
    _spec("Serving/Fleet/free_blocks", "count", HIGHER, "count",
          "free KV pool blocks fleet-wide"),
    _spec("Serving/Fleet/Spec/*", "count", NEUTRAL, "count",
          "fleet-merged speculative decoding counters"),
    _spec("Serving/*", "1", NEUTRAL, "gauge",
          "remaining serving gauges"),
    # -- cluster observatory (docs/cluster.md) -----------------------------
    _spec("Cluster/hosts", "count", NEUTRAL, "count",
          "hosts present in the heartbeat matrix"),
    _spec("Cluster/step_ms_max", "ms", LOWER, "time",
          "slowest host's step wall this heartbeat"),
    _spec("Cluster/step_ms_median", "ms", LOWER, "time",
          "fleet median step wall this heartbeat"),
    _spec("Cluster/step_skew", "ratio", LOWER, "gauge",
          "max/median step-wall skew across hosts"),
    _spec("Cluster/wire_bytes_ici_total", "bytes", NEUTRAL, "bytes",
          "fleet-total ICI bytes this heartbeat"),
    _spec("Cluster/wire_bytes_dcn_total", "bytes", NEUTRAL, "bytes",
          "fleet-total DCN bytes this heartbeat"),
    _spec("Cluster/hbm_peak_bytes_max", "bytes", LOWER, "bytes",
          "worst host HBM peak this heartbeat"),
    _spec("Cluster/straggler_host", "host", NEUTRAL, "gauge",
          "host id named straggler (-1 = none)"),
    # -- measured-time profile observatory (docs/profile.md) ---------------
    _spec("Profile/exposed_ici_ms", "ms", LOWER, "time",
          "measured un-overlapped ICI time per step"),
    _spec("Profile/exposed_dcn_ms", "ms", LOWER, "time",
          "measured un-overlapped DCN time per step"),
    _spec("Profile/host_gap_ms", "ms", LOWER, "time",
          "measured device-idle host gap per step"),
    _spec("Profile/step_wall_ms", "ms", LOWER, "time",
          "measured step wall from the trace window"),
    _spec("Profile/mfu", "fraction", HIGHER, "fraction",
          "measured-window MFU"),
    _spec("Profile/*", "ms", NEUTRAL, "time",
          "measured per-class busy time per step"),
    # -- numerics observatory (docs/numerics.md): per-subtree stats --------
    _spec("Numerics/grad_norm/*", "1", NEUTRAL, "gauge",
          "per-subtree gradient norm from the in-graph sentinel"),
    _spec("Numerics/weight_norm/*", "1", NEUTRAL, "gauge",
          "per-subtree weight norm from the in-graph sentinel"),
    _spec("Numerics/update_ratio/*", "1", NEUTRAL, "gauge",
          "per-subtree update/weight norm ratio"),
    # -- alert plane (docs/alerts.md): 1 while a rule is firing ------------
    _spec("Alerts/*", "bool", NEUTRAL, "gauge",
          "1 while the named alert rule is firing, 0 once it clears"),
)


class MetricCatalog:
    """Declared metric schema with exact-then-longest-prefix resolution."""

    def __init__(self, specs=_DECLARATIONS):
        self.specs = tuple(specs)
        self._exact = {}
        self._families = []
        for s in self.specs:
            if s.is_family:
                self._families.append(s)
            else:
                if s.pattern in self._exact:
                    raise ValueError(f"duplicate declaration {s.pattern!r}")
                self._exact[s.pattern] = s
        # longest prefix first, so Serving/Fleet/Latency/* shadows Serving/*
        self._families.sort(key=lambda s: len(s.pattern), reverse=True)

    def resolve(self, name):
        """The declaration covering ``name``, or None when undeclared."""
        spec = self._exact.get(name)
        if spec is not None:
            return spec
        for fam in self._families:
            if fam.matches(name):
                return fam
        return None

    def direction(self, name):
        """lower_is_better / higher_is_better / neutral, or None when the
        name is undeclared (callers treat that as an error, not neutral)."""
        spec = self.resolve(name)
        return spec.direction if spec is not None else None

    def to_dict(self):
        return {"version": CATALOG_VERSION,
                "metrics": [s.to_dict() for s in self.specs]}


_DEFAULT_CATALOG = None


def default_catalog():
    """The shipped catalog singleton (cheap to rebuild, cached anyway)."""
    global _DEFAULT_CATALOG
    if _DEFAULT_CATALOG is None:
        _DEFAULT_CATALOG = MetricCatalog()
    return _DEFAULT_CATALOG


# ------------------------------------------------------------- metric store


class MetricStore:
    """Per-host bounded time-series ring, fed by SummaryMonitor.add_scalar.

    Fixed geometry: every metric keeps at most ``ring_len`` observations
    (step, value). ``to_dict`` snapshots are exactly mergeable across hosts
    (``merge_host_rings``) because merging is a union keyed by (host, step)
    — no reduction, no loss, no geometry negotiation beyond the equality
    check. Recording happens on EVERY rank (the SummaryMonitor hook runs
    before its rank-0 early return) so each host's flight-recorder dump
    carries its own ring."""

    def __init__(self, catalog=None, ring_len=DEFAULT_RING_LEN, strict=False,
                 host=0):
        self.catalog = catalog if catalog is not None else default_catalog()
        self.ring_len = int(ring_len)
        if self.ring_len <= 0:
            raise ValueError(f"ring_len must be > 0, got {ring_len!r}")
        self.strict = bool(strict)
        self.host = int(host)
        self.series_by_name = {}
        self.observations = 0
        self._warned = set()

    def observe(self, name, value, step):
        spec = self.catalog.resolve(name)
        if spec is None:
            if self.strict:
                raise UnknownMetricError(
                    f"scalar {name!r} is not declared in the MetricCatalog "
                    "(utils/metrics.py) — declare it with a unit/direction/"
                    "class or fix the emitter")
            if name not in self._warned:
                self._warned.add(name)
                logger.warning(
                    f"[deepspeed_tpu_torch] metrics: scalar {name!r} is not in the "
                    "MetricCatalog — recording it untyped (warn-once; add a "
                    "declaration in utils/metrics.py)")
        ring = self.series_by_name.get(name)
        if ring is None:
            ring = self.series_by_name[name] = deque(maxlen=self.ring_len)
        ring.append((int(step), float(value)))
        self.observations += 1

    # -- reads -------------------------------------------------------------
    def series(self, name):
        """Observations [(step, value), ...] oldest-first (possibly empty)."""
        return list(self.series_by_name.get(name, ()))

    def last(self, name):
        ring = self.series_by_name.get(name)
        return ring[-1] if ring else None

    def to_dict(self):
        return {
            "version": CATALOG_VERSION,
            "host": self.host,
            "ring_len": self.ring_len,
            "observations": self.observations,
            "series": {name: [[s, v] for s, v in ring]
                       for name, ring in sorted(self.series_by_name.items())},
        }


def merge_host_rings(rings_by_host):
    """Exact fleet merge of per-host ring snapshots (``MetricStore.to_dict``
    payloads keyed by host id, as the cluster dump plane delivers them).
    Geometry must match — mismatched ``ring_len`` raises, the same contract
    the serving latency sketches enforce for their bin edges."""
    hosts = sorted(rings_by_host)
    if not hosts:
        return {"version": CATALOG_VERSION, "hosts": [], "ring_len": None,
                "series": {}}
    lens = {int(rings_by_host[h].get("ring_len", 0)) for h in hosts}
    if len(lens) != 1:
        raise ValueError(
            f"metric rings disagree on geometry (ring_len {sorted(lens)}) — "
            "refusing a lossy merge")
    series = {}
    for h in hosts:
        for name, obs in (rings_by_host[h].get("series") or {}).items():
            series.setdefault(name, {})[int(h)] = [[int(s), float(v)]
                                                   for s, v in obs]
    return {"version": CATALOG_VERSION, "hosts": [int(h) for h in hosts],
            "ring_len": lens.pop(),
            "series": {k: series[k] for k in sorted(series)}}


# -------------------------------------------------------- OpenMetrics export

_OM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def openmetrics_name(name):
    """Catalog scalar name -> a valid OpenMetrics metric name."""
    out = _OM_BAD.sub("_", name.strip("/")).lower()
    if out and out[0].isdigit():
        out = "_" + out
    return out


def openmetrics_text(store_dict, catalog=None):
    """OpenMetrics text exposition of a ring snapshot's LATEST observation
    per metric (scrapers want the current value; the full ring travels in
    the dump plane, not the scrape). Deterministic: sorted by metric name."""
    catalog = catalog if catalog is not None else default_catalog()
    host = store_dict.get("host", 0)
    lines = []
    for name in sorted(store_dict.get("series") or {}):
        obs = store_dict["series"][name]
        if not obs:
            continue
        step, value = obs[-1]
        om = openmetrics_name(name)
        spec = catalog.resolve(name)
        if spec is not None:
            lines.append(f"# HELP {om} {spec.description}")
            lines.append(f"# UNIT {om} {spec.unit}")
        lines.append(f"# TYPE {om} gauge")
        lines.append(f'{om}{{host="{host}",step="{int(step)}"}} {value:g}')
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def export_store(store, path, catalog=None):
    """Write the OpenMetrics exposition of a live MetricStore to ``path``."""
    text = openmetrics_text(store.to_dict(), catalog=catalog)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


# ------------------------------------------------------------------ the CLI


def _ring_from_source(path):
    """Ring snapshot from a scalars.jsonl ledger OR a flight-recorder dump
    (its ``alerts.ring`` block). Pure host JSON reading."""
    if path.endswith(".jsonl"):
        store = MetricStore(strict=False)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                store.observe(rec["tag"], rec["value"], rec.get("step", 0))
        return store.to_dict()
    with open(path) as f:
        data = json.load(f)
    ring = (data.get("alerts") or {}).get("ring") or data.get("ring")
    if ring is None:
        raise ValueError(f"{path}: no metric ring (expected a scalars.jsonl "
                         "ledger or a flight-recorder dump with an alerts "
                         "block)")
    if "host" not in ring:
        ring = dict(ring, host=data.get("host", 0))
    return ring


def metrics_main(argv=None):
    """``ds-tpu metrics`` — catalog listing + OpenMetrics export."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="ds-tpu metrics",
        description="metric catalog listing and OpenMetrics export")
    ap.add_argument("--json", action="store_true",
                    help="emit the catalog as JSON instead of a table")
    ap.add_argument("--export", metavar="SOURCE",
                    help="export the latest observations of SOURCE (a "
                         "scalars.jsonl ledger or a flight-recorder dump) "
                         "as OpenMetrics text")
    ap.add_argument("--out", metavar="PATH",
                    help="write the export/listing to PATH instead of stdout")
    args = ap.parse_args(argv)
    catalog = default_catalog()
    if args.export:
        try:
            ring = _ring_from_source(args.export)
        except (OSError, ValueError, KeyError) as e:
            print(f"metrics: {e}", flush=True)
            return 1
        text = openmetrics_text(ring, catalog=catalog)
    elif args.json:
        text = json.dumps(catalog.to_dict(), indent=2, sort_keys=True) + "\n"
    else:
        rows = [(s.pattern, s.unit, s.direction, s.klass, s.description)
                for s in catalog.specs]
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        w2 = max(len(r[2]) for r in rows)
        lines = [f"{'METRIC':<{w0}}  {'UNIT':<{w1}}  {'DIRECTION':<{w2}}  "
                 f"CLASS       DESCRIPTION"]
        for p, u, d, k, desc in rows:
            lines.append(f"{p:<{w0}}  {u:<{w1}}  {d:<{w2}}  {k:<10}  {desc}")
        text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text, end="", flush=True)
    return 0
