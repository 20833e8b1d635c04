"""PyTorch port: a copy of ``deepspeed_tpu/utils/alerts.py`` (lines 1-784:
``validate_rules``, ``default_rules``, ``AlertEngine``, ``merge_fleet_alerts``,
``alerts_main`` and the attribution harness ``run_alert_attribution`` /
``alert_sim_main``), host-only. The loss-scale journal is the port's
(``runtime/fp16/loss_scaler.py`` ``LossScaleJournal``), the flight recorder
the port's copy (``utils/numerics.py``), the trace generator the port's
serve-sim (``serve/sim.py`` ``synth_trace``).

Alert plane over the metric catalog (docs/alerts.md).

Deterministic host-side rules evaluated once per ``TelemetrySession.end_step``
on the metric ring (utils/metrics.py) — ZERO new device syncs: every input is
a scalar the observatories already fetched. Four rule kinds:

- ``threshold``  — absolute bound (above/below) held for N consecutive
                   observations.
- ``delta``      — rolling-window mean vs the immediately preceding baseline
                   window; "worse" is oriented by the catalog direction, so a
                   rule on an MFU-like metric fires on a DROP and one on a
                   latency-like metric fires on a RISE. Neutral metrics are
                   rejected at validation — a regression rule needs a
                   direction.
- ``stuck``      — metric unchanged for N observations (optionally pinned to
                   a specific value, e.g. the loss-scale min floor), or
                   observed before but absent for N steps.
- ``slo_burn``   — Google-SRE multi-window burn rate over an error budget:
                   fires only when BOTH the fast and the slow window burn
                   above their thresholds, so a single bad step can't page
                   but a sustained budget fire does, fast. ``fraction`` mode
                   reads bad-fraction gauges (``good: true`` inverts a
                   goodput gauge like ``Run/Goodput/goodput_fraction``);
                   ``counter`` mode diffs a cumulative counter like
                   ``Serving/Fleet/shed`` into per-step events against a
                   budget of allowed events/step.

A rule firing is a False->True transition: it emits an ``Alerts/<rule>``
scalar (1.0), appends a structured record to the SummaryMonitor event stream,
and — severity ``page`` — triggers a flight-recorder dump so the post-mortem
bundle carries the full metric ring. Clearing emits the 0.0 scalar and an
``alert_clear`` event. Per-host alert state merges fleet-wide through
``assemble_cluster_report`` (utils/cluster.py), which names the first-firing
host + rule.

``ds-tpu alerts`` renders fired/active alerts from a live events ledger or a
dump; ``ds-tpu alert-sim`` is the attribution harness: four injected
ground-truth regressions, each asserted to fire exactly its own rule in the
shipped default ruleset and no other (golden-pinned, gated in lint.sh).

Pure host code: no jax import, no blocking primitives (pinned by
tests/test_torch_no_sync_guard.py).
"""

import json
import os

from .logging import logger
from .metrics import (HIGHER, LOWER, NEUTRAL, MetricStore, default_catalog,
                      merge_host_rings)

ALERTS_VERSION = 1
RULE_KINDS = ("threshold", "delta", "stuck", "slo_burn")
SEVERITIES = ("warn", "page")

# allowed keys per rule kind (beyond the common name/kind/metric/severity)
_COMMON_KEYS = {"name", "kind", "metric", "severity"}
_KIND_KEYS = {
    "threshold": {"above", "below", "for_steps"},
    "delta": {"window", "baseline", "drop_pct"},
    "stuck": {"steps", "at"},
    "slo_burn": {"mode", "budget", "fast_window", "slow_window",
                 "fast_burn", "slow_burn", "good"},
}


def _bad(rule, msg):
    name = rule.get("name", "<unnamed>") if isinstance(rule, dict) else rule
    raise ValueError(f"alert rule {name!r}: {msg}")


def _num(rule, key, lo=None):
    v = rule[key]
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _bad(rule, f"{key} must be a number, got {v!r}")
    if lo is not None and not v > lo:
        _bad(rule, f"{key} must be > {lo}, got {v!r}")
    return float(v)


def _count(rule, key, lo=1):
    v = rule[key]
    if isinstance(v, bool) or not isinstance(v, int):
        _bad(rule, f"{key} must be an int, got {v!r}")
    if v < lo:
        _bad(rule, f"{key} must be >= {lo}, got {v!r}")
    return int(v)


def validate_rules(rules, catalog=None):
    """Validate + normalize a rules list (fill kind defaults). Raises
    ValueError on any malformed rule; returns the normalized copies. With a
    catalog, also enforces that every rule targets a DECLARED metric and
    that ``delta`` rules target a direction-bearing (non-neutral) one."""
    if not isinstance(rules, (list, tuple)):
        raise ValueError(f"alert rules must be a list, got {type(rules).__name__}")
    out, names = [], set()
    for rule in rules:
        if not isinstance(rule, dict):
            raise ValueError(f"alert rule must be a dict, got {rule!r}")
        name = rule.get("name")
        if not isinstance(name, str) or not name:
            _bad(rule, "needs a non-empty string 'name'")
        if name in names:
            _bad(rule, "duplicate rule name")
        names.add(name)
        kind = rule.get("kind")
        if kind not in RULE_KINDS:
            _bad(rule, f"kind must be one of {RULE_KINDS}, got {kind!r}")
        metric = rule.get("metric")
        if not isinstance(metric, str) or not metric:
            _bad(rule, "needs a non-empty string 'metric'")
        severity = rule.get("severity", "warn")
        if severity not in SEVERITIES:
            _bad(rule, f"severity must be one of {SEVERITIES}, got {severity!r}")
        unknown = set(rule) - _COMMON_KEYS - _KIND_KEYS[kind]
        if unknown:
            _bad(rule, f"unknown key(s) for kind {kind!r}: {sorted(unknown)}")
        if catalog is not None and catalog.resolve(metric) is None:
            _bad(rule, f"metric {metric!r} is not declared in the "
                       "MetricCatalog (utils/metrics.py)")
        norm = {"name": name, "kind": kind, "metric": metric,
                "severity": severity}
        if kind == "threshold":
            above, below = rule.get("above"), rule.get("below")
            if above is None and below is None:
                _bad(rule, "threshold needs 'above' and/or 'below'")
            if above is not None:
                norm["above"] = _num(rule, "above")
            if below is not None:
                norm["below"] = _num(rule, "below")
            norm["for_steps"] = _count(rule, "for_steps") \
                if "for_steps" in rule else 1
        elif kind == "delta":
            norm["window"] = _count(rule, "window") if "window" in rule else 8
            norm["baseline"] = _count(rule, "baseline") \
                if "baseline" in rule else 16
            norm["drop_pct"] = _num(rule, "drop_pct", lo=0.0) \
                if "drop_pct" in rule else 20.0
            if catalog is not None and catalog.direction(metric) == NEUTRAL:
                _bad(rule, f"delta rule needs a direction-bearing metric; "
                           f"{metric!r} is declared neutral")
        elif kind == "stuck":
            norm["steps"] = _count(rule, "steps", lo=2) \
                if "steps" in rule else 8
            if "at" in rule and rule["at"] is not None:
                norm["at"] = _num(rule, "at")
        else:  # slo_burn
            mode = rule.get("mode", "fraction")
            if mode not in ("fraction", "counter"):
                _bad(rule, f"slo_burn mode must be 'fraction' or 'counter', "
                           f"got {mode!r}")
            norm["mode"] = mode
            if "budget" not in rule:
                _bad(rule, "slo_burn needs a 'budget' (error budget: bad "
                           "fraction in fraction mode, allowed events/step "
                           "in counter mode)")
            norm["budget"] = _num(rule, "budget", lo=0.0)
            norm["fast_window"] = _count(rule, "fast_window") \
                if "fast_window" in rule else 8
            norm["slow_window"] = _count(rule, "slow_window") \
                if "slow_window" in rule else 32
            if norm["slow_window"] < norm["fast_window"]:
                _bad(rule, "slow_window must be >= fast_window")
            norm["fast_burn"] = _num(rule, "fast_burn", lo=0.0) \
                if "fast_burn" in rule else 14.4
            norm["slow_burn"] = _num(rule, "slow_burn", lo=0.0) \
                if "slow_burn" in rule else 6.0
            good = rule.get("good", False)
            if not isinstance(good, bool):
                _bad(rule, f"good must be a bool, got {good!r}")
            norm["good"] = good
            if good and mode == "counter":
                _bad(rule, "'good' only applies to fraction mode")
        out.append(norm)
    return out


def default_rules():
    """The shipped ruleset — one rule per kind, one per failure class the
    attribution harness injects (PERF.md arms exactly these on TPU runs):
    MFU regression, fleet shed-rate SLO burn, loss-scale death spiral
    (stuck at the min-scale floor), cross-host dispatch skew."""
    return validate_rules([
        {"name": "mfu_drop", "kind": "delta",
         "metric": "Telemetry/Samples/mfu",
         "window": 8, "baseline": 16, "drop_pct": 20.0, "severity": "page"},
        {"name": "fleet_shed_burn", "kind": "slo_burn",
         "metric": "Serving/Fleet/shed", "mode": "counter", "budget": 0.1,
         "fast_window": 8, "slow_window": 16, "fast_burn": 14.4,
         "slow_burn": 6.0, "severity": "page"},
        {"name": "loss_scale_stuck", "kind": "stuck",
         "metric": "Train/Samples/loss_scale", "steps": 8, "at": 1.0,
         "severity": "warn"},
        {"name": "dispatch_skew", "kind": "threshold",
         "metric": "Cluster/step_skew", "above": 3.0, "for_steps": 2,
         "severity": "warn"},
    ], default_catalog())


def _mean(vals):
    return sum(vals) / len(vals)


def _r6(x):
    return round(float(x), 6)


class AlertEngine:
    """Evaluates the rules against a MetricStore once per end_step.

    Stateful per rule (active flag + fire count); a rule fires on its
    False->True transition and clears on True->False, so a sustained
    violation produces exactly one record, not one per step."""

    def __init__(self, rules=None, store=None, catalog=None, monitor=None,
                 recorder=None):
        self.catalog = catalog if catalog is not None else default_catalog()
        self.store = store if store is not None \
            else MetricStore(catalog=self.catalog)
        self.rules = default_rules() if rules is None \
            else validate_rules(rules, self.catalog)
        self.monitor = monitor
        self.recorder = recorder  # FlightRecorder, attached late by engine.py
        self.fired = []
        self.evaluations = 0
        self._state = {r["name"]: {"active": False, "fired": 0}
                       for r in self.rules}

    # -- predicates (pure reads of the ring, deterministic) ----------------
    def _eval_threshold(self, rule):
        series = self.store.series(rule["metric"])
        n = rule["for_steps"]
        if len(series) < n:
            return False, None, None
        tail = [v for _, v in series[-n:]]
        above, below = rule.get("above"), rule.get("below")

        def viol(v):
            return (above is not None and v > above) or \
                   (below is not None and v < below)

        if not all(viol(v) for v in tail):
            return False, None, None
        detail = {"for_steps": n, "last": _r6(tail[-1])}
        if above is not None:
            detail["above"] = _r6(above)
        if below is not None:
            detail["below"] = _r6(below)
        return True, tail[-1], detail

    def _eval_delta(self, rule):
        series = self.store.series(rule["metric"])
        w, b = rule["window"], rule["baseline"]
        if len(series) < w + b:
            return False, None, None
        vals = [v for _, v in series]
        recent = _mean(vals[-w:])
        base = _mean(vals[-(w + b):-w])
        if base == 0.0:
            return False, None, None
        direction = self.catalog.direction(rule["metric"])
        if direction == HIGHER:
            frac = (base - recent) / abs(base)
        elif direction == LOWER:
            frac = (recent - base) / abs(base)
        else:  # undeclared metric in a catalog-less validation path: no fire
            return False, None, None
        if frac * 100.0 < rule["drop_pct"]:
            return False, None, None
        return True, recent, {"recent_mean": _r6(recent),
                              "baseline_mean": _r6(base),
                              "regression_pct": _r6(frac * 100.0),
                              "drop_pct": _r6(rule["drop_pct"])}

    def _eval_stuck(self, rule, step):
        series = self.store.series(rule["metric"])
        if not series:
            return False, None, None
        n = rule["steps"]
        at = rule.get("at")
        last_step, last_val = series[-1]
        if step - last_step >= n:
            # observed before, silent since: only the un-pinned form treats
            # absence as stuck (a pinned rule watches for a specific value)
            if at is None:
                return True, last_val, {"mode": "absent",
                                        "last_seen_step": int(last_step),
                                        "silent_steps": int(step - last_step)}
            return False, None, None
        if len(series) < n:
            return False, None, None
        tail = [v for _, v in series[-n:]]
        if any(v != tail[0] for v in tail):
            return False, None, None
        if at is not None and tail[0] != at:
            return False, None, None
        detail = {"mode": "unchanged", "steps": n, "value": _r6(tail[0])}
        if at is not None:
            detail["at"] = _r6(at)
        return True, tail[0], detail

    def _eval_slo_burn(self, rule, active):
        series = self.store.series(rule["metric"])
        vals = [v for _, v in series]
        if rule["mode"] == "counter":
            # cumulative counter -> per-step events (clamped: a counter
            # reset after restart must not register as negative burn)
            bad = [max(0.0, vals[i] - vals[i - 1])
                   for i in range(1, len(vals))]
        else:
            bad = [(1.0 - v) if rule["good"] else v for v in vals]
        sw, fw = rule["slow_window"], rule["fast_window"]
        if len(bad) < sw:
            return False, None, None
        budget = rule["budget"]
        burn_fast = _mean(bad[-fw:]) / budget
        burn_slow = _mean(bad[-sw:]) / budget
        if active:
            # hysteresis: an active burn alert clears only when BOTH windows
            # drop back within budget (burn < 1), not merely below the fire
            # threshold — anything else flaps on a bursty error stream
            firing = burn_fast >= 1.0 or burn_slow >= 1.0
        else:
            firing = burn_fast >= rule["fast_burn"] \
                and burn_slow >= rule["slow_burn"]
        if not firing:
            return False, None, None
        return True, vals[-1], {"burn_fast": _r6(burn_fast),
                                "burn_slow": _r6(burn_slow),
                                "budget": _r6(budget),
                                "fast_burn": _r6(rule["fast_burn"]),
                                "slow_burn": _r6(rule["slow_burn"])}

    def _predicate(self, rule, step, active):
        kind = rule["kind"]
        if kind == "threshold":
            return self._eval_threshold(rule)
        if kind == "delta":
            return self._eval_delta(rule)
        if kind == "stuck":
            return self._eval_stuck(rule, step)
        return self._eval_slo_burn(rule, active)

    # -- evaluation --------------------------------------------------------
    def evaluate(self, step):
        """Evaluate every rule at the end_step boundary; returns the newly
        fired records (empty most steps). Host-only: reads the ring, writes
        the monitor/recorder — never touches a device value."""
        step = int(step)
        self.evaluations += 1
        newly = []
        for rule in self.rules:
            st = self._state[rule["name"]]
            firing, value, detail = self._predicate(rule, step,
                                                    st["active"])
            if firing and not st["active"]:
                st["active"] = True
                st["fired"] += 1
                rec = {"rule": rule["name"], "kind": rule["kind"],
                       "metric": rule["metric"],
                       "severity": rule["severity"], "step": step,
                       "value": _r6(value), "detail": detail}
                self.fired.append(rec)
                newly.append(rec)
                self._emit_fire(rec)
            elif not firing and st["active"]:
                st["active"] = False
                self._emit_clear(rule, step)
        return newly

    def _emit_fire(self, rec):
        logger.warning(f"[deepspeed_tpu_torch] ALERT {rec['severity']}: "
                       f"{rec['rule']} ({rec['kind']} on {rec['metric']}) "
                       f"at step {rec['step']}: {rec['detail']}")
        if self.monitor is not None:
            self.monitor.add_scalar(f"Alerts/{rec['rule']}", 1.0, rec["step"])
            self.monitor.event("alert", rec, rec["step"])
        if self.recorder is not None:
            self.recorder.record_event("alert", rec, rec["step"])
            if rec["severity"] == "page":
                # post-mortem bundle carries the full metric ring (the
                # recorder's bundle embeds alerts_snapshot) — dump AFTER
                # recording so the bundle contains this firing
                self.recorder.trigger(f"alert:{rec['rule']}", rec)

    def _emit_clear(self, rule, step):
        if self.monitor is not None:
            self.monitor.add_scalar(f"Alerts/{rule['name']}", 0.0, step)
            self.monitor.event("alert_clear",
                               {"rule": rule["name"], "step": step}, step)
        if self.recorder is not None:
            self.recorder.record_event("alert_clear",
                                       {"rule": rule["name"]}, step)

    # -- state export ------------------------------------------------------
    def active(self):
        return sorted(n for n, st in self._state.items() if st["active"])

    def snapshot(self):
        """Deterministic alert-state block for dumps and the fleet plane
        (no wall-clock stamps — fleet merges must be byte-stable)."""
        return {
            "version": ALERTS_VERSION,
            "rules": [{"name": r["name"], "kind": r["kind"],
                       "metric": r["metric"], "severity": r["severity"]}
                      for r in self.rules],
            "active": self.active(),
            "fired": list(self.fired),
            "evaluations": self.evaluations,
        }


# ------------------------------------------------------------- fleet merge


def merge_fleet_alerts(by_host):
    """Fleet alert state from per-host dump bundles ({host: bundle} with an
    ``alerts`` block each, as ``assemble_cluster_report`` receives them).
    Deterministic: firings ordered by (step, host, rule); the first entry
    names the first-firing host + rule — where the incident started."""
    hosts = sorted(int(h) for h in by_host)
    fired, active = [], {}
    for h in hosts:
        bundle = by_host[h]
        blk = bundle.get("alerts") if isinstance(bundle, dict) else None
        if not isinstance(blk, dict):
            continue
        for rec in blk.get("fired") or ():
            fired.append(dict(rec, host=int(h)))
        for name in blk.get("active") or ():
            active.setdefault(name, []).append(int(h))
    fired.sort(key=lambda r: (r.get("step", 0), r.get("host", 0),
                              r.get("rule", "")))
    first = fired[0] if fired else None
    return {
        "hosts": hosts,
        "fired_total": len(fired),
        "fired_rules": sorted({r.get("rule") for r in fired}),
        "by_host": {str(h): sum(1 for r in fired if r["host"] == h)
                    for h in hosts},
        "active": {k: sorted(v) for k, v in sorted(active.items())},
        "first_firing": ({"host": first["host"], "rule": first["rule"],
                          "step": first.get("step"),
                          "severity": first.get("severity")}
                         if first else None),
    }


# --------------------------------------------------------------- ds-tpu CLI


def _load_alert_state(path):
    """Alert state from an events.jsonl ledger (live run) or a
    flight-recorder dump's ``alerts`` block."""
    if path.endswith(".jsonl"):
        fired, active = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("event") == "alert":
                    p = rec.get("payload") or {}
                    fired.append(p)
                    if p.get("rule") not in active:
                        active.append(p.get("rule"))
                elif rec.get("event") == "alert_clear":
                    rule = (rec.get("payload") or {}).get("rule")
                    if rule in active:
                        active.remove(rule)
        return {"fired": fired, "active": sorted(a for a in active if a)}
    with open(path) as f:
        data = json.load(f)
    blk = data.get("alerts") if isinstance(data, dict) else None
    if not isinstance(blk, dict):
        raise ValueError(f"{path}: no alert state (expected an events.jsonl "
                         "ledger or a flight-recorder dump with an alerts "
                         "block)")
    return {"fired": list(blk.get("fired") or []),
            "active": list(blk.get("active") or [])}


def alerts_main(argv=None):
    """``ds-tpu alerts`` — render fired/active alerts; ``--diff`` compares
    two states (what's new, what resolved)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="ds-tpu alerts",
        description="fired/active alerts from a live ledger or dump")
    ap.add_argument("source", help="events.jsonl ledger or flight-recorder "
                                   "dump JSON")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--diff", metavar="BASELINE",
                    help="compare against BASELINE's alert state")
    args = ap.parse_args(argv)
    try:
        state = _load_alert_state(args.source)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"alerts: {e}", flush=True)
        return 1
    if args.diff:
        try:
            base = _load_alert_state(args.diff)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"alerts: {e}", flush=True)
            return 1
        mine = {r.get("rule") for r in state["fired"]}
        theirs = {r.get("rule") for r in base["fired"]}
        diff = {"new": sorted(mine - theirs),
                "resolved": sorted(theirs - mine),
                "common": sorted(mine & theirs)}
        if args.json:
            print(json.dumps(diff, indent=2, sort_keys=True), flush=True)
        else:
            for k in ("new", "resolved", "common"):
                print(f"{k:>9}: {', '.join(diff[k]) or '-'}", flush=True)
        return 0
    if args.json:
        print(json.dumps(state, indent=2, sort_keys=True), flush=True)
        return 0
    if not state["fired"]:
        print("no alerts fired", flush=True)
        return 0
    print(f"{len(state['fired'])} firing(s), "
          f"{len(state['active'])} active: "
          f"{', '.join(state['active']) or '-'}", flush=True)
    for r in state["fired"]:
        print(f"  step {r.get('step'):>6}  {r.get('severity', '?'):<4}  "
              f"{r.get('rule')}  ({r.get('kind')} on {r.get('metric')})  "
              f"value={r.get('value')}", flush=True)
    return 0


# ------------------------------------------------- attribution harness (sim)


class _SimTelemetry:
    """Minimal telemetry stand-in for the sim's FlightRecorder: provides the
    alerts_snapshot hook the dump bundle embeds (utils/numerics.py)."""

    def __init__(self):
        self.monitor = None
        self.watchdog = None
        self._snapper = None

    def alerts_snapshot(self):
        return self._snapper() if self._snapper is not None else None


def _sim_scenario(name, expected_rule, feed, steps, inject_step, dump_dir,
                  host=0, inject_shift=0):
    """Drive one injected-regression scenario through the DEFAULT ruleset.
    ``feed(store, step, injected)`` must emit ALL four watched metric
    families — healthy except the scenario's own injected stream — so the
    no-cross-fire assertion means something."""
    from .numerics import FlightRecorder

    store = MetricStore(catalog=default_catalog(), ring_len=256, strict=True,
                        host=host)
    tel = _SimTelemetry()
    recorder = FlightRecorder(capacity=64, dump_dir=dump_dir, telemetry=tel,
                              host_id=host, run_id="alertsim")
    engine = AlertEngine(rules=default_rules(), store=store,
                         recorder=recorder)
    tel._snapper = lambda: dict(engine.snapshot(), ring=store.to_dict())
    inject_at = inject_step + inject_shift
    for step in range(steps):
        feed(store, step, step >= inject_at)
        engine.evaluate(step)
    fired_rules = [r["rule"] for r in engine.fired]
    return {
        "name": name,
        "expected_rule": expected_rule,
        "inject_step": inject_at,
        "steps": steps,
        "fired": list(engine.fired),
        "unexpected": sorted(r for r in fired_rules if r != expected_rule),
        "missed": expected_rule not in fired_rules,
        "dumps": recorder.dump_count,
        "ok": fired_rules == [expected_rule],
    }, engine.snapshot()


def _feed_healthy(store, step, *, mfu=True, shed=None, journal=None,
                  skew=True):
    """The healthy baselines each scenario shares. Returns nothing; streams
    straight into the ring like SummaryMonitor.add_scalar would."""
    if mfu:
        step_ms = 100.0 + 0.5 * (step % 3)
        store.observe("Telemetry/Samples/step_time_ms", step_ms, step)
        store.observe("Telemetry/Samples/mfu", 0.40 * 100.0 / step_ms, step)
    if shed is not None:
        store.observe("Serving/Fleet/shed", float(shed), step)
    if journal is not None:
        journal.record(step, False)
        store.observe("Train/Samples/loss_scale", journal.cur_scale, step)
    if skew:
        from .cluster import derive_cluster_stats
        matrix = [[step, 0.0, 100.0 + 0.5 * h + 0.3 * (step % 2),
                   95.0 + 0.5 * h, 0.0, 0.0, 1 << 30] for h in range(4)]
        stats = derive_cluster_stats(matrix)
        store.observe("Cluster/step_skew", stats["step_skew"], step)


def _make_journal():
    from ..runtime.fp16.loss_scaler import LossScaleJournal
    # scale_window 4 < the stuck rule's 8-step run: a HEALTHY journal ramps
    # every 4 clean steps, so its longest unchanged run can never trip the
    # rule — only the min-scale death spiral holds one value 8 steps
    return LossScaleJournal(True, 256.0, scale_window=4, scale_factor=2.0,
                            min_scale=1.0, hysteresis=1)


def _scenario_mfu(seed):
    journal = _make_journal()

    def feed(store, step, injected):
        step_ms = (160.0 if injected else 100.0) + 0.5 * (step % 3)
        store.observe("Telemetry/Samples/step_time_ms", step_ms, step)
        store.observe("Telemetry/Samples/mfu", 0.40 * 100.0 / step_ms, step)
        _feed_healthy(store, step, mfu=False, shed=0.0, journal=journal)

    return feed


def _scenario_shed(seed, steps, inject_step):
    """Fleet shed-rate spike: Poisson arrivals at 2x the service capacity
    (the serve-sim trace generator's own arrival knob) through a bounded
    admission queue — the shed counter is CUMULATIVE like the router's."""
    from ..serve.sim import synth_trace

    reqs = synth_trace(16 * steps, vocab_size=64, max_model_len=32,
                       seed=seed, beam_every=0,
                       arrival_process=("poisson", 4.0))
    arrivals = [0] * (16 * steps)
    for r in reqs:
        if r.arrival < len(arrivals):
            arrivals[r.arrival] += 1
    state = {"queue": 0, "shed": 0, "iter": 0}
    capacity, queue_bound = 2, 8
    journal = _make_journal()

    def feed(store, step, injected):
        if injected:
            # 2x-capacity Poisson arrival burst (seeded trace, iteration
            # domain offset so each injected step consumes fresh arrivals)
            state["queue"] += arrivals[state["iter"]]
            state["iter"] += 1
        else:
            state["queue"] += step % 2  # 0.5 req/step, well under capacity
        over = max(0, state["queue"] - queue_bound)
        state["shed"] += over
        state["queue"] -= over + min(state["queue"] - over, capacity)
        _feed_healthy(store, step, shed=state["shed"], journal=journal)

    return feed


def _scenario_loss_scale(seed):
    journal = _make_journal()

    def feed(store, step, injected):
        # forced-NaN overflow streak: hysteresis-1 journal halves every
        # step, hits the min_scale floor and pins there — the death spiral
        journal.record(step, injected)
        store.observe("Train/Samples/loss_scale", journal.cur_scale, step)
        _feed_healthy(store, step, shed=0.0, journal=None)

    return feed


def _scenario_skew(seed):
    from .cluster import derive_cluster_stats

    journal = _make_journal()

    def feed(store, step, injected):
        matrix = []
        for h in range(4):
            step_ms = 100.0 + 0.5 * h + 0.3 * (step % 2)
            dispatch = 95.0 + 0.5 * h
            if injected and h == 2:
                step_ms *= 6.0   # one host's dispatch stalls the fleet
                dispatch *= 6.0
            matrix.append([step, 0.0, step_ms, dispatch, 0.0, 0.0, 1 << 30])
        stats = derive_cluster_stats(matrix)
        store.observe("Cluster/step_skew", stats["step_skew"], step)
        _feed_healthy(store, step, shed=0.0, journal=journal, skew=False)

    return feed


def run_alert_attribution(seed=20, steps=64, inject_step=32, dump_dir=None):
    """The four ground-truth regressions, each against the shipped default
    ruleset; plus a two-host fleet merge of the shed scenario (host 1's
    injection shifted +4 steps) pinning first-firing attribution.
    Deterministic transcript — golden-pinned in lint.sh."""
    scenarios = [
        ("mfu_step_wall_inflation", "mfu_drop",
         lambda shift: _scenario_mfu(seed)),
        ("fleet_shed_poisson_2x", "fleet_shed_burn",
         lambda shift: _scenario_shed(seed, steps, inject_step + shift)),
        ("loss_scale_forced_nan", "loss_scale_stuck",
         lambda shift: _scenario_loss_scale(seed)),
        ("heartbeat_dispatch_skew", "dispatch_skew",
         lambda shift: _scenario_skew(seed)),
    ]
    results, rules = [], default_rules()
    for name, expected, make_feed in scenarios:
        res, _snap = _sim_scenario(name, expected, make_feed(0), steps,
                                   inject_step, dump_dir)
        results.append(res)
    # fleet plane: the shed regression on two hosts, host 1 injected later —
    # the merged state must name host 0 / fleet_shed_burn as first firing
    by_host = {}
    for host, shift in ((0, 0), (1, 4)):
        _res, snap = _sim_scenario("fleet", "fleet_shed_burn",
                                   _scenario_shed(seed, steps,
                                                  inject_step + shift),
                                   steps, inject_step, dump_dir, host=host,
                                   inject_shift=shift)
        by_host[host] = {"alerts": snap}
    fleet = merge_fleet_alerts(by_host)
    ok = all(r["ok"] for r in results) and \
        fleet["first_firing"] is not None and \
        fleet["first_firing"]["host"] == 0 and \
        fleet["first_firing"]["rule"] == "fleet_shed_burn"
    return {
        "version": ALERTS_VERSION,
        "kind": "alert_attribution",
        "seed": seed,
        "steps": steps,
        "rules": [r["name"] for r in rules],
        "scenarios": results,
        "fleet": fleet,
        "ok": ok,
    }


def alert_sim_main(argv=None):
    """``ds-tpu alert-sim`` — run the attribution harness; exit nonzero
    unless every injected regression fired exactly its own rule."""
    import argparse
    import shutil
    import tempfile
    ap = argparse.ArgumentParser(
        prog="ds-tpu alert-sim",
        description="alert attribution harness: four injected regressions "
                    "against the default ruleset")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--inject-step", type=int, default=32)
    ap.add_argument("--json", metavar="PATH",
                    help="write the (golden-pinned) transcript to PATH")
    ap.add_argument("--dump-dir", metavar="DIR",
                    help="keep page-severity flight-recorder dumps in DIR "
                         "(default: a temp dir, removed after the run)")
    args = ap.parse_args(argv)
    dump_dir = args.dump_dir or tempfile.mkdtemp(prefix="alert_sim_")
    try:
        transcript = run_alert_attribution(seed=args.seed, steps=args.steps,
                                           inject_step=args.inject_step,
                                           dump_dir=dump_dir)
    finally:
        if not args.dump_dir:
            shutil.rmtree(dump_dir, ignore_errors=True)
    for s in transcript["scenarios"]:
        fired = [r["rule"] for r in s["fired"]]
        status = "OK " if s["ok"] else "FAIL"
        print(f"[{status}] {s['name']:<28} expected={s['expected_rule']:<18} "
              f"fired={','.join(fired) or '-'}", flush=True)
    ff = transcript["fleet"]["first_firing"]
    print(f"fleet: {transcript['fleet']['fired_total']} firing(s), first = "
          f"host {ff['host']} / {ff['rule']} @ step {ff['step']}"
          if ff else "fleet: no firings", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(transcript, f, indent=2, sort_keys=True)
        print(f"transcript -> {args.json}", flush=True)
    print(f"alert-sim: {'OK' if transcript['ok'] else 'FAILED'}", flush=True)
    return 0 if transcript["ok"] else 1
