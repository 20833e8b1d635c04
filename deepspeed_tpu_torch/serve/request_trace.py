"""Serving request observatory: per-request lifecycle ledger, latency
percentiles, preemption-waste accounting, Perfetto timelines, SLO gate
(a copy of ``deepspeed_tpu/serve/request_trace.py`` for the PyTorch port).

The serving engine's iteration loop crosses every interesting request-lifecycle
boundary on the host anyway — admission, each prefill chunk, each decode
iteration's batch membership, preemption, beam fork, first token, completion.
``RequestTracer`` records exactly those boundaries (plus one ``perf_counter``
read each) into a bounded per-host ring: no device fetch, no barrier, no
change to the serving programs — with ``serving.request_trace`` disabled the
engine holds ``None`` instead of a tracer. The module imports the standard
library only (no torch, no numpy), so it holds no blocking primitive.

Four consumers sit on the ledger:

* **Latency percentiles** — streaming log-bucketed histograms for TTFT, TPOT,
  queue delay and end-to-end latency; ``percentiles()`` reads p50/p90/p99 (or
  any requested set) and ``latency_summary()`` gives them as one dict.
* **Waste accounting** — every scheduled token is classified useful vs
  replayed-after-preemption (the scheduler knows exactly which prefill
  positions and decode steps recompute work a preempted attempt already did);
  the split sums to total scheduled tokens exactly, plus a per-iteration
  block-pool occupancy / fragmentation / free-list timeline.
* **SLO accounting** — finished requests are classified met/violated against
  ``serving.request_trace.slo`` (``ttft_ms`` / ``tpot_ms``).
* **Perfetto export** — ``to_serve_trace_events`` / ``serve_timeline_main``
  convert a ledger bundle (or a flight-recorder dump embedding one) into
  deterministic Chrome ``trace_event`` JSON: one track per request, queue /
  prefill / decode / replay slices on the iteration timebase, counter tracks
  for pool occupancy, waiting queue and waste fraction. The bytes equal the
  JAX package's for the same bundle; the envelope keeps its tool name
  (``ds-tpu serve-timeline``), so the two packages' files compare equal.
"""

import argparse
import atexit
import json
import math
import os
import time
from collections import deque

from ..utils.trace_event import (complete_slice, counter_event, instant_event,
                                 load_bundle, process_name_event,
                                 serialize_trace, thread_meta_events,
                                 trace_envelope)

REQUEST_TRACE_VERSION = 1
SERVE_TRACE_KIND = "serving_request_trace"

# the wall-clock latency metrics the tracer keeps streaming histograms for
LATENCY_METRICS = ("ttft_ms", "tpot_ms", "queue_delay_ms", "e2e_ms")
# SLO-gateable subset (serving.request_trace.slo config keys)
SLO_METRICS = ("ttft_ms", "tpot_ms")

# lifecycle event names; every event is a compact list
# [name, iteration, rel_us, *args] (iteration -1 = outside the step loop)
EV_SUBMIT = "submit"
EV_REFUSED = "refused"          # args: reason
EV_SHED = "shed"                # args: reason (fleet router load shedding)
EV_ADMIT = "admit"              # args: lanes, queue_delay_iters
EV_CACHE_HIT = "cache_hit"      # args: cached_prefix_tokens (prefix reuse)
EV_PREFILL = "prefill"          # args: pos, n, replayed
EV_DECODE = "decode"            # args: lanes, replayed
EV_SPEC_ACCEPT = "spec_accept"  # args: drafted, accepted, committed
EV_SPEC_REJECT = "spec_reject"  # args: drafted, accepted, committed (a == 0)
EV_FORK = "fork"                # args: lanes (beam CoW table fork)
EV_PREEMPT = "preempt"          # args: evicted_blocks
EV_FIRST_TOKEN = "first_token"
EV_FINISH = "finish"            # args: n_tokens


class HistogramSketch:
    """Log-bucketed streaming histogram sketch: O(1) add, bounded memory,
    percentile read-out at ``growth``-factor relative resolution (default
    ~3%). Quantiles report the upper bound of the covering bucket, so they
    never understate a tail — the conservative direction for an SLO read-out.

    The bin edges are a pure function of ``(growth, min_value)``, identical
    on every replica, so sketches are EXACTLY mergeable: ``merge_from`` adds
    integer bin counts, and the merged percentiles equal the percentiles of
    the concatenated value stream (same covering-bucket read-out over the
    same total bin counts). ``utils/cluster.fleet_latency_summary`` builds
    fleet-level rollups on this property."""

    def __init__(self, growth=1.03, min_value=1e-3):
        self._min = float(min_value)
        self._lg = math.log(float(growth))
        self._growth = float(growth)
        self._buckets = {}
        self.count = 0
        self.total = 0.0

    def add(self, value):
        if value is None:
            return
        v = max(float(value), self._min)
        idx = int(math.log(v / self._min) / self._lg)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += float(value)

    def percentile(self, p):
        """Value at percentile ``p`` (0..100], or None on an empty histogram."""
        if not self.count:
            return None
        target = max(float(p) / 100.0 * self.count, 1.0)
        seen = 0
        last = None
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            last = idx
            if seen >= target:
                break
        return self._min * self._growth ** (last + 1)

    def percentiles(self, ps=(50, 90, 99)):
        return {f"p{p:g}": self.percentile(p) for p in ps}

    @property
    def mean(self):
        return (self.total / self.count) if self.count else None

    # -- merge / serialization (fleet rollups) ------------------------------
    def merge_from(self, other):
        """Fold another sketch into this one. Exact: bin geometry must match
        (raises ValueError otherwise), then merging is bin-count addition."""
        if (other._min, other._growth) != (self._min, self._growth):
            raise ValueError(
                "histogram sketch geometry mismatch: "
                f"(min={other._min}, growth={other._growth}) vs "
                f"(min={self._min}, growth={self._growth})")
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        return self

    def to_dict(self):
        return {
            "kind": "histogram_sketch",
            "growth": self._growth,
            "min_value": self._min,
            "buckets": {str(i): self._buckets[i]
                        for i in sorted(self._buckets)},
            "count": self.count,
            "total": self.total,
        }

    @classmethod
    def from_dict(cls, d):
        sk = cls(growth=d.get("growth", 1.03),
                 min_value=d.get("min_value", 1e-3))
        for i, n in (d.get("buckets") or {}).items():
            sk._buckets[int(i)] = int(n)
        sk.count = int(d.get("count", sum(sk._buckets.values())))
        sk.total = float(d.get("total", 0.0))
        return sk

    @classmethod
    def merged(cls, sketches):
        out = None
        for sk in sketches:
            if out is None:
                out = cls(growth=sk._growth, min_value=sk._min)
            out.merge_from(sk)
        return out


# Historical name — the sketch started life as a per-host-only histogram.
StreamingHistogram = HistogramSketch


class RequestTracer:
    """Bounded per-host ledger of per-request lifecycle events plus the
    per-iteration goodput/pool timeline. Only stdlib calls on the hot path:
    one ``perf_counter`` read and a list append per recorded boundary."""

    def __init__(self, capacity=256, iteration_capacity=4096, dump_dir=None,
                 slo=None, host_id=0):
        self.capacity = int(capacity)
        self.iteration_capacity = int(iteration_capacity)
        self.dump_dir = dump_dir or None
        self.host_id = int(host_id)
        # configured SLO thresholds; 0 / missing = that metric is not gated
        slo = slo or {}
        self.slo = {m: float(slo[m]) for m in SLO_METRICS
                    if slo.get(m) and float(slo[m]) > 0.0}
        self.requests = deque(maxlen=self.capacity)   # finished/refused records
        self.live = {}                                # req_id -> open record
        self.iterations = deque(maxlen=self.iteration_capacity)
        self.hist = {m: StreamingHistogram() for m in LATENCY_METRICS}
        self.totals = {"prefill_tokens": 0, "prefill_replayed": 0,
                       "decode_tokens": 0, "decode_replayed": 0,
                       "cached_prefix_tokens": 0, "drafted_tokens": 0,
                       "accepted_draft_tokens": 0, "wasted_draft_tokens": 0}
        self.slo_met = 0
        self.slo_violated = 0
        self.refused = 0
        self.shed = 0
        self.finished = 0
        self.preemptions = 0
        self._epoch = time.perf_counter()
        self._cur = None                              # open iteration record
        if self.dump_dir:
            atexit.register(self._atexit_dump)

    # -- plumbing ----------------------------------------------------------
    def _now_us(self):
        return int((time.perf_counter() - self._epoch) * 1e6)

    def _event(self, rec, name, it, *args):
        rec["events"].append([name, int(it), self._now_us()] + list(args))

    # -- request lifecycle -------------------------------------------------
    def on_submit(self, req):
        rec = {
            "req_id": req.req_id,
            "arrival": int(req.arrival),
            "lanes": int(req.num_beams),
            "prompt_len": len(req.prompt),
            "max_new_tokens": int(req.max_new_tokens),
            "status": "live",
            "preemptions": 0,
            "events": [],
        }
        self.live[req.req_id] = rec
        self._event(rec, EV_SUBMIT, -1)
        return rec

    def on_refused(self, req, reason):
        rec = self.live.pop(req.req_id, None) or self.on_submit(req)
        self.live.pop(req.req_id, None)
        self._event(rec, EV_REFUSED, -1, reason)
        rec["status"] = "refused"
        self.refused += 1
        self.requests.append(rec)
        return rec

    def on_shed(self, req, reason):
        # fleet-router admission control: same refusal-not-crash ledger shape
        # as on_refused, but counted separately — shedding is a routing-policy
        # outcome (fleet saturated), not an engine capacity error
        rec = self.live.pop(req.req_id, None) or self.on_submit(req)
        self.live.pop(req.req_id, None)
        self._event(rec, EV_SHED, -1, reason)
        rec["status"] = "shed"
        self.shed += 1
        self.requests.append(rec)
        return rec

    def on_admit(self, g, it):
        rec = self.live.get(g.req.req_id)
        if rec is None:
            return
        self._event(rec, EV_ADMIT, it, g.lanes, int(it) - rec["arrival"])
        cached = int(getattr(g, "cached_prefix_tokens", 0))
        if cached:
            # prefix-cache reuse: these prompt tokens are never scheduled, so
            # they enter neither the useful nor the replayed side of the
            # waste split — a preempt-restart's remapped prefix must not be
            # billed as recomputation (that is the whole point of the remap)
            self._event(rec, EV_CACHE_HIT, it, cached)
            rec["cached_prefix_tokens"] = (
                rec.get("cached_prefix_tokens", 0) + cached)
            self.totals["cached_prefix_tokens"] += cached

    def on_prefill(self, g, it, pos, n, replayed):
        rec = self.live.get(g.req.req_id)
        if rec is None:
            return
        self._event(rec, EV_PREFILL, it, int(pos), int(n), int(replayed))
        if self._cur is not None:
            self._cur["prefill"][0] += int(n) - int(replayed)
            self._cur["prefill"][1] += int(replayed)
        self.totals["prefill_tokens"] += int(n)
        self.totals["prefill_replayed"] += int(replayed)

    def on_decode(self, g, it, lanes, replayed):
        rec = self.live.get(g.req.req_id)
        if rec is not None:
            self._event(rec, EV_DECODE, it, int(lanes), int(replayed))
        if self._cur is not None:
            self._cur["decode"][0] += int(lanes) - int(replayed)
            self._cur["decode"][1] += int(replayed)
        self.totals["decode_tokens"] += int(lanes)
        self.totals["decode_replayed"] += int(replayed)

    def on_spec(self, g, it, drafted, accepted, committed, replayed):
        """One speculative round for one request. The ``committed`` tokens
        enter the decode side of the useful+replayed == scheduled identity
        (they ARE the tokens plain decode would have scheduled); the draft
        economics — drafted / accepted / wasted — live OUTSIDE the identity,
        like ``cached_prefix_tokens``: draft-model work is not target-model
        schedule, and billing it there would misread speculation as waste."""
        rec = self.live.get(g.req.req_id)
        if rec is not None:
            name = EV_SPEC_ACCEPT if accepted else EV_SPEC_REJECT
            self._event(rec, name, it, int(drafted), int(accepted),
                        int(committed))
            rec["drafted_tokens"] = (
                rec.get("drafted_tokens", 0) + int(drafted))
            rec["accepted_tokens"] = (
                rec.get("accepted_tokens", 0) + int(accepted))
            rec["wasted_draft_tokens"] = (
                rec.get("wasted_draft_tokens", 0) + int(drafted)
                - int(accepted))
        if self._cur is not None:
            self._cur["decode"][0] += int(committed) - int(replayed)
            self._cur["decode"][1] += int(replayed)
        self.totals["decode_tokens"] += int(committed)
        self.totals["decode_replayed"] += int(replayed)
        self.totals["drafted_tokens"] += int(drafted)
        self.totals["accepted_draft_tokens"] += int(accepted)
        self.totals["wasted_draft_tokens"] += int(drafted) - int(accepted)

    def on_fork(self, g, it):
        rec = self.live.get(g.req.req_id)
        if rec is not None and g.lanes > 1:
            self._event(rec, EV_FORK, it, g.lanes)

    def on_preempt(self, g, it, evicted_blocks):
        rec = self.live.get(g.req.req_id)
        if rec is None:
            return
        self._event(rec, EV_PREEMPT, it, int(evicted_blocks))
        rec["preemptions"] += 1
        self.preemptions += 1

    def on_first_token(self, g, it):
        """Record the first-token boundary and return ``(ttft_ms,
        ttft_iters)`` — the single source both the engine's scalar emission
        and the RequestOutput fields derive from (they cannot drift)."""
        rec = self.live.get(g.req.req_id)
        if rec is None:
            return None, None
        self._event(rec, EV_FIRST_TOKEN, it)
        ttft_ms = (rec["events"][-1][2] - rec["events"][0][2]) / 1000.0
        ttft_iters = int(it) - rec["arrival"]
        rec["ttft_ms"] = ttft_ms
        rec["ttft_iters"] = ttft_iters
        return ttft_ms, ttft_iters

    def on_finish(self, g, it, n_tokens):
        rec = self.live.pop(g.req.req_id, None)
        if rec is None:
            return None
        self._event(rec, EV_FINISH, it, int(n_tokens))
        rec["status"] = "finished"
        rec["finished_it"] = int(it)
        rec["n_tokens"] = int(n_tokens)
        t_submit = rec["events"][0][2]
        t_finish = rec["events"][-1][2]
        rec["e2e_ms"] = (t_finish - t_submit) / 1000.0
        rec["e2e_iters"] = int(it) - rec["arrival"]
        admits = [e for e in rec["events"] if e[0] == EV_ADMIT]
        if admits:  # queue delay of the admission that completed (the last)
            rec["queue_delay_ms"] = (admits[-1][2] - t_submit) / 1000.0
            rec["queue_delay_iters"] = admits[-1][4]
        first = [e for e in rec["events"] if e[0] == EV_FIRST_TOKEN]
        if first and n_tokens > 1:
            rec["tpot_ms"] = (t_finish - first[-1][2]) / 1000.0 / (n_tokens - 1)
        for m in LATENCY_METRICS:
            self.hist[m].add(rec.get(m))
        rec["slo_violations"] = sorted(
            m for m, lim in self.slo.items()
            if rec.get(m) is not None and rec[m] > lim)
        if self.slo:
            if rec["slo_violations"]:
                self.slo_violated += 1
            else:
                self.slo_met += 1
        self.finished += 1
        self.requests.append(rec)
        return rec

    # -- iteration timeline ------------------------------------------------
    def begin_iteration(self, it):
        self._cur = {"it": int(it), "t_us": self._now_us(),
                     "prefill": [0, 0],     # [useful, replayed] tokens
                     "decode": [0, 0]}

    def end_iteration(self, waiting, running, pool):
        """Close the iteration record with the scheduler's queue depths and
        the allocator's pool timeline point (``Scheduler.pool_stats``)."""
        cur, self._cur = self._cur, None
        if cur is None:
            return None
        cur["waiting"] = int(waiting)
        cur["running"] = int(running)
        cur["pool"] = pool
        self.iterations.append(cur)
        return cur

    # -- read-outs ---------------------------------------------------------
    def percentiles(self, metric=None, ps=(50, 90, 99)):
        """p50/p90/p99 (or any ``ps``) of one latency metric, or of all of
        them when ``metric`` is None — only metrics with data appear."""
        if metric is not None:
            return self.hist[metric].percentiles(ps)
        return {m: self.hist[m].percentiles(ps)
                for m in LATENCY_METRICS if self.hist[m].count}

    def latency_summary(self, ps=(50, 90, 99)):
        """Flat ``{metric_pNN: value}`` dict for TelemetrySession.end_step
        (emitted as ``Serving/Latency/*`` scalars)."""
        out = {}
        for m in LATENCY_METRICS:
            h = self.hist[m]
            if not h.count:
                continue
            for p in ps:
                out[f"{m}_p{p:g}"] = h.percentile(p)
        return out

    def waste_summary(self):
        t = self.totals
        scheduled = t["prefill_tokens"] + t["decode_tokens"]
        replayed = t["prefill_replayed"] + t["decode_replayed"]
        return {
            "scheduled_tokens": scheduled,
            "useful_tokens": scheduled - replayed,
            "replayed_tokens": replayed,
            "prefill_tokens": t["prefill_tokens"],
            "prefill_replayed": t["prefill_replayed"],
            "decode_tokens": t["decode_tokens"],
            "decode_replayed": t["decode_replayed"],
            "waste_fraction": (replayed / scheduled) if scheduled else 0.0,
            # prefix-cache reuse: prompt tokens whose KV was remapped rather
            # than scheduled — by construction OUTSIDE the useful+replayed ==
            # scheduled identity, so reuse is never misread as recomputation
            "cached_prefix_tokens": t["cached_prefix_tokens"],
            # speculation economics: draft-model work, likewise OUTSIDE the
            # identity (the committed tokens themselves are counted above)
            "drafted_tokens": t["drafted_tokens"],
            "accepted_draft_tokens": t["accepted_draft_tokens"],
            "wasted_draft_tokens": t["wasted_draft_tokens"],
        }

    def slo_summary(self):
        classified = self.slo_met + self.slo_violated
        return {
            "configured": dict(self.slo),
            "met": self.slo_met,
            "violated": self.slo_violated,
            "attainment": (self.slo_met / classified) if classified else None,
        }

    # -- bundle / dump -----------------------------------------------------
    def bundle(self):
        return {
            "version": REQUEST_TRACE_VERSION,
            "kind": SERVE_TRACE_KIND,
            "host": self.host_id,
            "slo": dict(self.slo),
            "requests": list(self.requests),
            "live": [self.live[k] for k in sorted(self.live)],
            "iterations": list(self.iterations),
            "totals": dict(self.totals),
            "counts": {"finished": self.finished, "refused": self.refused,
                       "shed": self.shed, "preemptions": self.preemptions},
            # mergeable latency sketches: N replica bundles combine exactly
            # into fleet percentiles (utils/cluster.fleet_latency_summary)
            "latency_sketches": {m: self.hist[m].to_dict()
                                 for m in LATENCY_METRICS
                                 if self.hist[m].count},
        }

    def dump(self, path=None):
        if path is None:
            if not self.dump_dir:
                return None
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"request_trace_host{self.host_id}.json")
        with open(path, "w") as f:
            json.dump(self.bundle(), f)
        return path

    def _atexit_dump(self):
        if self.dump_dir and (self.requests or self.live):
            try:
                self.dump()
            except OSError:
                pass  # trace dump failure must never mask the real exit


# ------------------------------------------------------------- Perfetto export

# Chrome trace_event reserved color names (same convention as the pipeline
# exporter): useful work vs replayed-after-preemption work must be visually
# distinct at a glance
_CAT_COLORS = {
    "prefill": "thread_state_running",
    "decode": "thread_state_runnable",
    "prefill_replay": "cq_build_failed",
    "decode_replay": "cq_build_failed",
    "queued": "rail_idle",
}


def _slice(tid, ts, dur, name, cat, args):
    return complete_slice(0, tid, ts, dur, name, cat, args,
                          cname=_CAT_COLORS.get(cat))


def to_serve_trace_events(bundle, us_per_iter=1000):
    """Convert a request-trace bundle into Chrome/Perfetto ``trace_event``
    JSON: one thread (track) per request in arrival order, queue / prefill /
    decode slices (replayed work color-flagged), instant markers for preempt /
    first-token / finish, and counter tracks for pool occupancy, waiting queue
    and cumulative waste fraction.

    Timestamps live on the ITERATION timebase (``it * us_per_iter``), which is
    a pure function of the schedule — the export is byte-deterministic for a
    deterministic trace (the golden-file contract), unlike the wall-clock
    ``*_us`` fields the bundle also carries for human inspection."""
    U = int(us_per_iter)
    events = [process_name_event(0, f"serving host {bundle.get('host', 0)}")]
    records = sorted(list(bundle.get("requests", []))
                     + list(bundle.get("live", [])),
                     key=lambda r: (r["arrival"], r["req_id"]))

    def ts_of(it, fallback):
        return (int(it) if it >= 0 else int(fallback)) * U

    for i, rec in enumerate(records):
        tid = i + 1
        events += thread_meta_events(0, tid, rec["req_id"], sort_index=tid)
        queued_since = rec["arrival"]
        run = None          # open decode run: [start_it, end_it, toks, replay]

        def flush_run():
            nonlocal run
            if run is None:
                return
            start, end, toks, replayed = run
            cat = "decode_replay" if replayed else "decode"
            events.append(_slice(
                tid, start * U, (end - start + 1) * U,
                f"decode x{end - start + 1}", cat,
                {"iters": end - start + 1, "tokens": toks,
                 "replayed": replayed}))
            run = None

        for ev in rec["events"]:
            name, it = ev[0], ev[1]
            if name != EV_DECODE:
                flush_run()
            if name == EV_ADMIT:
                if it > queued_since:
                    events.append(_slice(
                        tid, queued_since * U, (it - queued_since) * U,
                        "queued", "queued",
                        {"iters": it - queued_since}))
            elif name == EV_PREFILL:
                pos, n, replayed = ev[3], ev[4], ev[5]
                cat = "prefill_replay" if replayed == n else "prefill"
                events.append(_slice(
                    tid, it * U, U, f"prefill[{pos}:{pos + n}]", cat,
                    {"pos": pos, "tokens": n, "replayed": replayed}))
            elif name == EV_DECODE:
                lanes, replayed = ev[3], ev[4]
                if run is not None and (run[1] + 1 != it
                                        or bool(run[3]) != bool(replayed)):
                    flush_run()
                if run is None:
                    run = [it, it, 0, 0]
                run[1] = it
                run[2] += lanes
                run[3] += replayed
            elif name in (EV_SPEC_ACCEPT, EV_SPEC_REJECT):
                # only ever present with speculation on, so speculation-off
                # exports (the golden-file contract) are unchanged
                events.append(instant_event(
                    0, tid, it * U,
                    "spec accept" if name == EV_SPEC_ACCEPT else "spec reject",
                    {"drafted": ev[3], "accepted": ev[4],
                     "committed": ev[5]}))
            elif name == EV_CACHE_HIT:
                # only ever present with the prefix cache on and hitting, so
                # cache-off exports (the golden-file contract) are unchanged
                events.append(instant_event(0, tid, it * U, "prefix cache hit",
                                            {"cached_tokens": ev[3]}))
            elif name == EV_PREEMPT:
                events.append(instant_event(0, tid, it * U, "preempt",
                                            {"evicted_blocks": ev[3]}))
                queued_since = it
            elif name == EV_FIRST_TOKEN:
                events.append(instant_event(
                    0, tid, it * U, "first_token",
                    {"ttft_iters": rec.get("ttft_iters")}))
            elif name == EV_FINISH:
                events.append(instant_event(0, tid, it * U, "finish",
                                            {"n_tokens": ev[3]}))
            elif name == EV_REFUSED:
                events.append(instant_event(0, tid, ts_of(it, rec["arrival"]),
                                            "refused", {"reason": ev[3]}))
            elif name == EV_SHED:
                # only ever present in fleet-router front-door ledgers, so
                # single-engine exports (the golden-file contract) are unchanged
                events.append(instant_event(0, tid, ts_of(it, rec["arrival"]),
                                            "shed", {"reason": ev[3]}))
        flush_run()

    sched_tokens = 0
    replayed_tokens = 0
    for itrec in bundle.get("iterations", []):
        ts = itrec["it"] * U
        pool = itrec.get("pool") or {}
        used, free = pool.get("used", 0), pool.get("free", 0)
        occ = used / (used + free) if (used + free) else 0.0
        events.append(counter_event(0, 0, ts, "pool occupancy",
                                    {"occupancy": round(occ, 6)}))
        if "frag" in pool:
            events.append(counter_event(0, 0, ts, "pool fragmentation",
                                        {"fragmentation": round(pool["frag"], 6)}))
        events.append(counter_event(0, 0, ts, "waiting queue",
                                    {"waiting": itrec.get("waiting", 0)}))
        events.append(counter_event(0, 0, ts, "free blocks", {"free": free}))
        sched_tokens += sum(itrec["prefill"]) + sum(itrec["decode"])
        replayed_tokens += itrec["prefill"][1] + itrec["decode"][1]
        waste = replayed_tokens / sched_tokens if sched_tokens else 0.0
        events.append(counter_event(0, 0, ts, "waste fraction",
                                    {"waste": round(waste, 6)}))
    return trace_envelope(events, "ds-tpu serve-timeline",
                          requests=len(records), us_per_iter=U,
                          trace_version=bundle.get("version"))


# --------------------------------------------------------------------- the CLI


def _load_bundle(path):
    # flight-recorder dumps embed the request-trace bundle under its kind key
    return load_bundle(path, SERVE_TRACE_KIND)


def serve_timeline_main(argv=None):
    """``ds-tpu serve-timeline`` entry point: request-trace ledger bundle (or
    a flight-recorder dump embedding one) -> Perfetto/Chrome trace_event JSON."""
    parser = argparse.ArgumentParser(
        prog="ds-tpu serve-timeline",
        description="Convert a serving request_trace ledger bundle (or a "
                    "flight-recorder dump that embeds one) into Perfetto/"
                    "Chrome trace_event JSON viewable at ui.perfetto.dev or "
                    "chrome://tracing.")
    parser.add_argument("bundle", help="path to the ledger bundle / dump JSON")
    parser.add_argument("-o", "--output", default=None,
                        help="output path (default: <bundle>.trace.json)")
    parser.add_argument("--us-per-iter", type=int, default=1000,
                        help="microseconds per scheduler iteration on the "
                             "deterministic timebase (default 1000)")
    args = parser.parse_args(argv)

    try:
        bundle = _load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"ds-tpu serve-timeline: cannot read {args.bundle}: {e}")
        return 2
    if bundle is None:
        print(f"ds-tpu serve-timeline: {args.bundle} holds no "
              f"{SERVE_TRACE_KIND} bundle (enable serving.request_trace and "
              "re-dump)")
        return 2

    trace = to_serve_trace_events(bundle, us_per_iter=args.us_per_iter)
    out = args.output
    if out is None:
        stem = args.bundle[:-5] if args.bundle.endswith(".json") else args.bundle
        out = stem + ".trace.json"
    with open(out, "w") as f:
        f.write(serialize_trace(trace))
    n_req = len(bundle.get("requests", [])) + len(bundle.get("live", []))
    print(f"wrote {len(trace['traceEvents'])} trace events "
          f"({n_req} requests, {len(bundle.get('iterations', []))} "
          f"iterations) -> {out}")
    return 0
