"""PyTorch port: a copy of ``deepspeed_tpu/serve/router.py`` (lines 1-388),
host arithmetic over the port's engine hooks (``serve/engine.py``
``prefix_peek``, ``load_view``, ``fast_forward``, ``state_dict``) and the
port's warm failover (``resilience/serve_restart.py`` ``failover_server``);
every routing decision, shed, kill and ledger close is the JAX router's, line
for line, so the fleet transcript is the JAX package's byte for byte on the
same trace. Replicas share one model, whose programs each replica captures
as its own CUDA graphs on the card (``serve/paged.py`` ``GraphedProgram``).

Serving fleet router: prefix-affinity scheduling, load shedding, and warm
failover across N paged-serving replicas.

The single-engine serving stack (serve/engine.py) ends at one replica; this
module is the fleet-level front-end that spends every substrate piece built
for it:

- **prefix-affinity routing** (the SGLang cache-aware-routing insight): the
  router peeks each replica's prefix cache through the read-only
  ``InferenceEngine.prefix_peek`` hook — the exact chained content keys of
  serve/prefix_cache.py, no stats touched, no blocks revived — and routes an
  arrival to the replica with the longest cached prefix, falling back to
  least-loaded (queue depth with pool-headroom tiebreak). The
  ``affinity_weight`` knob trades cache reuse against load balance; weight 0
  is pure least-loaded, ``round_robin`` ignores both (the lint.sh gate's
  baseline policy).
- **admission control / load shedding**: a replica is ineligible when its
  waiting queue exceeds ``max_queue_depth`` or its pool occupancy exceeds
  ``occupancy_cap``; an arrival with no eligible replica is SHED — a
  RequestOutput with status "shed" and an EV_SHED record in the router's
  front-door request trace. Refusal, not a crash: overload degrades p99
  gracefully instead of collapsing goodput.
- **warm failover**: a crash-sim-style kill schedule removes replicas
  mid-flight. The victim drains through resilience/serve_restart —
  snapshot (quiesce parks every prefill frontier in the prefix cache),
  rebuild, restore — so requeued in-flight requests REMAP their prompt pages
  on the successor instead of re-prefilling. ``cold_failover=True`` rebuilds
  without the snapshot (the strictly-worse baseline the lint gate compares
  against). Each failover bills ``failover_cost`` synthetic seconds of
  ``restart_replay`` badput to that slot's goodput ledger.
- **fleet observability**: per-replica request-trace sketches fold through
  ``utils/cluster.fleet_latency_summary`` into exact fleet p50/p95/p99 every
  iteration (the mergeable-sketch contract — bitwise-equal the
  single-stream percentiles over the concatenated ledger), speculation
  counters fold through ``fleet_serving_totals``, and per-slot goodput
  ledgers merge into one ``goodput_fleet`` block.

Determinism: the router steps every replica in lockstep on one iteration
clock (idle steps are host-cheap — no device call without lanes), routes by
exact integer counters, and the run transcript (``run`` returns it) is a
pure function of (requests, config, kill schedule) — byte-stable under
json.dumps, golden-compared in scripts/lint.sh.

Compile economics: replicas share one model/params object, so the paged
program set is built ONCE and shared through the build memo in
serve/paged.py; only replica 0 carries the telemetry session (a second
replica registering the same program signature would read as a recompile to
the compile watchdog).
"""

from collections import deque

from ..runtime.constants import (SERVING_FLEET_POLICIES,
                                 SERVING_FLEET_POLICY_AFFINITY,
                                 SERVING_FLEET_POLICY_ROUND_ROBIN)
from ..utils import logger
from .request_trace import LATENCY_METRICS, RequestTracer
from .scheduler import RequestOutput, unpack_request

FLEET_TRANSCRIPT_VERSION = 1
FLEET_TRANSCRIPT_KIND = "serve_fleet_transcript"
SHED_REASON = "fleet_saturated"

_GUARD_ITERS = 200000


class FleetRouter:
    """Deterministic front-end owning N ``InferenceEngine`` replicas.

    ``engines``            the replica list (index = slot id; a failed-over
                           replacement takes its victim's slot).
    ``policy``             "affinity" | "least_loaded" | "round_robin".
    ``affinity_weight``    cached-prefix blocks are worth this many queue
                           slots in the routing score (affinity policy only).
    ``max_queue_depth``    per-replica waiting-queue bound (0 = unbounded).
    ``occupancy_cap``      per-replica pool-occupancy admission cap in
                           (0, 1]; 1.0 disables occupancy shedding.
    ``kill_schedule``      iterable of ``(it, slot)`` — kill that slot's
                           replica when the router clock reaches ``it``.
    ``build_replacement``  ``slot -> InferenceEngine`` factory for failover
                           (must share the fleet's model/params object and
                           pass ``telemetry=None`` — see module docstring).
    ``snapshot_dir``       where warm-failover snapshots commit.
    ``failover_cost``      synthetic restart_replay seconds billed per kill.
    ``cold_failover``      rebuild without the snapshot (baseline mode).
    ``telemetry``          optional TelemetrySession for Serving/Fleet/*
                           scalars (replica 0's session in serve-sim).
    ``tracer``             front-door RequestTracer for shed records; one is
                           created (host_id = fleet size) when omitted.
    """

    def __init__(self, engines, *, policy=SERVING_FLEET_POLICY_AFFINITY,
                 affinity_weight=1.0, max_queue_depth=0, occupancy_cap=1.0,
                 kill_schedule=None, build_replacement=None,
                 snapshot_dir=None, failover_cost=4.0, cold_failover=False,
                 telemetry=None, tracer=None, run_id="fleet"):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if policy not in SERVING_FLEET_POLICIES:
            raise ValueError(f"fleet policy must be one of "
                             f"{SERVING_FLEET_POLICIES}, got {policy!r}")
        self.engines = list(engines)
        self.policy = policy
        self.affinity_weight = float(affinity_weight)
        self.max_queue_depth = int(max_queue_depth)
        self.occupancy_cap = float(occupancy_cap)
        self.build_replacement = build_replacement
        self.snapshot_dir = snapshot_dir
        self.failover_cost = float(failover_cost)
        self.cold_failover = bool(cold_failover)
        self.telemetry = telemetry
        self.run_id = run_id
        self.tracer = tracer if tracer is not None else RequestTracer(
            capacity=1024, host_id=len(self.engines))
        # kill schedule: it -> [slots], applied once when the clock arrives
        self._kills = {}
        for it, slot in (kill_schedule or ()):
            self._kills.setdefault(int(it), []).append(int(slot))
        self.kills_applied = 0
        self._rr = 0                     # round-robin cursor
        self._it = 0
        self._order = []                 # req_id in routing order
        self.outputs = {}                # req_id -> RequestOutput
        self.shed_count = 0
        self.finished_count = 0
        self.refused_count = 0
        self.prefill_chunks = [0] * len(self.engines)   # per slot, survives
        self._retired = []               # full bundles of killed replicas
        self.last_fleet_latency = {}
        # per-slot goodput ledgers on a synthetic clock: 1.0s per stepped
        # iteration, failover_cost s per kill — pure function of the
        # schedule, so the merged fraction is golden-able
        from ..utils.goodput import RunLedger
        self._cells = [[0.0] for _ in self.engines]
        self._ledgers = [
            RunLedger(run_id=self.run_id, host=slot,
                      clock=(lambda c=cell: c[0]), wall=lambda: 0.0)
            for slot, cell in enumerate(self._cells)]

    # ------------------------------------------------------------- routing
    def _eligible(self, slot, view):
        if self.max_queue_depth and view["waiting"] >= self.max_queue_depth:
            return False
        if self.occupancy_cap < 1.0:
            used = 1.0 - view["free_blocks"] / max(view["num_blocks"], 1)
            if used >= self.occupancy_cap:
                return False
        return True

    def route(self, req):
        """Pick a replica slot for ``req`` (None = shed). Exact integer/
        rational scoring, deterministic tie-break toward the lowest slot."""
        views = [eng.load_view() for eng in self.engines]
        elig = [s for s in range(len(self.engines))
                if self._eligible(s, views[s])]
        if not elig:
            return None, 0
        if self.policy == SERVING_FLEET_POLICY_ROUND_ROBIN:
            slot = elig[self._rr % len(elig)]
            self._rr += 1
            return slot, 0
        w = (self.affinity_weight
             if self.policy == SERVING_FLEET_POLICY_AFFINITY else 0.0)
        hits = {s: self.engines[s].prefix_peek(req.prompt)[0] for s in elig}
        best, best_key = None, None
        for s in elig:
            v = views[s]
            load = (v["waiting"] + v["running"]
                    - v["free_blocks"] / max(v["num_blocks"], 1))
            key = (w * hits[s] - load, -s)
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best, hits[best]

    def _submit(self, req, slot):
        self._order.append(req.req_id)
        out = self.engines[slot].submit(req)
        if out is not None:                     # engine-level refusal
            self.outputs[req.req_id] = out
            self.refused_count += 1

    def _shed(self, req):
        self._order.append(req.req_id)
        self.tracer.on_shed(req, SHED_REASON)
        self.outputs[req.req_id] = RequestOutput(req.req_id, "shed",
                                                 refusal=SHED_REASON)
        self.shed_count += 1

    # ------------------------------------------------------------ failover
    def _kill(self, slot):
        """Replace ``engines[slot]`` mid-flight. Warm: drain through the
        serve_restart snapshot (in-flight requests remap their prefix pages
        on the successor). Cold: rebuild and re-submit the quiesced waiting
        queue — every requeued prompt re-prefills from scratch."""
        if self.build_replacement is None:
            raise RuntimeError("kill schedule requires a build_replacement "
                               "factory")
        victim = self.engines[slot]
        if victim.tracer is not None:
            self._retired.append(victim.tracer.bundle())
        mode = "cold" if self.cold_failover else "warm"
        if self.cold_failover:
            state = victim.state_dict()          # quiesces the victim
            replacement = self.build_replacement(slot)
            replacement.fast_forward(self._it)
            for packed, _idx in state["scheduler"]["waiting"]:
                replacement.submit(unpack_request(packed))
        else:
            if self.snapshot_dir is None:
                raise RuntimeError("warm failover requires snapshot_dir")
            from ..resilience.serve_restart import failover_server
            replacement = failover_server(
                victim, lambda: self.build_replacement(slot),
                self.snapshot_dir, tag=f"fleet_r{slot}_it{self._it}")
        self.engines[slot] = replacement
        self._cells[slot][0] += self.failover_cost
        self._ledgers[slot].close("restart_replay")
        self.kills_applied += 1
        logger.info(f"[deepspeed_tpu_torch] fleet: replica {slot} killed at "
                    f"it={self._it}, {mode} failover "
                    f"({len(replacement.scheduler.waiting)} requests "
                    f"requeued)")
        return mode

    # --------------------------------------------------------- observability
    def _live_sketch_bundles(self):
        out = []
        for eng in self.engines:
            tr = eng.tracer
            if tr is None:
                continue
            out.append({"latency_sketches": {
                m: tr.hist[m].to_dict() for m in LATENCY_METRICS
                if tr.hist[m].count}})
        out.extend(self._retired)
        out.append({"latency_sketches": {
            m: self.tracer.hist[m].to_dict() for m in LATENCY_METRICS
            if self.tracer.hist[m].count}})
        return out

    def bundles(self):
        """Every request-trace bundle the fleet produced: live replicas,
        retired (killed) replicas, and the router's front door — the operand
        of the fleet merge AND of the end-of-run exactness assertion."""
        live = [eng.tracer.bundle() for eng in self.engines
                if eng.tracer is not None]
        return live + list(self._retired) + [self.tracer.bundle()]

    def goodput_summaries(self):
        return {slot: led.finalize(persist=False)
                for slot, led in enumerate(self._ledgers)}

    def fleet_goodput(self):
        from ..utils.goodput import fleet_goodput
        return fleet_goodput(self.goodput_summaries())

    def fleet_summary(self, ps=(50, 95, 99)):
        """End-of-run fleet rollup: exact merged percentiles, summed serving
        totals (speculation counters included), merged goodput."""
        from ..utils.cluster import fleet_latency_summary, fleet_serving_totals
        bundles = self.bundles()
        return {
            "replicas": len(self.engines),
            "policy": self.policy,
            "latency": fleet_latency_summary(bundles, ps=ps),
            "serving": fleet_serving_totals(bundles),
            "goodput_fleet": self.fleet_goodput(),
            "prefill_chunks": list(self.prefill_chunks),
            "total_prefill_chunks": sum(self.prefill_chunks),
            "finished": self.finished_count,
            "refused": self.refused_count,
            "shed": self.shed_count,
            "kills": self.kills_applied,
        }

    def _fleet_scalar(self, name, value):
        if self.telemetry is not None:
            self.telemetry.monitor.add_scalar(f"Serving/Fleet/{name}",
                                              float(value), self._it)

    def _emit_fleet_scalars(self):
        from ..utils.cluster import fleet_latency_summary, fleet_serving_totals
        self.last_fleet_latency = fleet_latency_summary(
            self._live_sketch_bundles(), ps=(50, 95, 99))
        if self.telemetry is None:
            return
        for k, v in self.last_fleet_latency.items():
            self._fleet_scalar(f"Latency/{k}", v)
        views = [eng.load_view() for eng in self.engines]
        self._fleet_scalar("waiting", sum(v["waiting"] for v in views))
        self._fleet_scalar("running", sum(v["running"] for v in views))
        self._fleet_scalar("free_blocks",
                           sum(v["free_blocks"] for v in views))
        self._fleet_scalar("shed", self.shed_count)
        self._fleet_scalar("finished", self.finished_count)
        spec = fleet_serving_totals(
            [{"totals": dict(eng.tracer.totals)} for eng in self.engines
             if eng.tracer is not None] + self._retired)["totals"]
        for k in ("drafted_tokens", "accepted_draft_tokens",
                  "wasted_draft_tokens"):
            self._fleet_scalar(f"Spec/{k}", spec.get(k, 0))
        productive = sum(led.class_seconds["productive_step"]
                         for led in self._ledgers)
        accounted = sum(led.accounted_seconds() for led in self._ledgers)
        self._fleet_scalar("Goodput/fraction",
                           productive / accounted if accounted else 0.0)

    # ------------------------------------------------------------- the loop
    def run(self, requests):
        """Route and drive everything to completion in lockstep. Returns
        ``(outputs in arrival order, transcript)`` — the transcript is the
        byte-stable iteration-domain record lint.sh golden-compares."""
        pending = deque(sorted(enumerate(requests),
                               key=lambda e: (e[1].arrival, e[0])))
        iterations = []
        guard = 0
        while pending or any(not e.scheduler.idle for e in self.engines):
            it = self._it
            entry = {"it": it, "routed": [], "shed": [], "kills": []}
            for slot in self._kills.pop(it, ()):
                entry["kills"].append([slot, self._kill(slot)])
            while pending and pending[0][1].arrival <= it:
                _, req = pending.popleft()
                slot, hit_blocks = self.route(req)
                if slot is None:
                    self._shed(req)
                    entry["shed"].append([req.req_id, SHED_REASON])
                else:
                    self._submit(req, slot)
                    entry["routed"].append([req.req_id, slot,
                                            int(hit_blocks)])
            for slot, eng in enumerate(self.engines):
                log = eng.step()
                if log["prefill"] is not None:
                    self.prefill_chunks[slot] += 1
                for rid in log["finished"]:
                    self.outputs[rid] = eng.outputs[rid]
                    self.finished_count += 1
                self._cells[slot][0] += 1.0
                self._ledgers[slot].close_step(it)
            self._emit_fleet_scalars()
            if entry["routed"] or entry["shed"] or entry["kills"]:
                iterations.append(entry)
            self._it += 1
            # fast-forward a fully idle fleet to the next event (arrival or
            # scheduled kill) — the synthetic goodput clock only advances on
            # stepped iterations, so skipped idle gaps bill nothing
            if (pending and all(e.scheduler.idle for e in self.engines)
                    and not any(k >= self._it for k in self._kills)):
                nxt = max(int(pending[0][1].arrival), self._it)
                if nxt > self._it:
                    self._it = nxt
                    for eng in self.engines:
                        eng.fast_forward(nxt)
            guard += 1
            if guard > _GUARD_ITERS:
                raise RuntimeError("fleet loop failed to drain (bug)")
        missing = [rid for rid in self._order if rid not in self.outputs]
        if missing:
            raise RuntimeError(
                f"fleet conservation violated: {len(missing)} requests "
                f"lost (neither finished, refused, nor shed): "
                f"{missing[:8]}")
        transcript = self._transcript(iterations)
        return [self.outputs[rid] for rid in self._order], transcript

    def _transcript(self, iterations):
        return {
            "version": FLEET_TRANSCRIPT_VERSION,
            "kind": FLEET_TRANSCRIPT_KIND,
            "fleet": {
                "replicas": len(self.engines),
                "policy": self.policy,
                "affinity_weight": self.affinity_weight,
                "max_queue_depth": self.max_queue_depth,
                "occupancy_cap": self.occupancy_cap,
            },
            "iterations": iterations,
            "totals": {
                "prefill_chunks": list(self.prefill_chunks),
                "finished": self.finished_count,
                "refused": self.refused_count,
                "shed": self.shed_count,
                "kills": self.kills_applied,
                "goodput_fleet_fraction":
                    self.fleet_goodput()["goodput_fraction"],
            },
        }
