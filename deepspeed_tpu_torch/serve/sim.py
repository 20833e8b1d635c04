"""``serve-sim`` — deterministic request-replay harness for the engine.

PyTorch port of ``deepspeed_tpu/serve/sim.py`` (lines 1-997), run as
``python -m deepspeed_tpu_torch.serve.sim`` (the ``bin/`` entry is ROADMAP.md
item 20). The trace generator, the invariants and the reports are the JAX
module's; the model builds (JAX lines 96-116, 129-135) are the port's
``GPT2Model`` on ``--device`` (``cuda`` unless ``cpu`` is asked for),
initialised from ``--seed`` by ``GPT2Model.init`` (its numbers differ from
``jax.random``'s). ``main(argv, model_params=(model, params))`` hands it a
model and a name -> tensor dict instead (``params_from_jax`` gives one), so
a test can hold it against the JAX sim on equal weights; ``fleet_run``
returns the fleet run's objects to a caller in the same process. On the card
each replica captures its programs as CUDA graphs; the watchdog records
replica 0's captures (``serve:<program>``). ``--sharding`` above 1 is
head-sharded serving, ROADMAP.md item 10.6, and raises.

Replays a seeded synthetic trace (mixed prompt/generation lengths, staggered
arrivals, a sprinkle of beam-search requests) through InferenceEngine and
asserts the serving invariants:

1. **Zero recompiles after warmup** — every serve:* program is recorded
   exactly once for the whole trace (its capture on the card, its first call
   on the CPU; compile watchdog through TelemetrySession).
2. **Bit-exact paging** — the engine runs with ``mirror=True``, so every
   prefill chunk and decode step is compared bitwise against the dense-cache
   oracle (serve/oracle.py); one diverging ulp fails the run.
3. **Deterministic schedule** — with ``--replay``, the whole trace is run
   twice on fresh engines and the per-iteration schedule logs must be
   byte-identical (json.dumps) and the outputs token-identical.
4. **Exact waste decomposition** — the request-trace ledger (on by default
   here) must classify every scheduled token as useful or replayed, summing
   to the schedule log's own token count exactly.
5. **SLO attainment** (with ``--slo-ttft-ms`` / ``--slo-tpot-ms``) — any
   finished request violating a configured SLO fails the run nonzero.

Serving/* scalars (occupancy, TTFT, goodput) land in the TelemetrySession's
scalars.jsonl. ``--json`` writes a machine-readable report whose
``deterministic`` subtree is byte-stable across runs (CI diffs it, mirroring
``ds-tpu lint --json``); ``--dump-ledger`` writes the raw ledger bundle for
``ds-tpu serve-timeline``. Exit 0 = all invariants held.
"""

import argparse
import json
import sys


def synth_trace(n, *, vocab_size, max_model_len, seed, beam_every=7,
                include_infeasible=False, shared_prefix_len=0,
                arrival_scale=1.0, arrival_process=None):
    """Seeded mixed trace: prompts 1..~ML/2, generations 1..~ML/4, arrivals
    staggered 0-2 iterations apart, every ``beam_every``-th request beam-4.

    With ``shared_prefix_len > 0`` every prompt starts with the SAME seeded
    ``shared_prefix_len``-token system prompt followed by a per-request tail —
    the canonical prefix-cache workload. ``arrival_scale`` scales the seeded
    inter-arrival gaps (0.0 = every request arrives at once, the
    past-saturation fleet workload) without perturbing the RNG stream. The
    default path draws nothing extra, so existing seeded traces (and their
    goldens) are untouched.

    ``arrival_process=("poisson", rate)`` replaces the staggered gaps with a
    seeded Poisson process of intensity ``rate`` requests/iteration
    (exponential inter-arrival gaps on a float clock, floored to the
    iteration domain). Arrivals bunch, so a rate past the fleet's service
    capacity drives the waiting queues through any --max-queue-depth bound —
    the load-shedding workload. Deterministic per seed like everything else
    here; it is a DIFFERENT mode (the extra draw shifts the RNG stream), so
    default-mode traces are still byte-identical to older releases."""
    import numpy as np
    from .scheduler import Request

    rng = np.random.RandomState(seed)
    P = int(shared_prefix_len)
    if P >= max_model_len:
        raise ValueError("shared_prefix_len must leave room for a tail and "
                         f"generation (got {P} >= {max_model_len})")
    system_prompt = rng.randint(0, vocab_size, size=P).tolist() if P else []
    reqs, arrival, clock = [], 0, 0.0
    for i in range(n):
        if arrival_process is not None:
            kind, rate = arrival_process
            if kind != "poisson":
                raise ValueError(f"unknown arrival process {kind!r}")
            clock += float(rng.exponential(1.0 / rate))
            arrival = int(clock)
        else:
            arrival += int(int(rng.randint(0, 3)) * arrival_scale)
        T0 = P + int(rng.randint(1, max(2, (max_model_len - P) // 2)))
        L = int(rng.randint(1, max(2, max_model_len // 4)))
        if T0 + L > max_model_len:          # keep the trace feasible
            L = max_model_len - T0
        K = 4 if (beam_every and i % beam_every == beam_every - 1) else 1
        prompt = system_prompt + rng.randint(0, vocab_size,
                                             size=T0 - P).tolist()
        reqs.append(Request(f"req{i:03d}", prompt, L, arrival=arrival,
                            num_beams=K))
    if include_infeasible:
        prompt = rng.randint(0, vocab_size, size=max_model_len).tolist()
        reqs.append(Request("req-too-long", prompt, max_model_len,
                            arrival=0))
    return reqs


def _p50(values):
    """Deterministic iteration-domain median: upper median of sorted ints."""
    vals = sorted(v for v in values if v is not None)
    return vals[len(vals) // 2] if vals else None


def _seeded(args, seed):
    """A GPT-2 of the sim's widths on ``args.device``, initialised from
    ``seed``; returns (model, params)."""
    import torch

    from ..models.gpt2 import GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=args.vocab_size, n_positions=args.max_model_len,
                     n_embd=args.n_embd, n_layer=args.n_layer,
                     n_head=args.n_head, compute_dtype=torch.float32,
                     loss_chunk=0)
    model = GPT2Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    return model, {k: v.detach().clone() for k, v in params.items()}


def _model_params(args):
    """Build the sim model + params once — fleet replicas SHARE the model
    object (one set of weights on the device; each replica owns its pools
    and, on the card, its captured programs)."""
    return _seeded(args, args.seed)


def _build(args, telemetry, prefix_cache=None, sharding=None, speculate=None,
           model_params=None, host_id=0):
    from .engine import InferenceEngine

    pc = args.prefix_cache if prefix_cache is None else prefix_cache
    tp = args.sharding if sharding is None else sharding
    spec_k = args.speculate if speculate is None else speculate
    # the dense-cache oracle cannot mirror any of these modes (skipped
    # prefills / reduction-order drift / multi-token commits), and the
    # engine constructor enforces that
    mirror = not args.no_mirror and not pc and tp <= 1 and not spec_k
    model, params = (model_params if model_params is not None
                     else _model_params(args))
    speculation = None
    if spec_k:
        # self-draft by default (same model + params -> near-total acceptance,
        # the deterministic upper bound the strict-step gate relies on); a
        # non-negative --spec-draft-seed draws a draft model of its own so the
        # rejection/rollback path gets exercised too
        if args.spec_draft_seed >= 0:
            draft, dparams = _seeded(args, args.spec_draft_seed)
        else:
            draft, dparams = model, None
        speculation = {"enabled": True, "draft_model": draft,
                       "draft_params": dparams, "max_draft_tokens": spec_k}
    engine = InferenceEngine(
        model, params, num_slots=args.slots, block_size=args.block_size,
        num_blocks=args.num_blocks, max_model_len=args.max_model_len,
        prefill_chunk=args.prefill_chunk, use_pallas=args.pallas,
        telemetry=telemetry, mirror=mirror, prefix_cache=pc,
        sharding={"model": tp} if tp > 1 else None,
        speculation=speculation,
        request_trace=None if args.no_trace else {
            "enabled": True,
            "capacity": max(args.requests + 1, 256),
            "slo": {"ttft_ms": args.slo_ttft_ms, "tpot_ms": args.slo_tpot_ms},
            "host_id": host_id,
        })
    return engine


def _trace(args):
    return synth_trace(args.requests, vocab_size=args.vocab_size,
                       max_model_len=args.max_model_len, seed=args.seed,
                       include_infeasible=args.include_infeasible,
                       shared_prefix_len=args.shared_prefix,
                       arrival_scale=args.arrival_scale,
                       arrival_process=args.arrival_process)


def _report(args, trace, outputs, logs, tracer, waste, slo, failures,
            cache_stats=None, ttft_compare=None, fleet_merge_exact=None,
            spec_summary=None, steps_compare=None):
    """Machine-readable serve-sim report. The ``deterministic`` subtree is a
    pure function of the seeded trace (iteration-domain latencies, token
    counts, waste split — byte-stable across runs on one platform); ``wall``
    carries the ms-domain percentiles and SLO attainment, which vary run to
    run. CI diffs the deterministic part."""
    recs = {}
    if tracer is not None:
        recs = {r["req_id"]: r for r in tracer.requests}
    table = []
    for o in sorted(outputs, key=lambda o: o.req_id):
        r = recs.get(o.req_id, {})
        table.append({
            "req_id": o.req_id,
            "status": o.status,
            "n_tokens": len(o.tokens),
            "ttft_iters": o.ttft_iters,
            "queue_delay_iters": r.get("queue_delay_iters"),
            "e2e_iters": r.get("e2e_iters"),
            "preemptions": o.preemptions,
            "slo_violations": r.get("slo_violations", []),
        })
    det = {
        "args": {"requests": args.requests, "seed": args.seed,
                 "slots": args.slots, "block_size": args.block_size,
                 "num_blocks": args.num_blocks,
                 "max_model_len": args.max_model_len,
                 "prefill_chunk": args.prefill_chunk,
                 "shared_prefix": args.shared_prefix,
                 "sharding": args.sharding,
                 "prefix_cache": bool(args.prefix_cache),
                 "speculate": args.speculate,
                 "spec_draft_seed": args.spec_draft_seed},
        "n_finished": sum(1 for o in outputs if o.status == "finished"),
        "n_refused": sum(1 for o in outputs if o.status == "refused"),
        "iterations": len(logs),
        "preemptions": sum(len(l["preempted"]) for l in logs),
        "requests": table,
        "waste": waste,
    }
    if cache_stats is not None:
        # pure functions of the seeded schedule -> deterministic subtree
        det["prefix_cache"] = cache_stats
    if spec_summary is not None:
        # acceptance counters and step ratios are pure functions of the
        # seeded schedule (host argmax over deterministic logits)
        det["speculation"] = spec_summary
    if steps_compare is not None:
        det["target_steps"] = steps_compare
    if ttft_compare is not None:
        det["ttft_p50_iters"] = ttft_compare
    if fleet_merge_exact is not None:
        # exact-by-construction boolean (sketch merge == single stream), so
        # it belongs in the byte-stable subtree despite wall-derived inputs
        det["fleet_merge_exact"] = bool(fleet_merge_exact)
    wall = {}
    if tracer is not None:
        wall["percentiles"] = tracer.percentiles()
        wall["slo"] = slo
    return {"version": 1, "kind": "serve_sim_report",
            "deterministic": det, "wall": wall,
            "failures": list(failures)}


def _parse_kill(ap, spec, fleet):
    try:
        it_s, slot_s = spec.split(":")
        it, slot = int(it_s), int(slot_s)
    except ValueError:
        ap.error(f"--kill wants IT:REPLICA, got {spec!r}")
    if not fleet:
        ap.error("--kill needs --fleet N")
    if not 0 <= slot < fleet:
        ap.error(f"--kill replica {slot} out of range for --fleet {fleet}")
    if it < 0:
        ap.error(f"--kill iteration must be >= 0, got {it}")
    return (it, slot)


def _run_fleet(args, session, model_params, *, policy, cold_failover,
               snapshot_dir):
    """One fleet pass over the seeded trace: N fresh replicas sharing one
    model/params (one program build for the whole fleet), replica 0 carrying
    the telemetry session (a second replica registering the same program
    signature would read as a recompile to the watchdog)."""
    from .request_trace import RequestTracer
    from .router import FleetRouter

    engines = [_build(args, session if slot == 0 else None,
                      prefix_cache=True, model_params=model_params,
                      host_id=slot)
               for slot in range(args.fleet)]

    def build_replacement(slot):
        return _build(args, None, prefix_cache=True,
                      model_params=model_params, host_id=slot)

    front = RequestTracer(capacity=max(args.requests + 1, 256),
                          host_id=args.fleet)
    router = FleetRouter(
        engines, policy=policy, affinity_weight=args.affinity_weight,
        max_queue_depth=args.max_queue_depth,
        occupancy_cap=args.occupancy_cap, kill_schedule=args.kill,
        build_replacement=build_replacement, snapshot_dir=snapshot_dir,
        cold_failover=cold_failover, telemetry=session, tracer=front,
        run_id=f"fleet_seed{args.seed}")
    outputs, transcript = router.run(_trace(args))
    return router, outputs, transcript


def _fleet_single_stream(bundles, ps=(50, 95, 99)):
    """Percentiles of ONE sketch stream over every finished record in every
    bundle — the ground truth the merged fleet sketches must bitwise equal
    (the HistogramSketch mergeability contract, asserted every fleet run)."""
    from .request_trace import HistogramSketch, LATENCY_METRICS
    singles = {m: HistogramSketch() for m in LATENCY_METRICS}
    for b in bundles:
        for rec in (b or {}).get("requests") or []:
            if rec.get("status") == "finished":
                for m in LATENCY_METRICS:
                    singles[m].add(rec.get(m))
    out = {}
    for m in sorted(singles):
        if not singles[m].count:
            continue
        for p in ps:
            out[f"{m}_p{p:g}"] = singles[m].percentile(p)
    return out


def fleet_run(args, model_params=None):
    """The fleet run's checks of ``_fleet_main``, returning (failures, info):
    ``info`` holds the routers (``router``, and ``router_rr`` /
    ``router_cold`` of the compare modes), the outputs, the session, the
    merged and single-stream percentiles and the compare dicts."""
    info = {}
    rc = _fleet_main(args, model_params=model_params, info=info)
    return rc, info


def _fleet_main(args, model_params=None, info=None):
    import tempfile

    from ..utils.cluster import fleet_latency_summary, fleet_serving_totals
    from ..utils.telemetry import TelemetrySession

    if args.compare_cold_failover and not args.kill:
        print("serve-sim: --compare-cold-failover needs --kill",
              file=sys.stderr)
        return 2

    trace = _trace(args)
    session = TelemetrySession(output_path=args.output, job_name="serve_sim",
                               device=args.device)
    if model_params is None:
        model_params = _model_params(args)
    snapshot_dir = args.snapshot_dir or tempfile.mkdtemp(
        prefix="ds_tpu_fleet_snap_")

    router, outputs, transcript = _run_fleet(
        args, session, model_params, policy=args.fleet_policy,
        cold_failover=False, snapshot_dir=snapshot_dir)

    failures = []
    finished = [o for o in outputs if o.status == "finished"]
    refused = [o for o in outputs if o.status == "refused"]
    shed = [o for o in outputs if o.status == "shed"]

    # fleet invariant 1: no program of replica 0 (the one carrying the
    # session) is recorded twice
    serve_names = sorted(n for n in session.watchdog.records
                         if n.startswith("serve:"))
    for name in serve_names:
        n_r = session.watchdog.recompiles(name)
        if n_r:
            failures.append(f"{name}: {n_r} recompile(s) after warmup")
    if not serve_names:
        failures.append("no serve:* programs reached the compile watchdog")

    # fleet invariant 2: conservation — every submitted request comes back
    # exactly once, finished or EXPLICITLY refused/shed; kills lose nothing
    want = sorted(r.req_id for r in trace)
    got = sorted(o.req_id for o in outputs)
    if want != got:
        lost = sorted(set(want) - set(got))
        dups = len(got) - len(set(got))
        failures.append(f"request conservation violated: {len(lost)} "
                        f"lost / {dups} duplicated "
                        f"({', '.join(lost[:8])})")
    bad = [o.req_id for o in outputs
           if o.status not in ("finished", "refused", "shed")]
    if bad:
        failures.append(f"unexpected terminal status on {len(bad)} "
                        f"request(s): {', '.join(bad[:8])}")

    # fleet invariant 3: EXACT fleet percentiles — the merged per-replica
    # sketches must bitwise-equal the single-stream sketch over the
    # concatenated ledger (retired replicas and the front door included)
    bundles = router.bundles()
    fleet_lat = fleet_latency_summary(bundles, ps=(50, 95, 99))
    single_lat = _fleet_single_stream(bundles, ps=(50, 95, 99))
    fleet_merge_exact = fleet_lat == single_lat
    if not fleet_merge_exact:
        failures.append("fleet percentile merge diverged from the "
                        "single-stream sketch over the concatenated ledger")

    # fleet invariant 4: merged goodput floor (kills bill restart_replay
    # badput on a synthetic per-iteration clock — pure schedule function)
    gp = router.fleet_goodput()
    if args.fleet_goodput_floor and not (
            gp["goodput_fraction"] >= args.fleet_goodput_floor):
        failures.append(
            f"goodput_fleet fraction {gp['goodput_fraction']:.4f} under the "
            f"--fleet-goodput-floor {args.fleet_goodput_floor}")

    # fleet invariant 5: the SLO gate over FLEET-MERGED percentiles
    if args.slo_ttft_ms and fleet_lat.get("ttft_ms_p99", 0.0) > args.slo_ttft_ms:
        failures.append(f"fleet ttft_ms_p99 {fleet_lat['ttft_ms_p99']:.2f} "
                        f"over the {args.slo_ttft_ms} ms SLO")
    if args.slo_tpot_ms and fleet_lat.get("tpot_ms_p99", 0.0) > args.slo_tpot_ms:
        failures.append(f"fleet tpot_ms_p99 {fleet_lat['tpot_ms_p99']:.2f} "
                        f"over the {args.slo_tpot_ms} ms SLO")

    # fleet invariant 6 (optional): affinity must BUY something over
    # round-robin on this trace — identical tokens, strictly fewer total
    # prefill chunks (the fleet-wide cache-reuse win), strictly better
    # fleet p50 TTFT in the deterministic iteration domain
    affinity_compare = None
    if args.compare_affinity:
        router_rr, outs_rr, _ = _run_fleet(
            args, None, model_params, policy="round_robin",
            cold_failover=False, snapshot_dir=snapshot_dir)
        t_aff = {o.req_id: (o.status, o.tokens) for o in outputs}
        t_rr = {o.req_id: (o.status, o.tokens) for o in outs_rr}
        if t_aff != t_rr:
            diff = sorted(r for r in t_aff if t_aff[r] != t_rr.get(r))
            failures.append(
                f"routing policy changed tokens on {len(diff)} request(s): "
                f"{', '.join(diff[:8])}")
        chunks_aff = sum(router.prefill_chunks)
        chunks_rr = sum(router_rr.prefill_chunks)
        p50_aff = _p50(o.ttft_iters for o in outputs
                       if o.status == "finished")
        p50_rr = _p50(o.ttft_iters for o in outs_rr
                      if o.status == "finished")
        affinity_compare = {
            "prefill_chunks": {"affinity": chunks_aff,
                               "round_robin": chunks_rr},
            "ttft_p50_iters": {"affinity": p50_aff, "round_robin": p50_rr},
        }
        if not chunks_aff < chunks_rr:
            failures.append(
                f"affinity routing did not strictly reduce prefill chunks: "
                f"{chunks_aff} vs round-robin {chunks_rr}")
        if p50_aff is None or p50_rr is None or not p50_aff < p50_rr:
            failures.append(
                f"affinity routing did not strictly improve fleet p50 TTFT: "
                f"{p50_aff} vs round-robin {p50_rr} iters")

    # fleet invariant 7 (optional): warm failover must strictly beat a cold
    # successor on the same kill schedule — identical tokens, fewer chunks
    failover_compare = None
    if args.compare_cold_failover:
        router_cold, outs_cold, _ = _run_fleet(
            args, None, model_params, policy=args.fleet_policy,
            cold_failover=True, snapshot_dir=snapshot_dir)
        t_warm = {o.req_id: (o.status, o.tokens) for o in outputs}
        t_cold = {o.req_id: (o.status, o.tokens) for o in outs_cold}
        if t_warm != t_cold:
            diff = sorted(r for r in t_warm if t_warm[r] != t_cold.get(r))
            failures.append(
                f"failover mode changed tokens on {len(diff)} request(s): "
                f"{', '.join(diff[:8])}")
        chunks_warm = sum(router.prefill_chunks)
        chunks_cold = sum(router_cold.prefill_chunks)
        failover_compare = {"prefill_chunks": {"warm": chunks_warm,
                                               "cold": chunks_cold}}
        if not chunks_warm < chunks_cold:
            failures.append(
                f"warm failover did not strictly reduce prefill chunks: "
                f"{chunks_warm} vs cold {chunks_cold}")

    # fleet invariant 8 (poisson arrivals): shed determinism — the shed set
    # (and so the shed RATE) must be a pure function of the seeded trace and
    # the admission bounds. Re-route the identical trace through a fresh
    # router (shared model/params, so no recompiles) and require the same
    # terminal status on every request.
    shed_rate = len(shed) / max(len(trace), 1)
    if args.arrival_process is not None:
        _, outs_re, _ = _run_fleet(
            args, None, model_params, policy=args.fleet_policy,
            cold_failover=False, snapshot_dir=snapshot_dir)
        st = {o.req_id: o.status for o in outputs}
        st_re = {o.req_id: o.status for o in outs_re}
        if st != st_re:
            diff = sorted(r for r in st if st[r] != st_re.get(r))
            failures.append(
                f"shed determinism violated: terminal status changed on "
                f"{len(diff)} request(s) across identical replays "
                f"({', '.join(diff[:8])})")
        shed_re = sum(1 for s in st_re.values() if s == "shed")
        if shed_re != len(shed):
            failures.append(f"shed rate not deterministic: {len(shed)} vs "
                            f"{shed_re} shed across identical replays")

    spec_totals = fleet_serving_totals(bundles)
    if info is not None:
        info.update(router=router, outputs=outputs, transcript=transcript,
                    session=session, fleet_latency=fleet_lat,
                    single_stream_latency=single_lat, failures=failures,
                    affinity_compare=affinity_compare,
                    failover_compare=failover_compare, goodput_fleet=gp,
                    serving_totals=spec_totals)
        if args.compare_affinity:
            info.update(router_rr=router_rr, outputs_rr=outs_rr)
        if args.compare_cold_failover:
            info.update(router_cold=router_cold, outputs_cold=outs_cold)

    if args.transcript:
        with open(args.transcript, "w") as f:
            f.write(json.dumps(transcript, sort_keys=True,
                               separators=(",", ":")))

    if args.dump_ledger:
        router.tracer.dump(args.dump_ledger)

    if args.json_out:
        det = {
            "args": {"requests": args.requests, "seed": args.seed,
                     "fleet": args.fleet, "fleet_policy": args.fleet_policy,
                     "affinity_weight": args.affinity_weight,
                     "max_queue_depth": args.max_queue_depth,
                     "occupancy_cap": args.occupancy_cap,
                     "arrival_scale": args.arrival_scale,
                     "arrival": args.arrival,
                     "shared_prefix": args.shared_prefix,
                     "kill": [list(k) for k in args.kill],
                     "speculate": args.speculate},
            "n_finished": len(finished),
            "n_refused": len(refused),
            "n_shed": len(shed),
            "shed_rate": round(shed_rate, 6),
            "kills": router.kills_applied,
            "prefill_chunks": list(router.prefill_chunks),
            "total_prefill_chunks": sum(router.prefill_chunks),
            "goodput_fleet_fraction": gp["goodput_fraction"],
            "fleet_merge_exact": bool(fleet_merge_exact),
            "serving_totals": spec_totals,
        }
        if affinity_compare is not None:
            det["affinity_compare"] = affinity_compare
        if failover_compare is not None:
            det["failover_compare"] = failover_compare
        report = {"version": 1, "kind": "serve_fleet_report",
                  "deterministic": det,
                  "wall": {"fleet_latency": fleet_lat,
                           "goodput_fleet": gp},
                  "failures": list(failures)}
        blob = json.dumps(report, sort_keys=True, separators=(",", ":"))
        if args.json_out == "-":
            print(blob)
        else:
            with open(args.json_out, "w") as f:
                f.write(blob)

    session.close()

    print(f"serve-sim: fleet={args.fleet} policy={args.fleet_policy}: "
          f"{len(finished)} finished / {len(refused)} refused / "
          f"{len(shed)} shed of {len(trace)} requests, "
          f"{router.kills_applied} replica kill(s)")
    print(f"  prefill chunks   : {sum(router.prefill_chunks)} total "
          f"{list(router.prefill_chunks)} per slot")
    print(f"  fleet merge      : "
          f"{'exact' if fleet_merge_exact else 'DIVERGED'} over "
          f"{len(bundles)} bundles")
    print(f"  goodput_fleet    : {gp['goodput_fraction']:.4f} "
          f"({gp['class_seconds']['restart_replay']:.1f}s restart_replay "
          f"across {gp['n_hosts']} slots)")
    tot = spec_totals["totals"]
    if tot.get("drafted_tokens"):
        print(f"  fleet speculation: {tot['accepted_draft_tokens']} of "
              f"{tot['drafted_tokens']} drafts accepted, "
              f"{tot['wasted_draft_tokens']} wasted")
    if affinity_compare is not None:
        pc, tp = (affinity_compare["prefill_chunks"],
                  affinity_compare["ttft_p50_iters"])
        print(f"  affinity compare : chunks {pc['affinity']} vs "
              f"round-robin {pc['round_robin']}, p50 TTFT "
              f"{tp['affinity']} vs {tp['round_robin']} iters")
    if failover_compare is not None:
        fc = failover_compare["prefill_chunks"]
        print(f"  failover compare : warm {fc['warm']} vs cold "
              f"{fc['cold']} prefill chunks")
    if args.transcript:
        print(f"  transcript       : {args.transcript}")
    print(f"  scalars          : {session.monitor.log_dir}/scalars.jsonl")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("serve-sim: OK")
    return 0


def main(argv=None, model_params=None):
    """Run the sim; ``model_params`` = (GPT2Model, name -> tensor dict)
    replaces the seeded model (on the model's own device)."""
    args = parse_args(argv)
    if isinstance(args, int):
        return args
    if args.fleet:
        return _fleet_main(args, model_params=model_params)
    return _single_main(args, model_params)


def parse_args(argv=None):
    """The sim's arguments (argparse errors exit 2), with the derived
    ``arrival_process`` and ``kill`` schedule; for a fleet run
    ``prefix_cache`` is on and ``fleet_policy`` set."""
    ap = argparse.ArgumentParser(
        prog="serve-sim",
        description="deterministic serving-engine replay with bitwise oracle "
                    "+ zero-recompile assertions")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=257)
    ap.add_argument("--max-model-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--vocab-size", type=int, default=128)
    ap.add_argument("--n-embd", type=int, default=32)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--n-head", type=int, default=2)
    ap.add_argument("--no-mirror", action="store_true",
                    help="skip the dense-oracle bitwise lockstep (faster)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the cross-request prefix cache (disables the "
                         "mirror oracle: remapped prefixes skip the prefill "
                         "the oracle would need to reproduce)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="P",
                    help="give every request the same seeded P-token system "
                         "prompt (the prefix-cache workload); 0 = off")
    ap.add_argument("--compare-prefix-cache", action="store_true",
                    help="run the trace cache-off AND cache-on, assert token "
                         "identity and a STRICT cache-on p50 TTFT (iters) "
                         "improvement (implies --prefix-cache)")
    ap.add_argument("--speculate", type=int, nargs="?", const=4, default=0,
                    metavar="K",
                    help="speculative decoding with a K-token self-draft "
                         "(disables the mirror oracle: the K+1-wide verify is "
                         "token-identical, not bitwise); bare flag = K=4")
    ap.add_argument("--compare-speculate", action="store_true",
                    help="run the trace speculation-off AND speculation-on, "
                         "assert byte-identical tokens and STRICTLY fewer "
                         "target-model steps (implies --speculate)")
    ap.add_argument("--spec-draft-seed", type=int, default=-1, metavar="S",
                    help="re-draw the draft params from seed S instead of "
                         "self-drafting, to exercise rejection/rollback "
                         "(-1 = self-draft)")
    ap.add_argument("--spec-steps-budget", type=float, default=0.0,
                    metavar="R",
                    help="with --speculate: fail unless target_steps_per_"
                         "token < R (0 = not gated; PERF.md defines the "
                         "metric)")
    ap.add_argument("--sharding", type=int, default=1, metavar="TP",
                    help="shard the KV pool + decode programs over TP model-"
                         "axis devices by attention head (disables the "
                         "mirror oracle: per-layer psum is token-identical, "
                         "not bitwise)")
    ap.add_argument("--verify-unsharded", action="store_true",
                    help="with --sharding > 1: also run the trace on a "
                         "single-chip engine and assert token-identical "
                         "outputs (greedy and beam)")
    ap.add_argument("--pallas", action="store_true",
                    help="use the paged-decode kernel (its plain PyTorch "
                         "version on the CPU)")
    ap.add_argument("--replay", action="store_true",
                    help="run the trace twice and assert byte-identical "
                         "schedules")
    ap.add_argument("--include-infeasible", action="store_true",
                    help="append a request that can never fit (exercises "
                         "admission refusal)")
    ap.add_argument("--output", default="serve_sim_telemetry",
                    help="TelemetrySession output dir for Serving/* scalars")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable the request-trace ledger (the engine's "
                         "tracer gate is None — the HLO-identity mode)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT SLO in ms (0 = not gated); any finished "
                         "request over the limit fails the run")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="per-output-token SLO in ms (0 = not gated)")
    ap.add_argument("--json", dest="json_out", default=None, metavar="PATH",
                    help="write the machine-readable report here ('-' = "
                         "stdout); its 'deterministic' subtree is byte-"
                         "stable across runs")
    ap.add_argument("--dump-ledger", default=None, metavar="PATH",
                    help="write the raw request-trace ledger bundle here "
                         "(input for `ds-tpu serve-timeline`)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="route the trace across N engine replicas through "
                         "the FleetRouter (serve/router.py) instead of one "
                         "engine; implies --prefix-cache (affinity routing "
                         "peeks it)")
    ap.add_argument("--fleet-policy", default=None,
                    choices=["affinity", "least_loaded", "round_robin"],
                    help="fleet routing policy (default: affinity)")
    ap.add_argument("--affinity-weight", type=float, default=1.0,
                    help="cached-prefix blocks are worth this many queue "
                         "slots in the affinity routing score")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="per-replica waiting-queue admission bound; an "
                         "arrival with every replica at the bound is SHED "
                         "(0 = unbounded)")
    ap.add_argument("--occupancy-cap", type=float, default=1.0,
                    help="per-replica pool-occupancy admission cap in "
                         "(0, 1]; 1.0 = occupancy shedding off")
    ap.add_argument("--compare-affinity", action="store_true",
                    help="run the fleet trace affinity AND round_robin, "
                         "assert token identity, STRICTLY fewer total "
                         "prefill chunks and STRICTLY better fleet p50 TTFT "
                         "(iters) with affinity on")
    ap.add_argument("--kill", action="append", default=None,
                    metavar="IT:REPLICA",
                    help="kill replica REPLICA when the router clock reaches "
                         "IT and fail it over (repeatable)")
    ap.add_argument("--compare-cold-failover", action="store_true",
                    help="with --kill: rerun the kill schedule with COLD "
                         "replacements (no snapshot), assert token identity "
                         "and STRICTLY fewer warm prefill chunks")
    ap.add_argument("--fleet-goodput-floor", type=float, default=0.0,
                    help="fail unless the merged goodput_fleet fraction is "
                         ">= this floor (0 = not gated)")
    ap.add_argument("--transcript", default=None, metavar="PATH",
                    help="write the byte-stable fleet routing transcript "
                         "here (lint.sh golden-compares it)")
    ap.add_argument("--arrival-scale", type=float, default=1.0,
                    help="scale the seeded inter-arrival gaps (0.0 = all "
                         "requests arrive at once, past saturation)")
    ap.add_argument("--arrival", default="default", metavar="PROCESS",
                    help="arrival process: 'default' (seeded 0-2 iteration "
                         "stagger) or 'poisson:RATE' (seeded Poisson process "
                         "at RATE requests/iteration — arrivals bunch, so a "
                         "rate past service capacity crosses any "
                         "--max-queue-depth bound and sheds; with --fleet "
                         "the run re-routes the trace a second time and "
                         "asserts the shed set is deterministic)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="warm-failover snapshot directory (default: a "
                         "fresh temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the engines run: cuda (the "
                         "default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.no_trace and (args.slo_ttft_ms or args.slo_tpot_ms
                          or args.dump_ledger):
        ap.error("--no-trace is incompatible with --slo-*/--dump-ledger "
                 "(they need the ledger)")
    args.arrival_process = None
    if args.arrival != "default":
        kind, sep, rate_s = args.arrival.partition(":")
        try:
            rate = float(rate_s)
        except ValueError:
            rate = 0.0
        if kind != "poisson" or not sep or not rate > 0.0:
            ap.error("--arrival must be 'default' or 'poisson:RATE' with "
                     f"RATE > 0, got {args.arrival!r}")
        args.arrival_process = (kind, rate)
    args.kill = [_parse_kill(ap, s, args.fleet) for s in (args.kill or [])]
    if args.fleet:
        if args.fleet < 1:
            ap.error("--fleet must be >= 1")
        if args.no_trace:
            ap.error("--fleet needs the request-trace ledger (the fleet "
                     "percentile merge reads it)")
        if args.sharding > 1 or args.verify_unsharded:
            ap.error("--fleet replicas are single-chip in the sim")
        if args.compare_prefix_cache or args.compare_speculate or args.replay:
            ap.error("--fleet has its own compare modes "
                     "(--compare-affinity / --compare-cold-failover)")
        args.prefix_cache = True
        if args.fleet_policy is None:
            args.fleet_policy = "affinity"
        return args
    if (args.fleet_policy or args.compare_affinity or args.kill
            or args.compare_cold_failover or args.transcript
            or args.fleet_goodput_floor):
        ap.error("fleet options need --fleet N")
    if args.compare_prefix_cache:
        args.prefix_cache = True
    if args.compare_speculate and not args.speculate:
        args.speculate = 4
    if args.speculate < 0:
        ap.error("--speculate must be >= 1 (or omitted)")
    if args.spec_steps_budget and not args.speculate:
        ap.error("--spec-steps-budget needs --speculate")
    if args.speculate and args.sharding > 1:
        ap.error("--speculate is single-chip only (the spec_verify program "
                 "does not shard)")
    if args.verify_unsharded and args.sharding <= 1:
        ap.error("--verify-unsharded needs --sharding > 1")
    if args.sharding < 1:
        ap.error("--sharding must be >= 1")
    mirror_on = not args.no_mirror and not args.prefix_cache \
        and args.sharding <= 1 and not args.speculate
    if not args.no_mirror and not mirror_on:
        print("serve-sim: note: mirror oracle disabled "
              "(incompatible with --prefix-cache / --sharding / --speculate)")
    args.mirror_on = mirror_on
    return args


def _single_main(args, model_params=None):
    from ..utils.telemetry import TelemetrySession

    mirror_on = args.mirror_on
    trace = _trace(args)
    if model_params is None:
        model_params = _model_params(args)

    session = TelemetrySession(output_path=args.output, job_name="serve_sim",
                               device=args.device)
    engine = _build(args, session, model_params=model_params)
    outputs, logs = engine.run(trace)

    finished = [o for o in outputs if o.status == "finished"]
    refused = [o for o in outputs if o.status == "refused"]
    tokens = sum(len(o.tokens) for o in finished)
    preempts = sum(len(l["preempted"]) for l in logs)
    ttfts = [o.ttft_iters for o in finished if o.ttft_iters is not None]

    failures = []

    # invariant 1: one compile per program, zero recompiles, whole trace
    serve_names = sorted(n for n in session.watchdog.records
                         if n.startswith("serve:"))
    total_recompiles = 0
    for name in serve_names:
        n_c = session.watchdog.compiles(name)
        n_r = session.watchdog.recompiles(name)
        total_recompiles += n_r
        if n_r:
            failures.append(f"{name}: {n_r} recompile(s) after warmup")
    if not serve_names:
        failures.append("no serve:* programs reached the compile watchdog")

    # invariant 2: the oracle lockstep actually ran
    if mirror_on and engine.mirror_checks == 0:
        failures.append("mirror enabled but no bitwise checks executed")

    # invariant 3 (optional): byte-identical replay on a fresh engine
    if args.replay:
        engine2 = _build(args, None, model_params=model_params)
        outputs2, logs2 = engine2.run(_trace(args))
        if json.dumps(logs) != json.dumps(logs2):
            failures.append("replay schedule log diverged")
        toks1 = [(o.req_id, o.status, o.tokens) for o in outputs]
        toks2 = [(o.req_id, o.status, o.tokens) for o in outputs2]
        if toks1 != toks2:
            failures.append("replay outputs diverged")

    # invariant 6 (optional): the model-axis sharded engine is a memory-layout
    # + compute-placement change, not a sampling change — token-identical to
    # the single-chip engine on the same trace (greedy and beam lanes alike)
    ttft_compare = None
    if args.verify_unsharded:
        eng1 = _build(args, None, sharding=1, model_params=model_params)
        outs1, _ = eng1.run(_trace(args))
        sharded = {(o.req_id): (o.status, o.tokens) for o in outputs}
        single = {(o.req_id): (o.status, o.tokens) for o in outs1}
        if sharded != single:
            bad = sorted(r for r in sharded if sharded[r] != single.get(r))
            failures.append(
                f"sharded (model={args.sharding}) outputs diverge from "
                f"single-chip on {len(bad)} request(s): {', '.join(bad[:8])}")

    # invariant 7 (optional): the prefix cache must actually BUY something on
    # this trace — token-identical outputs AND a strictly better p50 TTFT in
    # the deterministic iteration domain than the same engine cache-off
    if args.compare_prefix_cache:
        eng_off = _build(args, None, prefix_cache=False, model_params=model_params)
        outs_off, _ = eng_off.run(_trace(args))
        t_on = {o.req_id: (o.status, o.tokens) for o in outputs}
        t_off = {o.req_id: (o.status, o.tokens) for o in outs_off}
        if t_on != t_off:
            bad = sorted(r for r in t_on if t_on[r] != t_off.get(r))
            failures.append(
                f"prefix cache changed tokens on {len(bad)} request(s): "
                f"{', '.join(bad[:8])}")
        p50_on = _p50(o.ttft_iters for o in outputs
                      if o.status == "finished")
        p50_off = _p50(o.ttft_iters for o in outs_off
                       if o.status == "finished")
        ttft_compare = {"cache_on": p50_on, "cache_off": p50_off}
        if p50_on is None or p50_off is None or not p50_on < p50_off:
            failures.append(
                f"prefix cache did not strictly improve p50 TTFT: "
                f"cache-on {p50_on} vs cache-off {p50_off} iters")

    # invariant 8 (optional): speculation is a schedule optimization, not a
    # sampling change — byte-identical emitted tokens on the same trace with
    # STRICTLY fewer target-model program executions (the headline number)
    steps_compare = None
    if args.compare_speculate:
        eng_plain = _build(args, None, speculate=0, model_params=model_params)
        outs_plain, _ = eng_plain.run(_trace(args))
        t_on = {o.req_id: (o.status, o.tokens) for o in outputs}
        t_off = {o.req_id: (o.status, o.tokens) for o in outs_plain}
        if t_on != t_off:
            bad = sorted(r for r in t_on if t_on[r] != t_off.get(r))
            failures.append(
                f"speculation changed tokens on {len(bad)} request(s): "
                f"{', '.join(bad[:8])}")
        steps_compare = {"speculative": engine.target_steps,
                         "plain": eng_plain.target_steps}
        if not engine.target_steps < eng_plain.target_steps:
            failures.append(
                f"speculation did not strictly reduce target-model steps: "
                f"{engine.target_steps} vs plain {eng_plain.target_steps}")
    spec_summary = engine.spec_summary() if args.speculate else None
    if args.spec_steps_budget:
        ratio = spec_summary["target_steps_per_token"]
        if not ratio < args.spec_steps_budget:
            failures.append(
                f"target_steps_per_token {ratio:.4f} is not under the "
                f"--spec-steps-budget {args.spec_steps_budget}")

    tracer = engine.tracer
    waste = slo = None
    fleet_merge_exact = None
    if tracer is not None:
        # invariant 4: the ledger's useful/replayed split covers every token
        # the schedule log says was scheduled — exactly, no residue
        waste = tracer.waste_summary()
        sched_prefill = sum(l["prefill"][2] for l in logs if l["prefill"])
        # speculative rounds commit tokens outside the per-lane decode list;
        # their log entries carry the committed count in slot 3 (the "spec"
        # key only exists with speculation on, so spec-off logs are unchanged)
        sched_decode = (sum(len(l["decode"]) for l in logs)
                        + sum(e[3] for l in logs for e in l.get("spec", [])))
        if (waste["prefill_tokens"] != sched_prefill
                or waste["decode_tokens"] != sched_decode):
            failures.append(
                f"waste decomposition does not sum to scheduled tokens: "
                f"ledger prefill {waste['prefill_tokens']} vs schedule "
                f"{sched_prefill}, ledger decode {waste['decode_tokens']} "
                f"vs schedule {sched_decode}")
        if (waste["useful_tokens"] + waste["replayed_tokens"]
                != waste["scheduled_tokens"]):
            failures.append("waste decomposition: useful + replayed != "
                            "scheduled")
        # invariant 5: configured SLOs hold for every finished request
        slo = tracer.slo_summary()
        if slo["configured"] and slo["violated"]:
            worst = [r["req_id"] for r in tracer.requests
                     if r.get("slo_violations")]
            failures.append(
                f"SLO violated by {slo['violated']} of "
                f"{slo['met'] + slo['violated']} finished requests "
                f"(attainment {slo['attainment']:.3f}): "
                f"{', '.join(worst[:8])}")
        # invariant 6: fleet rollup exactness — shard the finished-request
        # stream over 4 virtual replicas, rebuild per-replica latency
        # sketches, merge, and require the fleet percentiles to EQUAL the
        # single-stream read-out (the HistogramSketch mergeability contract
        # ROADMAP item 2c's router gates on). Wall-derived values, but the
        # equality itself is exact by construction, so the boolean is stable.
        finished_recs = [r for r in tracer.requests
                         if r.get("status") == "finished"]
        if finished_recs and len(finished_recs) == tracer.finished:
            from ..utils.cluster import fleet_latency_summary
            from .request_trace import HistogramSketch, LATENCY_METRICS
            replicas = [{m: HistogramSketch() for m in LATENCY_METRICS}
                        for _ in range(4)]
            for i, rec in enumerate(finished_recs):
                for m in LATENCY_METRICS:
                    replicas[i % 4][m].add(rec.get(m))
            bundles = [{"latency_sketches":
                        {m: h[m].to_dict() for m in LATENCY_METRICS
                         if h[m].count}} for h in replicas]
            fleet = fleet_latency_summary(bundles, ps=(50, 90, 99))
            single = tracer.latency_summary(ps=(50, 90, 99))
            fleet_merge_exact = fleet == single
            if not fleet_merge_exact:
                failures.append(
                    "fleet histogram-sketch merge diverged from the "
                    "single-stream percentiles")

    if args.dump_ledger:
        tracer.dump(args.dump_ledger)

    cache_stats = (engine.prefix_cache.stats()
                   if engine.prefix_cache is not None else None)

    if args.json_out:
        report = _report(args, trace, outputs, logs, tracer, waste, slo,
                         failures, cache_stats=cache_stats,
                         ttft_compare=ttft_compare,
                         fleet_merge_exact=fleet_merge_exact,
                         spec_summary=spec_summary,
                         steps_compare=steps_compare)
        blob = json.dumps(report, sort_keys=True, separators=(",", ":"))
        if args.json_out == "-":
            print(blob)
        else:
            with open(args.json_out, "w") as f:
                f.write(blob)

    session.close()

    print(f"serve-sim: {len(finished)} finished / {len(refused)} refused "
          f"of {len(trace)} requests over {len(logs)} iterations")
    print(f"  tokens generated : {tokens}")
    print(f"  preemptions      : {preempts}")
    if ttfts:
        print(f"  TTFT iters       : mean {sum(ttfts) / len(ttfts):.1f} "
              f"max {max(ttfts)}")
    print(f"  programs watched : {len(serve_names)} "
          f"(recompiles after warmup: {total_recompiles})")
    if mirror_on:
        print(f"  oracle lockstep  : {engine.mirror_checks} bitwise checks, "
              f"all identical")
    if args.sharding > 1:
        shard_note = (" (token-identical to single-chip)"
                      if args.verify_unsharded and not failures else "")
        print(f"  sharding         : model={args.sharding} ways by attention "
              f"head{shard_note}")
    if cache_stats is not None:
        print(f"  prefix cache     : hit-rate {cache_stats['hit_rate']:.1%} "
              f"({cache_stats['hits']} hits), "
              f"{cache_stats['hit_tokens']} prompt tokens remapped "
              f"({cache_stats['cached_token_fraction']:.1%} of looked-up), "
              f"{cache_stats['evictions']} evictions")
    if ttft_compare is not None:
        print(f"  TTFT p50 iters   : cache-on {ttft_compare['cache_on']} vs "
              f"cache-off {ttft_compare['cache_off']}")
    if spec_summary is not None:
        print(f"  speculation      : K={args.speculate}, acceptance "
              f"{spec_summary['spec_acceptance_rate']:.1%} "
              f"({spec_summary['accepted_tokens']} of "
              f"{spec_summary['drafted_tokens']} drafts), "
              f"{spec_summary['target_steps_per_token']:.3f} "
              f"target steps/token")
    if steps_compare is not None:
        print(f"  target steps     : speculative "
              f"{steps_compare['speculative']} vs plain "
              f"{steps_compare['plain']} (token-identical)")
    if args.replay:
        print("  replay           : byte-identical schedule + outputs")
    if waste is not None:
        print(f"  token waste      : {waste['replayed_tokens']} of "
              f"{waste['scheduled_tokens']} scheduled tokens replayed "
              f"({waste['waste_fraction']:.1%})")
        pcts = tracer.percentiles()
        for m in ("ttft_ms", "tpot_ms"):
            if m in pcts:
                p = pcts[m]
                print(f"  {m:<16} : p50 {p['p50']:.2f} p90 {p['p90']:.2f} "
                      f"p99 {p['p99']:.2f}")
    if slo and slo["configured"]:
        print(f"  SLO              : {slo['met']} met / {slo['violated']} "
              f"violated (attainment {slo['attainment']:.3f})")
    if args.dump_ledger:
        print(f"  ledger           : {args.dump_ledger}")
    print(f"  scalars          : {session.monitor.log_dir}/scalars.jsonl")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("serve-sim: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
