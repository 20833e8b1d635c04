"""PyTorch port: a copy of ``deepspeed_tpu/utils/pipeline_trace.py`` (lines
1-661: ``PipelineTracer``, ``lint_schedule``, ``simulate_schedule``,
``simulated_bundle``, ``to_trace_events``, ``timeline_main``), host-only; the
schedules replayed are the port's copy of ``runtime/pipe/schedule.py``. The
tracer's engine wiring waits for the pipeline engine (ROADMAP.md item 16).

Pipeline schedule observatory: per-instruction span timeline, bubble/goodput
accounting, an analytic schedule simulator, and a Perfetto trace exporter.

The PipelineEngine's instruction executor runs merged per-stage streams on a
single controller, so the only honest measurement surface is the host-side
interval around each executed ``PipeInstruction`` — boundaries the executor
already crosses. ``PipelineTracer`` records exactly those spans (stage id,
schedule step index, micro-batch id, buffer id, wall interval in µs) and keeps
them in a bounded per-step ring. No device fetch, no barrier, no added HLO:
with ``telemetry.pipeline_trace`` disabled the engine holds ``None`` instead of
a tracer and the executor path is byte-identical (see
tests/unit/test_pipeline_trace.py::test_pipeline_hlo_identical_when_disabled
and the AST no-sync guard pinning this module to zero blocking primitives).

Three consumers sit on the span stream:

* ``goodput_decomposition`` — per optimizer step, seconds spent in
  fwd / bwd / p2p / load / reduce / opt, plus the bubble the schedule would
  have on a real per-stage deployment, reconstructed by replaying the spans
  on a lockstep timeline (step wall = slowest stage at that schedule step).
* ``simulate_schedule`` / ``lint_schedule`` — offline symbolic replay of
  ``TrainSchedule``/``InferenceSchedule`` streams: expected bubble fraction
  (``(p-1)/(m+p-1)`` at uniform cost), per-stage idle slots, peak buffer
  occupancy, and a static validator for send/recv rendezvous and buffer
  lifetime invariants (tests/unit/test_schedule_lint.py).
* ``to_trace_events`` / ``timeline_main`` — Perfetto/Chrome ``trace_event``
  JSON: one track per stage, microbatch-colored slices, counter tracks for
  buffer occupancy and bubble fraction. ``bin/ds-tpu timeline`` dispatches
  here, accepting either a live span bundle or a flight-recorder dump that
  embeds one (docs/pipeline-trace.md).
"""

import argparse
import atexit
import json
import os
import time
from collections import deque

from .logging import logger
from .trace_event import (complete_slice, counter_event, load_bundle,
                          process_name_event, serialize_trace,  # noqa: F401
                          thread_meta_events, trace_envelope)

PIPELINE_TRACE_VERSION = 1
PIPELINE_TRACE_KIND = "pipeline_trace"

# instruction name -> goodput category
CATEGORY = {
    "LoadMicroBatch": "load",
    "ForwardPass": "fwd",
    "BackwardPass": "bwd",
    "SendActivation": "p2p",
    "RecvActivation": "p2p",
    "SendGrad": "p2p",
    "RecvGrad": "p2p",
    "ReduceGrads": "reduce",
    "ReduceTiedGrads": "reduce",
    "OptimizerStep": "opt",
}
_COMPUTE = ("ForwardPass", "BackwardPass")
# mirror of engine._SEND_CMDS: within one merged step all Sends/Loads run
# before any Recv (the rendezvous invariant the symbolic replay re-checks)
_SEND_NAMES = ("SendActivation", "SendGrad", "LoadMicroBatch")

# span tuple layout: [stage, sched_step, name, micro_batch, buffer_id, rel_us, dur_us]
SPAN_STAGE, SPAN_STEP, SPAN_NAME, SPAN_MB, SPAN_BUF, SPAN_T0, SPAN_DUR = range(7)


class ScheduleLintError(Exception):
    """A TrainSchedule/InferenceSchedule instruction stream violated a
    rendezvous or buffer-lifetime invariant."""


# --------------------------------------------------------------- span recorder


class PipelineTracer:
    """Host-side span recorder for the instruction-stream pipeline executor.

    One ``begin_step``/``record``*/``end_step`` cycle per ``train_batch`` (or
    ``eval_batch``). Only stdlib calls on the hot path: two ``perf_counter``
    reads and a list append per executed instruction.
    """

    def __init__(self, stages, capacity=64, dump_dir=None, host_id=0):
        self.stages = int(stages)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir or None
        self.host_id = int(host_id)
        self.steps = deque(maxlen=self.capacity)
        # the per-step SCHEDULE decomposition (bubble accounting) — distinct
        # from the run-level Run/Goodput ledger (utils/goodput.py), which is
        # why this is the schedule_-prefixed name, never bare "goodput"
        self.last_schedule_goodput = None
        self._epoch = time.perf_counter()
        self._cur = None
        self._straggler_warned = 0
        if self.dump_dir:
            atexit.register(self._atexit_dump)

    # -- recording ---------------------------------------------------------
    def begin_step(self, step, schedule_name, micro_batches, kind="train"):
        now = time.perf_counter()
        self._cur = {
            "step": int(step),
            "kind": kind,
            "schedule": schedule_name,
            "micro_batches": int(micro_batches),
            "t0_us": int((now - self._epoch) * 1e6),
            "_t0": now,
            "spans": [],
        }

    def record(self, stage, sched_step, name, micro_batch, buffer_id, t0, t1):
        cur = self._cur
        if cur is None:
            return
        cur["spans"].append([
            int(stage), int(sched_step), name,
            None if micro_batch is None else int(micro_batch),
            None if buffer_id is None else int(buffer_id),
            int((t0 - cur["_t0"]) * 1e6),
            max(int((t1 - t0) * 1e6), 0),
        ])

    def end_step(self):
        cur, self._cur = self._cur, None
        if cur is None:
            return None
        t0 = cur.pop("_t0")
        cur["wall_seconds"] = time.perf_counter() - t0
        goodput = goodput_decomposition(cur["spans"], self.stages)
        cur["schedule_goodput"] = goodput
        self.steps.append(cur)
        self.last_schedule_goodput = goodput
        straggler = goodput.get("straggler")
        if straggler is not None and self._straggler_warned < 3:
            self._straggler_warned += 1
            logger.warning(
                "[deepspeed_tpu_torch] pipeline_trace: stage %d is a straggler — "
                "%.1fx the median stage busy time (step %d)",
                straggler["stage"], straggler["ratio"], cur["step"])
        return goodput

    # -- divergence --------------------------------------------------------
    def divergence(self, threshold=3.0):
        """Measured-vs-ideal check on the most recent step: the ideal schedule
        gives every stage the same busy time, so a stage whose measured busy
        seconds exceed ``threshold`` x the median is named as the straggler."""
        if not self.steps:
            return None
        last = self.steps[-1]
        decomp = last.get("schedule_goodput") or {}
        return _find_straggler(decomp["per_stage_busy_seconds"], threshold)

    # -- bundle / dump -----------------------------------------------------
    def bundle(self, last_n=None):
        steps = list(self.steps)
        if last_n is not None:
            steps = steps[-int(last_n):]
        return {
            "version": PIPELINE_TRACE_VERSION,
            "kind": "pipeline_trace",
            "host": self.host_id,
            "stages": self.stages,
            "steps": steps,
        }

    def dump(self, path=None):
        if path is None:
            if not self.dump_dir:
                return None
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"pipeline_trace_host{self.host_id}.json")
        with open(path, "w") as f:
            json.dump(self.bundle(), f)
        return path

    def _atexit_dump(self):
        if self.dump_dir and self.steps:
            try:
                self.dump()
            except OSError:
                pass  # trace dump failure must never mask the real exit


# ------------------------------------------------------------ goodput accounting


def _find_straggler(per_stage_busy, threshold):
    if len(per_stage_busy) < 2:
        return None
    ordered = sorted(per_stage_busy)
    median = ordered[len(ordered) // 2]
    worst = max(range(len(per_stage_busy)), key=lambda s: per_stage_busy[s])
    if median > 0 and per_stage_busy[worst] > threshold * median:
        return {"stage": worst, "ratio": per_stage_busy[worst] / median}
    return None


def goodput_decomposition(spans, stages, straggler_threshold=3.0):
    """Decompose one step's span stream into category seconds plus the bubble
    the schedule would exhibit on a real per-stage deployment.

    The single-controller executor serializes all stages on one host, so wall
    clock alone cannot show a bubble. Instead the spans are replayed on a
    lockstep timeline: schedule step ``k`` costs ``max`` over stages of their
    compute (fwd/bwd) span durations at ``k`` — the slowest stage gates every
    peer exactly as in a synchronous pipeline. ``bubble_seconds`` is then the
    idle stage-time of that reconstructed timeline and ``bubble_fraction``
    its share; at uniform compute cost this converges to the PipeDream-flush
    closed form ``(p-1)/(m+p-1)``.
    """
    cat_seconds = {"fwd": 0.0, "bwd": 0.0, "p2p": 0.0, "load": 0.0,
                   "reduce": 0.0, "opt": 0.0}
    busy = {}          # (stage, sched_step) -> compute seconds
    per_stage = [0.0] * stages
    for sp in spans:
        dur = sp[SPAN_DUR] / 1e6
        cat = CATEGORY.get(sp[SPAN_NAME])
        if cat is not None:
            cat_seconds[cat] += dur
        if sp[SPAN_NAME] in _COMPUTE:
            key = (sp[SPAN_STAGE], sp[SPAN_STEP])
            busy[key] = busy.get(key, 0.0) + dur
            per_stage[sp[SPAN_STAGE]] += dur
    wall_by_step = {}
    for (_, k), dur in busy.items():
        wall_by_step[k] = max(wall_by_step.get(k, 0.0), dur)
    pipeline_seconds = sum(wall_by_step.values())
    compute_seconds = sum(per_stage)
    slot_time = stages * pipeline_seconds
    bubble_seconds = max(slot_time - compute_seconds, 0.0)
    out = dict(cat_seconds)
    out.update({
        "compute_seconds": compute_seconds,
        "pipeline_seconds": pipeline_seconds,
        "bubble_seconds": bubble_seconds,
        "bubble_fraction": (bubble_seconds / slot_time) if slot_time > 0 else 0.0,
        "per_stage_busy_seconds": per_stage,
        "spans": len(spans),
        "straggler": _find_straggler(per_stage, straggler_threshold),
    })
    # keep the *_seconds suffix for the monitor scalar names
    for cat in ("fwd", "bwd", "p2p", "load", "reduce", "opt"):
        out[f"{cat}_seconds"] = out.pop(cat)
    return out


def measured_costs(step_record):
    """Mean fwd/bwd span duration (seconds) of a recorded step — feed these to
    ``simulate_schedule`` to get the expected bubble at the measured costs."""
    sums = {"ForwardPass": [0.0, 0], "BackwardPass": [0.0, 0]}
    for sp in step_record["spans"]:
        if sp[SPAN_NAME] in sums:
            acc = sums[sp[SPAN_NAME]]
            acc[0] += sp[SPAN_DUR] / 1e6
            acc[1] += 1
    t_fwd = sums["ForwardPass"][0] / max(sums["ForwardPass"][1], 1)
    t_bwd = sums["BackwardPass"][0] / max(sums["BackwardPass"][1], 1)
    return t_fwd, t_bwd


# ----------------------------------------------------- symbolic schedule replay


def _instruction_streams(micro_batches, stages, schedule="train"):
    # lazy: keeps this module importable without pulling the runtime package
    from ..runtime.pipe import schedule as sched_mod
    cls = {"train": sched_mod.TrainSchedule,
           "inference": sched_mod.InferenceSchedule}[schedule]
    scheds = [cls(micro_batches=micro_batches, stages=stages, stage_id=s)
              for s in range(stages)]
    return ([list(iter(sc)) for sc in scheds],
            [sc.num_pipe_buffers() for sc in scheds])


def _replay(streams, rings, micro_batches, schedule="train"):
    """Symbolically execute merged per-stage streams, mirroring the engine's
    buffer dicts and send-before-recv merged-step ordering. Raises
    ``ScheduleLintError`` on any rendezvous or buffer-lifetime violation;
    returns the executed event list and per-stage occupancy stats."""
    S = len(streams)
    m = micro_batches
    train = schedule == "train"
    act_in = [dict() for _ in range(S)]    # buffer -> mb, input awaiting fwd
    saved = [dict() for _ in range(S)]     # buffer -> mb, activation awaiting bwd
    act_out = [dict() for _ in range(S)]   # buffer -> mb, output awaiting send
    grad_in = [dict() for _ in range(S)]   # buffer -> mb, grad awaiting bwd
    dx_buf = [dict() for _ in range(S)]    # buffer -> mb, input-grad awaiting send
    chan_act = {}                          # (src stage, mb) -> send step
    chan_grad = {}
    fwd_count = [0] * S
    bwd_count = [0] * S
    recv_act = [0] * S
    recv_grad = [0] * S
    load_count = [0] * S
    loaded = set()                         # micro-batches stage 0 has loaded
    peak_live = [0] * S
    events = []

    def fail(s, k, cmd, why):
        raise ScheduleLintError(
            f"stage {s} step {k}: {cmd!r}: {why} "
            f"(micro_batches={m}, stages={S}, schedule={schedule})")

    def note_live(s):
        # distinct buffer slots holding an activation: saved and act_out share
        # the slot their ForwardPass used, exactly as in the engine's ring
        live = set(act_in[s]) | set(saved[s]) | set(act_out[s])
        peak_live[s] = max(peak_live[s], len(live))

    def exec_cmd(s, k, cmd):
        name, buf = cmd.name, getattr(cmd, "buffer_id", None)
        mb_id = None
        if name == "LoadMicroBatch":
            mb_id = load_count[s]
            load_count[s] += 1
            if s == 0:
                if buf in act_in[0]:
                    fail(s, k, cmd, f"load clobbers unconsumed input buffer {buf}")
                act_in[0][buf] = mb_id
                loaded.add(mb_id)
            elif s != S - 1:
                fail(s, k, cmd, "LoadMicroBatch on an interior stage")
            elif mb_id >= m:
                fail(s, k, cmd, "more label loads than micro-batches")
        elif name == "ForwardPass":
            if buf not in act_in[s]:
                fail(s, k, cmd, f"buffer {buf} used before load/recv")
            mb_id = act_in[s].pop(buf)
            if mb_id != fwd_count[s]:
                fail(s, k, cmd, f"out-of-order forward: mb {mb_id} before {fwd_count[s]}")
            fwd_count[s] += 1
            if train:
                if buf in saved[s]:
                    fail(s, k, cmd, f"forward clobbers saved activation in buffer {buf}")
                saved[s][buf] = mb_id
            if s < S - 1:
                if buf in act_out[s]:
                    fail(s, k, cmd, f"forward clobbers unsent output in buffer {buf}")
                act_out[s][buf] = mb_id
        elif name == "SendActivation":
            if s >= S - 1:
                fail(s, k, cmd, "SendActivation on the last stage")
            if buf not in act_out[s]:
                fail(s, k, cmd, f"send of never-produced output buffer {buf}")
            mb_id = act_out[s].pop(buf)
            if (s, mb_id) in chan_act:
                fail(s, k, cmd, f"duplicate in-flight activation for mb {mb_id}")
            chan_act[(s, mb_id)] = k
            in_flight = sum(1 for (src, _) in chan_act if src == s)
            if in_flight > rings[s + 1]:
                fail(s, k, cmd, f"{in_flight} activations in flight > receiver "
                                f"num_pipe_buffers()={rings[s + 1]}")
        elif name == "RecvActivation":
            mb_id = recv_act[s]
            recv_act[s] += 1
            if (s - 1, mb_id) not in chan_act:
                fail(s, k, cmd, f"no matching SendActivation on stage {s - 1} "
                                f"for mb {mb_id}")
            sent_at = chan_act.pop((s - 1, mb_id))
            if sent_at != k:
                fail(s, k, cmd, f"rendezvous step mismatch: sent at step {sent_at}")
            if buf in act_in[s]:
                fail(s, k, cmd, f"recv clobbers unconsumed input buffer {buf}")
            act_in[s][buf] = mb_id
        elif name == "BackwardPass":
            if buf not in saved[s]:
                fail(s, k, cmd, f"backward without saved activation in buffer {buf}")
            mb_id = saved[s].pop(buf)
            if mb_id != bwd_count[s]:
                fail(s, k, cmd, f"out-of-order backward: mb {mb_id} before {bwd_count[s]}")
            bwd_count[s] += 1
            if s == S - 1:
                if mb_id not in loaded:
                    fail(s, k, cmd, f"labels for mb {mb_id} were never loaded")
            else:
                if buf not in grad_in[s]:
                    fail(s, k, cmd, f"backward without received grad in buffer {buf}")
                grad_in[s].pop(buf)
            if s > 0:
                if buf in dx_buf[s]:
                    fail(s, k, cmd, f"backward clobbers unsent grad in buffer {buf}")
                dx_buf[s][buf] = mb_id
        elif name == "SendGrad":
            if s == 0:
                fail(s, k, cmd, "SendGrad on the first stage")
            if buf not in dx_buf[s]:
                fail(s, k, cmd, f"send of never-produced grad buffer {buf}")
            mb_id = dx_buf[s].pop(buf)
            if (s, mb_id) in chan_grad:
                fail(s, k, cmd, f"duplicate in-flight grad for mb {mb_id}")
            chan_grad[(s, mb_id)] = k
            in_flight = sum(1 for (src, _) in chan_grad if src == s)
            if in_flight > rings[s - 1]:
                fail(s, k, cmd, f"{in_flight} grads in flight > receiver "
                                f"num_pipe_buffers()={rings[s - 1]}")
        elif name == "RecvGrad":
            mb_id = recv_grad[s]
            recv_grad[s] += 1
            if (s + 1, mb_id) not in chan_grad:
                fail(s, k, cmd, f"no matching SendGrad on stage {s + 1} for mb {mb_id}")
            sent_at = chan_grad.pop((s + 1, mb_id))
            if sent_at != k:
                fail(s, k, cmd, f"rendezvous step mismatch: sent at step {sent_at}")
            if buf in grad_in[s]:
                fail(s, k, cmd, f"recv clobbers unconsumed grad buffer {buf}")
            grad_in[s][buf] = mb_id
        elif name in ("ReduceGrads", "ReduceTiedGrads", "OptimizerStep"):
            pass
        else:
            fail(s, k, cmd, "unknown instruction")
        note_live(s)
        events.append((s, k, name, mb_id, buf))

    total_steps = len(streams[0])
    for k in range(total_steps):
        for s in range(S):
            for cmd in streams[s][k]:
                if cmd.name in _SEND_NAMES:
                    exec_cmd(s, k, cmd)
        for s in range(S):
            for cmd in streams[s][k]:
                if cmd.name not in _SEND_NAMES:
                    exec_cmd(s, k, cmd)

    if chan_act or chan_grad:
        raise ScheduleLintError(
            f"payloads left in flight at end of schedule: act={chan_act} "
            f"grad={chan_grad} (micro_batches={m}, stages={S})")
    for s in range(S):
        if fwd_count[s] != m or (train and bwd_count[s] != m):
            raise ScheduleLintError(
                f"stage {s} retired fwd={fwd_count[s]} bwd={bwd_count[s]} "
                f"of {m} micro-batches")
        leftover = (len(act_in[s]) + len(saved[s]) + len(act_out[s])
                    + len(grad_in[s]) + len(dx_buf[s]))
        if leftover:
            raise ScheduleLintError(f"stage {s} ends with {leftover} live buffers")
    return {"events": events, "peak_live": peak_live, "total_steps": total_steps}


def lint_schedule(micro_batches, stages, schedule="train"):
    """Static validator for one (micro_batches, stages) schedule instance across
    ALL stage ids: every send has a same-step recv on the adjacent stage, every
    buffer is loaded before use, and live buffers never exceed the stage's
    ``num_pipe_buffers()``. Raises ``ScheduleLintError`` on violation."""
    streams, rings = _instruction_streams(micro_batches, stages, schedule)
    stats = _replay(streams, rings, micro_batches, schedule)
    for s, (peak, ring) in enumerate(zip(stats["peak_live"], rings)):
        if peak > ring:
            raise ScheduleLintError(
                f"stage {s} peak live buffers {peak} > num_pipe_buffers()={ring}")
    return stats


# ------------------------------------------------------------ analytic simulator


def simulate_schedule(micro_batches, stages, schedule="train", t_fwd=1.0, t_bwd=None):
    """Replay a schedule offline on the lockstep timeline: expected bubble
    fraction, per-stage busy/idle slots, and peak buffer occupancy for any
    ``(micro_batches, stages)``. At uniform cost (``t_bwd == t_fwd``) the
    train-schedule bubble equals the closed form ``(p-1)/(m+p-1)``."""
    if t_bwd is None:
        t_bwd = t_fwd
    streams, rings = _instruction_streams(micro_batches, stages, schedule)
    stats = _replay(streams, rings, micro_batches, schedule)
    cost = {"ForwardPass": t_fwd, "BackwardPass": t_bwd}
    busy = {}
    per_stage = [0.0] * stages
    busy_slots = []
    for s, k, name, _, _ in stats["events"]:
        c = cost.get(name)
        if c is None:
            continue
        busy[(s, k)] = busy.get((s, k), 0.0) + c
        per_stage[s] += c
        busy_slots.append([s, k])
    wall_by_step = {}
    for (_, k), c in busy.items():
        wall_by_step[k] = max(wall_by_step.get(k, 0.0), c)
    pipeline_seconds = sum(wall_by_step.values())
    slot_time = stages * pipeline_seconds
    compute = sum(per_stage)
    active_steps = sorted(wall_by_step)
    idle_slots = [sum(1 for k in active_steps if (s, k) not in busy)
                  for s in range(stages)]
    return {
        "schedule": schedule,
        "micro_batches": micro_batches,
        "stages": stages,
        "total_steps": stats["total_steps"],
        "bubble_fraction": ((slot_time - compute) / slot_time) if slot_time else 0.0,
        "pipeline_seconds": pipeline_seconds,
        "per_stage_busy_seconds": per_stage,
        "per_stage_idle_slots": idle_slots,
        "busy_slots": sorted(map(tuple, busy_slots)),
        "peak_buffer_occupancy": stats["peak_live"],
        "num_pipe_buffers": rings,
    }


def simulated_bundle(micro_batches, stages, schedule="train",
                     t_fwd_us=100, t_bwd_us=200, step=0):
    """Deterministic synthetic span bundle from the lockstep replay: compute
    spans get the given integer costs, everything else is a zero-length marker.
    Used by the exporter golden test and as a docs-friendly demo input."""
    streams, rings = _instruction_streams(micro_batches, stages, schedule)
    stats = _replay(streams, rings, micro_batches, schedule)
    cost = {"ForwardPass": int(t_fwd_us), "BackwardPass": int(t_bwd_us)}
    step_wall = {}
    for s, k, name, _, _ in stats["events"]:
        c = cost.get(name, 0)
        step_wall[k] = max(step_wall.get(k, 0), c)
    start = {}
    t = 0
    for k in range(stats["total_steps"]):
        start[k] = t
        t += step_wall.get(k, 0)
    spans = [[s, k, name, mb, buf, start[k], cost.get(name, 0)]
             for s, k, name, mb, buf in stats["events"]]
    rec = {
        "step": int(step),
        "kind": "train" if schedule == "train" else "eval",
        "schedule": "TrainSchedule" if schedule == "train" else "InferenceSchedule",
        "micro_batches": int(micro_batches),
        "t0_us": 0,
        "spans": spans,
        "wall_seconds": t / 1e6,
    }
    rec["schedule_goodput"] = goodput_decomposition(spans, stages)
    return {
        "version": PIPELINE_TRACE_VERSION,
        "kind": "pipeline_trace",
        "host": 0,
        "stages": int(stages),
        "steps": [rec],
    }


# ------------------------------------------------------------- Perfetto export

# Chrome trace_event reserved color names, cycled per micro-batch so adjacent
# microbatches get visually distinct slices in Perfetto
_MB_COLORS = ("thread_state_running", "thread_state_runnable", "rail_response",
              "rail_animation", "rail_idle", "rail_load", "cq_build_passed",
              "cq_build_failed")


def to_trace_events(bundle):
    """Convert a span bundle into a Chrome/Perfetto ``trace_event`` JSON object:
    one thread (track) per stage, complete ("X") events per instruction span,
    counter ("C") tracks for per-stage buffer occupancy and per-step bubble
    fraction. Deterministic for a given bundle."""
    stages = int(bundle["stages"])
    events = [process_name_event(0, f"pipeline host {bundle.get('host', 0)}")]
    for s in range(stages):
        events += thread_meta_events(0, s, f"stage {s}", sort_index=s)
    for rec in bundle.get("steps", []):
        base = int(rec.get("t0_us", 0))
        train = rec.get("schedule") != "InferenceSchedule"
        occupancy = [0] * stages
        # legacy bundles predate the schedule_goodput rename
        goodput = rec.get("schedule_goodput") or rec.get("goodput") or {}
        if goodput.get("bubble_fraction") is not None:
            events.append(counter_event(
                0, 0, base, "bubble_fraction",
                {"bubble": round(goodput["bubble_fraction"], 6)}))
        for sp in rec["spans"]:
            s, k, name, mb, buf, rel, dur = sp
            cname = (_MB_COLORS[mb % len(_MB_COLORS)]
                     if mb is not None and name in _COMPUTE else None)
            events.append(complete_slice(
                0, s, base + rel, dur,
                name if mb is None else f"{name} mb{mb}",
                CATEGORY.get(name, "other"),
                {"sched_step": k, "micro_batch": mb, "buffer": buf,
                 "step": rec.get("step")}, cname=cname))
            delta = 0
            if name == "RecvActivation" or (name == "LoadMicroBatch" and s == 0):
                delta = 1
            elif train and name == "BackwardPass":
                delta = -1
            elif not train and name == "ForwardPass":
                delta = -1
            if delta:
                occupancy[s] += delta
                events.append(counter_event(
                    0, s, base + rel + dur, f"stage {s} buffers",
                    {"buffers": occupancy[s]}))
    return trace_envelope(events, "ds-tpu timeline", stages=stages,
                          trace_version=bundle.get("version"))


# serialize_trace lives in utils/trace_event.py (shared with the serve and
# anatomy exporters) and stays re-exported here for its historical importers.


# --------------------------------------------------------------------- the CLI


def _load_bundle(path):
    # flight-recorder dumps (numerics.FlightRecorder) embed the span bundle
    return load_bundle(path, PIPELINE_TRACE_KIND)


def timeline_main(argv=None):
    """``ds-tpu timeline`` entry point: span bundle (or flight-recorder dump
    embedding one) -> Perfetto/Chrome trace_event JSON."""
    parser = argparse.ArgumentParser(
        prog="ds-tpu timeline",
        description="Convert a pipeline_trace span bundle (or a flight-recorder "
                    "dump that embeds one) into Perfetto/Chrome trace_event JSON "
                    "viewable at ui.perfetto.dev or chrome://tracing.")
    parser.add_argument("bundle", help="path to the span bundle / dump JSON "
                                       "(with --cluster: a shared dump dir)")
    parser.add_argument("-o", "--output", default=None,
                        help="output path (default: <bundle>.trace.json)")
    parser.add_argument("--cluster", action="store_true",
                        help="treat BUNDLE as a shared dump directory and "
                             "merge one run's per-host bundles onto per-host "
                             "track groups, aligned by heartbeat-estimated "
                             "clock offsets")
    parser.add_argument("--run", default=None,
                        help="with --cluster: merge this run instead of the "
                             "newest one")
    args = parser.parse_args(argv)

    if args.cluster:
        from .cluster import cluster_timeline
        out = args.output
        if out is None:
            out = os.path.join(args.bundle, "cluster.trace.json")
        return cluster_timeline(args.bundle, out, run=args.run)

    try:
        bundle = _load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"ds-tpu timeline: cannot read {args.bundle}: {e}")
        return 2
    if bundle is None:
        print(f"ds-tpu timeline: {args.bundle} holds no pipeline_trace bundle "
              "(enable telemetry.pipeline_trace and re-dump)")
        return 2

    trace = to_trace_events(bundle)
    out = args.output
    if out is None:
        stem = args.bundle[:-5] if args.bundle.endswith(".json") else args.bundle
        out = stem + ".trace.json"
    with open(out, "w") as f:
        f.write(serialize_trace(trace))
    n_spans = sum(len(rec["spans"]) for rec in bundle.get("steps", []))
    print(f"wrote {len(trace['traceEvents'])} trace events "
          f"({n_spans} spans, {len(bundle.get('steps', []))} steps, "
          f"{bundle['stages']} stages) -> {out}")
    return 0
