"""``ds-tpu-torch crash-sim`` — fault-injection harness for the resilience layer.

Counterpart of ``deepspeed_tpu/resilience/crash_sim.py`` over the port's
engine, ``resilience/{async_ckpt,auto_resume,serve_restart}.py`` and
``utils/goodput.py``, on ``--device`` (the card unless ``cpu``). Kills and
restarts trainer and serving runs at adversarial points and asserts
recovery, in-process and deterministically: the transcript is a function of
the seed alone (ints, bools, strings and the injected constants; no
wall-clock), so it is byte-compared with the JAX function's and between
devices. The models' weights come from torch seeds; no outcome depends on
their values (the serving trace has no EOS, so its schedule is fixed).

- ``trainer_mid_save``      — die during a checkpoint COMMIT: the tmp dir is
  fully written but never renamed. Restart must ignore the ``.tmp`` carcass,
  resume from the previous committed tag, and retrain BIT-EQUAL to an
  uninterrupted oracle.
- ``trainer_between_shards`` — die between shard writes (simulated as a
  committed tag with one optimizer shard torn afterwards): the manifest
  checksum pass must refuse the tag, and auto-resume falls back to the older
  committed one. Bit-equal retrain again.
- ``trainer_auto_resume``   — a flight-recorder dump names the first bad
  step; auto-resume must select the newest checkpoint strictly BEFORE it,
  not the newest overall.
- ``serve_mid_decode``      — kill a serving replica mid-decode-step, warm
  restart from the serving snapshot: strictly fewer prefill chunks than a
  cold restart, token-identical outputs vs the uninterrupted oracle, and the
  request-trace waste identity (useful + replayed == scheduled) intact.
- ``serve_post_preempt``    — same assertions with the kill landing right
  after a pool-pressure preemption (the snapshot then carries parked prefix
  pages AND requeued carry state at once).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
from torch import nn

HIDDEN = 16
BATCH = 8
TRAIN_STEPS = 8
SAVE_STEP = 3
KILL_STEP = 5


class _MLP(nn.Module):
    """Two-layer MLP returning MSE loss (the unit-test fixture model), in the
    wider of the input's and the parameters' dtypes (JAX's promotion)."""

    def __init__(self, seed, hidden=HIDDEN):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        h = hidden
        self.w1 = nn.Parameter(torch.randn(h, h, generator=g) * 0.1)
        self.b1 = nn.Parameter(torch.zeros(h))
        self.w2 = nn.Parameter(torch.randn(h, h, generator=g) * 0.1)
        self.b2 = nn.Parameter(torch.zeros(h))

    def forward(self, x, y):
        dt = torch.promote_types(x.dtype, self.w1.dtype)
        h = torch.tanh(x.to(dt) @ self.w1.to(dt) + self.b1.to(dt))
        out = h @ self.w2.to(dt) + self.b2.to(dt)
        return torch.mean(torch.square(out - y.to(dt)))


def _train_batches(n, seed):
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(1234).normal(
        size=(HIDDEN, HIDDEN)).astype(np.float32) * 0.3
    out = []
    for _ in range(n):
        x = rng.normal(size=(BATCH, HIDDEN)).astype(np.float32)
        out.append((x, np.tanh(x @ w_true)))
    return out


def _make_trainer(init_seed, device):
    import deepspeed_tpu_torch
    cfg = {"train_batch_size": BATCH, "steps_per_print": 1 << 30,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_MLP(init_seed), config_params=cfg, device=device)
    return engine


def _train(engine, batches):
    for x, y in batches:
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()


def _masters_bit_equal(a, b):
    return list(a) == list(b) and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _trainer_scenario(kill_point, seed, workdir, device):
    """One trainer kill/recover cycle. Returns the transcript record."""
    from ..checkpoint.checkpointing import (_write_payloads,
                                            snapshot_checkpoint)
    from .async_ckpt import AsyncCheckpointer
    from .auto_resume import auto_resume

    save_dir = os.path.join(workdir, f"trainer_{kill_point}")
    os.makedirs(save_dir, exist_ok=True)
    batches = _train_batches(TRAIN_STEPS, seed)

    oracle = _make_trainer(seed, device)
    _train(oracle, batches)

    victim = _make_trainer(seed, device)
    ck = AsyncCheckpointer(victim, save_dir)
    _train(victim, batches[:SAVE_STEP])
    ck.save(tag=f"step{SAVE_STEP}")
    _train(victim, batches[SAVE_STEP:KILL_STEP])

    if kill_point == "mid_save":
        # the step-SAVE_STEP commit has landed (its writer thread joined: a
        # step here can be faster than the commit); then the next commit
        # dies after every payload is written but BEFORE the atomic rename:
        # a fully-populated .tmp carcass restore must ignore
        ck.wait()
        snap = snapshot_checkpoint(victim, tag=f"step{KILL_STEP}")
        tmp = os.path.join(save_dir, f"step{KILL_STEP}.tmp")
        os.makedirs(tmp, exist_ok=True)
        _write_payloads(tmp, snap["files"], {"write": 0.0, "fsync_rename": 0.0})
    else:  # between_shards: a committed tag torn afterwards (one shard
        # truncated) — the manifest checksum pass must refuse the whole tag
        ck.save(tag=f"step{KILL_STEP}")
        ck.wait()
        shard = os.path.join(save_dir, f"step{KILL_STEP}",
                             "zero_pp_rank_0_mp_rank_00_optim_states.npz")
        with open(shard, "r+b") as f:
            f.truncate(max(os.path.getsize(shard) // 2, 1))
    # the dead run's in-memory state is gone from here on

    restarted = _make_trainer(seed + 1000, device)  # different init: restore must win
    path, _, info = auto_resume(restarted, save_dir)
    resumed = path is not None and info is not None
    resumed_at_save_step = bool(
        resumed and info["global_steps"] == SAVE_STEP
        and restarted.global_steps == SAVE_STEP)
    _train(restarted, batches[SAVE_STEP:])
    bit_equal = _masters_bit_equal(oracle.master_params,
                                   restarted.master_params)
    return {"kill_point": kill_point, "resumed": bool(resumed),
            "resumed_at_step": int(info["global_steps"]) if resumed else -1,
            "resumed_at_save_step": resumed_at_save_step,
            "retrained_bit_equal": bool(bit_equal),
            "ok": bool(resumed_at_save_step and bit_equal)}


def _auto_resume_scenario(seed, workdir, device):
    """A flight-recorder dump pins the first bad step between two committed
    checkpoints: selection must take the OLDER one."""
    from .auto_resume import find_resume_point

    save_dir = os.path.join(workdir, "trainer_auto_resume")
    dump_dir = os.path.join(workdir, "dumps")
    os.makedirs(dump_dir, exist_ok=True)
    batches = _train_batches(TRAIN_STEPS, seed)
    engine = _make_trainer(seed, device)
    _train(engine, batches[:SAVE_STEP])
    engine.save_checkpoint(save_dir, tag=f"step{SAVE_STEP}")
    _train(engine, batches[SAVE_STEP:KILL_STEP])
    engine.save_checkpoint(save_dir, tag=f"step{KILL_STEP}")
    with open(os.path.join(dump_dir, "numerics_dump_host0_0.json"), "w") as f:
        json.dump({"first_bad_step": SAVE_STEP + 1,
                   "loss_scale_trajectory": [[SAVE_STEP, 1024.0],
                                             [SAVE_STEP + 1, 512.0]]}, f)
    info = find_resume_point(save_dir, dump_dir)
    picked_before_bad = bool(info is not None
                             and info["tag"] == f"step{SAVE_STEP}"
                             and info["first_bad_step"] == SAVE_STEP + 1)
    no_dump = find_resume_point(save_dir, None)
    newest_without_dump = bool(no_dump is not None
                               and no_dump["tag"] == f"step{KILL_STEP}")
    return {"picked_before_bad_step": picked_before_bad,
            "journal_scale_seen": bool(info is not None
                                       and info["journal_scale"] == 512.0),
            "newest_without_dump": newest_without_dump,
            "ok": bool(picked_before_bad and newest_without_dump)}


# ------------------------------------------------------------------ serving
SERVE_GEOM = dict(num_slots=4, block_size=8, max_model_len=64,
                  prefill_chunk=8)


def _make_server(seed, num_blocks, device):
    from ..models.gpt2 import GPT2Config, GPT2Model
    from ..serve.engine import InferenceEngine
    cfg = GPT2Config(vocab_size=64, n_positions=SERVE_GEOM["max_model_len"],
                     n_embd=32, n_layer=2, n_head=2,
                     compute_dtype=torch.float32, loss_chunk=0)
    model = GPT2Model(cfg, device=device)
    model.init(torch.Generator(device=model.device).manual_seed(int(seed)))
    return InferenceEngine(
        model, num_blocks=num_blocks, prefix_cache=True,
        request_trace={"enabled": True, "capacity": 512}, **SERVE_GEOM)


def _serve_trace(seed, gen_lo=4, gen_hi=10):
    """Seeded greedy trace: shared 16-token system prefix (two full blocks —
    prefix-cache food), no EOS, so the schedule is independent of token
    VALUES and chunk counts are machine-independent."""
    from ..serve.scheduler import Request
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 64, size=16).tolist()
    reqs = []
    for i in range(6):
        tail = rng.randint(0, 64, size=int(rng.randint(6, 20))).tolist()
        reqs.append(Request(f"req{i:02d}", shared + tail,
                            int(rng.randint(gen_lo, gen_hi)), arrival=i))
    return reqs


def _drain(engine):
    logs = []
    guard = 0
    while not engine.scheduler.idle:
        if not engine.scheduler.running:
            na = engine.scheduler.next_arrival()
            if na is not None and na > engine._it:
                engine._it = na
        logs.append(engine.step())
        guard += 1
        if guard > 100000:
            raise RuntimeError("crash-sim serving loop failed to drain")
    return logs


def _prefill_chunks(logs):
    return sum(1 for l in logs if l.get("prefill") is not None)


def _serve_scenario(kill_point, seed, workdir, device):
    from ..serve.scheduler import pack_request, unpack_request
    from .serve_restart import restore_server, save_server

    # post_preempt needs pool pressure (tight pool + long generations so
    # concurrent decode demand outruns the free list); mid_decode wants a
    # roomy pool so the kill lands on plain decode progress
    if kill_point == "post_preempt":
        num_blocks, trace = 13, _serve_trace(seed, gen_lo=12, gen_hi=24)
    else:
        num_blocks, trace = 129, _serve_trace(seed)
    save_dir = os.path.join(workdir, f"serve_{kill_point}")

    oracle = _make_server(seed, num_blocks, device)
    oracle_out, _ = oracle.run([unpack_request(pack_request(r))
                                for r in trace])
    oracle_tokens = {o.req_id: list(o.tokens) for o in oracle_out
                     if o.status == "finished"}

    victim = _make_server(seed, num_blocks, device)
    for r in trace:
        victim.submit(unpack_request(pack_request(r)))
    # drive to the adversarial kill point (a pure function of the schedule)
    armed = False
    kill_it = -1
    guard = 0
    while not victim.scheduler.idle:
        log = victim.step()
        if kill_point == "mid_decode":
            armed = armed or bool(log["decode"])
        else:
            armed = armed or bool(log["preempted"])
        if armed:
            kill_it = log["it"]
            break
        guard += 1
        if guard > 100000:
            raise RuntimeError(f"crash-sim never reached {kill_point}")
    if not armed:  # trace drained before the adversarial point fired —
        # a silent pass here would test nothing, so refuse loudly
        raise RuntimeError(
            f"crash-sim trace drained without reaching {kill_point}")
    finished_at_kill = set(victim.outputs)
    snap_dir = save_server(victim, save_dir)
    # the dead replica's in-memory state is gone from here on

    warm = _make_server(seed, num_blocks, device)
    warm_ok = restore_server(warm, snap_dir)
    warm_logs = _drain(warm)
    warm_chunks = _prefill_chunks(warm_logs)
    warm_tokens = {o.req_id: list(o.tokens) for o in warm.outputs.values()
                   if o.status == "finished"}

    cold = _make_server(seed, num_blocks, device)
    pending = [r for r in trace if r.req_id not in finished_at_kill]
    cold_out, cold_logs = cold.run([unpack_request(pack_request(r))
                                    for r in pending])
    cold_chunks = _prefill_chunks(cold_logs)
    cold_tokens = {o.req_id: list(o.tokens) for o in cold_out
                   if o.status == "finished"}

    tokens_match_oracle = warm_tokens == oracle_tokens
    cold_match = all(cold_tokens.get(r.req_id) == oracle_tokens.get(r.req_id)
                     for r in pending)
    fewer_chunks = warm_chunks < cold_chunks
    ws = warm.tracer.waste_summary()
    waste_identity = (ws["useful_tokens"] + ws["replayed_tokens"]
                      == ws["scheduled_tokens"])
    return {"kill_point": kill_point, "kill_iteration": int(kill_it),
            "restored_warm": bool(warm_ok),
            "finished_before_kill": int(len(finished_at_kill)),
            "warm_prefill_chunks": int(warm_chunks),
            "cold_prefill_chunks": int(cold_chunks),
            "warm_fewer_chunks_than_cold": bool(fewer_chunks),
            "tokens_match_oracle": bool(tokens_match_oracle),
            "cold_tokens_match_oracle": bool(cold_match),
            "waste_identity_intact": bool(waste_identity),
            "ok": bool(warm_ok and fewer_chunks and tokens_match_oracle
                       and cold_match and waste_identity)}


# --------------------------------------------------- goodput attribution
# ``ds-tpu-torch crash-sim --goodput``: every injected stall carries a known
# ground-truth duration, and the run-lifecycle goodput ledger
# (utils/goodput.py) must attribute it to the correct badput class within
# GOODPUT_REL_TOL relative tolerance. The transcript holds only booleans,
# ints, and the injected constants — never measured wall-clock.

GOODPUT_REL_TOL = 0.10
FENCE_DELAY_S = 0.8     # injected checkpoint snapshot-fence stall, per save
REPLAY_STEP_S = 0.4     # injected per-step cost, so replay badput is known
HANG_STALL_S = 0.6      # injected stall under an armed hang watchdog
SKEW_MS = 80.0          # injected dispatch lag above the fleet median


def _within(attributed, truth, rel=GOODPUT_REL_TOL):
    """Ground-truth check: the ledger may bill the real (small) overhead on
    top of the injection, but never less than the injection and never more
    than ``rel`` above it."""
    return bool(truth <= attributed <= truth * (1.0 + rel))


def _partition_exact(ledger):
    """The taxonomy partition invariant: class seconds sum to the run wall."""
    return bool(abs(ledger.accounted_seconds() - ledger.wall_seconds()) < 0.01)


def _goodput_trainer(seed, ledger_dir, resilience, device, numerics=None):
    import deepspeed_tpu_torch
    cfg = {"train_batch_size": BATCH, "steps_per_print": 1 << 30,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "telemetry": {"enabled": True,
                         "goodput": {"enabled": True,
                                     "ledger_dir": ledger_dir}},
           "resilience": resilience}
    if numerics is not None:
        cfg["numerics"] = numerics
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_MLP(seed), config_params=cfg, device=device)
    return engine


def _train_slow(engine, batches, sleep_s):
    """Drive steps whose wall-clock is dominated by a known injected sleep,
    so per-step badput has a ground truth independent of machine speed. The
    sleep sits AFTER the forward: the ledger's first step interval opens at
    the first forward dispatch (everything before it is init), so a sleep
    ahead of it would be billed to init, not the step."""
    import time as _time
    for x, y in batches:
        loss = engine(x, y)
        _time.sleep(sleep_s)
        engine.backward(loss)
        engine.step()


def _goodput_fence_scenario(seed, workdir, device):
    """Injected checkpoint fence: every periodic save sleeps FENCE_DELAY_S
    inside the snapshot fence (AsyncCheckpointer.fence_delay_s); the ledger
    must bill each to ``checkpoint_stall``, not the productive step."""
    save_dir = os.path.join(workdir, "gp_fence_ckpt")
    ledger_dir = os.path.join(workdir, "gp_fence_ledger")
    engine = _goodput_trainer(
        seed, ledger_dir,
        {"enabled": True, "save_dir": save_dir, "save_interval": SAVE_STEP}, device)
    engine._resilience.fence_delay_s = FENCE_DELAY_S  # the fault injection
    _train(engine, _train_batches(TRAIN_STEPS, seed))
    engine._resilience.wait()
    led = engine._goodput
    led.finalize(persist=True)
    saves = int(engine._resilience.saves_started)   # steps 3 and 6 of 8
    truth = saves * FENCE_DELAY_S
    attributed = led.class_seconds["checkpoint_stall"]
    within = _within(attributed, truth)
    counted = led.checkpoint_stalls == saves
    return {"injected_class": "checkpoint_stall",
            "injected_s": truth, "saves": saves,
            "stalls_counted": bool(counted),
            "attributed_within_tolerance": within,
            "partition_exact": _partition_exact(led),
            "ok": bool(saves == 2 and counted and within
                       and _partition_exact(led))}


def _goodput_replay_scenario(seed, workdir, device):
    """Kill/restore replay: the victim dies after KILL_STEP with a committed
    checkpoint at SAVE_STEP and a flight-recorder dump whose span header
    prices its steps. The restarted engine re-runs steps SAVE_STEP+1..
    KILL_STEP — each carrying a known injected cost — and the ledger must
    bill exactly those to ``restart_replay``."""
    save_dir = os.path.join(workdir, "gp_replay_ckpt")
    dump_dir = os.path.join(workdir, "gp_replay_dumps")
    ledger_dir = os.path.join(workdir, "gp_replay_ledger")
    # async saves: the commit rides a background thread, so the victim's
    # dump span prices the steps themselves, not checkpoint file I/O
    resilience = {"enabled": True, "save_dir": save_dir,
                  "save_interval": SAVE_STEP, "auto_resume": True}
    numerics = {"enabled": True, "dump_dir": dump_dir}
    batches = _train_batches(TRAIN_STEPS, seed)

    victim = _goodput_trainer(seed, ledger_dir, resilience, device, numerics)
    _train_slow(victim, batches[:KILL_STEP], REPLAY_STEP_S)
    victim._resilience.wait()   # the kill must land AFTER the commit
    # clean preemption: dump the post-mortem (span header included), die
    victim._numerics.recorder.trigger("preempt", {"sim": "goodput"},
                                      quiet=True)

    restarted = _goodput_trainer(seed + 1000, ledger_dir, resilience, device,
                                 numerics)
    _train_slow(restarted, batches[SAVE_STEP:], REPLAY_STEP_S)
    led = restarted._goodput
    led.finalize(persist=True)

    expected_replay = KILL_STEP - SAVE_STEP
    truth = expected_replay * REPLAY_STEP_S
    attributed = led.class_seconds["restart_replay"]
    within = _within(attributed, truth)
    steps_match = led.replay_steps == expected_replay

    # offline pricing from the dump alone (satellite of the same taxonomy):
    # the victim's span header must reproduce the replay cost
    from ..utils.goodput import estimate_replay_seconds
    from ..utils.numerics import scan_dump_dir
    est_steps, est_s = estimate_replay_seconds(
        scan_dump_dir(dump_dir) or {}, SAVE_STEP)
    est_close = bool(truth > 0
                     and abs(est_s - truth) / truth <= 0.25)
    return {"injected_class": "restart_replay",
            "injected_s": truth, "replay_steps": expected_replay,
            "replay_steps_match": bool(steps_match),
            "attributed_within_tolerance": within,
            "offline_estimate_steps": int(est_steps),
            "offline_estimate_close": est_close,
            "partition_exact": _partition_exact(led),
            "ok": bool(steps_match and within
                       and est_steps == expected_replay and est_close
                       and _partition_exact(led))}


def _goodput_hang_scenario():
    """Watchdog hang: a step stalls HANG_STALL_S under an armed HangWatchdog
    with a much shorter deadline. The engine's billing rule — a step during
    which the watchdog fired bills its whole remainder to ``hang`` (a stalled
    step produced nothing) — must attribute the stall."""
    import time as _time

    from ..utils.cluster import HangWatchdog
    from ..utils.goodput import RunLedger

    led = RunLedger(run_id="gpattr", host=0)
    led.close("init")
    _time.sleep(0.05)
    led.close_step(1)                      # a healthy step first
    wd = HangWatchdog(deadline_s=0.2, signal_peers=False, poll_s=0.05,
                      run_id="gpattr")
    wd.arm(2)
    _time.sleep(HANG_STALL_S)              # the injected stall
    wd.disarm()
    fired = len(wd.fired) > 0
    led.close_step(2, hang=fired)          # the engine's rule, verbatim
    wd.stop()
    led.finalize(persist=False)
    attributed = led.class_seconds["hang"]
    within = _within(attributed, HANG_STALL_S)
    return {"injected_class": "hang", "injected_s": HANG_STALL_S,
            "watchdog_fired": bool(fired),
            "hang_steps": int(led.hang_steps),
            "attributed_within_tolerance": within,
            "partition_exact": _partition_exact(led),
            "ok": bool(fired and led.hang_steps == 1 and within
                       and _partition_exact(led))}


def _goodput_skew_scenario():
    """Rank sleep: this host really sleeps through its step while the
    injected heartbeat matrix shows its dispatch SKEW_MS above the fleet
    median — the amount the ledger must carve to ``straggler_skew``."""
    import time as _time

    from ..utils.cluster import ClusterMonitor
    from ..utils.goodput import RunLedger

    mon = ClusterMonitor(heartbeat_interval=1, host_id=1, n_hosts=2,
                         hang_deadline_s=0, warmup_steps=0,
                         allgather=lambda row: [row])
    led = RunLedger(run_id="gpattr", host=1)
    led.close("init")
    _time.sleep(SKEW_MS / 1000.0 + 0.05)   # the rank's real lag + step work
    mon.ingest([[1.0, 1000.0, 12.0, 9.0, 1024.0, 2048.0, 0.0],
                [1.0, 1000.0, 12.0, 9.0 + SKEW_MS, 1024.0, 2048.0, 0.0]], 1)
    truth = SKEW_MS / 1000.0
    led.close_step(1, {"straggler_skew": mon.last_local_skew_s})
    led.finalize(persist=False)
    attributed = led.class_seconds["straggler_skew"]
    within = _within(attributed, truth)
    integral_seen = abs(mon.skew_integral_s - truth) < 1e-9
    return {"injected_class": "straggler_skew", "injected_s": truth,
            "skew_integral_seen": bool(integral_seen),
            "attributed_within_tolerance": within,
            "partition_exact": _partition_exact(led),
            "ok": bool(integral_seen and within and _partition_exact(led))}


def run_goodput_attribution(seed=0, workdir=None, device=None):
    """All four injected-stall attributions on ``device`` (the card unless
    ``"cpu"``). Deterministic transcript."""
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix="ds_tpu_torch_goodput_attr_")
    try:
        scenarios = {
            "checkpoint_fence": _goodput_fence_scenario(seed, workdir, device),
            "restart_replay": _goodput_replay_scenario(seed, workdir, device),
            "watchdog_hang": _goodput_hang_scenario(),
            "rank_sleep_skew": _goodput_skew_scenario(),
        }
        return {"version": 1, "kind": "goodput_attribution",
                "seed": int(seed), "tolerance_rel": GOODPUT_REL_TOL,
                "scenarios": scenarios,
                "ok": all(s["ok"] for s in scenarios.values())}
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


KILL_POINTS = ("mid_save", "between_shards", "auto_resume", "mid_decode",
               "post_preempt")


def run_crash_sim(seed=0, kill_points=KILL_POINTS, workdir=None, device=None):
    """Every kill point's scenario on ``device`` (the card unless
    ``"cpu"``). Deterministic transcript."""
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix="ds_tpu_torch_crash_sim_")
    try:
        scenarios = {}
        for kp in kill_points:
            if kp in ("mid_save", "between_shards"):
                scenarios[f"trainer_{kp}"] = _trainer_scenario(
                    kp, seed, workdir, device)
            elif kp == "auto_resume":
                scenarios["trainer_auto_resume"] = _auto_resume_scenario(
                    seed, workdir, device)
            else:
                scenarios[f"serve_{kp}"] = _serve_scenario(kp, seed, workdir,
                                                           device)
        return {"version": 1, "seed": int(seed), "scenarios": scenarios,
                "ok": all(s["ok"] for s in scenarios.values())}
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ds-tpu-torch crash-sim",
        description="Kill/restart trainer and serve-sim runs at adversarial "
                    "points; assert bit-exact or documented-tolerance "
                    "recovery.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kill-points", default="all",
                        help="comma list of "
                             f"{','.join(KILL_POINTS)} (default: all)")
    parser.add_argument("--json", metavar="PATH",
                        help="write the deterministic recovery transcript")
    parser.add_argument("--workdir", default=None,
                        help="keep checkpoints here instead of a tmp dir")
    parser.add_argument("--goodput", action="store_true",
                        help="run the goodput-attribution sweep instead: "
                             "every injected stall (checkpoint fence, "
                             "kill/restore replay, watchdog hang, rank "
                             "sleep) must land in the correct badput class "
                             "within tolerance")
    parser.add_argument("--device", default="cuda",
                        help="device of the engines and servers (default: cuda)")
    args = parser.parse_args(argv)

    if args.goodput:
        transcript = run_goodput_attribution(seed=args.seed,
                                             workdir=args.workdir,
                                             device=args.device)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(transcript, f, indent=2, sort_keys=True)
                f.write("\n")
        print(f"crash-sim --goodput seed={args.seed} "
              f"(rel tolerance {transcript['tolerance_rel']})")
        for name, s in transcript["scenarios"].items():
            status = "PASS" if s["ok"] else "FAIL"
            print(f"  {status} {name}: {s['injected_s']:.2f}s injected -> "
                  f"{s['injected_class']}")
        print("crash-sim: every injected stall attributed"
              if transcript["ok"]
              else "crash-sim: GOODPUT MISATTRIBUTION", flush=True)
        return 0 if transcript["ok"] else 1

    kps = (KILL_POINTS if args.kill_points == "all"
           else tuple(args.kill_points.split(",")))
    bad = [k for k in kps if k not in KILL_POINTS]
    if bad:
        print(f"crash-sim: unknown kill point(s): {bad}", file=sys.stderr)
        return 2
    transcript = run_crash_sim(seed=args.seed, kill_points=kps,
                               workdir=args.workdir, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(transcript, f, indent=2, sort_keys=True)
            f.write("\n")
    print(f"crash-sim seed={args.seed}")
    for name, s in transcript["scenarios"].items():
        status = "PASS" if s["ok"] else "FAIL"
        extra = ""
        if "warm_prefill_chunks" in s:
            extra = (f" (warm {s['warm_prefill_chunks']} vs cold "
                     f"{s['cold_prefill_chunks']} prefill chunks)")
        elif "retrained_bit_equal" in s:
            extra = (f" (resumed at step {s['resumed_at_step']}, "
                     f"bit-equal={s['retrained_bit_equal']})")
        print(f"  {status} {name}{extra}")
    print("crash-sim: all kill points recovered" if transcript["ok"]
          else "crash-sim: RECOVERY FAILURES", flush=True)
    return 0 if transcript["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
