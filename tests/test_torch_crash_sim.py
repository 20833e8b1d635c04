"""``ds-tpu-torch crash-sim`` (``deepspeed_tpu_torch/resilience/crash_sim.py``)
against the JAX package's: the recovery transcript of the five kill points
and the goodput-attribution transcript, byte for byte against the JAX
functions' own output on the CPU (and against the JAX goldens where the JAX
output matches them). With them, the two faults of the port the goodput
transcript found: the engine billed no restart replay, and auto-resume did
not default to the engine's flight-recorder dump directory."""

import json
import os

import numpy as np

from deepspeed_tpu.resilience import crash_sim as jcs
from deepspeed_tpu_torch.resilience import crash_sim as tcs

GOLDEN = os.path.join(os.path.dirname(__file__), "unit", "golden")


def _bytes(transcript):
    return json.dumps(transcript, indent=2, sort_keys=True) + "\n"


def _check(ours, theirs, golden):
    assert ours["ok"], ours
    assert _bytes(ours) == _bytes(theirs)
    with open(os.path.join(GOLDEN, golden)) as f:
        pinned = f.read()
    if _bytes(theirs) == pinned:
        assert _bytes(ours) == pinned


def test_crash_sim_transcript_equals_jax(tmp_path):
    ours = tcs.run_crash_sim(seed=0, workdir=str(tmp_path / "torch"), device="cpu")
    theirs = jcs.run_crash_sim(seed=0, workdir=str(tmp_path / "jax"))
    _check(ours, theirs, "crash_sim_transcript.json")
    # the warm restart's prefill saving is the serving scenarios' point
    for kp in ("serve_mid_decode", "serve_post_preempt"):
        s = ours["scenarios"][kp]
        assert s["warm_prefill_chunks"] < s["cold_prefill_chunks"]


GOODPUT_ATTEMPTS = 3


def test_goodput_attribution_transcript_equals_jax(tmp_path):
    """The attribution holds injected sleeps (0.4-0.8 s) against the ledger's
    wall-clock classes within 10%: on a loaded host a step's own overhead
    can pass that margin in either package, so a run whose JAX reference
    itself misattributes is repeated, up to GOODPUT_ATTEMPTS times."""
    for attempt in range(GOODPUT_ATTEMPTS):
        ours = tcs.run_goodput_attribution(seed=0, device="cpu",
                                           workdir=str(tmp_path / f"torch{attempt}"))
        theirs = jcs.run_goodput_attribution(seed=0, workdir=str(tmp_path / f"jax{attempt}"))
        if ours["ok"] and theirs["ok"]:
            break
    _check(ours, theirs, "goodput_attribution.json")


def test_cli_writes_the_transcript(tmp_path):
    from deepspeed_tpu_torch import cli
    path = tmp_path / "t.json"
    assert cli.main(["crash-sim", "--kill-points", "auto_resume,mid_save",
                     "--device", "cpu", "--json", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert rep["ok"] and set(rep["scenarios"]) == {"trainer_auto_resume",
                                                   "trainer_mid_save"}
    assert cli.main(["crash-sim", "--kill-points", "nope"]) == 2


def test_restart_replay_is_billed(tmp_path):
    """Fault: an engine that auto-resumed with the goodput ledger on billed no
    step to ``restart_replay`` (the JAX engine's runtime/engine.py:688-706),
    and auto-resume read no dump unless the caller named its directory."""
    s = tcs._goodput_replay_scenario(0, str(tmp_path), "cpu")
    # the steps billed (the wall-clock attribution is the transcript test's)
    assert s["replay_steps_match"] and s["replay_steps"] == tcs.KILL_STEP - tcs.SAVE_STEP, s


def test_auto_resume_defaults_to_the_engine_dump_dir(tmp_path):
    from deepspeed_tpu_torch.resilience.auto_resume import auto_resume
    batches = tcs._train_batches(tcs.TRAIN_STEPS, 0)
    dump_dir = tmp_path / "dumps"
    save_dir = str(tmp_path / "ckpt")
    eng = tcs._goodput_trainer(0, str(tmp_path / "ledger"), {}, "cpu",
                               numerics={"enabled": True, "dump_dir": str(dump_dir)})
    tcs._train(eng, batches[:tcs.SAVE_STEP])
    eng.save_checkpoint(save_dir, tag="step3")
    tcs._train(eng, batches[tcs.SAVE_STEP:tcs.KILL_STEP])
    eng.save_checkpoint(save_dir, tag="step5")
    os.makedirs(dump_dir, exist_ok=True)
    with open(dump_dir / "numerics_dump_host0_0.json", "w") as f:
        json.dump({"first_bad_step": 4}, f)
    path, _, info = auto_resume(eng, save_dir)
    assert path is not None and info["tag"] == "step3" and eng.global_steps == 3
    assert np.isfinite(float(eng.master_params["w1"].sum()))
