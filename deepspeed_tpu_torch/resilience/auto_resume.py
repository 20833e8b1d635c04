"""Auto-resume: restart from the newest good state, not the newest state
(PyTorch port of ``deepspeed_tpu/resilience/auto_resume.py``).

On a crash the flight recorder dumped a post-mortem (``utils/numerics.py``
reads it) that knows two things a naive "load latest" restart does not:

- **the first bad step** — a checkpoint taken at or after it has already
  absorbed the anomaly (a nonfinite subtree, a desync), so resuming from it
  replays the failure. ``find_resume_point`` selects the newest COMMITTED
  checkpoint strictly before the first bad step (manifest-verified — torn
  saves are skipped, never loaded).
- **the journaled loss scale** — the scale trajectory around an overflow
  spiral ends far below the scale the pre-crash checkpoint recorded. Resuming
  with the checkpoint's (higher) scale re-runs the same overflow/backoff
  spiral, wasting the same steps again. ``auto_resume`` clamps the restored
  scale to the journal's final value, so recovery continues from where the
  backoff had actually converged.

With no dump present (clean preemption, not a numerics crash) every committed
checkpoint is eligible and the newest wins — plain warm restart. The port's
engine refuses the ``numerics`` block (ROADMAP.md item 22), so the dump
directory is the caller's to name.
"""

import json
import os

from ..checkpoint.checkpointing import (MANIFEST_NAME, TMP_SUFFIX, model_states_name,
                                        verify_checkpoint)
from ..utils import logger
from ..utils.numerics import scan_dump_dir


def _tag_step(ckpt_dir):
    """global_steps of a checkpoint dir, from the manifest meta (resilience
    saves) or the model-states meta (legacy saves). None when unreadable."""
    try:
        with open(os.path.join(ckpt_dir, MANIFEST_NAME)) as f:
            meta = json.load(f).get("meta", {})
        if "global_steps" in meta:
            return int(meta["global_steps"])
    except (OSError, ValueError):
        pass
    try:
        with open(os.path.join(ckpt_dir, model_states_name() + ".json")) as f:
            return int(json.load(f)["global_steps"])
    except (OSError, ValueError, KeyError):
        return None


def find_resume_point(save_dir, dump_dir=None):
    """Select the checkpoint a restart should load.

    Returns ``{"tag", "global_steps", "first_bad_step", "journal_scale"}`` or
    None when no committed checkpoint qualifies. ``journal_scale`` is the last
    loss scale the flight recorder journaled before the crash (None without a
    dump or an fp16 journal)."""
    first_bad = None
    journal_scale = None
    bundle = scan_dump_dir(dump_dir)
    if bundle is not None:
        first_bad = bundle.get("first_bad_step")
        if first_bad is None:
            for rec in bundle.get("steps", []):
                if rec.get("anomaly") or rec.get("overflow"):
                    first_bad = rec.get("step")
                    break
        traj = bundle.get("loss_scale_trajectory") or []
        if traj:
            journal_scale = float(traj[-1][1])

    best = None
    if os.path.isdir(save_dir):
        for name in sorted(os.listdir(save_dir)):
            ckpt_dir = os.path.join(save_dir, name)
            if name.endswith(TMP_SUFFIX) or not os.path.isdir(ckpt_dir):
                continue
            ok, reason = verify_checkpoint(ckpt_dir)
            if not ok:
                logger.warning(f"[deepspeed_tpu_torch] auto-resume skipping torn "
                               f"checkpoint {name}: {reason}")
                continue
            step = _tag_step(ckpt_dir)
            if step is None:
                continue
            if first_bad is not None and step >= first_bad:
                continue  # taken at/after the anomaly: replays the failure
            if best is None or step > best["global_steps"]:
                best = {"tag": name, "global_steps": step}
    if best is None:
        return None
    best["first_bad_step"] = first_bad
    best["journal_scale"] = journal_scale
    return best


def auto_resume(engine, save_dir, dump_dir=None):
    """Load the resume point into ``engine``. Returns ``(ckpt_path,
    client_state, info)`` — ``(None, {}, None)`` when nothing qualifies (cold
    start)."""
    info = find_resume_point(save_dir, dump_dir)
    if info is None:
        logger.info(f"[deepspeed_tpu_torch] auto-resume: no committed checkpoint "
                    f"before the first bad step in {save_dir}; cold start")
        return None, {}, None
    path, client_state = engine.load_checkpoint(save_dir, tag=info["tag"])
    if path is None:
        return None, {}, None
    scale = info["journal_scale"]
    if scale is not None and engine.scaler_state is not None:
        ckpt_scale = float(engine.scaler_state.cur_scale)
        new_scale = min(ckpt_scale, scale)
        if new_scale != ckpt_scale:
            # don't replay the overflow spiral: continue from the backed-off
            # scale the journal had converged to when the run died
            engine.scaler_state = engine.scaler_state._replace(cur_scale=new_scale)
            logger.info(f"[deepspeed_tpu_torch] auto-resume: loss scale clamped "
                        f"{ckpt_scale} -> {new_scale} (journaled)")
    logger.info(f"[deepspeed_tpu_torch] auto-resume: restored {info['tag']} "
                f"(step {info['global_steps']}, first bad step "
                f"{info['first_bad_step']})")
    return path, client_state, info
