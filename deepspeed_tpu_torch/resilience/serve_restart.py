"""Serving warm restart: checkpoint/restore of a paged-serving replica
(PyTorch port of ``deepspeed_tpu/resilience/serve_restart.py``; the files
are the JAX package's, so a snapshot of either package restores in the
other).

A preempted serving replica loses host state (scheduler ledger, allocator
free list, prefix-cache index) and device state (the paged KV pool). The
expensive part to rebuild is the pool: every cached prompt page holds KV a
cold replica must re-prefill. This module persists BOTH halves with the same
commit protocol the trainer checkpoints use (tmp dir → fsync → atomic rename
+ integrity manifest — checkpoint/checkpointing.py), so a warm restart:

- verifies the manifest and REFUSES a torn snapshot (never loads it);
- validates the engine geometry (``InferenceEngine.geometry``) and refuses a
  snapshot from a differently-shaped replica (page indices and pool bytes
  are meaningless under another layout);
- restores the pool bytes, allocator ledger (free-list/cached-tier ORDER
  included — allocation determinism depends on it), prefix-cache index, and
  requeued in-flight requests — which then rejoin through the prefix
  machinery: parked prompt pages remap into their new tables instead of
  re-prefilling, which is exactly what makes the restart *warm* (strictly
  fewer prefill chunks than a cold start, token-identical outputs).

The snapshot itself quiesces the scheduler (``Scheduler.quiesce``): every
running group is preempted — its prefill frontier registers in the prefix
cache and its requests requeue at their original positions — leaving a
ledger with no live Group objects to serialize.

Files: ``serve_state.json`` (the ledgers) and ``serve_pool.npz`` (the pools,
widened to float32: exact for every serving compute dtype). ``save_server``
records its stages' seconds in ``engine.last_serve_save`` and
``restore_server`` in ``engine.last_serve_load``.
"""

import json
import os
import shutil
import time

import numpy as np
import torch

from ..checkpoint.checkpointing import (TMP_SUFFIX, _fsync_dir,
                                        verify_checkpoint, write_manifest)
from ..utils import logger

STATE_JSON = "serve_state.json"
POOL_NPZ = "serve_pool.npz"


def _widen(pool):
    """A snapshot's pool as a float32 numpy array."""
    if isinstance(pool, torch.Tensor):
        return pool.float().numpy()
    return np.asarray(pool, np.float32)


def server_state_dict(engine) -> dict:
    """Snapshot a serving engine (quiesces it). Alias for
    ``InferenceEngine.state_dict`` so callers can stay serve-agnostic."""
    return engine.state_dict()


def save_server(engine, save_dir: str, tag: str = "serve") -> str:
    """Snapshot ``engine`` and commit it under ``save_dir/tag/`` atomically.
    Returns the committed directory path."""
    sec = {}
    t = time.perf_counter()
    state = server_state_dict(engine)
    sec["snapshot"] = time.perf_counter() - t
    t = time.perf_counter()
    k_pool = _widen(state.pop("k_pool"))
    v_pool = _widen(state.pop("v_pool"))
    sec["widen"] = time.perf_counter() - t
    final_dir = os.path.join(save_dir, tag)
    tmp_dir = final_dir + TMP_SUFFIX
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    t = time.perf_counter()
    with open(os.path.join(tmp_dir, POOL_NPZ), "wb") as f:
        np.savez(f, k_pool=k_pool, v_pool=v_pool)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp_dir, STATE_JSON), "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    sec["write"] = time.perf_counter() - t
    t = time.perf_counter()
    write_manifest(tmp_dir, extra={"kind": "serve", "tag": tag,
                                   "it": int(state["it"])})
    sec["manifest"] = time.perf_counter() - t
    t = time.perf_counter()
    _fsync_dir(tmp_dir)
    if os.path.isdir(final_dir):
        shutil.rmtree(final_dir)
    os.rename(tmp_dir, final_dir)
    _fsync_dir(save_dir)
    sec["commit"] = time.perf_counter() - t
    sec["bytes"] = k_pool.nbytes + v_pool.nbytes
    engine.last_serve_save = sec
    logger.info(f"[deepspeed_tpu_torch] serving snapshot committed to {final_dir}")
    return final_dir


def load_server_state(ckpt_dir: str, seconds=None):
    """Read a committed serving snapshot back into a ``state_dict``-shaped
    dict, or None for a missing/torn snapshot (refused, never loaded).
    ``seconds``, a dict, receives the verify and read stages' times."""
    sec = seconds if seconds is not None else {}
    t = time.perf_counter()
    ok, reason = verify_checkpoint(ckpt_dir)
    sec["verify"] = time.perf_counter() - t
    if not ok:
        logger.warning(f"[deepspeed_tpu_torch] REFUSING serving snapshot "
                       f"{ckpt_dir}: {reason}")
        return None
    t = time.perf_counter()
    try:
        with open(os.path.join(ckpt_dir, STATE_JSON)) as f:
            state = json.load(f)
        with np.load(os.path.join(ckpt_dir, POOL_NPZ)) as data:
            state["k_pool"] = data["k_pool"]
            state["v_pool"] = data["v_pool"]
    except (OSError, ValueError, KeyError) as e:
        logger.warning(f"[deepspeed_tpu_torch] REFUSING serving snapshot "
                       f"{ckpt_dir}: unreadable ({e})")
        return None
    sec["read"] = time.perf_counter() - t
    return state


def restore_server(engine, ckpt_dir: str) -> bool:
    """Load a committed snapshot into ``engine``. Returns False when the
    snapshot is missing/torn (caller starts cold); raises ValueError on a
    geometry mismatch (restarting into the wrong shape is a config bug, not
    a recoverable condition)."""
    sec = {}
    state = load_server_state(ckpt_dir, sec)
    if state is None:
        return False
    t = time.perf_counter()
    engine.load_state_dict(state)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    sec["place"] = time.perf_counter() - t
    engine.last_serve_load = sec
    logger.info(f"[deepspeed_tpu_torch] serving replica rejoined warm from "
                f"{ckpt_dir} (it={engine._it}, "
                f"{len(engine.scheduler.waiting)} requests requeued)")
    return True


def failover_server(engine, build_replacement, save_dir: str,
                    tag: str = "serve"):
    """Fleet warm failover: snapshot ``engine`` (quiescing it — in-flight
    prefill frontiers park in the prefix cache), build a replacement replica
    via ``build_replacement()``, and restore the snapshot into it, so the
    successor rejoins with the KV pool and requeued requests intact. Returns
    the restored replacement. Raises RuntimeError if the just-written
    snapshot is refused (torn mid-failover means the host is failing, not
    the request stream — the router must not silently drop work)."""
    ckpt_dir = save_server(engine, save_dir, tag=tag)
    replacement = build_replacement()
    if not restore_server(replacement, ckpt_dir):
        raise RuntimeError(
            f"fleet failover: snapshot {ckpt_dir} refused immediately after "
            "commit — aborting instead of dropping in-flight requests")
    return replacement
