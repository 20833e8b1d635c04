"""The resilience layer of the PyTorch port, on the CPU: the commit protocol,
async checkpointing, auto-resume and the engine's ``resilience`` block, each
the counterpart of a test in ``tests/unit/test_resilience.py``, on the tiny
GPT-2 of ``tests/test_torch_engine.py`` (float32 compute, bf16 parameters at
ZeRO-2) and, for the fp16 loss scale, a one-matrix model.
"""

import json
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.checkpointing import (MANIFEST_NAME, verify_checkpoint,
                                                          write_latest)
from deepspeed_tpu_torch.resilience import (AsyncCheckpointer, async_ckpt, auto_resume,
                                            find_resume_point)
from deepspeed_tpu_torch.utils.numerics import load_run_bundles, scan_dump_dir

from test_torch_checkpointing import (_assert_states_equal, _engine, _offload_cfg, _state,
                                      _train)
from test_torch_engine import _Quadratic, _batches, _config

CFG = _config("AdamW", 2, gas=1)


# ------------------------------------------------------- commit protocol
def test_manifest_verifier_detects_torn_checkpoint(tmp_path):
    """Every committed file is checksummed; truncation, bit rot and a missing
    file are all detected, and load_checkpoint REFUSES the tag
    (tests/unit/test_resilience.py:76)."""
    eng = _engine(CFG)
    _train(eng, _batches(2))
    eng.save_checkpoint(str(tmp_path), tag="t")
    ckpt = tmp_path / "t"
    assert verify_checkpoint(str(ckpt)) == (True, "ok")

    shard = ckpt / "zero_pp_rank_0_mp_rank_00_optim_states.npz"
    orig = shard.read_bytes()
    shard.write_bytes(orig[: len(orig) // 2])  # torn write
    ok, reason = verify_checkpoint(str(ckpt))
    assert not ok and "size mismatch" in reason
    fresh = _engine(CFG, scale=0.5)
    before = _state(fresh)
    path, cs = fresh.load_checkpoint(str(tmp_path), tag="t")
    assert path is None and cs == {}  # refused, never loaded
    _assert_states_equal(_state(fresh), before)
    assert fresh.global_steps == 0

    flipped = bytearray(orig)
    flipped[len(orig) // 2] ^= 0xFF  # bit rot at the original size
    shard.write_bytes(bytes(flipped))
    ok, reason = verify_checkpoint(str(ckpt))
    assert not ok and "checksum mismatch" in reason

    shard.write_bytes(orig)
    assert verify_checkpoint(str(ckpt))[0]
    shard.unlink()
    ok, reason = verify_checkpoint(str(ckpt))
    assert not ok and "missing" in reason

    shard.write_bytes(orig)
    (ckpt / MANIFEST_NAME).unlink()  # pre-manifest checkpoints still load
    ok, reason = verify_checkpoint(str(ckpt))
    assert ok and "legacy" in reason


def test_latest_pointer_write_is_atomic(tmp_path):
    """(tests/unit/test_resilience.py:112)"""
    write_latest(str(tmp_path), "step1")
    assert (tmp_path / "latest").read_text() == "step1"
    write_latest(str(tmp_path), "step2")
    assert (tmp_path / "latest").read_text() == "step2"
    # the tmp file used for the atomic replace never survives
    assert [p.name for p in tmp_path.iterdir()] == ["latest"]


def test_tmp_carcass_is_invisible_to_restore(tmp_path):
    """A fully-written but never-renamed <tag>.tmp (death mid-commit) is
    skipped by tag enumeration and auto-resume (tests/unit/test_resilience.py:121)."""
    eng = _engine(CFG)
    _train(eng, _batches(2))
    eng.save_checkpoint(str(tmp_path), tag="good")
    (tmp_path / "bad.tmp").mkdir()
    (tmp_path / "bad.tmp" / "junk.npz").write_bytes(b"x")
    info = find_resume_point(str(tmp_path))
    assert info is not None and info["tag"] == "good" and info["global_steps"] == 2


# ---------------------------------------------------- async checkpointing
@pytest.mark.parametrize("offload", [False, True])
def test_async_save_snapshot_consistency(tmp_path, monkeypatch, offload):
    """The snapshot is taken on the caller's thread at save(); three MORE
    steps train, in place, while the commit is held open on the writer
    thread, and none of them leaks into the files: restore lands bit-equal
    on the save-point state (tests/unit/test_resilience.py:134). Under
    ZeRO-Offload the host buffers are updated in place too."""
    cfg = _offload_cfg() if offload else CFG
    bs = _batches(6)
    eng = _engine(cfg)
    _train(eng, bs[:3])
    at_save = _state(eng)
    gate, seen = threading.Event(), []
    commit = async_ckpt.write_snapshot

    def held_commit(*args, **kw):
        seen.append(ck.in_flight)
        assert gate.wait(timeout=60)
        return commit(*args, **kw)

    monkeypatch.setattr(async_ckpt, "write_snapshot", held_commit)
    ck = AsyncCheckpointer(eng, str(tmp_path))
    ck.save(tag="step3")
    _train(eng, bs[3:])  # in place, while the commit is held
    assert ck.in_flight and ck.saves_committed == 0
    gate.set()
    ck.wait()
    assert seen == [True] and not ck.in_flight
    assert ck.saves_started == ck.saves_committed == 1 and ck.last_stall_ms >= 0.0

    again = _engine(cfg, scale=0.5)
    path, _ = again.load_checkpoint(str(tmp_path))
    assert path is not None and again.global_steps == 3
    _assert_states_equal(_state(again), at_save)
    assert any(not np.array_equal(v, at_save[k]) for k, v in _state(eng).items())


def test_failed_commit_reraises_at_the_next_save(tmp_path, monkeypatch):
    """A commit that fails on the writer thread is never dropped: the next
    save() (or wait()) raises it, and a later save commits."""
    eng = _engine(CFG)
    _train(eng, _batches(1))
    commit = async_ckpt.write_snapshot

    def failing(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(async_ckpt, "write_snapshot", failing)
    ck = AsyncCheckpointer(eng, str(tmp_path))
    ck.save(tag="a")
    with pytest.raises(OSError, match="disk full"):
        ck.save(tag="b")
    assert ck.saves_committed == 0
    ck.save(tag="c")
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    monkeypatch.setattr(async_ckpt, "write_snapshot", commit)
    ck.save(tag="d")
    ck.wait()
    assert ck.saves_committed == 1 and (tmp_path / "latest").read_text() == "d"
    assert not (tmp_path / "a").exists() and verify_checkpoint(str(tmp_path / "d"))[0]


# ------------------------------------------------------------- auto-resume
def _fp16_engine(seed_scale=1.0):
    cfg = {"train_batch_size": 1, "fp16": {"enabled": True, "initial_scale_power": 10},
           "optimizer": {"type": "SGD", "params": {"lr": 0.01}}}
    model = _Quadratic()
    with torch.no_grad():
        model.w.mul_(seed_scale)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                                  device="cpu")
    return eng


def _fp16_steps(eng, n):
    for _ in range(n):
        eng.backward(eng(torch.ones(1, 4)))
        eng.step()


def test_auto_resume_selection_and_scale_clamp(tmp_path):
    """Newest-before-first-bad-step selection, torn-tag skip, and the
    journaled loss-scale clamp (tests/unit/test_resilience.py:287)."""
    save_dir, dump_dir = tmp_path / "ckpts", tmp_path / "dumps"
    dump_dir.mkdir()
    eng = _fp16_engine()
    _fp16_steps(eng, 2)
    eng.save_checkpoint(str(save_dir), tag="step2")
    saved_w = eng.module.w.detach().clone()
    _fp16_steps(eng, 2)
    eng.save_checkpoint(str(save_dir), tag="step4")
    assert eng.loss_scale() == 1024.0

    # no dump: plain warm restart takes the newest commit
    assert find_resume_point(str(save_dir))["tag"] == "step4"
    # a torn newest tag is skipped
    (save_dir / "step4" / "loss_scaler.npz").write_bytes(b"torn")
    assert find_resume_point(str(save_dir))["tag"] == "step2"

    (dump_dir / "numerics_dump_host0_0.json").write_text(json.dumps(
        {"first_bad_step": 3,
         "loss_scale_trajectory": [[2, 1024.0], [3, 256.0]]}))
    info = find_resume_point(str(save_dir), str(dump_dir))
    assert info["tag"] == "step2" and info["journal_scale"] == 256.0

    fresh = _fp16_engine(seed_scale=0.5)
    path, _, info = auto_resume(fresh, str(save_dir), str(dump_dir))
    assert path is not None and fresh.global_steps == 2
    assert torch.equal(fresh.module.w.detach(), saved_w)
    # the checkpoint recorded 1024; the journal had backed off to 256
    assert fresh.loss_scale() == 256.0
    assert auto_resume(_fp16_engine(), str(tmp_path / "empty")) == (None, {}, None)


def test_scan_dump_dir_ignores_torn_dump(tmp_path):
    """(tests/unit/test_resilience.py:319), and the JAX package's reader
    agrees on the same directory, by run too."""
    from deepspeed_tpu.utils.numerics import load_run_bundles as jax_bundles
    from deepspeed_tpu.utils.numerics import scan_dump_dir as jax_scan
    assert scan_dump_dir(None) is None
    assert scan_dump_dir(str(tmp_path / "missing")) is None
    (tmp_path / "numerics_dump_host0_0.json").write_text('{"first_bad')
    assert scan_dump_dir(str(tmp_path)) is None  # torn dump never blocks resume
    (tmp_path / "numerics_dump_host0_1.json").write_text('{"first_bad_step": 7}')
    assert scan_dump_dir(str(tmp_path))["first_bad_step"] == 7
    (tmp_path / "numerics_dump_run2_host1_0.json").write_text('{"first_bad_step": 9}')
    assert scan_dump_dir(str(tmp_path)) == jax_scan(str(tmp_path))
    for run in (None, "", "run2", "nope"):
        assert load_run_bundles(str(tmp_path), run) == jax_bundles(str(tmp_path), run)
    assert load_run_bundles(str(tmp_path), "")[1] == {0: {"first_bad_step": 7}}


# --------------------------------------------- the engine's resilience block
@pytest.mark.parametrize("async_save", [True, False])
def test_engine_resilience_block(tmp_path, async_save):
    """``save_interval`` writes a committed ``global_stepN`` tag every N
    steps from the step itself (deepspeed_tpu/runtime/engine.py:2196-2204);
    an engine built with ``auto_resume`` on that directory comes up at the
    newest tag with its state (:676-700)."""
    block = {"enabled": True, "save_dir": str(tmp_path), "save_interval": 2,
             "async_save": async_save}
    eng = _engine(dict(CFG, resilience=block))
    bs = _batches(5)
    _train(eng, bs[:4])
    if not async_save:
        assert not eng._resilience.in_flight
    at4 = _state(eng)
    _train(eng, bs[4:])   # step 5 saves nothing
    eng._resilience.wait()
    assert eng._resilience.saves_committed == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["global_step2", "global_step4",
                                                           "latest"]
    for tag in ("global_step2", "global_step4"):
        assert verify_checkpoint(str(tmp_path / tag)) == (True, "ok")

    resumed = _engine(dict(CFG, resilience=dict(block, auto_resume=True)), scale=0.5)
    assert resumed.global_steps == 4
    _assert_states_equal(_state(resumed), at4)
