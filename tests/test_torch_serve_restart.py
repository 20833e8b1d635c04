"""Serving warm restart and the fleet hooks of the PyTorch port against the
JAX package, on the CPU.

The replica is the JAX crash simulator's (``resilience/crash_sim.py``): a
float32 GPT-2 of vocab 64, width 32, 2 layers, 2 heads, 4 slots, pages of 8,
``max_model_len`` 64, chunks of 8, the prefix cache and the request tracer
on, over its seeded trace of 6 greedy requests sharing a 16-token system
prefix. The port's replica carries the JAX weights (``params_from_jax``).

- killed mid-decode, and just after a preemption, and restored into a fresh
  engine: token-identical to the uninterrupted run, with fewer prefill
  chunks than a cold restart of the pending requests;
- a snapshot of another geometry is refused (ValueError), a torn one is
  refused (a cold start, not a crash);
- a snapshot written by the JAX ``save_server`` restores into the port's
  engine, and one written by the port restores into the JAX engine, both
  token-identical to the uninterrupted runs;
- ``prefix_peek``, ``load_view`` and ``fast_forward`` equal the JAX
  engine's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.resilience import crash_sim
from deepspeed_tpu.resilience import serve_restart as jax_restart
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.resilience.serve_restart import (load_server_state, restore_server,
                                                          save_server)
from deepspeed_tpu_torch.serve.engine import InferenceEngine
from deepspeed_tpu_torch.serve.scheduler import Request

GEOM = crash_sim.SERVE_GEOM


@pytest.fixture(scope="module")
def port_model():
    jm = crash_sim._make_server(0, 13)
    tm = GPT2Model(GPT2Config(vocab_size=64, n_positions=GEOM["max_model_len"], n_embd=32,
                              n_layer=2, n_head=2, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                       device="cpu"))
    return tm


def _server(tm, num_blocks):
    return InferenceEngine(tm, num_blocks=num_blocks, prefix_cache=True,
                           request_trace={"enabled": True, "capacity": 512}, **GEOM)


def _port(r):
    return Request(r.req_id, list(r.prompt), r.max_new_tokens, arrival=r.arrival)


def _scenario(kill_point):
    if kill_point == "post_preempt":
        return 13, crash_sim._serve_trace(0, gen_lo=12, gen_hi=24)
    return 129, crash_sim._serve_trace(0)


def _kill(engine, trace, kill_point):
    for r in trace:
        engine.submit(r)
    while True:
        log = engine.step()
        if log["decode"] if kill_point == "mid_decode" else log["preempted"]:
            return set(engine.outputs)


def _tokens(engine):
    return {rid: list(o.tokens) for rid, o in engine.outputs.items()
            if o.status == "finished"}


def _chunks(logs):
    return sum(1 for log in logs if log["prefill"] is not None)


@pytest.mark.parametrize("kill_point", ["mid_decode", "post_preempt"])
def test_warm_restart_is_token_identical_and_warm(port_model, tmp_path, kill_point):
    num_blocks, trace = _scenario(kill_point)
    oracle = _server(port_model, num_blocks)
    oracle.run([_port(r) for r in trace])

    victim = _server(port_model, num_blocks)
    finished = _kill(victim, [_port(r) for r in trace], kill_point)
    snap = save_server(victim, str(tmp_path))
    assert set(victim.last_serve_save) >= {"snapshot", "write", "manifest", "commit"}
    warm = _server(port_model, num_blocks)
    assert restore_server(warm, snap)
    assert (list(warm.scheduler.allocator._free)
            == list(victim.scheduler.allocator._free))
    warm_chunks = _chunks(crash_sim._drain(warm))
    assert _tokens(warm) == _tokens(oracle)

    cold = _server(port_model, num_blocks)
    pending = [_port(r) for r in trace if r.req_id not in finished]
    _, cold_logs = cold.run(pending)
    assert warm_chunks < _chunks(cold_logs)
    ws = warm.tracer.waste_summary()
    assert ws["useful_tokens"] + ws["replayed_tokens"] == ws["scheduled_tokens"]


def test_geometry_and_torn_snapshots_are_refused(port_model, tmp_path):
    victim = _server(port_model, 65)
    for r in crash_sim._serve_trace(0):
        victim.submit(_port(r))
    for _ in range(2):
        victim.step()
    snap = save_server(victim, str(tmp_path))
    with pytest.raises(ValueError, match="geometry"):
        restore_server(_server(port_model, 33), snap)
    pool = os.path.join(snap, "serve_pool.npz")
    data = open(pool, "rb").read()
    with open(pool, "wb") as f:
        f.write(data[:len(data) // 2])
    fresh = _server(port_model, 65)
    assert restore_server(fresh, snap) is False
    assert load_server_state(snap) is None and fresh.scheduler.idle


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_between_the_packages(port_model, tmp_path, writer):
    num_blocks, trace = _scenario("mid_decode")
    oracle = crash_sim._make_server(0, num_blocks)
    oracle.run(crash_sim._serve_trace(0))
    if writer == "jax":
        victim = crash_sim._make_server(0, num_blocks)
        _kill(victim, trace, "mid_decode")
        snap = jax_restart.save_server(victim, str(tmp_path))
        warm = _server(port_model, num_blocks)
        assert restore_server(warm, snap)
    else:
        victim = _server(port_model, num_blocks)
        _kill(victim, [_port(r) for r in trace], "mid_decode")
        snap = save_server(victim, str(tmp_path))
        warm = crash_sim._make_server(0, num_blocks)
        assert jax_restart.restore_server(warm, snap)
    assert warm.geometry() == victim.geometry()
    crash_sim._drain(warm)
    assert _tokens(warm) == _tokens(oracle)


def test_fleet_hooks_match_jax(port_model):
    num_blocks, trace = _scenario("mid_decode")
    jeng = crash_sim._make_server(0, num_blocks)
    teng = _server(port_model, num_blocks)
    probe = trace[3].prompt
    for eng, reqs in ((jeng, trace), (teng, [_port(r) for r in trace])):
        for r in reqs[:3]:
            eng.submit(r)
        for _ in range(9):
            eng.step()
    assert teng.prefix_peek(probe) == jeng.prefix_peek(probe)
    assert teng.prefix_peek(probe)[1] > 0
    assert teng.load_view() == jeng.load_view()
    for eng in (teng, jeng):
        eng.fast_forward(40)
        eng.fast_forward(3)
    assert teng.load_view() == jeng.load_view() and teng.load_view()["it"] == 40
    plain = InferenceEngine(port_model, **dict(GEOM, num_blocks=num_blocks))
    assert plain.prefix_peek(probe) == (0, 0)
