"""The PyTorch port's fleet router (``deepspeed_tpu_torch/serve/router.py``)
against the JAX package's, on the CPU.

Both routers drive tiny float32 GPT-2 replicas (vocab 64, width 16, 2
layers; the JAX init, carried over with ``params_from_jax``) over the same
seeded requests. Routing is host arithmetic over the engines' hooks
(``prefix_peek``, ``load_view``), so for every policy, admission bound and
kill schedule the fleet transcript (routes, sheds, kills, per-slot prefill
chunks, the goodput fraction) is the JAX router's byte for byte, the outputs
carry the same statuses, refusals and tokens, and the fleet summary's counts
and merged goodput are equal. Then the two orderings the serve-sim gates
on: warm failover takes fewer prefill chunks than cold, and affinity fewer
than round-robin, with identical tokens.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax

ML = 32
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)
ENGINE = dict(num_slots=4, block_size=4, num_blocks=33, max_model_len=ML,
              prefill_chunk=8, prefix_cache=True)


@functools.lru_cache(maxsize=None)
def _models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu"))
    return jm, jp, tm


def _prompt(seed, n, prefix=()):
    return list(prefix) + np.random.RandomState(seed).randint(0, 64, size=n).tolist()


def _requests(kind, Request):
    if kind == "shared_prefix":
        system = _prompt(99, 16)
        return [Request(f"r{i}", _prompt(40 + i, 1 + i % 3, system), 3 + i % 3,
                        arrival=i) for i in range(16)]
    if kind == "burst":
        return [Request(f"r{i}", _prompt(20 + i, 9), 3) for i in range(8)]
    return [Request(f"r{i}", _prompt(40 + i, 12), 4, arrival=i) for i in range(8)]


# (requests, replicas, engine overrides, router kwargs)
SCENARIOS = {
    "affinity": ("shared_prefix", 2, {}, dict(policy="affinity")),
    "affinity_weight_4": ("shared_prefix", 3, {}, dict(policy="affinity",
                                                      affinity_weight=4.0)),
    "least_loaded": ("shared_prefix", 2, {}, dict(policy="least_loaded")),
    "round_robin": ("shared_prefix", 2, {}, dict(policy="round_robin")),
    "queue_depth_shed": ("burst", 1, {"num_slots": 1},
                         dict(policy="least_loaded", max_queue_depth=2)),
    "occupancy_shed": ("staggered", 2, {"num_blocks": 9}, dict(occupancy_cap=0.5)),
    "warm_kill": ("staggered", 2, {}, dict(kill_schedule=[(3, 1)])),
    "cold_kill": ("staggered", 2, {}, dict(kill_schedule=[(3, 1)], cold_failover=True)),
    "two_kills": ("shared_prefix", 2, {}, dict(kill_schedule=[(2, 0), (5, 1)])),
}


def _fleet_run(pkg, scenario, tmp):
    """One scenario through ``pkg``'s router: (outputs, transcript, summary)."""
    kind, n, engine_over, router_kw = SCENARIOS[scenario]
    jm, jp, tm = _models()
    if pkg == "jax":
        from deepspeed_tpu.serve.engine import InferenceEngine
        from deepspeed_tpu.serve.router import FleetRouter
        from deepspeed_tpu.serve.scheduler import Request
        model, params = jm, jp
    else:
        from deepspeed_tpu_torch.serve.engine import InferenceEngine
        from deepspeed_tpu_torch.serve.router import FleetRouter
        from deepspeed_tpu_torch.serve.scheduler import Request
        model, params = tm, None

    def engine(slot):
        kw = dict(ENGINE, **engine_over)
        return InferenceEngine(model, params, request_trace={
            "enabled": True, "capacity": 64, "host_id": slot}, **kw)

    router = FleetRouter([engine(s) for s in range(n)], build_replacement=engine,
                         snapshot_dir=str(tmp / pkg), **router_kw)
    outs, transcript = router.run(_requests(kind, Request))
    summary = router.fleet_summary()
    return outs, transcript, summary


@functools.lru_cache(maxsize=None)
def _both(scenario, tmp):
    return _fleet_run("jax", scenario, tmp), _fleet_run("port", scenario, tmp)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("fleet")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_transcript_matches_jax_router(scenario, tmp):
    (j_outs, j_tr, j_sum), (p_outs, p_tr, p_sum) = _both(scenario, tmp)
    assert json.dumps(p_tr, sort_keys=True) == json.dumps(j_tr, sort_keys=True)
    assert ([(o.req_id, o.status, o.refusal, list(o.tokens)) for o in p_outs]
            == [(o.req_id, o.status, o.refusal, [int(t) for t in o.tokens])
                for o in j_outs])
    for key in ("replicas", "policy", "prefill_chunks", "total_prefill_chunks",
                "finished", "refused", "shed", "kills", "goodput_fleet", "serving"):
        assert p_sum[key] == j_sum[key], key
    # the merged percentiles cover the same metrics (their ms values are walls)
    assert sorted(p_sum["latency"]) == sorted(j_sum["latency"])


def test_scenarios_exercise_sheds_and_kills(tmp):
    summaries = {s: _both(s, tmp)[1][2] for s in SCENARIOS}
    assert summaries["queue_depth_shed"]["shed"] > 0
    assert summaries["occupancy_shed"]["shed"] > 0
    assert summaries["warm_kill"]["kills"] == 1 and summaries["two_kills"]["kills"] == 2
    assert all(summaries[s]["shed"] == 0 for s in ("affinity", "warm_kill", "cold_kill"))


def test_warm_failover_takes_fewer_chunks_than_cold(tmp):
    _, (w_outs, _, warm) = _both("warm_kill", tmp)
    _, (c_outs, _, cold) = _both("cold_kill", tmp)
    assert [(o.req_id, o.tokens) for o in w_outs] == [(o.req_id, o.tokens) for o in c_outs]
    assert warm["total_prefill_chunks"] < cold["total_prefill_chunks"]


def test_affinity_takes_fewer_chunks_than_round_robin(tmp):
    _, (a_outs, _, aff) = _both("affinity", tmp)
    _, (r_outs, _, rr) = _both("round_robin", tmp)
    assert [(o.req_id, o.tokens) for o in a_outs] == [(o.req_id, o.tokens) for o in r_outs]
    assert aff["total_prefill_chunks"] < rr["total_prefill_chunks"]


def test_router_refusals_match_jax():
    from deepspeed_tpu_torch.serve.router import FleetRouter
    _, _, tm = _models()
    with pytest.raises(ValueError, match="at least one engine"):
        FleetRouter([])
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    eng = InferenceEngine(tm, None, **ENGINE)
    with pytest.raises(ValueError, match="fleet policy must be one of"):
        FleetRouter([eng], policy="random")
    from deepspeed_tpu_torch.serve.scheduler import Request
    router = FleetRouter([eng], kill_schedule=[(0, 0)])
    with pytest.raises(RuntimeError, match="build_replacement"):
        router.run([Request("r0", _prompt(1, 5), 2)])
