"""Speculative decoding of the PyTorch port against the JAX package, on the CPU.

One tiny GPT-2 (vocab 64, 32 positions, width 16, 2 layers, 2 heads, float32,
the geometry of ``tests/unit/test_speculative.py``) is initialized by the JAX
package and carried into the port with ``params_from_jax``; the rejecting
draft is the same shape initialized from seed 1. Then:

- ``accept_greedy`` equals the JAX rule on random cases;
- ``spec_verify`` equals the JAX program on the same pools (logits of the
  valid rows within 1e-5, the pools outside the null page within 1e-6);
- the speculative engines (self-draft and rejecting draft) give the JAX
  speculative engine's tokens, schedule logs (``spec`` entries included,
  ``json.dumps``) and ``spec_summary()`` on ``synth_trace``, and strictly
  fewer target steps than the port's plain engine, with its tokens;
- copy-on-write rollback never writes into a forked snapshot's pages;
- preemption mid-burst keeps the tokens of the un-starved plain engine;
- the refusals, with the JAX package's words.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.serve.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.serve.paged import build_paged_programs as jax_build
from deepspeed_tpu.serve.sim import synth_trace
from deepspeed_tpu.serve.speculative import accept_greedy as jax_accept
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.serve.engine import InferenceEngine
from deepspeed_tpu_torch.serve.paged import build_paged_programs, serving_params
from deepspeed_tpu_torch.serve.scheduler import Request
from deepspeed_tpu_torch.serve.speculative import accept_greedy

ML = 32
L = 6
K = 4
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)
GEO = dict(num_slots=4, block_size=4, num_blocks=33, max_model_len=ML, prefill_chunk=8)


def _port_model(jax_params, **over):
    tm = GPT2Model(GPT2Config(**dict(DIMS, **over), compute_dtype=torch.float32),
                   device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                                       device="cpu"))
    return tm


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    jd = jm.init(jax.random.PRNGKey(1))
    return jm, jp, jd, _port_model(jp), _port_model(jd)


def _spec(draft, params=None):
    return {"enabled": True, "draft_model": draft, "draft_params": params,
            "max_draft_tokens": K}


def _port(req):
    return Request(req.req_id, list(req.prompt), req.max_new_tokens, arrival=req.arrival,
                   num_beams=req.num_beams,
                   eos_token_id=None if req.eos_token_id < 0 else req.eos_token_id,
                   length_penalty=req.length_penalty, temperature=req.temperature,
                   top_k=req.top_k, top_p=req.top_p, seed=req.seed)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 64, size=n).tolist()


def test_accept_greedy_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        m = int(rng.randint(0, 6))
        drafts = rng.randint(0, 3, size=m).tolist()
        rows = rng.randint(0, 3, size=m + 1).tolist()
        assert accept_greedy(rows, drafts) == jax_accept(rows, drafts)


def test_spec_verify_matches_jax(models):
    jm, jp, _, tm, _ = models
    S, BS, MB, C, D = 4, 4, 8, 8, K + 1
    NB = GEO["num_blocks"]
    geo = dict(num_slots=S, block_size=BS, max_blocks=MB, prefill_chunk=C,
               verify_width=D)
    jprog, tprog = jax_build(jm, **geo), build_paged_programs(tm, **geo)
    rng = np.random.RandomState(5)
    shape = (DIMS["n_layer"], NB, BS, DIMS["n_head"], DIMS["n_embd"] // DIMS["n_head"])
    kp, vp = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    toks = rng.randint(0, 64, size=(S, D)).astype(np.int32)
    pos0 = np.asarray([0, 7, ML - D, 3], np.int32)
    n_valid = np.asarray([D, 2, D, 1], np.int32)
    active = np.asarray([True, True, True, False])
    tables = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB).astype(np.int32)
    jl, jk, jv = jprog["spec_verify"](jp, *(jnp.asarray(a) for a in (
        toks, pos0, n_valid, tables, active, kp, vp)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = tprog["spec_verify"](serving_params(tm), *(torch.from_numpy(a) for a in (
        toks, pos0, n_valid, tables, active)), tk, tv)
    assert tuple(tl.shape) == (S, D, DIMS["vocab_size"])
    for s in range(S):
        if active[s]:
            np.testing.assert_allclose(tl[s, :n_valid[s]].numpy(),
                                       np.asarray(jl)[s, :n_valid[s]], atol=1e-5, rtol=0)
    # block 0 is the null page, written in no fixed order by the pad rows
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def plain_run(models):
    _, _, _, tm, _ = models
    trace = synth_trace(10, vocab_size=64, max_model_len=ML, seed=3)
    eng = InferenceEngine(tm, **GEO)
    outs, _ = eng.run([_port(r) for r in trace])
    return trace, outs, eng.target_steps


@pytest.mark.parametrize("draft", ["self", "seed1"])
def test_speculative_engine_matches_jax(models, plain_run, draft):
    jm, jp, jd, tm, td = models
    trace, plain_outs, plain_steps = plain_run
    jeng = JaxEngine(jm, jp, speculation=dict(_spec(jm, jp if draft == "self" else jd)),
                     **GEO)
    teng = InferenceEngine(tm, speculation=_spec(tm if draft == "self" else td), **GEO)
    jouts, jlogs = jeng.run(trace)
    touts, tlogs = teng.run([_port(r) for r in trace])
    assert [o.status for o in touts] == ["finished"] * len(trace)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert [o.tokens for o in touts] == [o.tokens for o in plain_outs]
    np.testing.assert_allclose([o.score or 0.0 for o in touts],
                               [o.score or 0.0 for o in jouts], atol=1e-5)
    assert json.dumps(tlogs) == json.dumps(jlogs)
    assert any(log["spec"] for log in tlogs)
    assert teng.spec_summary() == jeng.spec_summary()
    assert teng.target_steps < plain_steps
    ss = teng.spec_summary()
    if draft == "self":
        assert ss["drafted_tokens"] == ss["accepted_tokens"] > 0
    else:
        assert 0 < ss["accepted_tokens"] < ss["drafted_tokens"]
    assert teng.scheduler.allocator.num_used == 0
    assert teng._spec.pool_stats()["used"] == 0


def test_cow_rollback_never_aliases_a_forked_snapshot(models):
    """Fork a mid-decode request's table and keep decoding speculatively with
    a rejecting draft: the forked pages' bytes stay as they were, the writes
    went to copies, and the request's tokens are the plain engine's."""
    _, _, _, tm, td = models
    eng = InferenceEngine(tm, speculation=_spec(td), **GEO)
    alloc = eng.scheduler.allocator
    prompt = _prompt(70, 9)
    eng.submit(Request("f0", prompt, L))
    for _ in range(12):
        eng.step()
        running = [g for g in eng.scheduler.running if g.phase == "decode"]
        if running and len(running[0].generated[0]) >= 1:
            break
    else:
        pytest.fail("request never observed mid-decode")
    g = running[0]
    snap = alloc.fork(g.tables[0])
    cow_before = alloc.cow_copies
    before = eng.k_pool[:, snap].clone()
    while not eng.scheduler.idle:
        eng.step()
    assert torch.equal(eng.k_pool[:, snap], before)
    assert alloc.cow_copies > cow_before
    plain = InferenceEngine(tm, **GEO)
    plain.run([Request("f0", prompt, L)])
    assert eng.outputs["f0"].tokens == plain.outputs["f0"].tokens
    alloc.free(snap)
    assert alloc.num_used == 0


def test_preemption_mid_burst_keeps_tokens(models):
    _, _, _, tm, _ = models
    reqs = [(f"p{i}", _prompt(100 + i, 9)) for i in range(4)]
    small = InferenceEngine(tm, speculation=_spec(tm), **dict(GEO, num_blocks=13))
    outs_small, _ = small.run([Request(r, p, L) for r, p in reqs])
    plain = InferenceEngine(tm, **GEO)
    outs_plain, _ = plain.run([Request(r, p, L) for r, p in reqs])
    assert sum(o.preemptions for o in outs_small) > 0
    assert [o.tokens for o in outs_small] == [o.tokens for o in outs_plain]
    assert small._spec.pool_stats()["used"] == 0


@pytest.mark.parametrize("case,match", [
    ("vocab", "vocab_size"), ("positions", "n_positions"), ("sparse", "dense draft"),
    ("k0", "max_draft_tokens"), ("mirror", "mirror"), ("sharded", "sharding.model > 1"),
    ("no_draft", "live draft model"), ("own_params", "overwrite the target")])
def test_refusals(models, case, match):
    _, jp, _, tm, _ = models
    spec = _spec(tm)
    kw = {}
    if case in ("vocab", "positions", "sparse"):
        from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
        over = {"vocab": dict(vocab_size=65), "positions": dict(n_positions=16),
                "sparse": dict(sparse_attention=FixedSparsityConfig(num_heads=2, block=4))}
        spec["draft_model"] = GPT2Model(GPT2Config(**dict(DIMS, **over[case])),
                                        device="cpu")
    elif case == "k0":
        spec["max_draft_tokens"] = 0
    elif case == "mirror":
        kw["mirror"] = True
    elif case == "sharded":
        kw["sharding"] = {"model": 2}
    elif case == "no_draft":
        spec["draft_model"] = None
    else:
        spec["draft_params"] = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                               device="cpu")
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tm, speculation=spec, **GEO, **kw)
