"""Serving path of the PyTorch port against the JAX package, on the CPU.

One tiny GPT-2 (vocab 64, 32 positions, width 16, 2 layers, 2 heads, float32)
is initialized by the JAX package and carried into the port with
``params_from_jax``. Then:

- the port's ``prefill_chunk`` / ``decode_step`` / ``copy_blocks`` against the
  JAX gather path (``build_paged_programs(use_pallas=False)``) on the same
  pools: logits within 1e-5 and pools within 1e-6 (float32; the two
  frameworks sum in different orders), page copies bit for bit;
- the port's decode step with ``use_pallas=True`` (the kernel's plain
  version on the CPU) against the same JAX gather path, within 1e-5, and
  with float16 pools and weights against the JAX package's float16 model,
  within 1e-3;
- the whole slice: ``init_inference`` in both packages on one seeded trace
  gives the same tokens, statuses and schedule logs (``json.dumps``).

The ``cuda``-marked tests (skipped without a card) hold the CUDA graphs the
engine runs on the card: each replay bit for bit against the eager program
on the same pools, one capture a program, the launch counters moving per
replay, the graphed engine's outputs against the eager-driven one's, and a
warm restart keeping the graphs' pools.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention
from deepspeed_tpu_torch.serve.paged import build_paged_programs, serving_params
from deepspeed_tpu_torch.serve.scheduler import Request


class _Lazy:
    """A module imported at its first attribute read: JAX and the JAX package
    load only in the tests that use them, so that on a machine with a card
    and no JAX ``python -m pytest -m cuda --noconftest
    tests/test_torch_serving.py`` runs the CUDA-graph tests."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
deepspeed_tpu = _Lazy("deepspeed_tpu")
_jax_gpt2 = _Lazy("deepspeed_tpu.models.gpt2")
_jax_paged = _Lazy("deepspeed_tpu.serve.paged")
_jax_scheduler = _Lazy("deepspeed_tpu.serve.scheduler")

S, BS, MB, C = 4, 4, 8, 8          # slots, block size, table width, chunk
ML = MB * BS                       # 32
NB = 33                            # pool pages (1 null + 32)
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def models():
    jm = _jax_gpt2.GPT2Model(_jax_gpt2.GPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                       device="cpu"))
    return jm, jp, tm


def _pools(seed=0):
    rng = np.random.RandomState(seed)
    shape = (DIMS["n_layer"], NB, BS, DIMS["n_head"], DIMS["n_embd"] // DIMS["n_head"])
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _both(models, use_pallas=False):
    jm, jp, tm = models
    geo = dict(num_slots=S, block_size=BS, max_blocks=MB, prefill_chunk=C)
    return (_jax_paged.build_paged_programs(jm, **geo), jp,
            build_paged_programs(tm, use_pallas=use_pallas, **geo), serving_params(tm))


def test_params_from_jax_keeps_names_and_layout(models):
    jm, jp, tm = models
    names = dict(tm.named_parameters())
    assert len(names) == 4 + 12 * DIMS["n_layer"]
    np.testing.assert_array_equal(names["blocks.1.attn.c_attn_w"].detach().numpy(),
                                  np.asarray(jp["blocks"][1]["attn"]["c_attn_w"]))
    assert tuple(names["blocks.0.mlp.c_fc_w"].shape) == (16, 64)       # [in, out]


def test_init_scheme_matches_jax_statistics():
    """Same scheme as the JAX init: normal(0.02) weights, output projections
    at 0.02 / sqrt(2 n_layer), LayerNorm ones/zeros, zero biases."""
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=4,
                     n_head=4, compute_dtype=torch.float32)
    m = GPT2Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert abs(p["wte"].std().item() - 0.02) < 1e-3
    assert abs(p["blocks.2.mlp.c_proj_w"].std().item() - 0.02 / np.sqrt(8)) < 5e-4
    assert torch.equal(p["blocks.3.ln_2.scale"], torch.ones(64))
    assert torch.equal(p["blocks.0.attn.c_attn_b"], torch.zeros(192))
    q = GPT2Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)                   # seeded


@pytest.mark.parametrize("n_prompt", [C, C + 5])
def test_prefill_chunks_match_jax_gather_path(models, n_prompt):
    """One full chunk, and a two-chunk prompt whose second chunk is padded."""
    jprog, jp, tprog, tp = _both(models)
    kp, vp = _pools()
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    prompt = np.random.RandomState(1).randint(0, 64, size=n_prompt)
    table = np.zeros(MB, np.int32)
    table[:4] = [5, 9, 2, 17]
    for pos in range(0, n_prompt, C):
        n = min(C, n_prompt - pos)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[pos:pos + n]
        jl, jk, jv = jprog["prefill_chunk"](jp, jnp.asarray(toks), jnp.int32(pos),
                                            jnp.int32(n), jnp.asarray(table), jk, jv)
        tl = tprog["prefill_chunk"](tp, torch.from_numpy(toks), pos, n,
                                    torch.from_numpy(table), tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)


# float16 (fault C2: float16 pools): the activations round to float16 at
# every layer, the two frameworks at different points, and the kernel's plain
# version keeps the softmax weights in float32 where the gather path rounds
# them: a few float16 ulps (2.4e-4 at 0.25) of logits of about 0.26 and of the
# new pool rows.
@pytest.mark.parametrize("use_pallas,dtype,atol", [
    pytest.param(False, "float32", (1e-5, 1e-6), id="False"),
    pytest.param(True, "float32", (1e-5, 1e-6), id="True"),
    pytest.param(True, "float16", (1e-3, 1e-3), id="True-float16")])
def test_decode_step_matches_jax_gather_path(models, use_pallas, dtype, atol):
    jprog, jp, tprog, tp = _both(models, use_pallas=use_pallas)
    kp, vp = _pools(2)
    if dtype == "float16":
        jm, jp, tm = models
        jprog = _jax_paged.build_paged_programs(_jax_gpt2.GPT2Model(_jax_gpt2.GPT2Config(**DIMS, compute_dtype=jnp.float16,
                                                     loss_chunk=0)),
                          num_slots=S, block_size=BS, max_blocks=MB, prefill_chunk=C)
        tp = serving_params(tm, torch.float16)
        kp, vp = kp.astype(np.float16), vp.astype(np.float16)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 64, size=S).astype(np.int32)
    pos = np.asarray([0, 5, ML - 1, 17], np.int32)
    tables = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB).astype(np.int32)
    active = np.asarray([True, True, True, False])
    jl, jk, jv = jprog["decode_step"](jp, jnp.asarray(toks), jnp.asarray(pos),
                                      jnp.asarray(tables), jnp.asarray(active),
                                      jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    paged_decode_attention.launches = 0
    tl = tprog["decode_step"](tp, torch.from_numpy(toks), torch.from_numpy(pos),
                              torch.from_numpy(tables), torch.from_numpy(active), tk, tv)
    assert paged_decode_attention.launches == 0          # CPU: the plain version
    assert tk.dtype == getattr(torch, dtype) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol[0], rtol=0)
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk, np.float32), atol=atol[1],
                               rtol=0)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32), atol=atol[1],
                               rtol=0)


def test_copy_blocks_bitwise(models):
    jprog, _, tprog, _ = _both(models)
    kp, vp = _pools(4)
    src = np.asarray([3, 7, 0, 0], np.int32)
    dst = np.asarray([11, 12, 0, 0], np.int32)
    jk, jv = jprog["copy_blocks"](jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tprog["copy_blocks"](tk, tv, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _trace():
    """Greedy requests sharing a 9-token system prefix (prefix-cache hits),
    staggered arrivals, one beam-4 request with an EOS, two sampled ones."""
    rng = np.random.RandomState(7)
    system = rng.randint(0, 64, size=9).tolist()
    reqs = []
    for i in range(6):
        tail = rng.randint(0, 64, size=int(rng.randint(2, 12))).tolist()
        reqs.append((f"g{i}", system + tail, 6, dict(arrival=i // 2)))
    reqs.append(("beam", rng.randint(0, 64, size=9).tolist(), 6,
                 dict(num_beams=4, eos_token_id=5, arrival=1)))
    reqs.append(("temp", system + [3, 4], 7,
                 dict(temperature=0.8, top_k=10, seed=11, arrival=2)))
    reqs.append(("nucleus", rng.randint(0, 64, size=6).tolist(), 5,
                 dict(temperature=1.3, top_p=0.9, seed=12, arrival=3)))
    return reqs


@pytest.mark.parametrize("num_blocks,prefix_cache", [(33, False), (13, False),
                                                     (13, True), (33, True)])
def test_init_inference_matches_jax_engine(models, num_blocks, prefix_cache):
    """The whole slice on one trace: identical tokens, statuses, beam scores
    and schedule logs. ``num_blocks=13`` starves the pool into preemption."""
    jm, jp, tm = models
    cfg = {"serving": {"block_size": BS, "num_blocks": num_blocks, "max_seqs": S,
                       "max_model_len": ML, "prefill_chunk": C,
                       "prefix_cache": {"enabled": prefix_cache}}}
    trace = _trace()
    jeng = deepspeed_tpu.init_inference(jm, jp, config_params=cfg)
    teng = deepspeed_tpu_torch.init_inference(tm, config_params=cfg, device="cpu")
    jouts, jlogs = jeng.run([_jax_scheduler.Request(r, p, n, **kw) for r, p, n, kw in trace])
    touts, tlogs = teng.run([Request(r, p, n, **kw) for r, p, n, kw in trace])
    assert [o.status for o in touts] == ["finished"] * len(trace)
    assert [o.status for o in touts] == [o.status for o in jouts]
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert [o.preemptions for o in touts] == [o.preemptions for o in jouts]
    assert [o.finished_it for o in touts] == [o.finished_it for o in jouts]
    np.testing.assert_allclose([o.score or 0.0 for o in touts],
                               [o.score or 0.0 for o in jouts], atol=1e-5)
    assert json.dumps(tlogs) == json.dumps(jlogs)
    if num_blocks == 13:
        assert sum(o.preemptions for o in touts) > 0
    if prefix_cache:
        assert teng.prefix_cache.stats()["hit_tokens"] > 0
        assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()


def test_entry_points_refuse_to_fall_back_to_cpu(models):
    """No card and no device='cpu': the entry points raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tm = models
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(tm, config_params={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT2Model(GPT2Config(**DIMS))


@pytest.mark.parametrize("serving,error,match", [
    pytest.param({"speculation": {"enabled": True}}, ValueError,
                 "speculation.enabled needs a live draft model", id="serving0-speculation"),
    pytest.param({"sharding": {"model": 2}}, ValueError,
                 r"serving.sharding.model 2 exceeds 1 devices", id="serving1-sharding"),
    pytest.param({"request_trace": {"enabled": True, "capacity": 0}}, ValueError,
                 "request_trace.capacity must be", id="serving2-request_trace"),
])
def test_engine_refuses_later_slices(models, serving, error, match):
    """Head-sharded serving over more ranks than the world holds (one
    process here; tests/test_torch_serving_sharded.py serves at 2 gloo
    ranks), speculation without a live draft model and a request trace of
    capacity 0 are refused as the JAX package refuses them (ValueError)."""
    _, _, tm = models
    cfg = {"serving": dict({"block_size": BS, "num_blocks": NB, "max_seqs": S,
                            "max_model_len": ML, "prefill_chunk": C}, **serving)}
    with pytest.raises(error, match=match) as info:
        deepspeed_tpu_torch.init_inference(tm, config_params=cfg, device="cpu")
    assert type(info.value) is error


def test_engine_refuses_mirror_telemetry_and_warm_restart(models):
    """The mirror with the prefix cache and a snapshot of another geometry are
    refused with the JAX package's words; telemetry is accepted (the
    observatories slice); the lint programs (tests/test_torch_lint_programs.py
    checks them) and the memory manifest (tests/test_torch_hbm.py holds its
    bytes) are ported."""
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    _, _, tm = models
    geo = dict(num_slots=S, block_size=BS, num_blocks=NB, max_model_len=ML,
               prefill_chunk=C)
    with pytest.raises(ValueError, match="mirror cannot run with prefix_cache"):
        InferenceEngine(tm, mirror=True, prefix_cache=True, **geo)
    from deepspeed_tpu_torch.utils.telemetry import TelemetrySession
    import tempfile
    session = TelemetrySession(output_path=tempfile.mkdtemp(), job_name="t")
    assert InferenceEngine(tm, telemetry=session, **geo).telemetry is session
    session.close()
    eng = InferenceEngine(tm, **geo)
    assert [name for name, *_ in eng.lint_programs()] == [
        "serve_decode_step", "serve_prefill_chunk", "serve_copy_blocks"]
    assert set(eng.memory_manifest()["classes"]) == {"params", "kv_pool"}
    with pytest.raises(ValueError, match="geometry does not match"):
        eng.load_state_dict({"geometry": dict(eng.geometry(), num_blocks=NB + 1)})


@pytest.mark.parametrize("field", ["fused_block", "moe_experts", "sparse_attention"])
def test_model_refuses_later_slices(field):
    """MoE comes with a later slice. A sparse model is built (block-sparse
    attention is ported) but serving refuses it, as the JAX engine does. A
    ``fused_block`` model serves: the serving programs ignore the flag, as
    the JAX ones do, and give the unfused model's tokens."""
    cfg = {"serving": {"block_size": BS, "num_blocks": NB, "max_seqs": S,
                       "max_model_len": ML, "prefill_chunk": C}}
    if field == "moe_experts":
        with pytest.raises(NotImplementedError, match=field):
            GPT2Model(GPT2Config(**DIMS, **{field: 1}), device="cpu")
        return
    if field == "fused_block":
        outs = []
        for fused in (True, False):
            model = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32,
                                         fused_block=fused), device="cpu")
            model.init(torch.Generator().manual_seed(0))
            eng = deepspeed_tpu_torch.init_inference(model, config_params=cfg, device="cpu")
            outs.append(eng.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])[0])
        assert [o.status for o in outs[0]] == ["finished"] * len(outs[0])
        assert [o.tokens for o in outs[0]] == [o.tokens for o in outs[1]]
        return
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    model = GPT2Model(GPT2Config(**DIMS, sparse_attention=FixedSparsityConfig(
        num_heads=DIMS["n_head"], block=BS)), device="cpu")
    with pytest.raises(ValueError, match="dense attention only"):
        deepspeed_tpu_torch.init_inference(model, config_params=cfg, device="cpu")


# ------------------------------------------------------------ CUDA graphs
def _cuda_engine(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    model = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return InferenceEngine(model, use_pallas=True, num_slots=S, block_size=BS,
                           num_blocks=NB, max_model_len=ML, prefill_chunk=C, **kw)


def _step_inputs(seed):
    """A decode step's host inputs: toks, pos, tables, active."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, size=S).astype(np.int32),
            np.array([3, 9, 0, ML - 1], np.int32),
            rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB).astype(np.int32),
            np.array([True, True, False, True]))


def _on_card(*arrays):
    return [torch.as_tensor(a, device="cuda") for a in arrays]


def _run_eagerly(eng):
    """Swap the engine's captured programs for the same programs run op by op."""
    from deepspeed_tpu_torch.serve.paged import EagerProgram
    for attr, name in (("_decode", "decode_step"), ("_prefill", "prefill_chunk")):
        setattr(eng, attr, EagerProgram(eng._raw[name], name, eng._raw["inputs"][name],
                                        eng.params, eng.k_pool, eng.v_pool))


@pytest.mark.cuda
def test_cuda_graphs_replay_the_eager_programs_bit_for_bit():
    """Each program is captured once when the engine is built; a replay
    gives the eager program's logits and pool rows bit for bit on the same
    pools, and moves the paged-decode counters by one launch a layer."""
    eng = _cuda_engine()
    graphs = eng.graphs()
    assert set(graphs) == {"decode_step", "prefill_chunk"}
    assert [(g.captures, g.replays) for g in graphs.values()] == [(1, 0), (1, 0)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    eng.k_pool.normal_(generator=gen)
    eng.v_pool.normal_(generator=gen)
    for seed in range(3):
        args = _step_inputs(seed)
        k0, v0 = eng.k_pool.clone(), eng.v_pool.clone()
        want = eng._raw["decode_step"](eng.params, *_on_card(*args), k0, v0)
        paged_decode_attention.launches = paged_decode_attention.cluster_launches = 0
        got = eng._decode(eng.params, *args, eng.k_pool, eng.v_pool).clone()
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == DIMS["n_layer"]
        assert paged_decode_attention.cluster_launches == DIMS["n_layer"]
        assert torch.equal(got, want)
        assert torch.equal(eng.k_pool[:, 1:], k0[:, 1:])     # block 0: the pads'
        assert torch.equal(eng.v_pool[:, 1:], v0[:, 1:])
        pargs = (np.array([list(range(seed, seed + C))], np.int32),
                 np.int32(8 * seed), np.int32(C - seed), args[2][1])
        k0, v0 = eng.k_pool.clone(), eng.v_pool.clone()
        want = eng._raw["prefill_chunk"](eng.params, *_on_card(*pargs), k0, v0)
        got = eng._prefill(eng.params, *pargs, eng.k_pool, eng.v_pool).clone()
        assert torch.equal(got, want)
        assert torch.equal(eng.k_pool[:, 1:], k0[:, 1:])
    assert [(g.captures, g.replays) for g in graphs.values()] == [(1, 3), (1, 3)]
    with pytest.raises(ValueError, match="captured on other"):
        eng._decode(eng.params, *args, eng.k_pool.clone(), eng.v_pool)


@pytest.mark.cuda
def test_cuda_graphed_engine_serves_like_the_eager_one():
    """The whole trace through the graphs against the same engine driven by
    the eager programs: tokens and schedule logs identical, one replay a
    program execution; a speculative engine's three extra programs are
    captured once each and its tokens are the plain engine's; a warm
    restart copies into the live pools, so the graphs keep theirs."""
    graphed, eager = _cuda_engine(), _cuda_engine()
    _run_eagerly(eager)
    outs, logs = graphed.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])
    e_outs, e_logs = eager.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])
    assert [o.tokens for o in outs] == [o.tokens for o in e_outs]
    assert json.dumps(logs) == json.dumps(e_logs)
    g = graphed.graphs()
    assert g["decode_step"].replays == sum(1 for log in logs if log["decode"])
    assert g["prefill_chunk"].replays == sum(1 for log in logs if log["prefill"])

    spec = _cuda_engine(speculation={"enabled": True, "max_draft_tokens": 3,
                                     "draft_model": graphed.model})
    greedy = [(r, p, n, kw) for r, p, n, kw in _trace() if "temperature" not in kw]
    s_outs, _ = spec.run([Request(r, p, n, **kw) for r, p, n, kw in greedy])
    want = {o.req_id: o.tokens for o in outs}
    assert all(o.tokens == want[o.req_id] for o in s_outs)
    sg = spec.graphs()
    assert set(sg) == {"decode_step", "prefill_chunk", "spec_verify",
                       "spec_draft_decode", "spec_draft_prefill"}
    assert all(p.captures == 1 for p in sg.values())
    assert sg["spec_verify"].replays == spec.spec_summary()["spec_rounds"] > 0

    ptrs = (graphed.k_pool.data_ptr(), graphed.v_pool.data_ptr())
    state = eager.state_dict()
    graphed.load_state_dict(state)
    assert (graphed.k_pool.data_ptr(), graphed.v_pool.data_ptr()) == ptrs
    assert torch.equal(graphed.k_pool.cpu(), state["k_pool"])
