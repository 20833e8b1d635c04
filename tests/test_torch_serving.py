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
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.serve.paged import build_paged_programs as jax_build
from deepspeed_tpu.serve.scheduler import Request as JaxRequest
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention
from deepspeed_tpu_torch.serve.paged import build_paged_programs, serving_params
from deepspeed_tpu_torch.serve.scheduler import Request

S, BS, MB, C = 4, 4, 8, 8          # slots, block size, table width, chunk
ML = MB * BS                       # 32
NB = 33                            # pool pages (1 null + 32)
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
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
    return (jax_build(jm, **geo), jp,
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
        jprog = jax_build(JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float16,
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
    jouts, jlogs = jeng.run([JaxRequest(r, p, n, **kw) for r, p, n, kw in trace])
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


@pytest.mark.parametrize("serving,match", [
    ({"speculation": {"enabled": True}}, "speculation"),
    ({"sharding": {"model": 2}}, "sharding"),
    ({"request_trace": {"enabled": True}}, "request_trace"),
])
def test_engine_refuses_later_slices(models, serving, match):
    _, _, tm = models
    cfg = {"serving": dict({"block_size": BS, "num_blocks": NB, "max_seqs": S,
                            "max_model_len": ML, "prefill_chunk": C}, **serving)}
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.init_inference(tm, config_params=cfg, device="cpu")


def test_engine_refuses_mirror_telemetry_and_warm_restart(models):
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    _, _, tm = models
    geo = dict(num_slots=S, block_size=BS, num_blocks=NB, max_model_len=ML,
               prefill_chunk=C)
    with pytest.raises(NotImplementedError, match="mirror"):
        InferenceEngine(tm, mirror=True, **geo)
    with pytest.raises(NotImplementedError, match="telemetry"):
        InferenceEngine(tm, telemetry=object(), **geo)
    eng = InferenceEngine(tm, **geo)
    for call in (eng.state_dict, eng.lint_programs, eng.memory_manifest,
                 lambda: eng.load_state_dict({})):
        with pytest.raises(NotImplementedError):
            call()


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
