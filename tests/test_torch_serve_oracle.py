"""The dense-cache mirror of the PyTorch port against the JAX package, on
the CPU.

One tiny GPT-2 (vocab 64, 32 positions, width 16, 2 layers, 2 heads,
float32) from the JAX init, carried over with ``params_from_jax``:

- the oracle's ``prefill_chunk``, ``decode_step`` and ``reorder`` against
  the JAX oracle's on the same caches (the port's are token-major,
  ``[L, S + 1, ML, nh, hd]``; the JAX ones head-major): logits within 1e-5,
  caches within 1e-6;
- a ``mirror=True`` engine over greedy, beam-4 and sampled requests runs
  every prefill chunk and decode step bitwise against the oracle
  (``mirror_checks`` counts them), with the JAX mirror engine's tokens;
- the mirror's two refusals, in the JAX package's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.serve.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.serve.oracle import build_oracle_programs as jax_oracle
from deepspeed_tpu.serve.scheduler import Request as JaxRequest
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.serve.engine import InferenceEngine
from deepspeed_tpu_torch.serve.oracle import build_oracle_programs
from deepspeed_tpu_torch.serve.paged import serving_params
from deepspeed_tpu_torch.serve.scheduler import Request

S, C, ML = 4, 8, 32
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)
GEO = dict(num_slots=S, block_size=4, num_blocks=33, max_model_len=ML, prefill_chunk=C)


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _head_major(t):
    return t.numpy().transpose(0, 1, 3, 2, 4)


def test_oracle_programs_match_jax(models):
    jm, jp, tm = models
    geo = dict(num_slots=S, max_len=ML, prefill_chunk=C)
    jo, to = jax_oracle(jm, **geo), build_oracle_programs(tm, **geo)
    tp = serving_params(tm)
    jk, jv = jo["fresh_caches"]()
    tk, tv = to["fresh_caches"]()
    rng = np.random.RandomState(3)
    # two prompts into slots 1 and 2 (the second over two chunks, padded)
    for slot, n_prompt in ((1, 5), (2, C + 3)):
        prompt = rng.randint(0, 64, size=n_prompt)
        for pos in range(0, n_prompt, C):
            n = min(C, n_prompt - pos)
            toks = np.zeros((1, C), np.int32)
            toks[0, :n] = prompt[pos:pos + n]
            jl, jk, jv = jo["prefill_chunk"](jp, jnp.asarray(toks), jnp.int32(pos),
                                             jnp.int32(n), jnp.int32(slot), jk, jv)
            tl = to["prefill_chunk"](tp, torch.from_numpy(toks), pos, n, slot, tk, tv)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for step in range(3):
        toks = rng.randint(0, 64, size=S).astype(np.int32)
        pos = np.asarray([0, 5 + step, C + 3 + step, 0], np.int32)
        active = np.asarray([False, True, True, False])
        jl, jk, jv = jo["decode_step"](jp, jnp.asarray(toks), jnp.asarray(pos),
                                       jnp.asarray(active), jk, jv)
        tl = to["decode_step"](tp, torch.from_numpy(toks), torch.from_numpy(pos),
                               torch.from_numpy(active), tk, tv)
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   atol=1e-5, rtol=0)
    perm = np.asarray([0, 2, 2, 1], np.int32)
    jk, jv = jo["reorder"](jk, jv, jnp.asarray(perm))
    to["reorder"](tk, tv, torch.from_numpy(perm))
    # the slots' caches (the null slot S takes the pads' writes in no fixed order)
    np.testing.assert_allclose(_head_major(tk)[:, :S], np.asarray(jk)[:, :S], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(_head_major(tv)[:, :S], np.asarray(jv)[:, :S], atol=1e-6,
                               rtol=0)


def _trace():
    rng = np.random.RandomState(11)
    reqs = [(f"g{i}", rng.randint(0, 64, size=int(rng.randint(3, 14))).tolist(), 6,
             dict(arrival=i)) for i in range(4)]
    reqs.append(("beam", rng.randint(0, 64, size=9).tolist(), 6,
                 dict(num_beams=4, eos_token_id=5, arrival=1)))
    reqs.append(("temp", rng.randint(0, 64, size=7).tolist(), 5,
                 dict(temperature=0.9, top_k=8, seed=3, arrival=2)))
    return reqs


@pytest.mark.parametrize("num_blocks", [33, 13])
def test_mirror_engine_is_bitwise_with_jax_tokens(models, num_blocks):
    """``num_blocks=13`` starves the pool into preemption and CoW copies."""
    jm, jp, tm = models
    geo = dict(GEO, num_blocks=num_blocks)
    teng = InferenceEngine(tm, mirror=True, **geo)
    jeng = JaxEngine(jm, jp, mirror=True, **geo)
    touts, tlogs = teng.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])
    jouts, jlogs = jeng.run([JaxRequest(r, p, n, **kw) for r, p, n, kw in _trace()])
    assert [o.status for o in touts] == ["finished"] * len(touts)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    chunks = sum(1 for log in tlogs if log["prefill"] is not None)
    steps = sum(1 for log in tlogs if log["decode"])
    assert teng.mirror_checks == chunks + steps == jeng.mirror_checks > 0


@pytest.mark.parametrize("kw,words", [
    (dict(prefix_cache=True), "mirror cannot run with prefix_cache: a warm start "
     "skips prefill chunks"),
    (dict(speculation={"enabled": True, "max_draft_tokens": 2}),
     "mirror asserts bitwise identity against the dense oracle; the K\\+1-wide "
     "spec_verify program")])
def test_mirror_refusals(models, kw, words):
    jm, jp, tm = models
    if "speculation" in kw:
        kw = dict(speculation=dict(kw["speculation"], draft_model=tm))
        with pytest.raises(ValueError, match=words):
            JaxEngine(jm, jp, mirror=True, **GEO, speculation=dict(
                kw["speculation"], draft_model=jm, draft_params=jp))
    else:
        with pytest.raises(ValueError, match=words):
            JaxEngine(jm, jp, mirror=True, **GEO, **kw)
    with pytest.raises(ValueError, match=words):
        InferenceEngine(tm, mirror=True, **GEO, **kw)
