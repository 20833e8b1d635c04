"""GPT-2 ``generate`` and ``beam_search`` of the PyTorch port against the JAX
package, on the CPU.

One tiny float32 GPT-2 (vocab 64, 32 positions, width 16, 2 layers, 2 heads)
from the JAX init, carried over with ``params_from_jax``:

- greedy ``generate`` gives the JAX tokens;
- ``beam_search`` gives the JAX sequences, with scores within 1e-5, with
  and without EOS and at two length penalties;
- sampled ``generate`` is reproducible from one ``torch.Generator``, and
  every sampled token lies in the top-k / top-p set of its row;
- the port's serving engine gives ``generate``'s greedy tokens and
  ``beam_search``'s beam-4 sequence and score (the JAX package's own
  serving tests hold its engine to the same two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.serve.scheduler import Request

ML = 32
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _prompts(seed, B, T0):
    return np.random.RandomState(seed).randint(0, 64, size=(B, T0)).astype(np.int32)


def test_greedy_generate_matches_jax(models):
    jm, jp, tm = models
    prompts = _prompts(0, 3, 7)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompts), 12))
    got = tm.generate(torch.from_numpy(prompts), 12)
    assert got.dtype == torch.long and tuple(got.shape) == (3, 19)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eos,penalty", [(None, 1.0), (5, 1.0), (5, 0.6)])
def test_beam_search_matches_jax(models, eos, penalty):
    jm, jp, tm = models
    prompts = _prompts(1, 2, 6)
    want, wscores = jm.beam_search(jp, jnp.asarray(prompts), 10, num_beams=4,
                                   eos_token_id=eos, length_penalty=penalty)
    got, scores = tm.beam_search(torch.from_numpy(prompts), 10, num_beams=4,
                                 eos_token_id=eos, length_penalty=penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(wscores), atol=1e-5, rtol=0)


def _jax_nucleus(logits, top_p):
    """The JAX sampler's top-p keep mask (deepspeed_tpu/models/gpt2.py:804-815,
    line for line): a stable ascending argsort reversed, the exclusive mass
    before each token under ``top_p``, scattered back by sort position."""
    logits = jnp.asarray(logits)
    order = jnp.argsort(logits, axis=-1)[..., ::-1]
    sorted_logits = jnp.take_along_axis(logits, order, axis=-1)
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    kept_sorted = (jnp.cumsum(probs, axis=-1) - probs) < top_p
    inv = jnp.argsort(order, axis=-1)
    return np.asarray(jnp.take_along_axis(kept_sorted, inv, axis=-1))


def _kept(logits, temperature, top_k, top_p):
    """The boolean set a sampled token must lie in: the top-k set, then the
    JAX sampler's nucleus of what it leaves."""
    x = logits / temperature
    keep = torch.ones_like(x, dtype=torch.bool)
    if top_k:
        keep &= x >= torch.topk(x, top_k, dim=-1).values[..., -1:]
    if top_p < 1.0:
        masked = torch.where(keep, x, torch.full((), -np.inf)).detach()
        keep &= torch.from_numpy(_jax_nucleus(masked.numpy(), top_p))
    return keep


# rows with ties at the nucleus cutoff: of two equal logits JAX keeps the
# higher index first ([1, 1, 0] at top_p 0.3 keeps token 1 only)
_TIED_ROWS = [([1.0, 1.0, 0.0, -1.0], 0.3), ([0.5, 2.0, 2.0, 2.0], 0.2),
              ([0.5, 2.0, 2.0, 2.0], 0.5), ([3.0, 0.0, 3.0, 1.0], 0.45),
              ([0.0, 0.0, 0.0, 0.0], 0.6), ([-1.0, 2.0, -1.0, 2.0], 0.55)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nucleus_keep_matches_jax_sampler_on_ties(dtype):
    from deepspeed_tpu_torch.models.gpt2 import nucleus_keep
    rng = np.random.RandomState(3)
    rows = [(np.asarray(r, np.float32), p) for r, p in _TIED_ROWS]
    # integer logits over a few values: ties everywhere, cutoffs among them
    rows += [(rng.randint(-2, 3, size=16).astype(np.float32), p)
             for p in (0.1, 0.25, 0.4, 0.7, 0.9) for _ in range(4)]
    for row, top_p in rows:
        # the samplers' input: logits of the model's dtype over a float32
        # temperature (JAX's division promotes to float32; the port's casts)
        t = torch.from_numpy(row).to(getattr(torch, dtype)).float() / 1.0
        got = nucleus_keep(t[None], top_p)[0].numpy()
        x = jnp.asarray(row, dtype=getattr(jnp, dtype)) / jnp.float32(1.0)
        assert x.dtype == jnp.float32
        want = _jax_nucleus(x[None], top_p)[0]
        np.testing.assert_array_equal(got, want, err_msg=f"{row} top_p={top_p}")
    assert nucleus_keep(torch.tensor([[1.0, 1.0, 0.0]]), 0.3).tolist() == [[False, True, False]]


def test_generate_nucleus_keeps_the_jax_token_of_a_tie(models):
    """Every logit exactly 0 (zero token embeddings, which the LM head
    shares): the nucleus at a top_p under 1/vocab keeps one token, the JAX
    sampler's, so both packages' sampled ``generate`` give the same tokens
    whatever their generators."""
    jm, jp, tm = models
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    jp["wte"] = jnp.zeros_like(jp["wte"])
    tied = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    tied.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                         device="cpu"))
    prompts = _prompts(4, 2, 5)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompts), 6, temperature=1.0,
                                  rng=jax.random.PRNGKey(1), top_p=0.01))
    got = tied.generate(torch.from_numpy(prompts), 6, temperature=1.0,
                        generator=torch.Generator().manual_seed(1), top_p=0.01)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 5:] == DIMS["vocab_size"] - 1).all()


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (8, 0.7)])
def test_sampled_generate_is_seeded_and_truncated(models, top_k, top_p):
    _, _, tm = models
    prompts = torch.from_numpy(_prompts(2, 4, 5))
    kw = dict(temperature=1.3, top_k=top_k, top_p=top_p)
    a = tm.generate(prompts, 10, generator=torch.Generator().manual_seed(7), **kw)
    b = tm.generate(prompts, 10, generator=torch.Generator().manual_seed(7), **kw)
    c = tm.generate(prompts, 10, generator=torch.Generator().manual_seed(8), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    logits = tm(a)                                     # full forward: [B, T, V]
    for t in range(5, 15):
        keep = _kept(logits[:, t - 1], 1.3, top_k, top_p)
        assert keep.gather(1, a[:, t:t + 1]).all(), t
        assert (keep.sum(-1) < 64).all()               # the filter truncated


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=0), "max_new_tokens"), (dict(max_new_tokens=40), "n_positions"),
    (dict(temperature=1.0), "Generator"), (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p")])
def test_generate_refusals(models, kw, match):
    _, _, tm = models
    kw = dict(dict(max_new_tokens=4), **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(torch.zeros((1, 3), dtype=torch.long), **kw)


def test_engine_equals_generate_and_beam_search(models):
    _, _, tm = models
    cfg = {"serving": {"block_size": 4, "num_blocks": 33, "max_seqs": 4,
                       "max_model_len": ML, "prefill_chunk": 8}}
    eng = deepspeed_tpu_torch.init_inference(tm, config_params=cfg, device="cpu")
    prompts = _prompts(3, 3, 9)
    beam_prompt = _prompts(4, 1, 7)
    reqs = [Request(f"g{i}", prompts[i].tolist(), 8, arrival=i) for i in range(3)]
    reqs.append(Request("beam", beam_prompt[0].tolist(), 8, num_beams=4, eos_token_id=5))
    outs, _ = eng.run(reqs)
    want = tm.generate(torch.from_numpy(prompts), 8)[:, 9:]
    assert [o.tokens for o in outs[:3]] == want.tolist()
    seq, score = tm.beam_search(torch.from_numpy(beam_prompt), 8, num_beams=4,
                                eos_token_id=5)
    assert outs[3].tokens == seq[0, 7:].tolist()
    assert abs(outs[3].score - float(score[0])) <= 1e-5
