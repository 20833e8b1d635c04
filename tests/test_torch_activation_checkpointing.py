"""Activation checkpointing of the PyTorch port against the JAX package, on the CPU.

The cases of ``tests/unit/test_activation_checkpointing.py`` and
``tests/unit/test_remat_policies.py`` on the port's
``runtime/activation_checkpointing/checkpointing.py`` (the configuration
layer, the policies' decisions, the width-signature refusals, the RNG API),
and the remat GPT-2 against the JAX one: a tiny GPT-2 (vocab 64, width 32,
2 layers, float32) from the JAX init, ``remat=True`` under each named policy
on the flash path and ``"dots"`` on the dense, block-sparse and fused-block
paths, has the JAX model's loss and gradients within 1e-5 (the fused block
within its own file's bound, 1e-3 relative + 1e-5: both backward passes
differentiate a reference of their own); what each policy keeps of a block's
products has the shapes of the JAX block's dot residuals; with dropout the
remat model's loss and gradients equal the model's without remat bit for
bit. An autouse fixture resets the module's global configuration around
every test.
"""

import linecache
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JaxFixed
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jckpt
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckpt

POLICIES = [None, "dots", "attn", "dots+attn", "flash", "dots+attn-lean"]
DIMS = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=2)
B, T = 2, 16
E = 8
MM = torch.ops.aten.mm.default
ADDMM = torch.ops.aten.addmm.default


@pytest.fixture(autouse=True)
def _reset():
    ckpt.reset()
    yield
    ckpt.reset()


def _kept(monkeypatch, fn, *args, policy=None):
    """(op name, output shape) of each product that ``checkpoint_wrapper(fn,
    policy)(*args)`` keeps beyond its inputs, in forward order (what
    ``jax.ad_checkpoint.saved_residuals`` lists for the JAX one), and
    (op name, None) of each other op it keeps: the policy's forward
    decisions, read through torch's selective-checkpoint contexts."""
    kept = []
    contexts = ckpt.create_selective_checkpoint_contexts

    def recording(pol):
        def policy_fn(ctx, op, *a, **k):
            decision = pol(ctx, op, *a, **k)
            if not ctx.is_recompute and decision == CheckpointPolicy.MUST_SAVE:
                shape = ((a[-2].shape[0], a[-1].shape[1]) if op in (MM, ADDMM) else None)
                kept.append((str(op), shape))
            return decision
        return contexts(policy_fn)

    monkeypatch.setattr(ckpt, "create_selective_checkpoint_contexts", recording)
    ckpt.checkpoint_wrapper(fn, policy)(*args)
    return kept


# --------------------------------------------------------------- the module

def _block(x, w):
    return torch.tanh(x @ w) @ w.t()


def _grads(fn, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(8, 16, generator=g, requires_grad=True)
    w = (torch.randn(16, 16, generator=g) * 0.1).requires_grad_()
    torch.sum(fn(x, w) ** 2).backward()
    return x.grad, w.grad


def test_checkpoint_grad_parity():
    ckpt.configure()
    for r, g in zip(_grads(_block), _grads(ckpt.checkpoint_wrapper(_block))):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=0)


def test_checkpoint_call_style():
    x, w = torch.randn(8, 16), torch.randn(16, 16)
    torch.testing.assert_close(ckpt.checkpoint(_block, x, w), _block(x, w), rtol=0, atol=0)


def test_cpu_checkpointing_grad_parity(monkeypatch):
    ckpt.configure(checkpoint_in_cpu=True)
    assert ckpt.is_configured() and ckpt.cpu_checkpointing_enabled()
    packed = []

    class Recording(torch.autograd.graph.save_on_cpu):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pack = self.pack_hook
            self.pack_hook = lambda t: packed.append(tuple(t.shape)) or pack(t)

    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", Recording)
    got = _grads(ckpt.checkpoint_wrapper(_block, policy="dots"))
    for r, g in zip(_grads(_block), got):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=0)
    # the region's inputs went to host memory, and the offload overrides the
    # policy: full remat, nothing of the region kept
    assert packed == [(8, 16), (16, 16)]
    x, w = torch.ones(8, 16, requires_grad=True), torch.ones(16, 16)
    assert _kept(monkeypatch, _block, x, w, policy="dots") == []


def test_partition_activations_is_a_no_op_at_model_axis_1():
    ckpt.configure(partition_activations=True, mesh={"data": 1, "model": 1})
    for r, g in zip(_grads(_block), _grads(ckpt.checkpoint_wrapper(_block))):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # a model axis above 1 partitions over the model group, which a mapping
    # of sizes lacks (tests/test_torch_tensor_parallel.py runs it over gloo)
    ckpt.configure(mesh={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="needs the model group"):
        _grads(ckpt.checkpoint_wrapper(_block))


def test_set_default_mesh_never_overrides_an_explicit_one():
    ckpt.set_default_mesh({"data": 4, "model": 1})
    # a mapping of sizes is kept as a Mesh of those sizes
    assert ckpt._config["mesh"].shape["data"] == 4 and not ckpt.is_configured()
    ckpt.configure(mesh={"data": 2, "model": 1})
    ckpt.set_default_mesh({"data": 8, "model": 1})
    assert ckpt._config["mesh"].shape["data"] == 2


def test_configure_from_deepspeed_config():
    cfg = deepspeed_tpu_torch.DeepSpeedConfig(
        {"train_batch_size": 8,
         "activation_checkpointing": {"partition_activations": True,
                                      "cpu_checkpointing": True,
                                      "number_checkpoints": 4,
                                      "contiguous_memory_optimization": True,
                                      "synchronize_checkpoint_boundary": True,
                                      "profile": True}},
        world_size=1)
    ckpt.configure(deepspeed_config=cfg)
    assert ckpt._config["partition_activations"] is True
    assert ckpt._config["cpu_checkpointing"] is True
    assert ckpt._config["number_checkpoints"] == 4
    assert ckpt._config["contiguous_memory_optimization"] is True
    assert ckpt._config["synchronize"] is True
    assert ckpt._config["profile"] is True


def test_profile_mode_records_its_range():
    ckpt.configure(profile=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _grads(ckpt.checkpoint_wrapper(_block))
    assert all(torch.isfinite(g).all() for g in got)
    assert any(e.key == "ds_activation_checkpoint" for e in prof.key_averages())


def test_rng_tracker_streams():
    tracker = ckpt.get_rng_tracker()
    tracker.reset()
    tracker.add("model-parallel-rng", 42)
    a = torch.rand(4, generator=tracker.fork())
    b = torch.rand(4, generator=tracker.fork())
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        tracker.add("model-parallel-rng", 1)
    with pytest.raises(KeyError):
        tracker.fork("nope")
    # replay determinism: same seed, same stream
    tracker.reset()
    tracker.add("model-parallel-rng", 42)
    torch.testing.assert_close(torch.rand(4, generator=tracker.fork()), a, rtol=0, atol=0)
    states = tracker.get_states()
    tracker.fork()
    tracker.set_states(states)
    torch.testing.assert_close(torch.rand(4, generator=tracker.fork()), b, rtol=0, atol=0)


def test_model_parallel_manual_seed_parity_api():
    ckpt.model_parallel_cuda_manual_seed(1234)
    t = ckpt.get_cuda_rng_tracker()
    assert t is ckpt.get_rng_tracker()
    assert set(t.get_states()) == {"model-parallel-rng", "data-parallel-rng"}
    # model axis 1: every rank draws the base stream
    a = torch.rand(3, generator=ckpt.model_parallel_seed(7))
    torch.testing.assert_close(torch.rand(3, generator=torch.Generator().manual_seed(7)), a,
                               rtol=0, atol=0)


# --------------------------------------------------------------- the policies

def _decide(pol, lhs_shape, rhs_shape):
    return pol.saves(MM, (torch.ones(lhs_shape), torch.ones(rhs_shape)))


def test_flash_policy_saves_named_attention_residuals():
    pol = ckpt._FlashPolicy()
    x = torch.ones(2)
    assert pol.saves(ckpt._TAG, (x, "attn_out"))
    assert pol.saves(ckpt._TAG, (x, "attn_lse"))
    assert not pol.saves(ckpt._TAG, (x, "other"))
    assert pol.saves(fa.FLASH_FWD_OP, (x, x, x, None, True, 1.0, 0.0, 0, 0, 0))
    # "dots" keeps no attention output, so the flash forward is replayed
    assert not ckpt.named_policy("dots").saves(fa.FLASH_FWD_OP, (x,))
    assert ckpt.named_policy("attn").saves(fa.FLASH_FWD_OP, (x,))
    assert not ckpt.named_policy("attn").saves(MM, (torch.ones(4, E), torch.ones(E, E)))


@pytest.mark.parametrize("exclude,keep_qkv,qkv,square,fc,head", [
    # 'flash': drop the fused-qkv save, keep everything else
    ("qkv", False, False, True, True, True),
    # 'dots+attn-lean': keep qkv, drop the square attention projection
    ("square", True, True, False, True, True),
])
def test_flash_policy_width_signatures(exclude, keep_qkv, qkv, square, fc, head):
    pol = ckpt._FlashPolicy(exclude=exclude, keep_qkv=keep_qkv)
    assert _decide(pol, (4, E), (E, 3 * E)) == qkv        # fused qkv [E, 3E]
    assert _decide(pol, (4, E), (E, E)) == square          # attn proj [E, E]
    assert _decide(pol, (4, E), (E, 4 * E)) == fc          # mlp fc [E, 4E]
    assert _decide(pol, (4, 4 * E), (4 * E, E)) == head    # mlp proj [4E, E]
    # addmm(bias, lhs, rhs) is classified by its two matrices
    assert pol.saves(torch.ops.aten.addmm.default,
                     (torch.ones(3 * E), torch.ones(4, E), torch.ones(E, 3 * E))) == qkv


def test_flash_policy_refuses_colliding_qkv_widths():
    pol = ckpt._FlashPolicy(exclude="qkv", keep_qkv=False)
    assert not _decide(pol, (4, E), (E, 3 * E))
    with pytest.raises(ValueError, match="width-signature collision"):
        _decide(pol, (4, 2 * E), (2 * E, 6 * E))


def test_flash_policy_refuses_foreign_square_projection():
    pol = ckpt._FlashPolicy(exclude="square", keep_qkv=True)
    assert _decide(pol, (4, E), (E, 3 * E))  # establishes embed width E
    with pytest.raises(ValueError, match="MoE/router square"):
        _decide(pol, (4, 2 * E), (2 * E, 2 * E))


def test_flash_policy_collision_raises_through_wrapper():
    w_qkv = torch.ones(E, 3 * E, requires_grad=True)
    w_moe = torch.ones(2 * E, 2 * E, requires_grad=True)

    def block(x):
        h = x @ w_qkv                        # fused-qkv signature: embed width E
        r = torch.ones(4, 2 * E) @ w_moe     # square at 2E: not the attn out proj
        return h.sum() + r.sum()

    fn = ckpt.checkpoint_wrapper(block, policy="dots+attn-lean")
    with pytest.raises(ValueError, match="width-signature collision"):
        fn(torch.ones(4, E, requires_grad=True)).backward()


def test_wrapper_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat policy"):
        ckpt.checkpoint_wrapper(lambda x: x, policy="not-a-policy")(torch.ones(2))


@pytest.mark.parametrize("name", ["dots", "attn", "dots+attn", "flash", "dots+attn-lean",
                                  None, "callable"])
def test_all_named_policies_differentiate(name):
    w = torch.full((4, 4), 0.3)
    policy = ((lambda ctx, op, *a, **k: op is MM) if name == "callable" else name)

    def block(x):
        return torch.tanh(x @ w).sum()

    x = torch.arange(4.0).reshape(1, 4).requires_grad_()
    block(x).backward()
    g_ref, x.grad = x.grad, None
    ckpt.checkpoint_wrapper(block, policy=policy)(x).backward()
    torch.testing.assert_close(x.grad, g_ref, rtol=0, atol=0)


def _dot_decisions(pol, steps):
    """Feed announcements and products to the policy in order (they are
    stateful); return the products' decisions."""
    pol.begin()
    out = []
    for step in steps:
        if step[0] == "tag":
            pol.announce(step[1], ckpt._rows(torch.ones(step[2])))
        else:
            out.append(_decide(pol, step[1], step[2]))
    return out


def test_flash_policy_tag_gated_qkv_exclusion():
    """Announced products classify by tag, and the width heuristic is off in
    a tagged run: an untagged product with a colliding qkv signature keeps
    its save and raises nothing."""
    pol = ckpt._FlashPolicy(exclude="qkv", keep_qkv=False)
    decisions = _dot_decisions(pol, [("tag", "qkv", (4, E)), ("mm", (4, E), (E, 3 * E)),
                                     ("mm", (4, 2 * E), (2 * E, 6 * E))])
    assert decisions == [False, True]


def test_flash_policy_tag_gated_proj_exclusion():
    pol = ckpt._FlashPolicy(exclude="square", keep_qkv=True)
    decisions = _dot_decisions(pol, [("tag", "qkv", (4, E)), ("mm", (4, E), (E, 3 * E)),
                                     ("tag", "proj", (4, E)), ("mm", (4, E), (E, E)),
                                     ("mm", (4, 2 * E), (2 * E, 2 * E))])
    assert decisions == [True, False, True]


@pytest.mark.parametrize("name", ["dots", "dots+attn", "flash", "dots+attn-lean", "callable"])
def test_announced_last_product_is_never_kept(name):
    """The block's last product (``ds_dot:mlp_proj``) is recomputed under
    every policy that keeps products, a caller's included; the product
    before it keeps its save."""
    pol = ckpt.named_policy((lambda ctx, op, *a, **k: op is MM) if name == "callable"
                            else name)
    pol.begin()
    pol.announce("mlp_proj", ckpt._rows(torch.ones(4, 4 * E)))
    assert pol(None, MM, torch.ones(4, E), torch.ones(E, 4 * E)) == CheckpointPolicy.MUST_SAVE
    assert (pol(None, MM, torch.ones(4, 4 * E), torch.ones(4 * E, E))
            == CheckpointPolicy.PREFER_RECOMPUTE)


def test_tagged_block_with_foreign_square_differentiates():
    w_qkv = torch.full((E, 3 * E), 0.1)
    w_proj = torch.full((E, E), 0.1)
    w_moe = torch.full((2 * E, 2 * E), 0.1)

    def block(x):
        t = ckpt.checkpoint_name(x, "ds_dot:qkv")
        h = torch.tanh(t @ w_qkv)
        u = ckpt.checkpoint_name(x, "ds_dot:proj")
        p = torch.tanh(u @ w_proj)
        r = torch.ones(4, 2 * E) @ w_moe
        return h.sum() + p.sum() + r.sum()

    x = (torch.arange(4.0 * E).reshape(4, E) * 0.01).requires_grad_()
    block(x).backward()
    g_ref, x.grad = x.grad, None
    ckpt.checkpoint_wrapper(block, policy="dots+attn-lean")(x).backward()
    torch.testing.assert_close(x.grad, g_ref, rtol=0, atol=0)


def test_tags_outside_a_region_are_the_identity():
    x = torch.ones(3)
    assert ckpt.checkpoint_name(x, "attn_out") is x
    assert ckpt.checkpoint_name(x, "ds_dot:qkv") is x


def test_gpt2_attention_emits_ds_dot_tags(monkeypatch):
    seen = []
    announce = ckpt._FlashPolicy.announce
    monkeypatch.setattr(ckpt._FlashPolicy, "announce",
                        lambda self, cls, rows: seen.append(cls) or announce(self, cls, rows))
    tm = GPT2Model(GPT2Config(**dict(DIMS, n_layer=1), compute_dtype=torch.float32,
                              remat=True, remat_policy="flash"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros(1, T, dtype=torch.long)
    tm(tokens, tokens)
    assert seen == ["qkv", "proj", "mlp_proj"]


# --------------------------------------------------------------- GPT-2 against JAX

SPARSE = dict(num_heads=2, block=16, num_local_blocks=2, num_global_blocks=1,
              attention="unidirectional")


def _models(path, policy, remat=True):
    over = {"flash": dict(use_flash_attention=True), "dense": {},
            "fused": dict(fused_block=True)}.get(path, {})
    T_ = 64 if path == "sparse" else T
    jover = dict(over, sparse_attention=JaxFixed(**SPARSE)) if path == "sparse" else over
    tover = (dict(over, sparse_attention=FixedSparsityConfig(**SPARSE)) if path == "sparse"
             else over)
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0,
                                    remat=remat, remat_policy=policy, **jover))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0,
                              remat=remat, remat_policy=policy, **tover), device="cpu")
    tm.load_parameters(params_from_jax(jp, device="cpu"))
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, DIMS["vocab_size"], size=(B, T_)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    return jm, jp, tm, tokens, labels


@pytest.mark.parametrize("path,policy",
                         [("flash", p) for p in POLICIES]
                         + [("dense", "dots"), ("sparse", "dots"), ("fused", "dots")])
def test_remat_gpt2_matches_jax(path, policy):
    jm, jp, tm, tokens, labels = _models(path, policy)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.apply))(jp, jnp.asarray(tokens),
                                                         jnp.asarray(labels))
    loss = tm(torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    rtol = 1e-3 if path == "fused" else 0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=rtol, atol=1e-5,
                                   err_msg=name)


def _jax_dot_residual_shapes(jm, jp, policy, x):
    """(rows, width) of each JAX residual of one remat block made by a
    ``jnp.dot`` line of the JAX model (the arguments and named values
    aside)."""
    from jax._src.ad_checkpoint import saved_residuals
    f = lambda x, bp: jckpt.checkpoint_wrapper(jm._block, policy=policy)(x, bp)[0].sum()
    out = []
    for aval, desc in saved_residuals(f, jnp.asarray(x), jp["blocks"][0]):
        where = re.search(r"from (\S+\.py):(\d+):", desc)
        if where and "jnp.dot(" in linecache.getline(where.group(1), int(where.group(2))):
            out.append((int(np.prod(aval.shape[:-1])), aval.shape[-1]))
    return sorted(out)


@pytest.mark.parametrize("path", ["flash", "dense"])
@pytest.mark.parametrize("policy", POLICIES)
def test_saved_products_match_jax_dot_residuals(path, policy, monkeypatch):
    jm, jp, tm, _, _ = _models(path, policy)
    x = np.random.RandomState(2).standard_normal((B, T, DIMS["n_embd"])).astype(np.float32)
    want = _jax_dot_residual_shapes(jm, jp, policy, x)
    xt = torch.from_numpy(x).requires_grad_()
    kept = _kept(monkeypatch, tm._block, xt, tm.params_tree()["blocks"][0], policy=policy)
    got = sorted((int(np.prod(s[:-1])), s[-1]) for op, s in kept
                 if op in ("aten.mm.default", "aten.addmm.default"))
    assert got == want, (kept, want)
    if policy == "dots":
        # fused qkv, output projection, MLP fc; the MLP's second product
        # feeds only the residual, so no backward needs it
        assert want == sorted([(B * T, 3 * DIMS["n_embd"]), (B * T, DIMS["n_embd"]),
                               (B * T, 4 * DIMS["n_embd"])])


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("policy", [None, "dots", "dots+attn"])
def test_dropout_under_remat_is_bit_identical(flash, policy):
    def run(remat):
        tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, dropout=0.2,
                                  use_flash_attention=flash, remat=remat,
                                  remat_policy=policy), device="cpu")
        tm.init(torch.Generator().manual_seed(0))
        rng = np.random.RandomState(3)
        tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], size=(B, T)))
        loss = tm(tokens, torch.roll(tokens, -1, 1), torch.Generator().manual_seed(11))
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in tm.named_parameters()}

    (l0, g0), (l1, g1) = run(False), run(True)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_engine_with_activation_checkpointing_block_trains():
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "steps_per_print": 1000, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": 2},
           "activation_checkpointing": {"cpu_checkpointing": True,
                                        "partition_activations": True}}
    tm = GPT2Model(GPT2Config(**DIMS, remat=True, remat_policy="dots"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, config_params=cfg, device="cpu")
    assert ckpt.is_configured() and ckpt.cpu_checkpointing_enabled()
    # the engine publishes its mesh: the world as one data axis
    assert ckpt._config["partition_activations"] and ckpt._config["mesh"] is engine.mesh
    assert engine.mesh.shape == {"pipe": 1, "data": 1, "model": 1}
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, DIMS["vocab_size"], size=(2, 17)))
    losses = []
    for _ in range(8):
        loss = engine(tokens[:, :-1], tokens[:, 1:])
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    assert engine.global_steps == 4 and losses[-1] < losses[0]
    # an engine whose config has no block leaves the configuration alone
    deepspeed_tpu_torch.initialize(model=GPT2Model(GPT2Config(**DIMS), device="cpu"),
                                   config_params={"train_batch_size": 1}, device="cpu")
    assert ckpt.cpu_checkpointing_enabled()
