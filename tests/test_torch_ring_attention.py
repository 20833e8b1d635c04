"""The sequence-parallel ring (``parallel/ring_attention.py``), the flash
kernels' segmented operand (``ops/flash_attention.py``), GPT-2 under
sequence parallelism and the engine's ``sequence_parallel`` block, against
the JAX package on the same seeded inputs.

In this process: the zigzag layout and the work accounting for n = 1-8; the
segmented ``flash_attention_with_lse`` (the plain version) against JAX's
segmented call in interpret mode (out, lse, q/k/v grads, float32 within
1e-5); the segmented keep mask bit for bit against JAX's
``dropout_keep_reference`` at the global T; the refusals.

One spawn of 2 gloo ranks (one thread a rank, rendezvous through a
``file://`` store) runs every case at data = 2 and saves what it computed;
the JAX side runs on 2 of the 8 virtual devices (``build_mesh(data=2)``):
``ring_attention_sharded`` (zigzag, masked, non-causal; with and without
dropout; float32 within 1e-5, bf16 within 1e-2); GPT-2's
``sequence_parallel_loss_fn`` loss and grads with labels of -100 weighted
over the whole sequence; the engine with the ``sequence_parallel`` block at
ZeRO 0 (float32) and ZeRO 2 (bf16) against JAX's engine with the same block;
the ring's exchanges a step, equal for both schedules; the module called on
the whole sequence outside the loss function, which is the dense model.

JAX is imported inside the tests, so the spawned workers import only torch.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.parallel import ring_attention as ra

N = 2                                   # ranks of the ring
B, H, T, D = 1, 2, 32, 16               # ring-op shapes (global T)
RING_CASES = [  # (causal, schedule, rate, dtype)
    (True, "zigzag", 0.0, "float32"),
    (True, "zigzag", 0.2, "float32"),
    (True, "masked", 0.0, "float32"),
    (True, "masked", 0.2, "float32"),
    (False, "zigzag", 0.0, "float32"),
    (False, "zigzag", 0.2, "float32"),
    (True, "zigzag", 0.2, "bfloat16"),
]
RING_SEED = 4321
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GPT = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=2)
GPT_B, GPT_T = 2, 64
ENGINE_STEPS = 3
ENGINE_CASES = [(0, "float32"), (2, "bfloat16")]   # (ZeRO stage, compute dtype)


def _case_id(c):
    return f"{'causal' if c[0] else 'full'}-{c[1]}-{c[2]}-{c[3]}"


# ------------------------------------------------------------------ inputs
@functools.lru_cache(maxsize=None)
def _inputs():
    """Seeded numpy inputs and the JAX GPT-2 weights both sides take."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2 import GPT2Model as JModel
    rng = np.random.default_rng(0)
    out = {f"ring/{n}": rng.standard_normal((B, H, T, D)).astype(np.float32)
           for n in ("q", "k", "v", "g")}
    toks = rng.integers(0, GPT["vocab_size"], size=(GPT_B, GPT_T)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    labels[0, 3:19] = -100          # ignored labels unevenly over the ranks' slices
    out.update(tokens=toks, labels=labels)
    params = JModel(JConfig(**GPT, compute_dtype=jnp.float32)).init(jax.random.PRNGKey(1))
    out.update({f"params/{k}": v for k, v in _flat_jax(params).items()})
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    tree = _tree_from({k[len("params/"):]: v for k, v in out.items()
                       if k.startswith("params/")})
    out.update({f"port/{k}": v.numpy() for k, v in params_from_jax(tree, device="cpu").items()})
    return out


def _flat_jax(tree):
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree_from(flat):
    out = {}
    for k, v in flat.items():
        node, parts = out, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [listify(t[str(i)]) for i in range(len(t))]
            return {k: listify(v) for k, v in t.items()}
        return t
    return listify(out)


def _jax_params(inp):
    return _tree_from({k[len("params/"):]: v for k, v in inp.items() if k.startswith("params/")})


def _jax_mesh():
    import jax
    from deepspeed_tpu.parallel.mesh import build_mesh
    return build_mesh(data=N, model=1, pipe=1, devices=jax.devices()[:N])


def _engine_config(stage, compute):
    cfg = {"train_batch_size": N, "train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": 1, "steps_per_print": 1000,
           "sequence_parallel": {"enabled": True, "schedule": "zigzag"},
           "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": stage}}
    cfg["bf16"] = {"enabled": compute == "bfloat16"}
    return cfg


# ------------------------------------------------------------------ the ranks
def _worker(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            world_size=N, rank=rank)
    try:
        from deepspeed_tpu_torch.parallel.mesh import build_mesh
        inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        mesh = build_mesh()
        group = mesh.group("data")
        res = {}
        # the ring op: the whole output and the grads summed over the ranks
        for case in RING_CASES:
            causal, schedule, rate, dtype = case
            tag = _case_id(case)
            q, k, v = (torch.from_numpy(inp[f"ring/{n}"]).to(getattr(torch, dtype))
                       .requires_grad_() for n in "qkv")
            g = torch.from_numpy(inp["ring/g"])
            ra.rotate.exchanges = ra.rotate.bytes = 0
            out = ra.ring_attention_sharded(q, k, v, mesh, causal=causal,
                                            dropout_rate=rate,
                                            dropout_seed=RING_SEED if rate else None,
                                            schedule=schedule)
            (out.float() * g).sum().backward()
            res[f"{tag}/exchanges"] = np.asarray([ra.rotate.exchanges, ra.rotate.bytes])
            res[f"{tag}/out"] = out.detach().float().numpy()
            for n, t in zip("qkv", (q, k, v)):
                grad = t.grad.float().clone()
                dist.all_reduce(grad, group=group)
                res[f"{tag}/d{n}"] = grad.numpy()
        # GPT-2's loss function: loss, and the grads' mean over the ranks
        params = {k[len("port/"):]: torch.from_numpy(v) for k, v in inp.items()
                  if k.startswith("port/")}
        tokens, labels = torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["labels"])
        for schedule in ra.SCHEDULES:
            model = GPT2Model(GPT2Config(**GPT, compute_dtype=torch.float32), device="cpu")
            model.load_parameters(params)
            loss = model.sequence_parallel_loss_fn(mesh, "data", schedule)(tokens, labels)
            loss.backward()
            res[f"gpt2/{schedule}/loss"] = loss.detach().numpy()
            with torch.no_grad():       # outside the loss function the module is dense
                res[f"gpt2/{schedule}/module_loss"] = model(tokens, labels).numpy()
            for name, p in model.named_parameters():
                grad = p.grad.clone()
                dist.all_reduce(grad, group=group)
                res[f"gpt2/{schedule}/grad/{name}"] = grad.numpy() / N
        # dropout: the same generator seed gives the same loss, another seed
        # another loss, and the grads are finite
        model = GPT2Model(GPT2Config(**dict(GPT, dropout=0.2), compute_dtype=torch.float32),
                          device="cpu")
        model.load_parameters(params)
        fn = model.sequence_parallel_loss_fn(mesh)
        drop = [fn(tokens, labels, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
        drop[0].backward()
        res["gpt2/dropout/losses"] = np.asarray([float(x.detach()) for x in drop])
        res["gpt2/dropout/finite"] = np.asarray(all(
            bool(torch.isfinite(p.grad).all()) for p in model.parameters()))
        # the engine with the sequence_parallel block
        for stage, compute in ENGINE_CASES:
            model = GPT2Model(GPT2Config(**GPT, compute_dtype=getattr(torch, compute)),
                              device="cpu")
            eng, _, _, _ = deepspeed_tpu_torch.initialize(
                model=model, model_parameters=params, config_params=_engine_config(
                    stage, compute), device="cpu", dist_init_required=False)
            dense = GPT2Model(GPT2Config(**GPT, compute_dtype=getattr(torch, compute)),
                              device="cpu")
            dense.load_parameters(params)
            dense.to(next(eng.module.parameters()).dtype)
            with torch.no_grad():       # the engine's module called on the whole sequence
                res[f"engine/{stage}/module_loss"] = np.asarray(
                    [float(eng.module(tokens, labels)), float(dense(tokens, labels))])
            losses, norms = [], []
            for _ in range(ENGINE_STEPS):
                loss = eng(tokens, labels)
                eng.backward(loss)
                eng.step()
                losses.append(float(loss))
                norms.append(float(eng._last_grad_norm))
            res[f"engine/{stage}/losses"] = np.asarray(losses)
            res[f"engine/{stage}/norms"] = np.asarray(norms)
            res[f"engine/{stage}/dp"] = np.asarray(eng.dp_size)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ranks():
    out_dir = tempfile.mkdtemp(prefix="ring_gloo_")
    np.savez(os.path.join(out_dir, "inputs.npz"), **_inputs())
    mp.start_processes(_worker, args=(out_dir,), nprocs=N, start_method="spawn", join=True)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(N)]


# ------------------------------------------------------------------ JAX side
@functools.lru_cache(maxsize=None)
def _jax_ring(case):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.parallel.ring_attention import ring_attention_sharded
    causal, schedule, rate, dtype = case
    inp = _inputs()
    q, k, v = (jnp.asarray(inp[f"ring/{n}"]).astype(getattr(jnp, dtype)) for n in "qkv")
    g = jnp.asarray(inp["ring/g"])
    mesh = _jax_mesh()

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh, causal=causal, interpret=True,
                                     dropout_rate=rate,
                                     dropout_seed=RING_SEED if rate else None,
                                     schedule=schedule)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


@functools.lru_cache(maxsize=None)
def _jax_gpt2(schedule):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2 import GPT2Model as JModel
    inp = _inputs()
    model = JModel(JConfig(**GPT, compute_dtype=jnp.float32))
    fn = model.sequence_parallel_loss_fn(_jax_mesh(), "data", schedule=schedule)
    loss, grads = jax.jit(jax.value_and_grad(fn))(_jax_params(inp), jnp.asarray(inp["tokens"]),
                                                  jnp.asarray(inp["labels"]))
    return float(loss), _flat_jax(grads)


@functools.lru_cache(maxsize=None)
def _jax_engine(stage, compute):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2 import GPT2Model as JModel
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    inp = _inputs()
    mesh = _jax_mesh()
    model = JModel(JConfig(**GPT, compute_dtype=getattr(jnp, compute)))
    eng = DeepSpeedEngine(model=model, model_parameters=_jax_params(inp), mesh=mesh,
                          config_params=_engine_config(stage, compute))
    # the data axis carries the sequence: the batch is placed on dim 1
    spec = NamedSharding(mesh, P(None, "data"))
    toks = jax.device_put(jnp.asarray(inp["tokens"]), spec)
    labels = jax.device_put(jnp.asarray(inp["labels"]), spec)
    losses, norms = [], []
    for _ in range(ENGINE_STEPS):
        loss = eng(toks, labels)
        eng.backward(loss)
        eng.step()
        losses.append(float(jax.device_get(loss)))
        norms.append(float(eng._last_grad_norm))
    return np.asarray(losses), np.asarray(norms)


# ------------------------------------------------------------------ in this process
@pytest.mark.parametrize("n", range(1, 9))
def test_zigzag_layout_and_work_schedule_equal_jax(n):
    import importlib
    import jax.numpy as jnp
    # the module (the package exports a function of the same name)
    jra = importlib.import_module("deepspeed_tpu.parallel.ring_attention")
    x = np.arange(2 * 3 * 16 * n * 2, dtype=np.float32).reshape(2, 3, 16 * n, 2)
    got = ra.zigzag_shard(torch.from_numpy(x), n, axis=2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jra.zigzag_shard(jnp.asarray(x), n, axis=2)))
    np.testing.assert_array_equal(ra.zigzag_unshard(torch.from_numpy(got), n, axis=2).numpy(), x)
    assert ra._zigzag_chunk_order(n) == jra._zigzag_chunk_order(n)
    for schedule in ra.SCHEDULES:
        assert ra.ring_work_schedule(n, schedule) == jra.ring_work_schedule(n, schedule)


SEG_CASES = [  # (causal, rate, q_segments, k_segments): rank 1 of n = 2 at T 64 is (16, 32)
    (True, 0.0, (16, 32), (16, 32)),
    (True, 0.25, (16, 32), (16, 32)),
    (True, 0.25, (8, 40), (8, 40)),       # a half boundary inside a kernel tile
    (False, 0.25, (0, 48), None),         # one side segmented
    (False, 0.0, None, (32, 0))]


@pytest.mark.parametrize("causal,rate,q_seg,k_seg", SEG_CASES)
def test_segmented_flash_matches_jax(causal, rate, q_seg, k_seg):
    """The segmented call (the plain version, as the wrappers run it for CPU
    tensors) against JAX's segmented kernel in interpret mode: out, lse and
    the q, k, v grads under an lse cotangent, float32 within 1e-5."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse
    rng = np.random.default_rng(3)
    Tl = 32
    q, k, v, g = (rng.standard_normal((1, 2, Tl, 16)).astype(np.float32) for _ in range(4))
    g_lse = rng.standard_normal((1, 2, Tl)).astype(np.float32)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=77 if rate else None,
              q_segments=q_seg, k_segments=k_seg)

    def jloss(q, k, v):
        o, lse = flash_attention_with_lse(q, k, v, interpret=True, **kw)
        return jnp.sum(o * g) + jnp.sum(lse * g_lse), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, **kw)
    ((o * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), (o, lse, tq.grad, tk.grad, tv.grad),
                          (jo, jl, *jg)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_segmented_keep_mask_is_the_global_mask(n):
    """Each rank's segmented keep mask is JAX's ``dropout_keep_reference`` at
    the global T, taken at the rank's zigzag positions, bit for bit."""
    from deepspeed_tpu.ops.pallas.flash_attention import dropout_keep_reference
    Tg, rate, seed = 16 * n, 0.3, 99
    full = np.asarray(dropout_keep_reference(seed, 1, 2, Tg, Tg, rate))
    order = np.concatenate([np.arange(j * 8, (j + 1) * 8) for j in ra._zigzag_chunk_order(n)])
    for rank in range(n):
        seg = (rank * 8, (2 * n - 1 - rank) * 8)
        pos = fa._global_positions(16, fa._segments(0, seg, 16))
        np.testing.assert_array_equal(pos.numpy(), order[rank * 16:(rank + 1) * 16])
        got = fa._keep_mask(seed, 1, 2, 16, 16, rate, pos, pos).numpy()
        np.testing.assert_array_equal(got, full[:, :, pos.numpy()][:, :, :, pos.numpy()])


def test_refusals_name_their_reason():
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    mesh = build_mesh()
    with pytest.raises(ValueError, match="schedule"):
        GPT2Model(GPT2Config(**GPT), device="cpu").with_sequence_parallel(mesh, schedule="ring")
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    sparse = FixedSparsityConfig(num_heads=GPT["n_head"], block=16)
    with pytest.raises(ValueError, match="sparse_attention"):
        GPT2Model(GPT2Config(**GPT, sparse_attention=sparse),
                  device="cpu").with_sequence_parallel(mesh)
    with pytest.raises(NotImplementedError, match="item 14b"):
        GPT2Model(GPT2Config(**GPT, remat=True), device="cpu").with_sequence_parallel(mesh)
    with pytest.raises(NotImplementedError, match="A19"):
        GPT2Model(GPT2Config(**GPT, moe_experts=2), device="cpu")
    model = GPT2Model(GPT2Config(**GPT), device="cpu")
    with model.with_sequence_parallel(mesh):
        with pytest.raises(ValueError, match="manual TP"):
            model.with_tp(mesh)
        with pytest.raises(RuntimeError, match="twice"):
            with model.with_sequence_parallel(mesh):
                pass
    assert model._sp is None

    class _NoRing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def forward(self, x):
            return (self.w * x).sum()

    with pytest.raises(TypeError, match="sequence_parallel"):
        deepspeed_tpu_torch.initialize(
            model=_NoRing(), device="cpu",
            config_params={"train_batch_size": 1, "sequence_parallel": {"enabled": True},
                           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})


def test_one_rank_ring_is_the_flash_call():
    """A ring of one rank (no group) is the local causal flash call."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
               for _ in range(3))
    for schedule in ra.SCHEDULES:
        got = ra.ring_attention(q, k, v, None, causal=True, schedule=schedule)
        want = fa.flash_attention(q, k, v, causal=True)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(ra.ring_attention_sharded(q, k, v, None, causal=True,
                                                 schedule="zigzag"),
                       ra.ring_attention(ra.zigzag_shard(q, 1), ra.zigzag_shard(k, 1),
                                         ra.zigzag_shard(v, 1), None, causal=True))


# ------------------------------------------------------------------ the ranks' cases
@pytest.mark.parametrize("case", RING_CASES, ids=_case_id)
def test_ring_attention_sharded_matches_jax(case):
    """Each rank's whole output, and the grads summed over the ranks, against
    JAX's ``ring_attention_sharded`` at data = 2 (dropout hashed in global
    coordinates on both sides)."""
    ranks = _ranks()
    want = _jax_ring(case)
    tol = TOL[case[3]]
    tag = _case_id(case)
    for res in ranks:
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            got = res[f"{tag}/{name}"]
            scale = 1.0 if case[3] == "float32" else float(np.abs(w).max())
            np.testing.assert_allclose(got, w, rtol=0, atol=tol * scale,
                                       err_msg=f"{tag} {name}")


def test_ring_exchanges_equal_for_both_schedules():
    """One rotation a step each way at n = 2, k and v stacked into one
    exchange: the zigzag and masked rings move the same bytes (JAX's
    ``test_zigzag_ppermute_count_and_bytes_match_masked``)."""
    ranks = _ranks()
    kv_bytes = 2 * B * H * (T // N) * D * 4
    for res in ranks:
        zz = res[_case_id((True, "zigzag", 0.0, "float32")) + "/exchanges"]
        mk = res[_case_id((True, "masked", 0.0, "float32")) + "/exchanges"]
        assert list(zz) == list(mk) == [2 * (N - 1), 2 * (N - 1) * kv_bytes]


@pytest.mark.parametrize("schedule", ra.SCHEDULES)
def test_gpt2_sequence_parallel_loss_matches_jax(schedule):
    """The loss (labels of -100 weighted over the whole sequence) and the
    grads, mean over the ranks, against JAX's ``sequence_parallel_loss_fn``
    at data = 2, float32."""
    ranks = _ranks()
    loss, grads = _jax_gpt2(schedule)
    names = _names()
    for res in ranks:
        np.testing.assert_allclose(res[f"gpt2/{schedule}/loss"], loss, rtol=1e-5)
        for jname, pname in names.items():
            np.testing.assert_allclose(res[f"gpt2/{schedule}/grad/{pname}"], grads[jname],
                                       rtol=0, atol=1e-5, err_msg=pname)


def test_gpt2_sequence_parallel_dropout():
    ranks = _ranks()
    for res in ranks:
        a, b, c = res["gpt2/dropout/losses"]
        assert a == b and a != c and bool(res["gpt2/dropout/finite"])
    assert ranks[0]["gpt2/dropout/losses"][0] == ranks[1]["gpt2/dropout/losses"][0]


@pytest.mark.parametrize("stage,compute", ENGINE_CASES)
def test_engine_sequence_parallel_block_matches_jax(stage, compute):
    """The engine with ``sequence_parallel: {enabled, schedule: zigzag}`` at
    2 ranks, every rank passing the same batch, against JAX's engine with the
    same block: the losses and grad norms of each step."""
    ranks = _ranks()
    losses, norms = _jax_engine(stage, compute)
    tol = TOL[compute]
    for res in ranks:
        assert int(res[f"engine/{stage}/dp"]) == N
        np.testing.assert_allclose(res[f"engine/{stage}/losses"], losses, rtol=tol)
        np.testing.assert_allclose(res[f"engine/{stage}/norms"], norms, rtol=tol)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("stage,compute", ENGINE_CASES)
def test_module_outside_the_loss_fn_is_dense(stage, compute):
    """Sequence parallelism holds only inside the loss function: the module
    called on the whole sequence, after ``sequence_parallel_loss_fn`` ran
    and after ``initialize`` with the block, is the one-rank dense model."""
    ranks = _ranks()
    dense = {}
    for schedule in ra.SCHEDULES:
        loss, _ = _jax_gpt2(schedule)
        dense[schedule] = loss
    for res in ranks:
        module, want = res[f"engine/{stage}/module_loss"]
        assert module == want
        for schedule in ra.SCHEDULES:   # the SP loss is the whole sequence's: the dense one
            np.testing.assert_allclose(res[f"gpt2/{schedule}/module_loss"],
                                       dense[schedule], rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _names():
    """JAX flat leaf name -> the port's parameter name."""
    out = {}
    for jname in _flat_jax(_jax_params(_inputs())):
        parts = jname.split("/")
        out[jname] = ".".join(parts)
    return out
