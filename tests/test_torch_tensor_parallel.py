"""Tensor parallelism in the PyTorch port, on the CPU, against the JAX package.

Counterparts of ``tests/unit/test_tensor_parallel.py``. A tiny GPT-2 (vocab
96, width 32, 2 layers, 4 heads, T 16) from the JAX init
(``params_from_jax``), seeded micro-batches of 2 rows.

- Host-only: ``ProcessTopology`` / ``PipelineParallelGrid`` rank maths and
  ``qkv_tp_permutation`` against the JAX copies; ``build_mesh``'s refusal
  to strand ranks; ``param_shardings`` against the JAX layout; ``with_tp``'s
  refusals.
- dp = 1 x tp = 2, two gloo processes, one spawn (one thread a rank) for
  every case: one step's loss and whole grads against ``jax.value_and_grad``
  of the JAX model under ``param_shardings`` on a (data 1, model 2) mesh,
  with dense and with flash attention in the port (the plain version on the
  CPU); 3 engine steps at ZeRO-2 against the JAX engine with
  ``param_shardings`` (float32 compute within 1e-5, bf16 within 1e-2);
  partition_activations on and off bit for bit, with the saved block inputs
  at half the bytes; the flash dropout under TP against JAX's ``with_tp``
  attention under shard_map (the masks bit for bit: the same folded seeds);
  a tp = 2 checkpoint restored at tp = 1 and by the JAX engine; the
  tp = 2 module's ``generate`` / ``beam_search`` / ``model(tokens)`` equal
  to the tp = 1 module's; the memory manifest and the flop count per rank.
- dp = 2 x tp = 2, four gloo processes (the one 4-process spawn: torch's
  threaded process group cannot make subgroups): ZeRO-2 and ZeRO-3 over the
  data group against the JAX engine on ``build_mesh(data=2, model=2)``; the
  ZeRO-2 checkpoint's elastic dp merge at one rank.

JAX is imported inside the tests, so the spawned workers import only torch.
"""

import functools
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, qkv_tp_permutation
from deepspeed_tpu_torch.parallel import (Mesh, PipeModelDataParallelTopology,
                                          PipelineParallelGrid, build_mesh)
from deepspeed_tpu_torch.parallel.mesh import fold_tp_seed

DIMS = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4)
B, T, STEPS, CHUNK = 2, 16, 3, 8
DROPOUT = 0.2


def _config(stage=2, dp=1, **extra):
    cfg = {"train_batch_size": B * dp, "train_micro_batch_size_per_gpu": B,
           "steps_per_print": 1000, "gradient_clipping": 1.0,
           "optimizer": _optimizer(), "bf16": {"enabled": True},
           "zero_optimization": {"stage": stage}}
    cfg.update(extra)
    return cfg


def _optimizer(name="Adam"):
    return {"type": name, "params": {"lr": 1e-2}}


def _batches(n=STEPS, rows=B, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, DIMS["vocab_size"], size=(rows, T)).astype(np.int64)
        out.append((tokens, np.roll(tokens, -1, axis=1)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(compute="float32", flash=False, dropout=0.0):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=getattr(jnp, compute),
                                    loss_chunk=CHUNK, use_flash_attention=flash,
                                    dropout=dropout))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(7)))


@functools.lru_cache(maxsize=None)
def _port_params():
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return {k: v.numpy() for k, v in params_from_jax(_jax_model()[1], device="cpu").items()}


def _gpt2(params, compute=torch.float32, **over):
    model = GPT2Model(GPT2Config(**DIMS, compute_dtype=compute,
                                 **dict(dict(loss_chunk=CHUNK), **over)), device="cpu")
    model.load_parameters({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return model


def _sizes_mesh(model=2, pipe=1, rank=0):
    """A mesh of those sizes with no process groups: what an engine or a
    module does before its first collective needs none."""
    return Mesh(PipeModelDataParallelTopology(num_pp=pipe, num_mp=model, num_dp=1), rank)


class _Mpu:
    """An mpu that carries a mesh (as ``PipelineParallelGrid`` does)."""

    def __init__(self, mesh):
        self.mesh = mesh


def _grid(dp, tp):
    return PipelineParallelGrid(PipeModelDataParallelTopology(num_pp=1, num_mp=tp, num_dp=dp))


def _engine(params, cfg, grid=None, compute=torch.bfloat16, **over):
    model = _gpt2(params, compute, **dict(dict(use_flash_attention=True), **over))
    kw = {}
    if grid is not None:
        kw = dict(mpu=grid, param_shardings=model.param_shardings(grid.mesh))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                                  device="cpu", dist_init_required=False, **kw)
    return eng


def _train(eng, batches, rows=slice(None)):
    losses, norms = [], []
    for tokens, labels in batches:
        loss = eng(tokens[rows], labels[rows])
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
        norms.append(float(eng._last_grad_norm))
    return np.asarray(losses), np.asarray(norms)


def _state(eng):
    """Every array a save writes (whole leaves in the JAX layout)."""
    out = {f"params/{k}": np.array(v) for k, v in eng._ckpt_export("params").items()}
    out.update({f"master/{k}": np.array(v) for k, v in eng._ckpt_export("master").items()})
    out.update({f"opt/{k}": np.array(v) for k, v in eng._ckpt_export("opt").items()})
    return out


def _outside(module, tok):
    seqs, scores = module.beam_search(tok, 4, num_beams=2)
    return {"generate": module.generate(tok, 4).numpy(), "beam": seqs.numpy(),
            "beam_scores": scores.numpy(), "logits": module(tok).detach().numpy()}


def _saved_region_bytes(eng, batch):
    """The bytes of the tensors torch's checkpoint keeps as its regions'
    inputs over one forward (the block inputs, partitioned or not)."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act
    seen, orig = [], act._torch_checkpoint.checkpoint

    def spy(fn, *args, **kw):
        seen.append(sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a)))
        return orig(fn, *args, **kw)

    act._torch_checkpoint.checkpoint = spy
    try:
        loss = eng(*batch)
        eng.backward(loss)
        eng.zero_grad()
    finally:
        act._torch_checkpoint.checkpoint = orig
    return sum(seen)


# ------------------------------------------------------------------ host-only
TOPOLOGIES = [("pmd", (1, 2, 1)), ("pmd", (1, 2, 2)), ("pmd", (2, 2, 2)), ("pmd", (2, 1, 4)),
              ("pmd", (1, 4, 2)), ("pd", (2, 3)), ("pd", (1, 4)), ("world", (6,))]


def _topo(pkg, kind, dims):
    if kind == "pmd":
        return pkg.PipeModelDataParallelTopology(*dims)
    if kind == "pd":
        return pkg.PipeDataParallelTopology(*dims)
    return None


@pytest.mark.parametrize("kind,dims", TOPOLOGIES, ids=lambda v: str(v))
def test_topology_and_grid_rank_maths_match_jax(kind, dims):
    from deepspeed_tpu import parallel as jax_parallel
    from deepspeed_tpu_torch import parallel as port_parallel
    jt, pt = _topo(jax_parallel, kind, dims), _topo(port_parallel, kind, dims)
    world = dims[0] if kind == "world" else pt.world_size()
    if pt is not None:
        assert pt.mapping == jt.mapping and pt.get_axis_names() == jt.get_axis_names()
        for axis in pt.get_axis_names():
            assert pt.get_axis_comm_lists(axis) == jt.get_axis_comm_lists(axis)
            for i in range(pt.get_dim(axis)):
                assert pt.get_axis_list(axis, i) == jt.get_axis_list(axis, i)
        for r in range(world):
            assert pt.get_coord(r) == jt.get_coord(r)
            assert pt.get_rank_repr(r) == jt.get_rank_repr(r)
    for r in range(world):
        kw = dict(topology=pt) if pt is not None else dict(world_size=world)
        jkw = dict(topology=jt) if jt is not None else dict(world_size=world)
        pg = PipelineParallelGrid(global_rank=r, **kw)
        jg = jax_parallel.PipelineParallelGrid(global_rank=r, **jkw)
        for name in ("get_stage_id", "get_data_parallel_id", "get_pipe_parallel_rank",
                     "get_pipe_parallel_world_size", "get_pipe_parallel_group",
                     "get_data_parallel_rank", "get_data_parallel_world_size",
                     "get_data_parallel_group", "get_model_parallel_rank",
                     "get_model_parallel_world_size", "get_model_parallel_group",
                     "get_slice_parallel_rank", "get_slice_parallel_world_size",
                     "get_slice_parallel_group"):
            assert getattr(pg, name)() == getattr(jg, name)(), name
        assert pg.p2p_groups == jg.p2p_groups
        assert pg.stage_to_global(0) == jg.stage_to_global(0)
        # no live world: the grid's mesh has the sizes and no groups
        assert pg.mesh.shape == {"pipe": pg.pipe_parallel_size, "data": pg.data_parallel_size,
                                 "model": pg.model_parallel_size}
        assert pg.mesh.group("model") is None


@pytest.mark.parametrize("n_embd,tp", [(8, 2), (32, 2), (48, 4), (12, 3)])
def test_qkv_tp_permutation_matches_jax(n_embd, tp):
    from deepspeed_tpu.models.gpt2 import qkv_tp_permutation as jax_perm
    np.testing.assert_array_equal(qkv_tp_permutation(n_embd, tp), jax_perm(n_embd, tp))


def test_fold_tp_seed_is_the_jax_int32_fold():
    import jax.numpy as jnp
    for seed in (0, 4242, 2**31 - 2, 123456789):
        for rank in range(4):
            want = int(jnp.int32(seed) + (rank + 1) * jnp.int32(-1640531527))
            assert fold_tp_seed(seed, rank) == want


def test_build_mesh_shapes_and_refusals():
    mesh = build_mesh()
    assert mesh.shape == {"pipe": 1, "data": 1, "model": 1} and mesh.group("data") is None
    assert mesh.axis_index("model") == 0
    with pytest.raises(AssertionError, match="mesh needs 2 ranks"):
        build_mesh(data=1, model=2)
    with pytest.raises(AssertionError, match="not divisible"):
        build_mesh(model=2)
    # axis order (pipe, data, model): model innermost
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    assert topo.get_axis_comm_lists("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert topo.get_axis_comm_lists("data") == [[0, 2], [1, 3], [4, 6], [5, 7]]


def test_param_shardings_are_the_jax_layout(eight_devices):
    from deepspeed_tpu.parallel.mesh import build_mesh as jax_build_mesh
    jm, _ = _jax_model()
    jmesh = jax_build_mesh(data=4, model=2, pipe=1)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s.spec)
            for path, s in __import__("jax").tree_util.tree_flatten_with_path(
                jm.param_shardings(jmesh))[0]}
    from torch.utils import _pytree as pytree
    port = GPT2Model(GPT2Config(**DIMS), device="cpu").param_shardings()
    got = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): spec
           for path, spec in pytree.tree_flatten_with_path(
               port, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert got == want


@pytest.mark.parametrize("over,match", [
    (dict(n_head=3, n_embd=24), "n_head=3 must divide by tp size 2"),
    (dict(vocab_size=95), "vocab_size=95 must divide by tp size 2"),
])
def test_with_tp_refusals(over, match):
    model = GPT2Model(GPT2Config(**dict(DIMS, **over)), device="cpu")
    with pytest.raises(ValueError, match=match):
        model.with_tp(_sizes_mesh())


def test_with_tp_refuses_sparse_attention():
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    model = GPT2Model(GPT2Config(**DIMS, sparse_attention=FixedSparsityConfig(
        num_heads=4, block=16)), device="cpu")
    with pytest.raises(ValueError, match="sparse_attention does not compose"):
        model.with_tp(_sizes_mesh())


# ------------------------------------------------------------------ dp = 1 x tp = 2
def _tp_worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act
        from deepspeed_tpu_torch.utils import flops_profiler as fp
        from deepspeed_tpu_torch.utils import hbm
        inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        params = {k[2:]: v for k, v in inputs.items() if k.startswith("p/")}
        mesh = _grid(1, 2).mesh
        res = {}
        tokens, labels = (torch.from_numpy(a) for a in _batches(1)[0])
        # one step's loss and whole grads, the module alone (float32)
        for attn in ("dense", "flash"):
            model = _gpt2(params, use_flash_attention=attn == "flash").with_tp(mesh)
            with model.sliced_scope():
                loss = model(tokens, labels)
                loss.backward()
            res[f"grad/{attn}/loss"] = np.asarray(float(loss.detach()))
            for n, p in model.named_parameters():
                res[f"grad/{attn}/{n}"] = model.tp_whole(n, p.grad).numpy()
        # 3 engine steps at ZeRO-2, float32 and bf16 compute; and LAMB (its
        # per-leaf norms) in float32
        for run, compute, cfg in (("float32", "float32", _config(2)),
                                  ("bfloat16", "bfloat16", _config(2)),
                                  ("lamb", "float32", _config(2, optimizer=_optimizer("Lamb")))):
            act.reset()
            eng = _engine(params, cfg, _grid(1, 2), getattr(torch, compute))
            res[f"engine/{run}/losses"], res[f"engine/{run}/norms"] = _train(eng, _batches())
            res[f"engine/{run}/local"] = np.asarray([p.numel() for p in eng._params])
            res.update({f"engine/{run}/{k}": v for k, v in _state(eng).items()
                        if k.startswith("master/")})
        # partition_activations on and off (full remat)
        for on in (False, True):
            act.reset()
            cfg = _config(2, activation_checkpointing={"partition_activations": on})
            eng = _engine(params, cfg, _grid(1, 2), remat=True)
            res[f"pa/{on}/saved_bytes"] = np.asarray(_saved_region_bytes(eng, _batches(1)[0]))
            res[f"pa/{on}/losses"], res[f"pa/{on}/norms"] = _train(eng, _batches())
        act.reset()
        # the checkpoint at tp = 2
        eng = _engine(params, _config(2), _grid(1, 2))
        _train(eng, _batches())
        eng.save_checkpoint(os.path.join(out_dir, "tp2"))
        res.update({f"saved/{k}": v for k, v in _state(eng).items()})
        # fault C7's TP side: the module of slices outside the engine
        tok = torch.from_numpy(np.random.RandomState(7).randint(0, DIMS["vocab_size"], (2, 6)))
        model = _gpt2(params).with_tp(mesh)
        res.update({f"outside/{k}": v for k, v in _outside(model, tok).items()})
        res["outside_local"] = np.asarray([p.numel() for p in model.parameters()])
        # the flash dropout under TP: this rank's attention of block 0
        model = _gpt2(params, use_flash_attention=True, dropout=DROPOUT).with_tp(mesh)
        bp = model.params_tree()["blocks"][0]["attn"]
        with model.sliced_scope():
            y = model._attention(torch.from_numpy(inputs["x"]), bp, seed=int(inputs["seed"]))
        res["dropout/y"] = y.detach().numpy()
        # the memory manifest and the flop count of one rank (plain attention)
        eng = _engine(params, _config(2), _grid(1, 2), use_flash_attention=False)
        report = hbm.engine_report(eng)
        manifest = eng.memory_manifest()
        res["manifest/reconciled"] = np.asarray(report["reconciled"])
        res["manifest/psi"] = np.asarray(manifest["geometry"]["psi"])
        res["manifest/params_bytes"] = np.asarray(report["classes"]["params"]["parsed_bytes"])
        prof = eng.flops_profile(*(torch.from_numpy(a) for a in _batches(1)[0]))
        res["flops"] = np.asarray(prof["program_flops"]["loss_and_grad"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _dropout_inputs():
    """A block-0 attention input and the JAX model's dropout key and seed."""
    import jax
    import jax.numpy as jnp
    x = np.random.RandomState(3).randn(B, T, DIMS["n_embd"]).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    seed = int(jax.random.randint(rng, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    return x, rng, seed


@functools.lru_cache(maxsize=None)
def _gloo_run():
    out_dir = tempfile.mkdtemp(prefix="tp_gloo_")
    x, _, seed = _dropout_inputs()
    np.savez(os.path.join(out_dir, "inputs.npz"), x=x, seed=np.asarray(seed),
             **{f"p/{k}": v for k, v in _port_params().items()})
    mp.start_processes(_tp_worker, args=(_free_port(), out_dir), nprocs=2,
                       start_method="spawn", join=True)
    return out_dir, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in (0, 1)]


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _jax_mesh(data, model):
    import jax
    from deepspeed_tpu.parallel.mesh import build_mesh as jax_build_mesh
    return jax_build_mesh(data=data, model=model, pipe=1, devices=jax.devices()[:data * model])


@functools.lru_cache(maxsize=None)
def _jax_grads():
    """Loss and grads of the JAX model's one step under param_shardings on a
    (data 1, model 2) mesh (GSPMD)."""
    import jax
    jm, jp = _jax_model()
    mesh = _jax_mesh(1, 2)
    params = jax.device_put(jp, jm.param_shardings(mesh))
    tokens, labels = _batches(1)[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, tokens.astype(np.int32), labels.astype(np.int32))))(params)
    from deepspeed_tpu.checkpoint.checkpointing import _flatten_with_paths
    return float(loss), {k: np.asarray(v) for k, v in _flatten_with_paths(grads).items()}


@functools.lru_cache(maxsize=None)
def _jax_engine_run(compute, data=1, model=2, stage=2, optimizer="Adam", same_rows=False):
    """The JAX engine's losses and grad norms of each step, and its float32
    master after the last, with ``param_shardings`` on a (data, model)
    mesh; ``same_rows``: every data shard gets the B rows of ``_batches()``."""
    from deepspeed_tpu.checkpoint.checkpointing import _flatten_with_paths
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp = _jax_model(compute)
    mesh = _jax_mesh(data, model)
    cfg = _config(stage, dp=data, optimizer=_optimizer(optimizer))
    eng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=mesh,
                          param_shardings=jm.param_shardings(mesh), config_params=cfg)
    losses, norms = [], []
    batches = ([(np.tile(t, (data, 1)), np.tile(l, (data, 1))) for t, l in _batches()]
               if same_rows else _batches(rows=B * data))
    for tokens, labels in batches:
        loss = eng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
        norms.append(float(eng._last_grad_norm))
    master = {f"master/{k}": np.asarray(v, np.float32)
              for k, v in _flatten_with_paths(eng.master_params).items()}
    return np.asarray(losses), np.asarray(norms), master


def _assert_matches_jax(losses, norms, master, want, rtol, master_atol=None):
    """Losses and grad norms of each step against ``_jax_engine_run``'s
    within ``rtol``; with ``master_atol``, the whole master after the last
    step too (Adam's and LAMB's normalized updates turn a near-zero grad's
    last-bit difference into a visible step, hence an absolute bound, as
    tests/test_torch_engine.py's DP_MODES)."""
    np.testing.assert_allclose(losses, want[0], rtol=rtol, atol=0)
    np.testing.assert_allclose(norms, want[1], rtol=rtol, atol=0)
    if master_atol is None:
        return
    master = {k: v for k, v in master.items() if k.startswith("master/")}
    assert sorted(master) == sorted(want[2])
    for k, v in want[2].items():
        np.testing.assert_allclose(master[k], v, rtol=0, atol=master_atol, err_msg=k)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_tp2_one_step_loss_and_grads_match_jax(attn, eight_devices):
    """dp = 1 x tp = 2, float32: the port's loss and its grads (the ranks'
    slices joined into whole leaves) against the JAX model's
    ``value_and_grad`` under its Megatron param_shardings, within 1e-5."""
    _, ranks = _gloo_run()
    loss, grads = _jax_grads()
    names = {n: n.replace(".", "/") for n in _port_params()}
    for res in ranks:
        got = _sub(res, f"grad/{attn}")
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, atol=0)
        for n, key in names.items():
            np.testing.assert_allclose(got[n], grads[key], rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("run,rtol,master_atol", [("float32", 1e-5, 1e-4),
                                                   ("bfloat16", 1e-2, None),
                                                   ("lamb", 1e-5, 5e-6)],
                         ids=["float32-1e-05", "bfloat16-0.01", "lamb-1e-05"])
def test_tp2_engine_matches_the_jax_engine(run, rtol, master_atol, eight_devices):
    """3 steps at ZeRO-2 (Adam, or LAMB with its per-leaf norms; clipping)
    through ``initialize(mpu=..., param_shardings=...)`` with flash
    attention, against the JAX engine with ``param_shardings`` on a (data
    1, model 2) mesh: each step's loss and global grad norm (a replicated
    leaf counted once, a split one summed over the model group) and the
    whole float32 master after the last step (float32 compute; in bf16 a
    near-zero grad's rounding flips Adam's step); every rank holds its
    slices (the split leaves at half their size). Measured on the masters:
    Adam 2.8e-5, LAMB 1.2e-6. LAMB's bound is tight because its trust
    ratio of a split leaf from this rank's half alone (no model-group sum)
    moves the masters by only 2.0e-5: the two halves' norms nearly share
    their ratio."""
    _, ranks = _gloo_run()
    compute = "bfloat16" if run == "bfloat16" else "float32"
    want = _jax_engine_run(compute, optimizer="Lamb" if run == "lamb" else "Adam")
    full = np.asarray([p.numel() for p in GPT2Model(GPT2Config(**DIMS), device="cpu").parameters()])
    for res in ranks:
        _assert_matches_jax(res[f"engine/{run}/losses"], res[f"engine/{run}/norms"],
                            _sub(res, f"engine/{run}"), want, rtol, master_atol)
        local = res[f"engine/{run}/local"]
        assert sorted(set(full // local)) == [1, 2]
    np.testing.assert_array_equal(ranks[0][f"engine/{run}/norms"],
                                  ranks[1][f"engine/{run}/norms"])


def test_partition_activations_bit_for_bit_with_half_the_saved_bytes():
    """partition_activations over the model axis: the block inputs kept as
    each rank's half and all-gathered in the region; losses and grad norms
    bit for bit those without it."""
    _, ranks = _gloo_run()
    for res in ranks:
        np.testing.assert_array_equal(res["pa/True/losses"], res["pa/False/losses"])
        np.testing.assert_array_equal(res["pa/True/norms"], res["pa/False/norms"])
        assert int(res["pa/False/saved_bytes"]) > 0
        assert 2 * int(res["pa/True/saved_bytes"]) == int(res["pa/False/saved_bytes"])


def test_tp2_flash_dropout_matches_jax_with_tp(eight_devices):
    """The port's flash attention under TP with dropout (the tp rank folded
    into the seed, the kernels hashing the local head index) against the JAX
    ``with_tp`` model's attention under shard_map, Pallas in interpret
    mode: the masks bit for bit (the same folded seeds; a differing mask
    would move the outputs by the dropped probabilities), the outputs
    within float32's 1e-5."""
    import jax
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.parallel.mesh import shard_map
    _, ranks = _gloo_run()
    x, rng, seed = _dropout_inputs()
    jm, jp = _jax_model(flash=True, dropout=DROPOUT)
    jtp = jm.with_tp("model", 2)
    ap = jp["blocks"][0]["attn"]
    perm = qkv_tp_permutation(DIMS["n_embd"], 2)
    ap = dict(ap, c_attn_w=ap["c_attn_w"][:, perm], c_attn_b=ap["c_attn_b"][perm])
    specs = {"c_attn_w": P(None, "model"), "c_attn_b": P("model"),
             "c_proj_w": P("model", None), "c_proj_b": P()}
    fn = shard_map(lambda x_, p_, r_: jtp._attention(x_, p_, dropout_rng=r_),
                   mesh=_jax_mesh(1, 2), in_specs=(P(), specs, P()), out_specs=P())
    want = np.asarray(jax.jit(fn)(x, ap, rng))
    from deepspeed_tpu.ops.pallas.flash_attention import dropout_keep_reference as jax_keep
    from deepspeed_tpu_torch.ops.flash_attention import dropout_keep_reference as keep
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["dropout/y"], want, rtol=1e-5, atol=1e-6)
        folded = fold_tp_seed(seed, r)
        np.testing.assert_array_equal(
            keep(folded, B, DIMS["n_head"] // 2, T, T, DROPOUT).numpy(),
            np.asarray(jax_keep(folded, B, DIMS["n_head"] // 2, T, T, DROPOUT)))
    # the ranks' masks differ: the fold decorrelates the model-axis ranks
    assert not np.array_equal(keep(fold_tp_seed(seed, 0), B, 2, T, T, DROPOUT).numpy(),
                              keep(fold_tp_seed(seed, 1), B, 2, T, T, DROPOUT).numpy())


def test_tp2_checkpoint_restores_at_tp1():
    """A tp = 2 checkpoint holds whole leaves in the JAX layout: a tp = 1
    engine restores it bit for bit."""
    out_dir, ranks = _gloo_run()
    saved = _sub(ranks[0], "saved")
    for k, v in saved.items():
        np.testing.assert_array_equal(ranks[1][f"saved/{k}"], v, err_msg=k)
    one = _engine({k: v * 0.5 for k, v in _port_params().items()}, _config(2))
    one.load_checkpoint(os.path.join(out_dir, "tp2"))
    assert one.global_steps == STEPS
    state = _state(one)
    assert sorted(state) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)


def test_jax_engine_loads_the_tp2_checkpoint(eight_devices):
    import jax
    from deepspeed_tpu.checkpoint.checkpointing import _flatten_with_paths
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    out_dir, ranks = _gloo_run()
    jm, jp = _jax_model()
    jeng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=_config(2))
    path, _ = jeng.load_checkpoint(os.path.join(out_dir, "tp2"))
    assert path is not None and jeng.global_steps == STEPS
    got = {f"params/{k}": v for k, v in _flatten_with_paths(jeng.params).items()}
    got.update({f"master/{k}": v for k, v in _flatten_with_paths(jeng.master_params).items()})
    got.update({f"opt/{k}": v for k, v in _flatten_with_paths(jeng.opt_state).items()})
    got = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), got)
    for k, v in _sub(ranks[0], "saved").items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_tp2_module_outside_the_engine_equals_tp1():
    """``generate``, ``beam_search`` and ``model(tokens)`` of a tp = 2
    module (its leaves slices) run on whole leaves gathered over the model
    group and equal the tp = 1 module's; the slices come back after."""
    _, ranks = _gloo_run()
    tok = torch.from_numpy(np.random.RandomState(7).randint(0, DIMS["vocab_size"], (2, 6)))
    want = _outside(_gpt2(_port_params()), tok)
    for res in ranks:
        got = _sub(res, "outside")
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert sum(res["outside_local"]) < sum(int(np.prod(v.shape))
                                               for v in _port_params().values())


def test_tp2_memory_manifest_and_flops_count_one_rank():
    """Per rank: the manifest's Ψ is this rank's slices plus the replicated
    leaves (``hbm.gpt2_param_count(tp=2)``) and reconciles with the ZeRO
    model; the flop count is the rank's heads, columns and vocabulary block
    (``flops_profiler.gpt2_train_flops(tp=2)``)."""
    from deepspeed_tpu_torch.utils import flops_profiler as fp
    from deepspeed_tpu_torch.utils import hbm
    _, ranks = _gloo_run()
    psi = hbm.gpt2_param_count(DIMS["n_embd"], DIMS["n_layer"], DIMS["vocab_size"],
                               DIMS["n_positions"], tp=2)
    whole = hbm.gpt2_param_count(DIMS["n_embd"], DIMS["n_layer"], DIMS["vocab_size"],
                                 DIMS["n_positions"])
    flops = fp.gpt2_train_flops(DIMS["n_embd"], DIMS["n_layer"], DIMS["n_head"],
                                DIMS["vocab_size"], T, B, flash=False, tp=2)
    assert whole // 2 < psi < whole
    for res in ranks:
        assert bool(res["manifest/reconciled"])
        assert int(res["manifest/psi"]) == psi
        assert int(res["manifest/params_bytes"]) == 2 * psi
        assert int(res["flops"]) == flops


# ------------------------------------------------------------------ dp = 2 x tp = 2
def _dp_tp_worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                            rank=rank)
    try:
        params = {k[2:]: v for k, v in np.load(os.path.join(out_dir, "inputs.npz")).items()
                  if k.startswith("p/")}
        grid = _grid(2, 2)
        d = grid.get_data_parallel_rank()
        res = {}
        for stage in (2, 3):
            for compute in ("bfloat16", "float32"):
                run = f"stage{stage}/{compute}"
                eng = _engine(params, _config(stage, dp=2), grid, getattr(torch, compute))
                # bf16: each data rank its own rows; float32: both the same
                # rows (SAME_ROWS)
                batches, rows = ((_batches(rows=2 * B), slice(d * B, (d + 1) * B))
                                 if compute == "bfloat16" else (_batches(), slice(None)))
                res[f"{run}/losses"], res[f"{run}/norms"] = _train(eng, batches, rows)
                res[f"{run}/local"] = np.asarray([p.numel() for p in eng._params])
                state = _state(eng)
                res.update({f"{run}/{k}": v for k, v in state.items() if k.startswith("master/")})
                if stage == 2 and compute == "bfloat16":
                    # the elastic layout: 2 data ranks' optimizer files of whole leaves
                    eng.save_checkpoint(os.path.join(out_dir, "dp2tp2"))
                    res.update({f"saved/{k}": v for k, v in state.items()})
        res["coord"] = np.asarray([d, grid.get_slice_parallel_rank()])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _dp_tp_run():
    out_dir = tempfile.mkdtemp(prefix="dp_tp_gloo_")
    np.savez(os.path.join(out_dir, "inputs.npz"),
             **{f"p/{k}": v for k, v in _port_params().items()})
    mp.start_processes(_dp_tp_worker, args=(_free_port(), out_dir), nprocs=4,
                       start_method="spawn", join=True)
    return out_dir, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(4)]


@pytest.mark.parametrize("stage,compute,rtol,master_atol", [
    (2, "bfloat16", 1e-2, None), (3, "bfloat16", 1e-2, None),
    (2, "float32", 2e-5, 2e-4), (3, "float32", 2e-5, 2e-4)],
    ids=["2", "3", "2-float32", "3-float32"])
def test_dp2_tp2_matches_the_jax_engine(stage, compute, rtol, master_atol, eight_devices):
    """dp = 2 x tp = 2 (4 gloo ranks, the grid's data and model groups):
    ZeRO partitions each rank's slices over the data group only; the mean
    of the data ranks' losses and the grad norms against the JAX engine on
    ``build_mesh(data=2, model=2)`` with param_shardings, and the whole
    master after 3 steps in float32; the grad norms equal on every rank.
    bf16 gives each data rank its own rows. In float32 both data ranks take
    the same rows (and the JAX engine the rows twice): with distinct rows
    each rank's bf16 grad rounds differently from the whole batch's. The
    JAX engine's grads over the rows twice still round apart from one
    copy's (its step-1 norm 5e-6 from the port's, which at dp = 1 agrees to
    the last bit): measured 1.1e-5 on the norms and 1.2e-4 on the masters,
    held at 2e-5 (the JAX package's own TP test's bound) and 2e-4."""
    _, ranks = _dp_tp_run()
    want = _jax_engine_run(compute, data=2, model=2, stage=stage,
                           same_rows=compute == "float32")
    assert sorted(tuple(r["coord"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    run = f"stage{stage}/{compute}"
    mean = np.mean([r[f"{run}/losses"] for r in ranks], axis=0)
    for r in ranks:
        _assert_matches_jax(mean, r[f"{run}/norms"], _sub(r, run), want, rtol, master_atol)
        np.testing.assert_array_equal(r[f"{run}/norms"], ranks[0][f"{run}/norms"])
    two = _sub(ranks[0], f"stage2/{compute}")["local"]
    three = _sub(ranks[0], f"stage3/{compute}")["local"]
    assert sum(three) < sum(two)   # stage 3: the compute params' data-axis slices too


def test_dp2_tp2_checkpoint_merges_at_one_rank():
    """The elastic restore's dp merge with tp > 1: a dp = 2 x tp = 2 ZeRO-2
    checkpoint (two data ranks' optimizer files, whole leaves gathered over
    the data and the model group) restores bit for bit in a dp = 1, tp = 1
    engine."""
    out_dir, ranks = _dp_tp_run()
    saved = _sub(ranks[0], "saved")
    for r in ranks[1:]:
        for k, v in saved.items():
            np.testing.assert_array_equal(r[f"saved/{k}"], v, err_msg=k)
    one = _engine({k: v * 0.5 for k, v in _port_params().items()}, _config(2))
    one.load_checkpoint(os.path.join(out_dir, "dp2tp2"))
    assert one.global_steps == STEPS
    state = _state(one)
    assert sorted(state) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)


def _client_pair():
    def init(master):
        return {}

    def apply(grads, state, master, step, hyper):
        return master, state
    return init, apply


@pytest.mark.parametrize("cfg,kw", [
    (_config(2, zero_optimization={"stage": 2, "cpu_offload": True}), {}),
    (_config(0, sparse_gradients=True), {}),
    (_config(2, numerics={"enabled": True}), {}),
    (_config(0, optimizer={"type": "OneBitAdam", "params": {"lr": 1e-3}}), {}),
    (_config(0), {"optimizer": _client_pair()}),
], ids=["offload", "sparse_gradients", "numerics", "onebit_adam", "client_pair"])
def test_engine_paths_left_out_under_tp_raise(cfg, kw):
    """What the port leaves out under tensor parallelism raises, naming its
    ROADMAP item, before any collective."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    model = GPT2Model(GPT2Config(**DIMS), device="cpu")
    with pytest.raises(NotImplementedError, match="under tensor parallelism .* item 15b"):
        DeepSpeedEngine(model=model, config_params=cfg, device="cpu",
                        mpu=_Mpu(_sizes_mesh()), param_shardings=model.param_shardings(), **kw)


def test_engine_refuses_another_layout_and_a_pipe_axis():
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    model = GPT2Model(GPT2Config(**DIMS), device="cpu")
    layout = model.param_shardings()
    layout["wpe"] = ("model", None)
    with pytest.raises(ValueError, match="own Megatron layout"):
        DeepSpeedEngine(model=model, config_params=_config(2), device="cpu",
                        mpu=_Mpu(_sizes_mesh()), param_shardings=layout)
    with pytest.raises(NotImplementedError, match="item 16"):
        DeepSpeedEngine(model=model, config_params=_config(2), device="cpu",
                        mpu=_Mpu(_sizes_mesh(model=1, pipe=2)))


def test_model_parallel_seed_folds_the_model_axis_rank():
    """``model_parallel_seed`` under a mesh whose model axis is above 1: the
    rank's coordinate folded into the seed as the flash kernels fold it;
    without one, the base stream."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act
    try:
        act.reset()
        base = act.model_parallel_seed(1234).initial_seed()
        assert base == 1234
        act.configure(mesh=_sizes_mesh(rank=1))
        assert act.model_parallel_seed(1234).initial_seed() == fold_tp_seed(1234, 1) & 0xFFFFFFFF
    finally:
        act.reset()
