"""The port's per-rank pipeline executor (``parallel/pipeline_spmd.py``),
``models/gpt2_pipe.py`` and the pipeline engine's per-rank path against the
JAX package's SPMD executor, on the same seeded inputs and the JAX weights.

One spawn of 2 gloo ranks (the pipe group, one thread a rank) runs every
pipe = 2 case and saves what it computed; the JAX side runs on 2 of the 8
virtual devices (mesh data = 1, pipe = 2). Checked within 1e-5 in float32:
``pipeline_apply``'s outputs, loss and grads on a toy stack and through
``GPT2Pipe`` (4 layers, 32 wide, vocab 127, so that the table is padded);
the streamed and the flushed segments at M > cap against the unsplit
window and JAX; ``GPT2Pipe`` trained through ``initialize`` at pipe = 2
against the dense ``GPT2Model`` at pipe = 1; the per-rank engine on a
``PipelineModule`` against the instruction executor, and its layer-keyed
checkpoint loaded at 1 and 4 stages bit for bit. One spawn of 4 ranks runs
pipe = 2 x data = 2 under ZeRO-2 against the JAX engine's
``test_spmd_pipe_composes_with_zero2`` (bf16: 1e-2). ``flush_schedule``,
``to_dense`` / ``from_dense`` and the refusals run in this process."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.gpt2 import params_from_jax as gpt2_params_from_jax
from deepspeed_tpu_torch.models.gpt2_pipe import GPT2Pipe
from deepspeed_tpu_torch.models.gpt2_pipe import params_from_jax as pipe_params_from_jax
from deepspeed_tpu_torch.parallel.pipeline_spmd import flush_schedule

S, M, B, H = 2, 4, 8, 16
M_LONG = 16             # > the default cap 4 S = 8: two segments
TOL = 1e-5
GPT = dict(vocab_size=127, n_positions=16, n_embd=32, n_layer=4, n_head=2)
GPT_M, GPT_B, GPT_T = 4, 2, 16
TRAIN_STEPS = 3
TOY_HIDDEN = 8


def _gpt_cfg_torch():
    return GPT2Config(**GPT, compute_dtype=torch.float32)


def _flat_keys(tree):
    import jax
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            v.detach().float().numpy() for path, v in pytree.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ JAX side
@functools.lru_cache(maxsize=None)
def _inputs():
    """The seeded inputs and JAX weights both sides take (numpy)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2 import GPT2Model as JModel
    from deepspeed_tpu.models.gpt2_pipe import GPT2Pipe as JPipe
    key = jax.random.PRNGKey(0)
    toy = {}
    for s in range(S):
        k1, key = jax.random.split(key)
        toy[f"w{s}"] = np.asarray(jax.random.normal(k1, (H, H)) * 0.3)
        toy[f"b{s}"] = np.asarray(jax.random.normal(jax.random.fold_in(k1, 1), (H,)) * 0.1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M_LONG, B, H)).astype(np.float32)
    labels = np.tanh(x @ (rng.normal(size=(H, H)).astype(np.float32) * 0.5))
    jcfg = JConfig(**GPT, compute_dtype=jnp.float32)
    dense = JModel(jcfg).init(jax.random.PRNGKey(3))
    tree = JPipe(jcfg, num_stages=S).from_dense(dense)
    toks = rng.integers(0, GPT["vocab_size"], size=(M_LONG, GPT_B, GPT_T)).astype(np.int32)
    out = {"x": x, "labels": labels, "tokens": toks, "tok_labels": np.roll(toks, -1, axis=2)}
    out.update({f"toy/{k}": v for k, v in toy.items()})
    out.update({f"pipe/{k}": v for k, v in _flat_keys(tree).items()})
    out.update({f"dense/{k}": v for k, v in _flat_keys(dense).items()})
    return out


def _tree_from(flat, prefix):
    """A nested dict from '/'-joined keys under ``prefix`` (list indices for
    digit parts)."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _listify(tree):
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [_listify(tree[str(i)]) for i in range(len(tree))]
        return {k: _listify(v) for k, v in tree.items()}
    return tree


def _jax_mesh(data=1, pipe=S):
    import jax
    from deepspeed_tpu.parallel.mesh import build_mesh
    return build_mesh(data=data, model=1, pipe=pipe, devices=jax.devices()[:data * pipe])


def _toy_stage(p, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ p["w"] + p["b"])


@functools.lru_cache(maxsize=None)
def _jax_toy(n_mb, cap, streamed):
    """JAX pipeline_apply on the toy stack: (loss, grads {w, b} stacked [S, ...])."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.parallel.pipeline_spmd import pipeline_apply
    inp = _inputs()
    stacked = {"w": jnp.stack([inp[f"toy/w{s}"] for s in range(S)]),
               "b": jnp.stack([inp[f"toy/b{s}"] for s in range(S)])}
    x, labels = jnp.asarray(inp["x"][:n_mb]), jnp.asarray(inp["labels"][:n_mb])
    mesh = _jax_mesh()

    def last_fn(y, lab, mb):
        return jnp.mean((y - lab[mb]) ** 2)

    def f(st):
        return pipeline_apply(_toy_stage, st, x, mesh=mesh, last_stage_fn=last_fn,
                              last_stage_args=(labels,), last_stage_args_specs=(P(None, "data"),),
                              max_microbatches_per_flush=cap, stream_segments=streamed)
    loss, g = jax.jit(jax.value_and_grad(f))(stacked)
    outs = jax.jit(lambda st: pipeline_apply(_toy_stage, st, x, mesh=mesh))(stacked)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}, np.asarray(outs)


@functools.lru_cache(maxsize=None)
def _jax_gpt(n_mb, cap, streamed):
    """JAX GPT2Pipe.loss and its grads (flat by '/'-joined key)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
    from deepspeed_tpu.models.gpt2_pipe import GPT2Pipe as JPipe
    inp = _inputs()
    pipe = JPipe(JConfig(**GPT, compute_dtype=jnp.float32), num_stages=S)
    tree = jax.tree_util.tree_map(jnp.asarray, _tree_from(inp, "pipe"))
    mesh = _jax_mesh()
    placed = jax.device_put(tree, pipe.param_shardings(mesh, tree))
    toks = jnp.asarray(inp["tokens"][:n_mb])
    labels = jnp.asarray(inp["tok_labels"][:n_mb])
    loss, g = jax.jit(jax.value_and_grad(lambda p: pipe.loss(
        p, toks, labels, mesh=mesh, max_microbatches_per_flush=cap,
        stream_segments=streamed)))(placed)
    return float(loss), _flat_keys(g)


# ------------------------------------------------------------------ the ranks
TOY_CASES = [(M, None, True), (M_LONG, None, True), (M_LONG, None, False), (M_LONG, 0, True)]
GPT_CASES = [(GPT_M, None, True), (M_LONG, None, True), (M_LONG, None, False)]


# SGD for the trajectories held to 1e-5: Adam's first steps move every
# element by about lr whatever its gradient's size, so a gradient that float32
# summation order flips across zero moves a weight by 2 lr
SGD = {"type": "SGD", "params": {"lr": 0.1}}


def _engine_config(batch, gas, **over):
    cfg = {"train_batch_size": batch, "gradient_accumulation_steps": gas,
           "steps_per_print": 1000, "bf16": {"enabled": False},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(over)
    return cfg


def _toy_module(num_stages, hidden=TOY_HIDDEN, seed=0):
    from deepspeed_tpu_torch.parallel.pipe import LayerSpec, PipelineModule

    class Linear(torch.nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(hidden, dim))
            self.b = torch.nn.Parameter(torch.zeros(dim))

        def forward(self, x):
            return torch.tanh(x @ self.w.to(x.dtype) + self.b.to(x.dtype))

    def mse(out, tgt):
        return torch.mean(torch.square(out.float() - tgt.float()))

    module = PipelineModule([LayerSpec(Linear, hidden) for _ in range(4)],
                            num_stages=num_stages, loss_fn=mse)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.3 if n.endswith("w") else 0.1))
    return module


def _toy_batches(n, hidden=TOY_HIDDEN, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(77).normal(size=(hidden, hidden)).astype(np.float32) * 0.4
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, hidden)).astype(np.float32)
        out.append((x, np.tanh(x @ w_true)))
    return out


def _pipe2_worker(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            world_size=S, rank=rank)
    try:
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch.parallel import PipeDataParallelTopology, PipelineParallelGrid
        from deepspeed_tpu_torch.parallel.pipeline_spmd import pipeline_apply
        inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        grid = PipelineParallelGrid(PipeDataParallelTopology(num_pp=S, num_dp=1))
        mesh = grid.mesh
        res = {}
        # toy stack: outputs, loss and grads, unsplit and segmented
        for n_mb, cap, streamed in TOY_CASES:
            p = {"w": torch.from_numpy(inp[f"toy/w{rank}"]).requires_grad_(),
                 "b": torch.from_numpy(inp[f"toy/b{rank}"]).requires_grad_()}
            x = torch.from_numpy(inp["x"][:n_mb])
            lab = torch.from_numpy(inp["labels"][:n_mb])
            loss = pipeline_apply(lambda pp, h: torch.tanh(h @ pp["w"] + pp["b"]), p, x,
                                  mesh=mesh, last_stage_args=(lab,), last_stage_args_specs=("mb",),
                                  last_stage_fn=lambda y, lb, mb: torch.mean((y - lb[mb]) ** 2),
                                  max_microbatches_per_flush=cap, stream_segments=streamed)
            loss.backward()
            tag = f"toy/{n_mb}_{cap}_{streamed}"
            res[f"{tag}/loss"] = loss.detach().numpy()
            res[f"{tag}/w"], res[f"{tag}/b"] = p["w"].grad.numpy(), p["b"].grad.numpy()
            with torch.no_grad():
                res[f"{tag}/outs"] = pipeline_apply(
                    lambda pp, h: torch.tanh(h @ pp["w"] + pp["b"]), p, x, mesh=mesh).numpy()
        # a stage drawing from torch's generator: the masks of each step's
        # forward, its recompute's, and the grads through them
        draws = []

        def noisy(pp, h):
            mask = (torch.rand(h.shape) < 0.5).to(h.dtype)
            draws.append(mask)
            return torch.tanh(h @ pp["w"] + pp["b"]) * mask * 2

        torch.manual_seed(100 + rank)
        p = {"w": torch.from_numpy(inp[f"toy/w{rank}"]).requires_grad_(),
             "b": torch.from_numpy(inp[f"toy/b{rank}"]).requires_grad_()}
        loss = pipeline_apply(noisy, p, torch.from_numpy(inp["x"][:M]), mesh=mesh,
                              last_stage_args=(torch.from_numpy(inp["labels"][:M]),),
                              last_stage_args_specs=("mb",),
                              last_stage_fn=lambda y, lb, mb: torch.mean((y - lb[mb]) ** 2))
        loss.backward()
        res["noisy/loss"] = loss.detach().numpy()
        res["noisy/w"], res["noisy/b"] = p["w"].grad.numpy(), p["b"].grad.numpy()
        res["noisy/masks"] = torch.stack(draws).numpy()
        # GPT2Pipe: loss and whole grads
        tree = pipe_params_from_jax(_listify(_tree_from(inp, "pipe")), device="cpu")
        for n_mb, cap, streamed in GPT_CASES:
            gp = GPT2Pipe(_gpt_cfg_torch(), S, mesh=mesh, device="cpu")
            gp.load_parameters(tree)
            loss = gp.loss(torch.from_numpy(inp["tokens"][:n_mb]),
                           torch.from_numpy(inp["tok_labels"][:n_mb]),
                           max_microbatches_per_flush=cap, stream_segments=streamed)
            loss.backward()
            tag = f"gpt/{n_mb}_{cap}_{streamed}"
            res[f"{tag}/loss"] = loss.detach().numpy()
            for n, prm in gp.named_parameters():
                res[f"{tag}/grad/{n.replace('.', '/')}"] = gp.tp_whole(n, prm.grad).numpy()
        # GPT2Pipe trained through initialize at pipe = 2
        gp = GPT2Pipe(_gpt_cfg_torch(), S, mesh=mesh, device="cpu")
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=gp, model_parameters=tree, mpu=grid, param_shardings=gp.param_shardings(mesh),
            config_params=_engine_config(GPT_M * GPT_B, 1, optimizer=SGD), device="cpu",
            dist_init_required=False)
        losses, norms = [], []
        toks, labs = torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["tok_labels"])
        for step in range(TRAIN_STEPS):
            sl = slice(step * GPT_M % M_LONG, step * GPT_M % M_LONG + GPT_M)
            loss = eng(toks[sl], labs[sl])
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
            norms.append(float(eng._last_grad_norm))
        res["train/losses"], res["train/norms"] = np.asarray(losses), np.asarray(norms)
        res["train/params_local"] = np.asarray(sum(p.numel() for p in gp.parameters()))
        # bf16 parameters under ZeRO-2: the last rank alone uses ln_f, the
        # other adds zeros to its gradient's sum
        gp16 = GPT2Pipe(GPT2Config(**GPT), S, mesh=mesh, device="cpu")
        eng16, _, _, _ = deepspeed_tpu_torch.initialize(
            model=gp16, model_parameters=tree, mpu=grid,
            param_shardings=gp16.param_shardings(mesh), device="cpu", dist_init_required=False,
            config_params=_engine_config(GPT_M * GPT_B, 1, bf16={"enabled": True},
                                         zero_optimization={"stage": 2}))
        loss = eng16(toks[:GPT_M], labs[:GPT_M])
        eng16.backward(loss)
        eng16.step()
        res["train16/loss"] = np.asarray(float(loss))
        res["train16/norm"] = np.asarray(float(eng16._last_grad_norm))
        dense = gp.to_dense(gp.stacked_tree())
        res.update({f"train/dense/{k}": v for k, v in _torch_flat(dense).items()})
        # the per-rank PipelineEngine on a PipelineModule, and its checkpoint
        module = _toy_module(S)
        peng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=module, config_params=_engine_config(32, 2), device="cpu",
            dist_init_required=False)
        assert peng._spmd and peng.mesh.shape["pipe"] == S
        batches = _toy_batches(4)
        res["engine/losses"] = np.asarray([float(peng.train_batch(iter(batches[i:i + 2])))
                                           for i in (0, 2)])
        res["engine/params_local"] = np.asarray(len(list(peng.module.parameters())))
        peng.save_checkpoint(os.path.join(out_dir, "ckpt"))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _pipe2_run():
    out_dir = tempfile.mkdtemp(prefix="pipe_gloo_")
    np.savez(os.path.join(out_dir, "inputs.npz"), **_inputs())
    mp.start_processes(_pipe2_worker, args=(out_dir,), nprocs=S, start_method="spawn",
                       join=True)
    return out_dir, [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(S)]


# ------------------------------------------------------------------ toy stack
@pytest.mark.parametrize("n_mb,cap,streamed", TOY_CASES)
def test_toy_pipeline_apply_matches_jax(n_mb, cap, streamed):
    _, ranks = _pipe2_run()
    loss, grads, outs = _jax_toy(n_mb, cap, streamed)
    tag = f"toy/{n_mb}_{cap}_{streamed}"
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{tag}/loss"], loss, rtol=0, atol=TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(res[f"{tag}/{k}"], grads[k][r], rtol=0, atol=TOL)
        np.testing.assert_allclose(res[f"{tag}/outs"], outs, rtol=0, atol=TOL)


def test_recompute_replays_the_forward_random_draws():
    """A stage drawing dropout masks from torch's generator: each step's
    recompute draws its forward's mask, and loss and grads are the
    sequential model's with those masks."""
    _, ranks = _pipe2_run()
    inp = _inputs()
    masks = []
    for res in ranks:
        drawn = res["noisy/masks"]                 # M forward draws, then M recomputes
        assert len(drawn) == 2 * M
        np.testing.assert_array_equal(drawn[M:], drawn[:M][::-1])
        masks.append(torch.from_numpy(drawn[:M]))
    w = [torch.from_numpy(inp[f"toy/w{s}"]).requires_grad_() for s in range(S)]
    b = [torch.from_numpy(inp[f"toy/b{s}"]).requires_grad_() for s in range(S)]
    losses = []
    for m in range(M):
        h = torch.from_numpy(inp["x"][m])
        for s in range(S):
            h = torch.tanh(h @ w[s] + b[s]) * masks[s][m] * 2
        losses.append(torch.mean((h - torch.from_numpy(inp["labels"][m])) ** 2))
    loss = torch.stack(losses).mean()
    loss.backward()
    for s, res in enumerate(ranks):
        np.testing.assert_allclose(res["noisy/loss"], float(loss), rtol=0, atol=TOL)
        np.testing.assert_allclose(res["noisy/w"], w[s].grad.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(res["noisy/b"], b[s].grad.numpy(), rtol=0, atol=TOL)


def test_segments_equal_the_unsplit_window():
    """Streamed and flushed segments at M > cap give the unsplit window's
    loss and grads (cap 0 disables the split)."""
    _, ranks = _pipe2_run()
    for res in ranks:
        base = f"toy/{M_LONG}_0_True"
        for tag in (f"toy/{M_LONG}_None_True", f"toy/{M_LONG}_None_False"):
            for k in ("loss", "w", "b"):
                np.testing.assert_allclose(res[f"{tag}/{k}"], res[f"{base}/{k}"], rtol=0,
                                           atol=1e-6)


# ------------------------------------------------------------------ GPT2Pipe
@pytest.mark.parametrize("n_mb,cap,streamed", GPT_CASES)
def test_gpt2_pipe_loss_and_grads_match_jax(n_mb, cap, streamed):
    _, ranks = _pipe2_run()
    loss, grads = _jax_gpt(n_mb, cap, streamed)
    tag = f"gpt/{n_mb}_{cap}_{streamed}"
    for res in ranks:
        np.testing.assert_allclose(res[f"{tag}/loss"], loss, rtol=0, atol=TOL)
    got = {k[len(tag) + 6:]: v for k, v in ranks[0].items() if k.startswith(f"{tag}/grad/")}
    assert set(got) == set(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL, err_msg=k)
    # the padded table's extra row has no gradient
    assert grads["io/wte"].shape[0] == 128 and not np.any(got["io/wte"][127:])


def test_gpt2_pipe_trains_as_the_dense_model():
    """GPT2Pipe at pipe = 2 through ``initialize`` (the pipe x data mesh of
    the grid, its own layout) takes the dense GPT2Model's steps at pipe = 1
    with the window as its accumulation: losses, grad norms and the
    weights exported by ``to_dense``."""
    import deepspeed_tpu_torch
    _, ranks = _pipe2_run()
    inp = _inputs()
    dense = GPT2Model(_gpt_cfg_torch(), device="cpu")
    dense_tree = _listify(_tree_from(inp, "dense"))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=dense, model_parameters=gpt2_params_from_jax(dense_tree, device="cpu"),
        config_params=_engine_config(GPT_M * GPT_B, GPT_M, optimizer=SGD), device="cpu")
    losses, norms = [], []
    toks, labs = torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["tok_labels"])
    for step in range(TRAIN_STEPS):
        window = []
        for m in range(GPT_M):
            i = step * GPT_M % M_LONG + m
            loss = eng(toks[i], labs[i])
            eng.backward(loss)
            eng.step()
            window.append(float(loss))
        losses.append(np.mean(window))
        norms.append(float(eng._last_grad_norm))
    want = _torch_flat(dense.params_tree())
    for res in ranks:
        np.testing.assert_allclose(res["train/losses"], losses, rtol=0, atol=TOL)
        np.testing.assert_allclose(res["train/norms"], norms, rtol=TOL, atol=0)
    got = {k[len("train/dense/"):]: v for k, v in ranks[0].items()
           if k.startswith("train/dense/")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL, err_msg=k)
    # bf16 (parameters and compute) under ZeRO-2: the first step's loss and
    # norm within bf16's 1e-2 of the float32 run's
    for res in ranks:
        np.testing.assert_allclose(res["train16/loss"], losses[0], rtol=1e-2)
        np.testing.assert_allclose(res["train16/norm"], norms[0], rtol=1e-2)
    # each rank holds half the blocks and half the (padded) table
    total = sum(p.numel() for p in dense.parameters())
    assert all(int(r["train/params_local"]) < 0.6 * total for r in ranks)


def test_gpt2_pipe_dense_round_trip_and_padding():
    inp = _inputs()
    dense_tree = pipe_params_from_jax(_listify(_tree_from(inp, "dense")), device="cpu")
    for stages in (2, 4):
        gp = GPT2Pipe(_gpt_cfg_torch(), stages, device="cpu")
        stacked = gp.from_dense(dense_tree)
        assert stacked["io"]["wte"].shape[0] == 128            # padded to a stage multiple
        assert stacked["stages"]["attn"]["c_attn_w"].shape == (stages, 4 // stages, 32, 96)
        back = gp.to_dense(stacked)
        assert back["wte"].shape[0] == GPT["vocab_size"]
        for k, v in _torch_flat(dense_tree).items():
            assert np.array_equal(_torch_flat(back)[k], v), k
    # the port's stacking is the JAX package's, leaf for leaf
    gp = GPT2Pipe(_gpt_cfg_torch(), S, device="cpu")
    mine = _torch_flat(gp.from_dense(dense_tree))
    theirs = {k[5:]: v for k, v in inp.items() if k.startswith("pipe/")}
    assert set(mine) == set(theirs)
    for k in mine:
        assert np.array_equal(mine[k], theirs[k]), k


# ------------------------------------------------------------------ the engine
def test_per_rank_engine_matches_the_instruction_executor_and_its_checkpoint_moves():
    import deepspeed_tpu_torch
    out_dir, ranks = _pipe2_run()
    batches = _toy_batches(4)
    for stages in (1, 2, 4):
        module = _toy_module(stages)
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=module, config_params=_engine_config(32, 2, pipeline={"spmd": False}),
            device="cpu")
        losses = [float(eng.train_batch(iter(batches[i:i + 2]))) for i in (0, 2)]
        for res in ranks:
            np.testing.assert_allclose(res["engine/losses"], losses, rtol=0, atol=TOL)
        fresh = _toy_module(stages, seed=9)
        dst, _, _, _ = deepspeed_tpu_torch.initialize(
            model=fresh, config_params=_engine_config(32, 2, pipeline={"spmd": False}),
            device="cpu")
        dst.load_checkpoint(os.path.join(out_dir, "ckpt"))
        assert dst.global_steps == 2
        # the per-rank run and this one differ by float32 rounding only; the
        # file is the per-rank run's, bit for bit
        from deepspeed_tpu_torch.checkpoint import checkpointing as ck
        with open(os.path.join(out_dir, "ckpt", "latest")) as f:
            tag_dir = os.path.join(out_dir, "ckpt", f.read().strip())
        with ck.NpzFile(os.path.join(tag_dir, ck.model_states_name() + ".npz")) as f:
            for k, v in dst._ckpt_export("params").items():
                assert np.array_equal(f[k], v), k
        with ck._MergedElastic(tag_dir) as merged:
            for kind in ("master", "opt"):
                flat = dst._ckpt_export(kind)
                assert len(flat) == (8 if kind == "master" else 16)
                for k, v in flat.items():
                    assert np.array_equal(merged[f"{kind}/{k}"], v), (stages, kind, k)
    # each rank of the per-rank run held its stage's 2 layers (w, b each)
    assert all(int(r["engine/params_local"]) == 4 for r in ranks)


# ------------------------------------------------------------ pipe 2 x data 2
ZERO_HIDDEN = 64
ZERO_STEPS = 6


def _zero_batches():
    rng = np.random.default_rng(19)
    w_true = np.random.default_rng(7).normal(size=(ZERO_HIDDEN, ZERO_HIDDEN)).astype(
        np.float32) * 0.3
    out = []
    for _ in range(2 * ZERO_STEPS):
        x = rng.normal(size=(16, ZERO_HIDDEN)).astype(np.float32)
        out.append((x, np.tanh(x @ w_true)))
    return out


def _zero_params():
    """The JAX test's PipelineModule of 4 Linear(64) layers: its params."""
    import jax
    import jax.numpy as jnp
    from test_torch_pipe_engine import JaxLinear, jax_mse_loss
    from deepspeed_tpu.parallel.pipe import LayerSpec, PipelineModule
    jm = PipelineModule(layers=[LayerSpec(JaxLinear, ZERO_HIDDEN) for _ in range(4)],
                        num_stages=2, loss_fn=jax_mse_loss)
    return jm, jm.init_params(jax.random.PRNGKey(3), jnp.zeros((4, ZERO_HIDDEN), jnp.float32))


def _zero_config():
    return {"train_batch_size": 32, "gradient_accumulation_steps": 2, "steps_per_print": 100,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": 2}}


class Linear64(torch.nn.Module):
    """The JAX test's layer at width 64: ``tanh(x @ w + b)`` in x's dtype."""

    def __init__(self, dim):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(ZERO_HIDDEN, dim))
        self.b = torch.nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return torch.tanh(x @ self.w.to(x.dtype) + self.b.to(x.dtype))


def _zero_worker(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous",
                            world_size=4, rank=rank)
    try:
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch.parallel.pipe import LayerSpec, PipelineModule
        from test_torch_pipe_engine import mse_loss
        params = dict(np.load(os.path.join(out_dir, "params.npz")))
        module = PipelineModule([LayerSpec(Linear64, ZERO_HIDDEN) for _ in range(4)],
                                num_stages=2, loss_fn=mse_loss)
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=module, model_parameters={k: torch.from_numpy(v) for k, v in params.items()},
            config_params=_zero_config(), device="cpu", dist_init_required=False)
        d = eng.dp_rank
        batches = _zero_batches()
        losses, norms = [], []
        for step in range(ZERO_STEPS):
            window = [(x[8 * d:8 * d + 8], y[8 * d:8 * d + 8])
                      for x, y in batches[2 * step:2 * step + 2]]
            t = eng.train_batch(iter(window)).float().clone()
            dist.all_reduce(t, group=eng._dp_group)
            losses.append(float(t) / 2)
            norms.append(float(eng._last_grad_norm))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), losses=np.asarray(losses),
                 norms=np.asarray(norms), spmd=np.asarray(eng._spmd),
                 mesh=np.asarray([eng.mesh.shape["pipe"], eng.dp_size]),
                 master=np.asarray([m.numel() for m in eng._master]),
                 whole=np.asarray([p.numel() for p in eng._params]))
    finally:
        dist.destroy_process_group()


def test_pipe2_data2_zero2_matches_jax():
    """pipe 2 x data 2 under ZeRO-2 (the JAX package's
    ``test_spmd_pipe_composes_with_zero2``, whose engine runs pipe 2 x data 4
    on the 8 virtual devices): the window losses and grad norms within bf16's
    1e-2 of the JAX engine's, each rank's master half of its stage's leaves,
    the loss falling."""
    import deepspeed_tpu
    jm, jparams = _zero_params()
    from deepspeed_tpu_torch.runtime.pipe.engine import params_from_jax
    from test_torch_pipe_engine import mse_loss
    from deepspeed_tpu_torch.parallel.pipe import LayerSpec, PipelineModule
    tmpl = PipelineModule([LayerSpec(Linear64, ZERO_HIDDEN) for _ in range(4)], num_stages=2,
                          loss_fn=mse_loss)
    flat = {k: v.numpy() for k, v in params_from_jax(tmpl, jparams, device="cpu").items()}
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=jparams,
                                             config_params=_zero_config())
    assert jeng._spmd
    batches = _zero_batches()
    jl, jn = [], []
    for step in range(ZERO_STEPS):
        jl.append(float(jeng.train_batch(iter(batches[2 * step:2 * step + 2]))))
        jn.append(float(jeng._last_grad_norm))
    with tempfile.TemporaryDirectory() as out_dir:
        np.savez(os.path.join(out_dir, "params.npz"), **flat)
        mp.start_processes(_zero_worker, args=(out_dir,), nprocs=4, start_method="spawn",
                           join=True)
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(4)]
    for r in ranks:
        assert bool(r["spmd"]) and list(r["mesh"]) == [2, 2]
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-2)
        np.testing.assert_allclose(r["norms"], jn, rtol=1e-2)
        assert r["losses"][-1] < r["losses"][0] * 0.9
        # ZeRO-2 over the data group: every 64 x 64 weight's master halved
        assert list(r["master"]) == [n // 2 if n == ZERO_HIDDEN ** 2 else n
                                     for n in r["whole"]]
        assert len(r["whole"]) == 4                                  # 2 layers (w, b)


# ------------------------------------------------------------------ host-only
@pytest.mark.parametrize("M_,S_,cap,streamed", [(128, 8, 32, True), (128, 8, 32, False),
                                                (16, 2, 8, True), (16, 2, 8, False),
                                                (8, 4, 8, True)])
def test_flush_schedule_equals_jax(M_, S_, cap, streamed):
    from deepspeed_tpu.parallel.pipeline_spmd import flush_schedule as jax_flush_schedule
    assert flush_schedule(M_, S_, cap, streamed) == jax_flush_schedule(M_, S_, cap, streamed)
    with pytest.raises(AssertionError):
        flush_schedule(M=10, S=2, cap=4)


def test_refusals_name_their_item_and_specs_are_explicit():
    from deepspeed_tpu_torch.parallel import build_mesh
    from deepspeed_tpu_torch.parallel.pipeline_spmd import pipeline_apply
    with pytest.raises(NotImplementedError, match="item 16b"):
        GPT2Pipe(_gpt_cfg_torch(), 2, tp=2, device="cpu")
    # the port demands specs for any last_stage_args (JAX infers P() for a
    # leaf whose leading dim is not M, test_pipeline_spmd.py:82-103)
    x = torch.zeros(M, B, H)
    with pytest.raises(ValueError, match="explicit last_stage_args_specs"):
        pipeline_apply(lambda p, h: h, {}, x, mesh=build_mesh(),
                       last_stage_fn=lambda y, s, mb: s * torch.mean(y),
                       last_stage_args=(torch.tensor(2.0),))
    loss = pipeline_apply(lambda p, h: h, {}, x + 1, mesh=build_mesh(),
                          last_stage_fn=lambda y, s, mb: s * torch.mean(y),
                          last_stage_args=(torch.tensor(2.0),), last_stage_args_specs=("rep",))
    assert float(loss) == 2.0


def test_stage3_under_a_pipeline_names_its_item():
    """ZeRO stage 3 under the per-rank executor's pipe axis raises (item 16b);
    a world of one process takes the instruction executor, which runs it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.mesh import Mesh
    from deepspeed_tpu_torch.parallel.topology import PipeDataParallelTopology
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    class _Mpu:
        def __init__(self, mesh):
            self.mesh = mesh

    mesh = Mesh(PipeDataParallelTopology(num_pp=2, num_dp=1), 0)
    gp = GPT2Pipe(_gpt_cfg_torch(), 2, mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="ZeRO stage 3 under pipeline .* item 16b"):
        DeepSpeedEngine(model=gp, config_params=_engine_config(
            8, 1, bf16={"enabled": True}, zero_optimization={"stage": 3}),
            device="cpu", mpu=_Mpu(mesh), param_shardings=gp.param_shardings(mesh))
    module = _toy_module(2)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=module, device="cpu", config_params=_engine_config(
            32, 2, bf16={"enabled": True}, zero_optimization={"stage": 3}))
    assert not eng._spmd
    assert np.isfinite(float(eng.train_batch(iter(_toy_batches(2)))))
