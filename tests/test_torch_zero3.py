"""ZeRO stage 3 in the PyTorch port's engine, on the CPU.

Counterparts of ``tests/unit/test_zero3.py``. A tiny GPT-2 (vocab 128, width
64, 3 layers, 4 heads, T 32) from the JAX init (``params_from_jax``) and an
MLP of width 64 train on seeded micro-batches.

- dp = 1: the port at stage 3 against the JAX engine at stage 3 on a
  one-device mesh (float32 compute within 1e-5, bf16 compute within 1e-2),
  and against the port's own stage 2 bit for bit (two-step, fused, remat,
  LAMB, ZeRO-Offload); the config's stage-3 rules.
- dp = 2, two gloo processes, one spawn for every case: each shardable
  compute parameter holds half its leaf; losses, grad norms and the gathered
  masters equal the one-rank run under ``DP_MODES``' tolerances (GPT-2 with
  and without remat, full or "dots", the fused step, LAMB, the MLP through
  the generic gather at attribute access), and with the numerics sentinel
  on, its per-subtree norms are one rank's and the desync audit finds none;
  stage 3 + offload equals stage 2 + offload; a checkpoint round trip keeps
  the state bit for bit, restores at dp = 1 and loads in the JAX engine;
  ``generate``, ``beam_search`` and ``model(tokens)`` on the module of
  slices, outside the engine, equal the one-rank module's (fault C7); the
  gathered high-water mark on GPT-2 is at most one block's leaves plus
  ``wte``; the memory manifest reconciles with the
  ``utils/hbm.py`` model.
- dp = 8 in torch's fake process group: the recorded forward/backward
  all-gathers the parameters at stage 3 and not at stage 2, and both lint
  clean against their manifests.

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
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.zero.sharding import unshard, zero_spec

from test_torch_engine import DP_MODES

DIMS = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=3, n_head=4)
T, GAS, STEPS = 32, 2, 3
OPTIMIZERS = {"AdamW": {"lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1},
              "Lamb": {"lr": 1e-2, "weight_decay": 0.01}}


def _config(stage, dp=1, micro=1, gas=GAS, opt="AdamW", offload=False, **extra):
    cfg = {"train_batch_size": micro * gas * dp,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "steps_per_print": 1000,
           "optimizer": {"type": opt, "params": OPTIMIZERS[opt]},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 3, "warmup_max_lr": 1e-2,
                                    "warmup_min_lr": 1e-3}},
           "gradient_clipping": 0.5,
           "bf16": {"enabled": True},
           "zero_optimization": {"stage": stage, "cpu_offload": offload}}
    cfg.update(extra)
    return cfg


def _batches(n, micro, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, DIMS["vocab_size"], size=(micro, T)).astype(np.int64)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        out.append((tokens, labels))
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(compute):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=getattr(jnp, compute),
                                    loss_chunk=0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params():
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return {k: v.numpy() for k, v in params_from_jax(_jax_model("float32")[1],
                                                     device="cpu").items()}


def _gpt2(params, compute=torch.float32, **over):
    model = GPT2Model(GPT2Config(**DIMS, compute_dtype=compute, **dict(
        dict(loss_chunk=16), **over)), device="cpu")
    return model, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


class _MLP(torch.nn.Module):
    """Two 64-wide layers and a squared error: its weights (64 x 64) shard,
    its biases (64 elements) stay replicated."""

    def __init__(self, hidden=64):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.l1 = torch.nn.Linear(hidden, hidden)
        self.l2 = torch.nn.Linear(hidden, hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)

    def forward(self, x, y):
        h = torch.tanh(self.l1(x.to(torch.bfloat16)))
        return (self.l2(h).float() - y).square().mean()


def _mlp_batches(n, micro, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(micro, 64).astype(np.float32), rng.randn(micro, 64).astype(np.float32))
            for _ in range(n)]


def _engine(cfg, model="gpt2", scale=1.0, dist_init=None, **over):
    if model == "mlp":
        tm, params = _MLP(), None
    else:
        tm, params = _gpt2(_port_params(), **over)
        params = {k: v * scale for k, v in params.items()}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params, config_params=cfg, device="cpu",
        dist_init_required=dist_init)
    return eng


def _train(eng, batches, rows=slice(None)):
    """(per-micro-step losses, per-step grad norms) on ``rows`` of each
    batch; at dp > 1 the losses are the mean over the ranks."""
    losses, norms = [], []
    for a, b in batches:
        loss = eng(a[rows], b[rows])
        eng.backward(loss)
        eng.step()
        t = loss.detach().float().clone()
        if eng.dp_size > 1:
            dist.all_reduce(t)
        losses.append(float(t) / eng.dp_size)
        if eng.is_gradient_accumulation_boundary():
            norms.append(float(eng._last_grad_norm))
    return np.asarray(losses), np.asarray(norms)


def _masters(eng):
    return {n: unshard(m, a, eng.dp_size).numpy()
            for (n, m), a in zip(eng.master_params.items(), eng._axes)}


def _state(eng):
    """Every array a save writes (the slices gathered), as host copies."""
    out = {f"params/{k}": np.array(v) for k, v in eng._ckpt_export("params").items()}
    out.update({f"master/{k}": np.array(v) for k, v in eng._ckpt_export("master").items()})
    out.update({f"opt/{k}": np.array(v) for k, v in eng._ckpt_export("opt").items()})
    return out


# ------------------------------------------------------------------ dp = 1
@functools.lru_cache(maxsize=None)
def _jax_run(compute):
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp = _jax_model(compute)
    eng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                          config_params=_config(3, micro=2))
    losses = []
    for tokens, labels in _batches(2 * STEPS * GAS, 2):
        loss = eng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    return np.asarray(losses)


# float32 compute over bf16 parameters: the frameworks' summation order
# (tests/test_torch_engine.py's stage 2); bf16 compute rounds every product's
# result to bf16, where XLA and torch pick different points to round
@pytest.mark.parametrize("compute,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_stage3_matches_the_jax_engine(compute, rtol):
    eng = _engine(_config(3, micro=2), compute=getattr(torch, compute), loss_chunk=0)
    assert eng._gather is not None and not eng._gather.sharded
    got, _ = _train(eng, _batches(2 * STEPS * GAS, 2))
    np.testing.assert_allclose(got, _jax_run(compute), rtol=rtol, atol=0)
    assert eng.global_steps == 2 * STEPS and eng._gather.gathers == 0


# at one rank zero_spec shards nothing: stage 3 is stage 2, bit for bit, on
# every path of the step
VARIANTS = {
    "two_step": ({}, {}),
    "fused": ({"gas": 1, "fused_step": True}, {}),
    "remat": ({}, {"remat": True}),
    "lamb": ({"opt": "Lamb"}, {}),
    "offload": ({"offload": True}, {}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stage3_is_stage2_bit_for_bit_at_one_rank(variant):
    cfg_kw, model_kw = VARIANTS[variant]
    runs = []
    for stage in (2, 3):
        eng = _engine(_config(stage, micro=2, **cfg_kw), **model_kw)
        losses, norms = _train(eng, _batches(STEPS * eng.gradient_accumulation_steps(), 2))
        runs.append((losses, norms, _state(eng), eng.memory_manifest()["geometry"]))
    (l2, n2, s2, g2), (l3, n3, s3, g3) = runs
    assert list(l2) == list(l3) and list(n2) == list(n3)
    assert sorted(s2) == sorted(s3)
    for k in s2:
        np.testing.assert_array_equal(s2[k], s3[k], err_msg=k)
    assert (g2["zero_stage"], g3["zero_stage"]) == (2, 3)
    assert {k: v for k, v in g2.items() if k != "zero_stage"} == \
        {k: v for k, v in g3.items() if k != "zero_stage"}


@pytest.mark.parametrize("zero,ok", [
    ({"stage": 3}, True), ({"stage": 3, "cpu_offload": True}, True),
    ({"stage": 4}, False), ({"stage": 1, "cpu_offload": True}, False)],
    ids=["stage3", "stage3_offload", "stage4", "stage1_offload"])
def test_zero3_config_validation(zero, ok):
    """tests/unit/test_zero3.py::test_zero3_config_validation: stage 3 is
    accepted alone and with cpu_offload; stage 4, and cpu_offload at stage
    1, raise; an accepted config builds an engine."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = {"train_batch_size": 8, "bf16": {"enabled": True}, "zero_optimization": zero}
    if not ok:
        with pytest.raises(AssertionError):
            DeepSpeedConfig(cfg, world_size=8)
        return
    parsed = DeepSpeedConfig(cfg, world_size=8)
    assert parsed.zero_optimization_stage == 3
    assert parsed.zero_config.cpu_offload == bool(zero.get("cpu_offload"))
    eng = _engine(_config(3, offload=bool(zero.get("cpu_offload")), micro=2), model="mlp")
    assert (eng._offload is not None) == bool(zero.get("cpu_offload"))


def test_stage3_refusals_stay():
    """What the JAX engine refuses at stage 3 still raises: the two-level
    and bucketed exchanges (ValueError) and 1-bit Adam (AssertionError);
    sparse gradients fall back to the dense reduction."""
    for extra, exc in (({"comm": {"mode": "hierarchical"}}, ValueError),
                       ({"comm": {"overlap": {"mode": "bucketed"}}}, ValueError),
                       ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}},
                        AssertionError)):
        with pytest.raises(exc):
            _engine(_config(3, micro=2, **extra), model="mlp")
    eng = _engine(_config(3, micro=2, sparse_gradients=True))
    assert eng._sparse_flags is None and eng._exchange_kind == "flat"


# ------------------------------------------------------------------ dp = 2
# DP_MODES, and "row": each rank on one row, the one-rank run on that row
# alone at one thread (the ranks' kernels): the grads are the same bit for
# bit, and only the order of the sums over the ranks differs (the per-subtree
# norms of small subtrees see a one-ulp bf16 flip of "same" mode's grads)
MODES = dict(DP_MODES, row=([0, 0], 1e-6, 1e-6, 1e-6))
# (name, model, config kwargs, model kwargs, mode)
DP_CASES = [
    ("gpt2_same", "gpt2", {}, {}, "same"),
    ("gpt2_distinct", "gpt2", {}, {}, "distinct"),
    ("gpt2_remat", "gpt2", {}, {"remat": True}, "same"),
    ("gpt2_remat_dots", "gpt2", {}, {"remat": True, "remat_policy": "dots"}, "same"),
    ("gpt2_fused", "gpt2", {"gas": 1, "fused_step": True}, {}, "same"),
    ("gpt2_lamb", "gpt2", {"opt": "Lamb"}, {}, "same"),
    ("gpt2_numerics", "gpt2", {"numerics": {"enabled": True, "audit_interval": 2}}, {},
     "row"),
    ("mlp", "mlp", {}, {}, "same"),
]


def _with_dump_dir(cfg_kw, root):
    if "numerics" in cfg_kw:
        cfg_kw = dict(cfg_kw, numerics=dict(cfg_kw["numerics"], dump_dir=root))
    return cfg_kw


def _sentinel(eng):
    """The last step's per-subtree weight and grad norms, the audits run
    and whether one found a desync (the numerics block only)."""
    if eng._numerics is None:
        return {}
    rec = eng._numerics.last_record
    return {"weight_norms": np.asarray(rec["weight_norm_per_subtree"]),
            "grad_norms": np.asarray(rec["grad_norm_per_subtree"]),
            "audit": np.asarray([eng._numerics.audit_runs, eng._numerics.desync is not None])}


def _case_batches(model, gas):
    return (_mlp_batches if model == "mlp" else _batches)(STEPS * gas, 2)


def _block_bytes(eng):
    """(the largest block's gathered bytes, wte's) of a GPT-2 engine: the
    sharded leaves at their full size in the compute dtype."""
    size = torch.empty((), dtype=eng.compute_dtype).element_size()
    per = {}
    for n, s, pa in zip(eng._names, eng._shapes, eng._param_axes):
        if pa is not None:
            key = ".".join(n.split(".")[:2]) if n.startswith("blocks.") else n
            per[key] = per.get(key, 0) + int(np.prod(s)) * size
    blocks = [v for k, v in per.items() if k.startswith("blocks.")]
    return max(blocks), per["wte"], sum(blocks)


def _outside_the_engine(module):
    """``generate``, ``beam_search``, ``model(tokens)`` and a serving engine
    over a module, on a fixed prompt: what fault C7 broke for a module of
    stage-3 slices."""
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    from deepspeed_tpu_torch.serve.scheduler import Request
    tok = torch.from_numpy(np.random.RandomState(7).randint(0, DIMS["vocab_size"], (2, 6)))
    seqs, scores = module.beam_search(tok, 4, num_beams=2)
    serving = InferenceEngine(module, num_slots=2, block_size=4, num_blocks=17,
                              max_model_len=T, prefill_chunk=8)
    outs, _ = serving.run([Request(f"r{i}", row.tolist(), 4) for i, row in enumerate(tok)])
    return {"generate": module.generate(tok, 4).numpy(), "beam": seqs.numpy(),
            "beam_scores": scores.numpy(), "logits": module(tok).detach().numpy(),
            "serve": np.asarray([o.tokens for o in outs])}


def _dp_worker(rank, port, out_dir):
    # one thread a rank: two ranks of tiny ops gain nothing from more, and
    # contend for the cores with the other test workers
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        from deepspeed_tpu_torch.utils import hbm
        res = {}
        for name, model, cfg_kw, model_kw, mode in DP_CASES:
            rows = MODES[mode][0][rank:rank + 1]
            cfg_kw = _with_dump_dir(cfg_kw, os.path.join(out_dir, f"dumps{rank}"))
            eng = _engine(_config(3, dp=2, **cfg_kw), model=model, dist_init=False, **model_kw)
            res[f"{name}/local"] = np.asarray([p.numel() for p in eng._params])
            eng._gather.reset_counters()
            losses, norms = _train(eng, _case_batches(model, eng.gradient_accumulation_steps()),
                                   rows)
            res[f"{name}/losses"], res[f"{name}/norms"] = losses, norms
            res[f"{name}/gather"] = np.asarray([eng._gather.gathers, eng._gather.peak_bytes,
                                                eng._gather.alive_bytes])
            res.update({f"{name}/sentinel/{k}": v for k, v in _sentinel(eng).items()})
            if model == "gpt2":
                res[f"{name}/bounds"] = np.asarray(_block_bytes(eng))
            for n, m in _masters(eng).items():
                res[f"{name}/master/{n}"] = m
            report = hbm.engine_report(eng)
            params = report["classes"]["params"]
            res[f"{name}/manifest"] = np.asarray(
                [report["reconciled"], params["parsed_bytes"], params["modeled_bytes"]])
        # stage 3 + offload against stage 2 + offload
        for stage in (2, 3):
            eng = _engine(_config(stage, dp=2, offload=True), dist_init=False)
            res[f"offload{stage}/losses"], res[f"offload{stage}/norms"] = _train(
                eng, _batches(STEPS * GAS, 2), DP_MODES["same"][0][rank:rank + 1])
            res[f"offload{stage}/params"] = np.concatenate(
                [v.reshape(-1) for v in eng._ckpt_export("params").values()])
        # a checkpoint round trip at stage 3, and what a fresh engine loads
        rows = DP_MODES["same"][0][rank:rank + 1]
        eng = _engine(_config(3, dp=2), dist_init=False)
        _train(eng, _batches(STEPS * GAS, 2), rows)
        eng.save_checkpoint(os.path.join(out_dir, "z3"))
        res.update({f"saved/{k}": v for k, v in _state(eng).items()})
        res["saved_losses"], _ = _train(eng, _batches(2 * STEPS * GAS, 2)[STEPS * GAS:], rows)
        again = _engine(_config(3, dp=2), scale=0.5, dist_init=False)
        again.load_checkpoint(os.path.join(out_dir, "z3"))
        res.update({f"loaded/{k}": v for k, v in _state(again).items()})
        res["loaded_local"] = np.asarray([p.numel() for p in again._params])
        # fault C7: the module of slices used outside the engine
        try:
            res.update({f"c7/{k}": v for k, v in _outside_the_engine(again.module).items()})
        except Exception as err:  # recorded, so that only the C7 test fails on it
            res["c7_error"] = np.asarray(repr(err))
        res["c7_local"] = np.asarray([p.numel() for p in again._params])
        res["loaded_losses"], _ = _train(again, _batches(2 * STEPS * GAS, 2)[STEPS * GAS:],
                                         rows)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _gloo_run():
    out_dir = tempfile.mkdtemp(prefix="zero3_gloo_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dp_worker, args=(port, out_dir), nprocs=2, start_method="spawn",
                       join=True)
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in (0, 1)]
    return out_dir, ranks


@functools.lru_cache(maxsize=None)
def _dp1_run(name):
    _, model, cfg_kw, model_kw, mode = next(c for c in DP_CASES if c[0] == name)
    cfg_kw = _with_dump_dir(cfg_kw, tempfile.mkdtemp(prefix="zero3_dumps_"))
    row = mode == "row"
    threads = torch.get_num_threads()
    if row:
        torch.set_num_threads(1)
    try:
        eng = _engine(_config(3, micro=1 if row else 2, **cfg_kw), model=model, **model_kw)
        losses, norms = _train(eng, _case_batches(model, eng.gradient_accumulation_steps()),
                               [0] if row else MODES[mode][0])
    finally:
        torch.set_num_threads(threads)
    return losses, norms, _masters(eng), [tuple(s) for s in eng._shapes], _sentinel(eng)


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("name", [c[0] for c in DP_CASES])
def test_dp2_equals_dp1(name):
    """Losses, grad norms and the gathered masters of two ranks at stage 3
    against one rank, under DP_MODES' tolerances; each shardable compute
    parameter holds half its leaf on each rank."""
    _, ranks = _gloo_run()
    mode = next(c[4] for c in DP_CASES if c[0] == name)
    _, loss_tol, norm_tol, master_tol = MODES[mode]
    losses, norms, masters, shapes, sentinel = _dp1_run(name)
    for res in ranks:
        np.testing.assert_allclose(res[f"{name}/losses"], losses, rtol=loss_tol, atol=0)
        np.testing.assert_allclose(res[f"{name}/norms"], norms, rtol=norm_tol, atol=0)
        if master_tol is not None:
            for n, m in masters.items():
                np.testing.assert_allclose(res[f"{name}/master/{n}"], m, rtol=0,
                                           atol=master_tol, err_msg=n)
        for shape, held in zip(shapes, res[f"{name}/local"]):
            size = int(np.prod(shape))
            assert held == (size // 2 if zero_spec(shape, 2) is not None else size), shape
        gathers, peak, alive = res[f"{name}/gather"]
        assert gathers > 0 and peak > 0 and alive == 0
        # the numerics sentinel: the sharded leaves' squares summed over the
        # ranks read what one rank reads; the desync audit skips the compute
        # slices, which differ by rank, and finds the replicated leaves equal
        got = _sub(res, f"{name}/sentinel")
        assert sorted(got) == sorted(sentinel)
        for key in ("weight_norms", "grad_norms"):
            if key in sentinel:
                np.testing.assert_allclose(got[key], sentinel[key], rtol=norm_tol, atol=0)
        if sentinel:
            assert list(got["audit"]) == [STEPS // 2, 0]
        # the hbm model reconciles, the params class at its slices' bytes
        ok, parsed, modeled = res[f"{name}/manifest"]
        assert ok == 1 and parsed == modeled == 2 * int(res[f"{name}/local"].sum())


@pytest.mark.parametrize("name", ["gpt2_same", "gpt2_remat", "gpt2_remat_dots"])
def test_gpt2_gathers_one_block_at_a_time(name):
    """The gathered high-water mark over a whole step: at most one block's
    sharded leaves plus wte at their full size, without remat, with full
    remat and with the "dots" policy (a selective checkpoint),
    well under the three blocks' that a gather of the whole model holds;
    the recompute (remat) gathers each block again."""
    _, ranks = _gloo_run()
    for res in ranks:
        gathers, peak, _ = res[f"{name}/gather"]
        block, wte, blocks = res[f"{name}/bounds"]
        assert 0 < peak <= block + wte < blocks + wte, (peak, block, wte)
    # without remat the backward gathers each saved leaf again, with remat
    # the recompute gathers each block: both more than the forward's
    n_fwd = 3 * 4 + 3          # per micro-step: 4 sharded leaves a block, wte x 2, wpe
    assert all(r[f"{name}/gather"][0] > n_fwd * STEPS * GAS for r in ranks)


def test_stage3_offload_equals_stage2_offload():
    """tests/unit/test_zero3.py::test_zero3_composes_with_offload at dp = 2:
    the host tier steps the same slices, and the push lands in the compute
    slices instead of being gathered."""
    _, ranks = _gloo_run()
    for res in ranks:
        for key in ("losses", "norms", "params"):
            np.testing.assert_allclose(res[f"offload3/{key}"], res[f"offload2/{key}"],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
        assert res["offload3/losses"][-1] < res["offload3/losses"][0]


def test_checkpoint_round_trip_keeps_the_state():
    """tests/unit/test_zero3.py::test_zero3_checkpoint_roundtrip at dp = 2:
    the whole leaves written, a fresh engine (another init) restores them
    bit for bit into its slices and takes the same next steps."""
    out_dir, ranks = _gloo_run()
    for res in ranks:
        saved, loaded = _sub(res, "saved"), _sub(res, "loaded")
        assert sorted(saved) == sorted(loaded)
        for k in saved:
            np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
        np.testing.assert_array_equal(res["loaded_losses"], res["saved_losses"])
        assert list(res["loaded_local"]) == list(res["gpt2_same/local"])


def test_stage3_checkpoint_restores_at_one_rank():
    """The elastic restore dp = 2 -> 1 at stage 3
    (tests/unit/test_checkpointing.py:189-215): the one-rank engine holds
    what the two ranks saved, and its next steps' losses match theirs."""
    out_dir, ranks = _gloo_run()
    one = _engine(_config(3, micro=2), scale=0.5)
    one.load_checkpoint(os.path.join(out_dir, "z3"))
    state = _state(one)
    saved = _sub(ranks[0], "saved")
    for k in saved:
        np.testing.assert_array_equal(state[k], saved[k], err_msg=k)
    losses, _ = _train(one, _batches(2 * STEPS * GAS, 2)[STEPS * GAS:], DP_MODES["same"][0])
    np.testing.assert_allclose(losses, ranks[0]["saved_losses"], rtol=1e-5, atol=0)


def test_stage3_module_outside_the_engine_equals_one_rank():
    """Fault C7: ``generate``, ``beam_search``, a plain ``model(tokens)`` and
    a serving engine (``init_inference``'s) on the module of a stage-3 engine
    at dp = 2 (each parameter a slice) run on whole leaves, gathered without
    grad, and give what the one-rank engine holding the same state gives
    (both restored from the same checkpoint)."""
    out_dir, ranks = _gloo_run()
    one = _engine(_config(3, micro=2), scale=0.5)
    one.load_checkpoint(os.path.join(out_dir, "z3"))
    want = _outside_the_engine(one.module)
    for res in ranks:
        assert "c7_error" not in res, str(res.get("c7_error"))
        got = _sub(res, "c7")
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        # the slices are back after each call
        assert list(res["c7_local"]) == list(res["loaded_local"])


def test_jax_engine_loads_the_stage3_checkpoint():
    """The JAX engine at stage 3 restores the two ranks' checkpoint: its
    params, master and moments equal what the port saved."""
    import jax
    from deepspeed_tpu.checkpoint.checkpointing import _flatten_with_paths
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    out_dir, ranks = _gloo_run()
    jm, jp = _jax_model("float32")
    jeng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=_config(3, micro=2))
    path, _ = jeng.load_checkpoint(os.path.join(out_dir, "z3"))
    assert path is not None and jeng.global_steps == STEPS
    got = {f"params/{k}": v for k, v in _flatten_with_paths(jeng.params).items()}
    got.update({f"master/{k}": v for k, v in _flatten_with_paths(jeng.master_params).items()})
    got.update({f"opt/{k}": v for k, v in _flatten_with_paths(jeng.opt_state).items()})
    got = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), got)
    saved = _sub(ranks[0], "saved")
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ------------------------------------------------------------------ dp = 8
@pytest.mark.parametrize("stage", [2, 3])
def test_recorded_program_gathers_only_at_stage3(stage):
    """tests/unit/test_zero3.py::test_zero3_forward_all_gathers_params: in
    torch's fake process group of 8 ranks the recorded forward/backward of
    stage 3 all-gathers the parameters (bf16) and stage 2's does not; the
    update re-gathers at stage 2 only. Every program keeps its manifest's
    collectives and in-place state (the bf16 model's float32 LM head is the
    dtype pass's, tests/test_torch_lint_programs.py)."""
    from deepspeed_tpu_torch.lint.program_passes import ProgramArtifact, run_program_passes
    from deepspeed_tpu_torch.utils.op_record import collective_counts, collective_results
    from deepspeed_tpu_torch.utils.op_record import fake_world
    with fake_world(8):
        eng = _engine(_config(stage, dp=8), dist_init=False, compute=torch.bfloat16)
        arts = [ProgramArtifact.capture(n, fn, args, man)
                for n, fn, args, man in eng.lint_programs(_batches(1, 1)[0])]
    assert [a.name for a in arts] == ["loss_and_grad", "accumulate", "apply_update"]
    assert [v for v in run_program_passes(arts) if v.pass_id != "program-dtype"] == []
    lg, _, upd = (collective_counts(a.program) for a in arts)
    gathered = {dt for _, dt, _ in collective_results(arts[0].program, "all-gather")}
    if stage == 3:
        assert lg.get("all-gather", 0) >= 4 * DIMS["n_layer"] and gathered == {"bf16"}
        assert upd.get("all-gather", 0) == 0
    else:
        assert lg.get("all-gather", 0) == 0 and upd.get("all-gather", 0) >= 1
