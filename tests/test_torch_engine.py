"""Training engine of the PyTorch port against the JAX package, on the CPU.

A tiny GPT-2 (dense attention, float32 weights and compute) from the JAX
init is trained by the port's ``initialize`` -> ``DeepSpeedEngine`` and by
the JAX ``DeepSpeedEngine`` on a single-device mesh, on the same seeded
micro-batches: the loss trajectories agree within 1e-5 relative (float32;
the frameworks sum in different orders) at ZeRO 0, 1 and 2 with
gradient accumulation, clipping and WarmupLR, for Adam (L2) and AdamW, and
for SGD and LAMB. The loss scaler is held against the JAX ``update`` over a
scripted overflow sequence. Two gloo processes (dp = 2) train the same
trajectory as one process, and each holds half of every shardable moment.
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
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls
from deepspeed_tpu_torch.runtime.zero.sharding import (shard, sharding_coverage, unshard,
                                                       zero_spec)

DIMS = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=2)
MICRO, GAS, T = 2, 2, 16

OPTIMIZERS = {
    "AdamW": {"lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1},
    "Adam": {"lr": 1e-2, "betas": [0.9, 0.95], "weight_decay": 0.1},
    "SGD": {"lr": 0.1, "betas": [0.9, 0.999], "weight_decay": 0.01},
    "Lamb": {"lr": 1e-2, "weight_decay": 0.01},
}


def _config(opt, stage, gas=GAS, micro=MICRO, dp=1):
    return {"train_batch_size": micro * gas * dp,
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "steps_per_print": 1000,
            "optimizer": {"type": opt, "params": OPTIMIZERS[opt]},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3, "warmup_max_lr": 1e-2,
                                     "warmup_min_lr": 1e-3}},
            "gradient_clipping": 0.5,
            # ZeRO needs a low-precision policy: bf16 parameters at stages 1-2
            # (the model still computes in float32), float32 at stage 0
            "bf16": {"enabled": stage > 0},
            "zero_optimization": {"stage": stage}}


def _batches(n, micro=MICRO, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, DIMS["vocab_size"], size=(micro, T)).astype(np.int64)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        out.append((tokens, labels))
    return out


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _port_params():
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return {k: v.numpy() for k, v in params_from_jax(_jax_params()[1], device="cpu").items()}


def _port_model(params):
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    return tm, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _jax_trajectory(opt, stage, steps, gas):
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp = _jax_params()
    eng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                          config_params=_config(opt, stage, gas=gas))
    losses = []
    for tokens, labels in _batches(steps * gas):
        loss = eng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    return np.asarray(losses)


def _rows(tokens, labels, rows):
    return tokens[rows], labels[rows]


def _port_trajectory(opt, stage, steps, gas=GAS, rows=slice(None)):
    """(per-micro-step losses, per-step grad norms, engine) of the port on
    ``rows`` of each seeded micro-batch."""
    tm, params = _port_model(_port_params())
    eng, handle, _, sched = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params, config_params=_config(opt, stage, gas=gas),
        device="cpu")
    assert handle is eng.optimizer and sched is eng.lr_scheduler
    losses, norms = [], []
    for tokens, labels in _batches(steps * gas):
        loss = eng(*_rows(tokens, labels, rows))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
        if eng.is_gradient_accumulation_boundary():
            norms.append(float(eng._last_grad_norm))
    return np.asarray(losses), np.asarray(norms), eng


@pytest.mark.parametrize("opt", ["AdamW", "Adam"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_adam_trajectory_matches_jax_engine(opt, stage):
    got, _, eng = _port_trajectory(opt, stage, steps=6)
    want = _jax_trajectory(opt, stage, 6, GAS)
    # stage 1 has bf16 parameters and float32 grads. The JAX engine casts the
    # bf16 grads to float32, and XLA drops that bf16 round trip (excess
    # precision), so its grads are never rounded; autograd stores the grads of
    # bf16 parameters in bf16. Measured: 2.3e-4 relative over 12 micro-steps
    # (L2 Adam), 2.8e-5 (AdamW). Stages 0 (float32) and 2 (bf16 grads on both
    # sides) agree to 1e-5.
    np.testing.assert_allclose(got, want, rtol=5e-4 if stage == 1 else 1e-5, atol=0)
    assert eng.global_steps == 6 and eng.skipped_steps == 0
    assert eng._acc_dtype == torch.float32 and eng.get_lr() == eng.lr_scheduler.get_last_lr()


@pytest.mark.parametrize("opt", ["SGD", "Lamb"])
def test_sgd_and_lamb_trajectory_matches_jax_engine(opt):
    got, _, _ = _port_trajectory(opt, 0, steps=3, gas=1)
    np.testing.assert_allclose(got, _jax_trajectory(opt, 0, 3, 1), rtol=1e-5, atol=0)


def test_loss_scaler_matches_jax_update():
    """Ramp, backoff, hysteresis and the min-scale floor over a scripted
    sequence of overflows, state by state."""
    from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
    flags = [1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0]
    kw = dict(dynamic=True, scale_window=3, min_scale=2.0, hysteresis=2)
    mine, theirs = ls.init_state(0, 3, 2), jls.init_state(0, 3, 2)
    for f in flags:
        mine = ls.update(mine, bool(f), **kw)
        theirs = jls.update(theirs, np.bool_(f), **kw)
        assert tuple(mine) == tuple(float(x) if i == 0 else int(x)
                                    for i, x in enumerate(theirs)), (f, mine, theirs)
    static = ls.update(ls.init_state(128.0), True, dynamic=False)
    assert static.cur_scale == 128.0 and static.iter_count == 1


class _Quadratic(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 4), 0.5))

    def forward(self, x):
        return (x.to(self.w.dtype) @ self.w).float().square().mean()


def test_fp16_overflow_skips_the_step():
    """A scale of 2**20 overflows the fp16 backward: the step is skipped
    (master untouched, no scheduler step) and the scale backs off after the
    hysteresis, as the JAX update says, until a step goes through."""
    from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
    cfg = {"train_batch_size": 1, "fp16": {"enabled": True, "initial_scale_power": 20,
                                           "hysteresis": 2, "loss_scale_window": 1000},
           "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}}}
    eng, _, _, sched = deepspeed_tpu_torch.initialize(model=_Quadratic(),
                                                      config_params=cfg, device="cpu")
    x = torch.ones(1, 4)
    master0 = eng.master_params["w"].clone()
    theirs = jls.init_state(0, 20, 2)
    skipped = []
    for _ in range(12):
        before = eng.skipped_steps
        eng.backward(eng(x))
        eng.step()
        overflow = eng.skipped_steps > before
        skipped.append(overflow)
        theirs = jls.update(theirs, np.bool_(overflow), dynamic=True, scale_window=1000,
                            min_scale=1.0, hysteresis=2)
        assert eng.loss_scale() == float(theirs.cur_scale)
    assert skipped[0] and not skipped[-1]
    n_skip = sum(skipped)
    assert eng.skipped_steps == n_skip and sched.last_batch_iteration == 12 - n_skip - 1
    assert not torch.equal(eng.master_params["w"], master0)


def _refused():
    """(config, exception, message) of each refusal: the communication modes
    and the sequence_parallel block refuse what the JAX
    engine refuses, with its exception (deepspeed_tpu/runtime/engine.py:
    185-235, 294-301)."""
    base = {"train_batch_size": 1}
    zero2 = {"zero_optimization": {"stage": 2}, "bf16": {"enabled": True}}
    return [
        (dict(base, optimizer={"type": "OneBitAdam", "params": {"lr": 1e-3}}, **zero2),
         AssertionError, "1-bit Adam does not compose with ZeRO"),
        (dict(base, sparse_gradients=True, comm={"overlap": {"mode": "bucketed"}}),
         ValueError, "does not compose with sparse_gradients"),
        (dict(base, comm={"mode": "hierarchical"}, zero_optimization={"stage": 3},
              bf16={"enabled": True}), ValueError, "requires ZeRO stage <= 2"),
        (dict(base, comm={"mode": "hierarchical_compressed"}, bf16={"enabled": True},
              zero_optimization={"stage": 2, "cpu_offload": True}),
         ValueError, "does not compose with ZeRO-Offload"),
        # a model without sequence_parallel_loss_fn (deepspeed_tpu/runtime/engine.py:261-265)
        (dict(base, sequence_parallel={"enabled": True}), TypeError, "sequence_parallel"),
    ]


_REFUSED_IDS = ["optimizer", "sparse_gradients", "comm", "comm", "sequence_parallel"]


@pytest.mark.parametrize("cfg,exc,match", _refused(), ids=_REFUSED_IDS)
def test_unported_config_raises(cfg, exc, match):
    with pytest.raises(exc, match=match):
        deepspeed_tpu_torch.initialize(model=_Quadratic(), config_params=cfg, device="cpu")


def test_unported_arguments_and_methods_raise():
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    cfg = {"train_batch_size": 1}
    # a client optimizer must be an (init, apply) pair, as in the JAX engine
    with pytest.raises(TypeError, match=r"\(init_fn, apply_fn\) pair"):
        DeepSpeedEngine(model=_Quadratic(), config_params=cfg, device="cpu",
                        optimizer=torch.optim.SGD(_Quadratic().parameters(), lr=0.1))

    # the pipeline with tensor parallelism inside it is a later item
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.gpt2_pipe import GPT2Pipe
    with pytest.raises(NotImplementedError, match="item 16b"):
        GPT2Pipe(GPT2Config(n_layer=2, n_embd=16, n_head=2, vocab_size=64), num_stages=2,
                 tp=2, device="cpu")
    # the lint hook is ported: the active path's programs, with manifests
    eng = DeepSpeedEngine(model=_Quadratic(), config_params=cfg, device="cpu")
    progs = eng.lint_programs((torch.ones(1, 4),))
    assert [name for name, *_ in progs] == ["loss_and_grad", "apply_update"]
    assert all(man["strict"] and man["any_reduction" if name == "loss_and_grad"
                                      else "collectives"] is not None
               for name, _, _, man in progs)


def test_eval_runs_without_grad_and_add_config_arguments():
    import argparse
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_Quadratic(), config_params={"train_batch_size": 1}, device="cpu")
    eng.eval()
    loss = eng(torch.ones(1, 4))
    assert not loss.requires_grad
    with pytest.raises(RuntimeError, match="backward"):
        eng.backward(loss)
    args = deepspeed_tpu_torch.add_config_arguments(argparse.ArgumentParser()).parse_args(
        ["--deepspeed", "--deepspeed_config", "c.json"])
    assert args.deepspeed and args.deepspeed_config == "c.json"


def test_loss_scale_journal_matches_jax():
    from deepspeed_tpu.runtime.fp16.loss_scaler import LossScaleJournal as JaxJournal
    flags = [1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0]
    mine = ls.LossScaleJournal(True, 8.0, scale_window=3, min_scale=2.0, hysteresis=2)
    theirs = JaxJournal(True, 8.0, scale_window=3, min_scale=2.0, hysteresis=2)
    for step, f in enumerate(flags):
        assert mine.record(step, bool(f)) == theirs.record(step, bool(f))
    assert list(mine.events) == list(theirs.events)


def test_single_process_world_and_timers():
    from deepspeed_tpu_torch.runtime import dist as ds_dist
    assert ds_dist.init_distributed("cpu", world_size=1) is False
    assert (ds_dist.get_rank(), ds_dist.get_world_size()) == (0, 1)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_Quadratic(), device="cpu",
        config_params={"train_batch_size": 1, "wall_clock_breakdown": True})
    for _ in range(2):
        eng.backward(eng(torch.ones(1, 4)))
        eng.step()
    assert set(eng.timers.timers) == {"forward_microstep", "backward_microstep",
                                      "step_microstep"}
    assert eng.global_steps == 2
    from deepspeed_tpu_torch.utils.timer import ThroughputTimer
    syncs = []
    tt = ThroughputTimer(batch_size=4, num_workers=1, start_step=1,
                         sync_fn=lambda: syncs.append(1))
    for _ in range(3):
        tt.start()
        tt.stop()
    assert tt.total_step_count == 3 and len(syncs) == 4 and tt.avg_samples_per_sec() > 0


def test_dataloader_gives_each_rank_its_rows():
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
    data = [(np.array([i]),) for i in range(8)]
    rows = [[b[0][:, 0].tolist() for b in DeepSpeedDataLoader(
        data, 2, data_parallel_world_size=2, data_parallel_rank=r)] for r in (0, 1)]
    assert rows == [[[0, 1], [4, 5]], [[2, 3], [6, 7]]]
    loop = RepeatingLoader(DeepSpeedDataLoader(data, 4))
    assert [next(loop)[0][0, 0] for _ in range(3)] == [0, 4, 0]


def test_runtime_utils_match_jax():
    import jax.numpy as jnp
    from deepspeed_tpu.runtime import utils as jutils
    from deepspeed_tpu_torch.runtime import utils as tutils
    for weights, parts in (([3, 1, 4, 1, 5, 9, 2, 6], 3), ([1] * 10, 4), ([2, 7], 5)):
        assert tutils.partition_balanced(weights, parts) == jutils.partition_balanced(
            weights, parts)
        assert tutils.partition_uniform(len(weights), parts) == jutils.partition_uniform(
            len(weights), parts)
    rng = np.random.RandomState(0)
    tree = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    want = float(jutils.global_norm([jnp.asarray(a) for a in tree]))
    got = tutils.get_grad_norm([torch.from_numpy(a) for a in tree])
    assert abs(float(got) - want) <= 1e-6 * want
    assert tutils.param_count({"a": torch.zeros(3, 4), "b": [torch.zeros(5)]}) == 17
    clipped = [torch.from_numpy(a.copy()) for a in tree]
    tutils.clip_grads_by_global_norm(clipped, 1.0)
    jclipped = jutils.clip_grads_by_global_norm([jnp.asarray(a) for a in tree], 1.0)
    for a, b in zip(clipped, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    bad = [torch.ones(2), torch.tensor([1.0, float("inf")])]
    assert bool(tutils.detect_overflow(bad, True)[0])
    assert not bool(tutils.detect_overflow(bad, False)[0])


def test_shard_copies_into_storage_of_its_own():
    """A rank's ZeRO slice owns storage of its slice's size: a view would keep
    the whole leaf alive (a slice along axis 0 of a contiguous leaf is
    contiguous), and the master would hold the full leaf on every rank."""
    full = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    for axis in (0, 1):
        for rank in range(4):
            part = shard(full, axis, rank, 4)
            assert part.is_contiguous()
            assert part.untyped_storage().nbytes() == part.numel() * 4
            assert torch.equal(part, full.chunk(4, dim=axis)[rank])
    assert shard(full, None, 0, 4) is full


# ------------------------------------------------------------------ dp = 2
# ZeRO needs bf16 parameters, so each rank's micro-batch grads are rounded to
# bf16 before the mean over ranks. With the same row on both ranks (and that
# row twice at dp = 1) the mean is exact: losses and grad norms agree to 1e-5
# and the masters to 1e-4 (Adam's normalized update turns the rare one-ulp
# flip of a near-zero grad into a visible step). With distinct rows each
# rank's rounding differs from the rounding of the two-row grad by up to one
# bf16 ulp (2**-8) per element: measured 2.4e-4 on the losses and 1.4e-3 on
# the norms over 6 micro-steps, and the masters are not compared.
# mode: (row of each rank, loss rtol, norm rtol, master atol)
DP_MODES = {"same": ([0, 0], 1e-5, 1e-5, 1e-4), "distinct": ([0, 1], 1e-3, 5e-3, None)}


def _dp_worker(rank, params, out_dir):
    # a file store in the test's own directory: a free TCP port picked by the
    # parent can be taken by another test process before rank 0 binds it
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", world_size=2,
                            rank=rank)
    try:
        for stage in (1, 2):
            for mode, (rows, *_) in DP_MODES.items():
                tm, ps = _port_model(params)
                eng, _, _, _ = deepspeed_tpu_torch.initialize(
                    model=tm, model_parameters=ps, device="cpu", dist_init_required=False,
                    config_params=_config("AdamW", stage, micro=1, dp=2))
                losses, norms = [], []
                for tokens, labels in _batches(3 * GAS):
                    loss = eng(*_rows(tokens, labels, rows[rank:rank + 1]))
                    eng.backward(loss)
                    eng.step()
                    t = loss.detach().clone()
                    dist.all_reduce(t)
                    losses.append(float(t) / 2)
                    if eng.is_gradient_accumulation_boundary():
                        norms.append(float(eng._last_grad_norm))
                full = {n: unshard(m, a, 2).numpy()
                        for (n, m), a in zip(eng.master_params.items(), eng._axes)}
                np.savez(os.path.join(out_dir, f"{stage}_{mode}_{rank}.npz"),
                         losses=np.asarray(losses), norms=np.asarray(norms),
                         moments=np.asarray([m.numel() for m in eng.opt_state.exp_avg]),
                         frac=np.asarray(eng._zero_sharded_fraction),
                         **{f"full/{n}": v for n, v in full.items()})
    finally:
        dist.destroy_process_group()


def test_dp2_over_gloo_equals_dp1():
    params = _port_params()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_dp_worker, args=(params, out_dir), nprocs=2,
                           start_method="spawn", join=True)
        shapes = {k: v.shape for k, v in params.items()}
        for stage in (1, 2):
            for mode, (rows, loss_tol, norm_tol, master_tol) in DP_MODES.items():
                losses, norms, eng = _port_trajectory("AdamW", stage, steps=3, rows=rows)
                for r in (0, 1):
                    res = np.load(os.path.join(out_dir, f"{stage}_{mode}_{r}.npz"))
                    np.testing.assert_allclose(res["losses"], losses, rtol=loss_tol, atol=0)
                    np.testing.assert_allclose(res["norms"], norms, rtol=norm_tol, atol=0)
                    for n, m in eng.master_params.items():
                        if master_tol is not None:
                            np.testing.assert_allclose(res[f"full/{n}"], m.numpy(), rtol=0,
                                                       atol=master_tol, err_msg=n)
                    # each rank holds its half of every shardable leaf's moments
                    axes = [zero_spec(shapes[n], 2) for n in eng.master_params]
                    for n, a, held in zip(eng.master_params, axes, res["moments"]):
                        size = int(np.prod(shapes[n]))
                        assert held == (size // 2 if a is not None else size), n
                    sharded_b, total_b = sharding_coverage(
                        axes, [torch.zeros(shapes[n]) for n in eng.master_params])
                    assert float(res["frac"]) == sharded_b / total_b > 0.9
