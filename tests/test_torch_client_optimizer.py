"""Client ``(init, apply)`` optimizers of the PyTorch port's engine against the
JAX engine, on the CPU.

A tiny GPT-2 (vocab 64, width 32, 2 layers) from the JAX init trains through
the port's ``initialize`` and the JAX ``DeepSpeedEngine`` on a one-device
mesh, on the same seeded micro-batches:
- ``bench.py``'s ``_shard_optimizer(32)`` (an external-master pair) in the
  JAX engine against its torch copy (``runtime/client_optimizers.py``) in
  the port's: after 3 steps each leaf of the client state (shard, m1, m2)
  is within a bound of its own scale (max |JAX's|): 1e-5 in float32 without
  ZeRO (where each element is also within 1e-6), 1e-2 in bf16 at ZeRO-2
  (the ``zero_allow_untested_optimizer`` path), bounds that a zeroed or
  doubled leaf fails; the two copies agree within
  1e-6 relative on the same float32 grads (XLA's square root and division
  round the last bit differently);
- the external-master engine holds no float32 master, ``master_params`` is
  the params upcast, and the params never change;
- a plain momentum-SGD pair: the 4-step loss trajectory and the final master
  agree within 1e-5;
- the JAX engine's refusals, with its messages (a pair under ZeRO at dp > 1
  is tests/test_torch_client_optimizer_dp.py's).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.parallel.mesh import single_device_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import bench  # noqa: E402

DIMS = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=2)
MICRO, T = 2, 16


def _config(zero=False, **extra):
    cfg = {"train_batch_size": MICRO, "steps_per_print": 1000,
           "bf16": {"enabled": zero}}
    if zero:
        cfg.update(zero_optimization={"stage": 2}, zero_allow_untested_optimizer=True)
    cfg.update(extra)
    return cfg


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, DIMS["vocab_size"], size=(MICRO, T)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        out.append((tokens, labels))
    return out


def _jax_params():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _train(jax_pair, torch_pair, steps, zero=False, **extra):
    """(JAX engine, port engine, JAX losses, port losses) after ``steps``
    steps of one micro-batch each."""
    jm, jp = _jax_params()
    jeng = JaxEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                     optimizer=jax_pair, config_params=_config(zero, **extra))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    teng, handle, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params_from_jax(jp, device="cpu"), optimizer=torch_pair,
        config_params=_config(zero, **extra), device="cpu")
    assert handle is teng.optimizer and handle.name == "client"
    jl, tl = [], []
    for tokens, labels in _batches(steps):
        loss = jeng(tokens, labels)
        jeng.backward(loss)
        jeng.step()
        jl.append(float(loss))
        loss = teng(tokens.astype(np.int64), labels.astype(np.int64))
        teng.backward(loss)
        teng.step()
        tl.append(float(loss.detach()))
    return jeng, teng, np.asarray(jl), np.asarray(tl)


def _scaled_err(got, want):
    """max |got - want| over max |want|: the error against the leaf's own
    scale (the state's leaves lie orders of magnitude apart: m2 ~ g^2)."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("zero,tol", [(False, 1e-5), (True, 1e-2)], ids=["f32", "bf16-zero2"])
def test_bench_shard_optimizer_matches_jax_engine(zero, tol):
    jeng, teng, jl, tl = _train(bench._shard_optimizer(32), shard_optimizer(32),
                                steps=3, zero=zero)
    for key in ("shard", "m1", "m2"):
        want = np.asarray(jeng.opt_state[key], np.float32)
        got = teng.opt_state[key].numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert _scaled_err(got, want) <= tol, (key, _scaled_err(got, want))
        # the bound tells a wrong state apart: a zeroed leaf, or one a
        # doubled gradient would give (m1 x2, m2 x4; the shard's step is
        # scale-free, so a shard twice off)
        assert _scaled_err(np.zeros_like(want), want) > tol
        assert _scaled_err(2 * want, want) > tol
        if not zero:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)
    assert np.abs(teng.opt_state["m1"].numpy()).max() > 0
    np.testing.assert_allclose(tl, jl, rtol=tol if zero else 1e-5, atol=0)


def test_shard_optimizer_copies_agree_on_the_same_grads():
    """The torch copy is the bench's function: the same float32 grad tree
    (the JAX package's leaf order) gives the same state up to the last bit
    of XLA's square root and division."""
    _, jp = _jax_params()
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    hyper = {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8, "weight_decay": 0.0}
    (jinit, japply), (tinit, tapply) = bench._shard_optimizer(32), shard_optimizer(32)
    assert tapply.external_master and japply.external_master
    tgrads = _sorted_tree(grads)
    jstate, tstate = jinit(jp), tinit(tgrads)
    for _ in range(2):
        _, jstate = japply(grads, jstate, None, 1,
                           {k: jnp.float32(v) for k, v in hyper.items()})
        _, tstate = tapply(tgrads, tstate, None, 1,
                           {k: torch.tensor(v, dtype=torch.float32) for k, v in hyper.items()})
    for key in ("shard", "m1", "m2"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), rtol=1e-6,
                                   atol=0, err_msg=key)


def _sorted_tree(tree):
    """A JAX-package tree of numpy leaves as torch tensors, dict keys sorted
    (the engine's client layout)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_tree(t) for t in tree]
    return torch.from_numpy(np.asarray(tree))


def test_client_tree_walks_leaves_in_jax_order():
    _, jp = _jax_params()
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params_from_jax(jp, device="cpu"),
        optimizer=shard_optimizer(32), config_params=_config(), device="cpu")
    tree = teng._client_tree([p.detach() for p in teng._params])
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(jp)]
    got = [t.numpy() for t in pytree.tree_leaves(tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_external_master_holds_no_float32_master():
    _, teng, _, _ = _train(bench._shard_optimizer(32), shard_optimizer(32),
                           steps=2, zero=True)
    assert teng._master is None and teng._external_master
    params = dict(teng.module.named_parameters())
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    master = teng.master_params
    assert set(master) == set(params)
    for name, m in master.items():
        assert m.dtype == torch.float32
        torch.testing.assert_close(m, params[name].float(), rtol=0, atol=0)
    # the params are the init's, cast once: the pair never changed them
    _, jp = _jax_params()
    for name, t in params_from_jax(jp, device="cpu").items():
        torch.testing.assert_close(params[name], t.to(torch.bfloat16), rtol=0, atol=0)


def _jax_momentum_pair():
    def init(master):
        return jax.tree_util.tree_map(jnp.zeros_like, master)

    def apply(grads, state, master, step, hyper):
        mom = jax.tree_util.tree_map(lambda m, g: 0.9 * m + g, state, grads)
        master = jax.tree_util.tree_map(lambda p, m: p - hyper["lr"] * m, master, mom)
        return master, mom

    return init, apply


def _torch_momentum_pair():
    def init(master):
        return pytree.tree_map(torch.zeros_like, master)

    def apply(grads, state, master, step, hyper):
        assert step.dtype == torch.int32 and step.dim() == 0
        assert set(hyper) == {"lr", "beta1", "beta2", "eps", "weight_decay"}
        mom = pytree.tree_map(lambda m, g: 0.9 * m + g, state, grads)
        master = pytree.tree_map(lambda p, m: p - hyper["lr"] * m, master, mom)
        return master, mom

    return init, apply


def test_plain_pair_trajectory_matches_jax_engine():
    opt = {"optimizer": {"type": "Adam", "params": {"lr": 0.05}}}
    jeng, teng, jl, tl = _train(_jax_momentum_pair(), _torch_momentum_pair(), steps=4, **opt)
    assert not teng._external_master and teng._master is not None
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.master_params),
                           device="cpu")
    got = teng.master_params
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    # the compute params are the adopted master, re-cast
    for name, p in teng.module.named_parameters():
        torch.testing.assert_close(p, got[name], rtol=0, atol=0)


class _Quadratic(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 4), 0.5))

    def forward(self, x):
        return (x.to(self.w.dtype) @ self.w).float().square().mean()


def _pair():
    return (lambda master: {}, lambda g, s, m, step, hyper: (m, s))


def test_refusals_match_the_jax_engine():
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    groups = {"train_batch_size": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "param_groups": [
                  {"pattern": "w", "weight_decay": 0.0}]}}}
    with pytest.raises(AssertionError, match="param_groups require a built-in optimizer"):
        DeepSpeedEngine(model=_Quadratic(), config_params=groups, device="cpu",
                        optimizer=_pair())
    zero = {"train_batch_size": 1, "bf16": {"enabled": True},
            "zero_optimization": {"stage": 1}}
    with pytest.raises(AssertionError, match="untested ZeRO Optimizer"):
        DeepSpeedEngine(model=_Quadratic(), config_params=zero, device="cpu",
                        optimizer=_pair())
    for bad in (torch.optim.SGD(_Quadratic().parameters(), lr=0.1), (_pair()[0],),
                [*_pair()]):
        with pytest.raises(TypeError, match=r"\(init_fn, apply_fn\) pair"):
            DeepSpeedEngine(model=_Quadratic(), config_params={"train_batch_size": 1},
                            device="cpu", optimizer=bad)

