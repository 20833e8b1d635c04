"""The PyTorch port's ``FP16_Optimizer`` / ``FP16_UnfusedOptimizer``
(``deepspeed_tpu_torch/runtime/fp16/fused_optimizer.py``) against the JAX
package's, on the CPU.

The JAX package's eight cases (tests/unit/test_fp16_optimizer.py) run step
by step through both classes on the same numpy-seeded inputs: a linear model
``x @ w + b`` whose parameters are bf16 (or float32) tensors in the port and
a dict of arrays in JAX. Compared each step: the loss, the float32 master,
the loss scale and the overflow flag. Tolerances: float32 masters and losses
1e-5 relative; bf16-computed ones 1e-2 (the bf16 grads may round one ulp
apart between the two matrix products), each element within that share of
the leaf's largest magnitude; scales, flags and step counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.fp16 import FP16_Optimizer as JaxFP16
from deepspeed_tpu.runtime.fp16 import FP16_UnfusedOptimizer as JaxUnfused
from deepspeed_tpu_torch.runtime.fp16 import FP16_Optimizer, FP16_UnfusedOptimizer


def _init(key=0, dtype=np.float32):
    """The JAX test's parameters, rounded through ``dtype`` so that both
    packages start from the same float32 master."""
    k1, _ = jax.random.split(jax.random.PRNGKey(key))
    w = np.asarray(jax.random.normal(k1, (8, 4), jnp.float32) * 0.1)
    w = np.asarray(jnp.asarray(w, dtype).astype(jnp.float32))
    return {"w": w, "b": np.zeros((4,), np.float32)}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    w_true = rng.normal(size=(8, 4)).astype(np.float32)
    return x, (x @ w_true).astype(np.float32)


def _jax_loss(p, x, y):
    pred = x @ p["w"].astype(x.dtype) + p["b"].astype(x.dtype)
    return jnp.mean((pred.astype(jnp.float32) - y) ** 2)


class _Port:
    """The port's side: bf16 (or float32) parameters and the same loss."""

    def __init__(self, init, dtype):
        self.w = torch.nn.Parameter(torch.tensor(init["w"]).to(dtype))
        self.b = torch.nn.Parameter(torch.tensor(init["b"]).to(dtype))

    def params(self):
        return [self.b, self.w]          # jax.tree_util's order: keys sorted

    def loss(self, x, y):
        pred = torch.from_numpy(x) @ self.w.float() + self.b.float()
        return torch.mean((pred - torch.from_numpy(y)) ** 2)


def _jax_master(opt):
    m = jax.device_get(opt.master)
    return [np.asarray(m["b"]), np.asarray(m["w"])]


def _close(port_master, jax_master, rtol):
    for a, b in zip(port_master, jax_master):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max())


def _train(jopt, popt, model, jdtype, steps, rtol):
    """``steps`` steps of both, compared after each."""
    x, y = _batch()
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdtype),
                                 {"w": model.w.detach().float().numpy(),
                                  "b": model.b.detach().float().numpy()})
    jl, pl = [], []
    for _ in range(steps):
        loss, grads = jopt.backward(_jax_loss, p16, jnp.asarray(x), jnp.asarray(y))
        p16 = jopt.step(grads)
        ploss = popt.backward(model.loss(x, y))
        popt.step()
        popt.zero_grad()
        jl.append(float(loss))
        pl.append(float(ploss))
        assert popt.overflow == jopt.overflow
        assert popt.cur_scale == jopt.cur_scale
        assert popt.steps == int(jax.device_get(jopt.steps))
        _close(popt.master, _jax_master(jopt), rtol)
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    return pl


@pytest.mark.parametrize("dtype,rtol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_training_decreases_loss(dtype, rtol):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    init = _init(dtype=jdt)
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), optimizer="adamw", lr=5e-2,
                   compute_dtype=jdt)
    model = _Port(init, dtype)
    popt = FP16_Optimizer(model.params(), optimizer="adamw", lr=5e-2)
    losses = _train(jopt, popt, model, jdt, 30, rtol)
    assert losses[-1] < 0.3 * losses[0], losses
    # the model's parameters are the master re-cast, in place
    for p, m in zip(model.params(), popt.master):
        assert torch.equal(p.detach(), m.to(dtype))


def _bad(opt_master, value):
    return [torch.full_like(m, value) for m in opt_master]


def test_overflow_skips_step_and_halves_scale():
    init = _init()
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), dynamic_loss_scale=True,
                   initial_scale_power=4, hysteresis=1, lr=1e-2)
    model = _Port(init, torch.bfloat16)
    popt = FP16_Optimizer(model.params(), dynamic_loss_scale=True, initial_scale_power=4,
                          hysteresis=1, lr=1e-2)
    before = [m.clone() for m in popt.master]
    params_before = [p.detach().clone() for p in model.params()]
    scale = popt.cur_scale
    jopt.step(jax.tree_util.tree_map(lambda p: jnp.full_like(p, jnp.inf), jopt.master))
    assert popt.step(_bad(popt.master, float("inf"))) is True
    assert popt.overflow and jopt.overflow
    assert popt.cur_scale == jopt.cur_scale == scale / 2
    assert all(torch.equal(a, b) for a, b in zip(before, popt.master))     # bit for bit
    assert all(torch.equal(a, b.detach()) for a, b in zip(params_before, model.params()))
    assert popt.steps == int(jax.device_get(jopt.steps)) == 0
    assert [e["kind"] for e in popt.journal.events] == \
        [e["kind"] for e in jopt.journal.events] == ["backoff", "skip"]


def test_hysteresis_delays_scale_drop():
    init = _init()
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), dynamic_loss_scale=True,
                   initial_scale_power=4, hysteresis=2)
    model = _Port(init, torch.bfloat16)
    popt = FP16_Optimizer(model.params(), dynamic_loss_scale=True, initial_scale_power=4,
                          hysteresis=2)
    s0 = popt.cur_scale
    scales = []
    for _ in range(2):
        jopt.step(jax.tree_util.tree_map(lambda p: jnp.full_like(p, jnp.nan), jopt.master))
        popt.step(_bad(popt.master, float("nan")))
        assert popt.cur_scale == jopt.cur_scale
        scales.append(popt.cur_scale)
    assert scales == [s0, s0 / 2]  # the first overflow only consumes hysteresis
    assert [e["kind"] for e in popt.journal.events] == \
        [e["kind"] for e in jopt.journal.events]


def test_scale_doubles_after_window():
    init = _init(dtype=jnp.bfloat16)
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), dynamic_loss_scale=True,
                   initial_scale_power=4, scale_window=3, lr=1e-3)
    model = _Port(init, torch.bfloat16)
    popt = FP16_Optimizer(model.params(), dynamic_loss_scale=True, initial_scale_power=4,
                          scale_window=3, lr=1e-3)
    s0 = popt.cur_scale
    _train(jopt, popt, model, jnp.bfloat16, 3, 1e-2)
    assert popt.cur_scale == jopt.cur_scale == s0 * 2
    assert popt.journal.events[-1]["kind"] == "ramp"


def test_static_scale_never_moves():
    init = _init()
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), static_loss_scale=128.0,
                   dynamic_loss_scale=False)
    model = _Port(init, torch.bfloat16)
    popt = FP16_Optimizer(model.params(), static_loss_scale=128.0, dynamic_loss_scale=False)
    assert popt.cur_scale == jopt.cur_scale == 128.0
    jopt.step(jax.tree_util.tree_map(lambda p: jnp.full_like(p, jnp.inf), jopt.master))
    assert popt.step(_bad(popt.master, float("inf")))
    assert popt.cur_scale == jopt.cur_scale == 128.0


def test_clip_grad_limits_update():
    """Adam is scale-invariant, so the clip shows through an SGD inner rule
    (the client ``inner_apply`` hook)."""
    def jax_sgd(grads, state, master, step, hyper):
        return jax.tree_util.tree_map(lambda p, g: p - hyper["lr"] * g, master, grads), state

    def port_sgd(grads, state, master, step, hyper):
        return [p - hyper["lr"] * g for p, g in zip(master, grads)], state

    init = _init()
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), clip_grad=1e-3, lr=1.0,
                   dynamic_loss_scale=False, static_loss_scale=1.0,
                   inner_apply=jax_sgd, inner_init=lambda m: {})
    model = _Port(init, torch.float32)
    popt = FP16_Optimizer(model.params(), clip_grad=1e-3, lr=1.0, dynamic_loss_scale=False,
                          static_loss_scale=1.0, inner_apply=port_sgd,
                          inner_init=lambda m: {})
    before = [m.clone() for m in popt.master]
    jopt.step(jax.tree_util.tree_map(lambda p: jnp.full_like(p, 100.0), jopt.master))
    popt.step(_bad(popt.master, 100.0))
    _close(popt.master, _jax_master(jopt), 1e-5)
    max_delta = max(float((a - b).abs().max()) for a, b in zip(popt.master, before))
    assert max_delta <= 1.1e-3


def test_lamb_unfused_variant():
    init = _init(dtype=jnp.bfloat16)
    jopt = JaxUnfused(jax.tree_util.tree_map(jnp.asarray, init), lr=0.1)
    model = _Port(init, torch.bfloat16)
    popt = FP16_UnfusedOptimizer(model.params(), lr=0.1)
    losses = _train(jopt, popt, model, jnp.bfloat16, 40, 1e-2)
    assert losses[-1] < 0.6 * losses[0], losses


def test_state_dict_roundtrip():
    init = _init(dtype=jnp.bfloat16)
    jopt = JaxFP16(jax.tree_util.tree_map(jnp.asarray, init), lr=1e-2)
    model = _Port(init, torch.bfloat16)
    popt = FP16_Optimizer(model.params(), lr=1e-2)
    _train(jopt, popt, model, jnp.bfloat16, 3, 1e-2)
    sd = popt.state_dict()

    other = _Port(_init(7), torch.bfloat16)
    popt2 = FP16_Optimizer(other.params(), lr=1e-2)
    popt2.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(popt.master, popt2.master))
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(model.params(), other.params()))
    assert popt2.cur_scale == popt.cur_scale == jopt.cur_scale
    assert popt2.steps == popt.steps == 3
    # the restored wrapper steps on as the original does
    x, y = _batch()
    for opt, m in ((popt, model), (popt2, other)):
        opt.backward(m.loss(x, y))
        opt.step()
    assert all(torch.equal(a, b) for a, b in zip(popt.master, popt2.master))
