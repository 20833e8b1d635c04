"""The port's pipeline instruction executor (``runtime/pipe/engine.py``, one
process) against the JAX package's, on the toy ``Linear`` / ``tanh`` layers
of tests/unit/test_pipe_engine.py mirrored in torch, with the JAX weights
carried over (``params_from_jax``) and the same seeded batches: losses,
window grads, grad norms and the Adam masters within 1e-5 in float32 at
S = 1, 2, 4; tied weights; ``eval_batch`` against the inference schedule;
the fp16 loss scale and an overflow that skips the step;
``activation_checkpoint_interval``; M >> S under the ring bound; the
blocked base API and the breakdown timers; layer-keyed checkpoints across
stage counts, bit for bit; the tracer's spans against the JAX tracer's. The
JAX engine runs its instruction executor (``pipeline.spmd: false``) on the
8 virtual devices: its micro-batch of 16 rows is split over them, the
port's one process takes all 16, and both losses are the 16-row mean."""

import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu_torch.parallel.pipe import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.runtime.pipe.engine import (PipelineEngine, PipelineError,
                                                     params_from_jax)

HIDDEN = 8
TOL = 1e-5


class Linear(nn.Module):
    """The JAX test's layer: ``tanh(x @ w + b)`` in x's dtype."""

    def __init__(self, dim, activation=True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(HIDDEN, dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.activation = activation

    def forward(self, x):
        y = x @ self.w.to(x.dtype) + self.b.to(x.dtype)
        return torch.tanh(y) if self.activation else y


def mse_loss(out, target):
    return torch.mean(torch.square(out.float() - target.float()))


class JaxLinear:
    """tests/unit/test_pipe_engine.py's pure-function layer (its init draws
    the weights the port's layers take over)."""

    def __init__(self, dim, activation=True):
        self.dim = dim
        self.activation = activation

    def init(self, rng, x):
        import jax
        import jax.numpy as jnp
        k1, _ = jax.random.split(rng)
        return {"w": jax.random.normal(k1, (x.shape[-1], self.dim), jnp.float32) * 0.3,
                "b": jnp.zeros((self.dim,), jnp.float32)}

    def apply(self, params, x):
        import jax.numpy as jnp
        y = x @ params["w"].astype(x.dtype) + params["b"].astype(x.dtype)
        return jnp.tanh(y) if self.activation else y

    def param_shapes(self):
        return [(HIDDEN, self.dim), (self.dim,)]


def jax_mse_loss(out, target):
    import jax.numpy as jnp
    return jnp.mean(jnp.square(out.astype(jnp.float32) - target.astype(jnp.float32)))


def _layers(spec, tied_spec, cls, num_layers, tied):
    if tied:
        return ([tied_spec("emb", cls, HIDDEN)]
                + [spec(cls, HIDDEN) for _ in range(num_layers - 2)]
                + [tied_spec("emb", cls, HIDDEN)])
    return [spec(cls, HIDDEN) for _ in range(num_layers)]


def make_pair(num_layers=4, num_stages=2, seed=0, tied=False, interval=0):
    """The JAX module and its params, and the port's module carrying them."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.parallel.pipe import LayerSpec as JLayerSpec
    from deepspeed_tpu.parallel.pipe import PipelineModule as JPipelineModule
    from deepspeed_tpu.parallel.pipe import TiedLayerSpec as JTiedLayerSpec
    jm = JPipelineModule(layers=_layers(JLayerSpec, JTiedLayerSpec, JaxLinear, num_layers, tied),
                         num_stages=num_stages, loss_fn=jax_mse_loss,
                         activation_checkpoint_interval=interval)
    params = jm.init_params(jax.random.PRNGKey(seed), jnp.zeros((4, HIDDEN), jnp.float32))
    tm = PipelineModule(layers=_layers(LayerSpec, TiedLayerSpec, Linear, num_layers, tied),
                        num_stages=num_stages, loss_fn=mse_loss,
                        activation_checkpoint_interval=interval)
    return jm, params, tm, params_from_jax(tm, params, device="cpu")


def pipe_config(batch=32, micro=2, **over):
    cfg = {"train_batch_size": batch, "gradient_accumulation_steps": micro,
           "steps_per_print": 100, "bf16": {"enabled": False},
           "pipeline": {"spmd": False},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(over)
    return cfg


def data_iter(hidden=HIDDEN, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(77).normal(size=(hidden, hidden)).astype(np.float32) * 0.4
    while True:
        x = rng.normal(size=(batch, hidden)).astype(np.float32)
        yield x, np.tanh(x @ w_true)


def _jax_engine(jm, params, cfg):
    import deepspeed_tpu
    eng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                            config_params=cfg)
    assert not eng._spmd
    return eng


def _port_engine(tm, tp, cfg):
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, model_parameters=tp,
                                                  config_params=cfg, device="cpu")
    assert isinstance(eng, PipelineEngine) and not eng._spmd
    return eng


def _flat(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_window_grads(eng, batches):
    """The JAX engine's window gradient at its current params: the mean over
    the micro-batches of the whole model's loss, differentiated."""
    import jax
    import jax.numpy as jnp

    def f(p):
        return jnp.mean(jnp.stack([eng._whole_model_fn(p, jnp.asarray(x), jnp.asarray(y))
                                   for x, y in batches]))
    return _flat(jax.grad(f)(jax.device_get(eng.master_params)))


def _spy_grads(eng):
    """Record the window grads the port hands its update, by on-disk key."""
    seen, orig = [], eng._update
    keys = eng._ckpt_keys()

    def spy(grads):
        seen.append({k: grads[i].detach().float().numpy().copy() for k, i in keys})
        return orig(grads)
    eng._update = spy
    return seen


def _assert_close(a, b, tol=TOL, what=""):
    assert set(a) == set(b), (what, sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol, err_msg=f"{what} {k}")


def _trajectory_pair(steps=3, num_layers=4, num_stages=2, seed=0, tied=False, interval=0,
                     cfg=None, data_seed=0, compare_grads=True):
    jm, params, tm, tp = make_pair(num_layers, num_stages, seed, tied, interval)
    cfg = cfg or pipe_config()
    je, pe = _jax_engine(jm, params, cfg), _port_engine(tm, tp, cfg)
    seen = _spy_grads(pe)
    jit, pit = data_iter(seed=data_seed), data_iter(seed=data_seed)
    out = {"jax": [], "port": [], "jnorm": [], "pnorm": []}
    for _ in range(steps):
        batches = [next(jit) for _ in range(je.micro_batches)]
        if compare_grads:
            jgrads = _jax_window_grads(je, batches)
        out["jax"].append(float(je.train_batch(iter(batches))))
        out["port"].append(float(pe.train_batch(pit)))
        out["jnorm"].append(float(je._last_grad_norm))
        out["pnorm"].append(float(pe._last_grad_norm))
        if compare_grads:
            _assert_close(seen[-1], jgrads, what="grads")
        _assert_close(pe.canonical_master_params(), _flat(je.master_params), what="master")
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=TOL)
    np.testing.assert_allclose(out["pnorm"], out["jnorm"], rtol=TOL, atol=0)
    return je, pe, out


@pytest.mark.parametrize("num_stages", [1, 2, 4])
def test_instruction_executor_matches_jax(num_stages):
    _, pe, out = _trajectory_pair(num_stages=num_stages, seed=5, data_seed=11)
    assert pe.num_stages == num_stages and pe.global_steps == 3
    assert out["port"][-1] < out["port"][0]


def test_tied_weights_match_jax():
    _, pe, _ = _trajectory_pair(num_stages=2, tied=True, steps=4)
    keys = [k for k, _ in pe._ckpt_keys()]
    assert sum(k.startswith("tied::emb/") for k in keys) == 2        # w and b, once
    assert pe.pipe_module._built_layers[0] is pe.pipe_module._built_layers[-1]


@pytest.mark.parametrize("interval", [1, 2])
def test_activation_checkpoint_interval_matches_jax(interval):
    # a pure memory/compute trade: the same trajectory as interval 0 and as JAX
    _, pe, out = _trajectory_pair(num_stages=2, seed=3, interval=interval, data_seed=13)
    _, pe0, out0 = _trajectory_pair(num_stages=2, seed=3, interval=0, data_seed=13,
                                    compare_grads=False)
    assert out["port"] == out0["port"]
    _assert_close(pe.canonical_master_params(), pe0.canonical_master_params(), tol=0)


@pytest.mark.parametrize("num_layers,num_stages,micro", [(4, 2, 16), (8, 4, 8)])
def test_many_microbatches_under_the_ring_bound(num_layers, num_stages, micro):
    """M = 8 S at S = 2 and M = 8 at S = 4 (rings of unequal size): every Send
    checks the receiver's ring, so a clean window is the proof; and the
    windows train as one stage does (the JAX engine's parity is the tests
    above)."""
    cfg = pipe_config(batch=16 * micro, micro=micro)
    out = {}
    for stages in (num_stages, 1):
        _, _, tm, tp = make_pair(num_layers, stages, seed=2)
        eng = _port_engine(tm, tp, cfg)
        it = data_iter(seed=4)
        out[stages] = ([float(eng.train_batch(it)) for _ in range(2)],
                       eng.canonical_master_params())
    np.testing.assert_allclose(out[num_stages][0], out[1][0], rtol=0, atol=1e-6)
    _assert_close(out[num_stages][1], out[1][1], tol=1e-6, what="master")


def test_eval_batch_matches_jax_inference_schedule():
    jm, params, tm, tp = make_pair(num_stages=2)
    je, pe = _jax_engine(jm, params, pipe_config()), _port_engine(tm, tp, pipe_config())
    batches = [next(data_iter(seed=21)) for _ in range(pe.micro_batches)]
    got = float(pe.eval_batch(iter(batches)))
    want = float(je.eval_batch(iter(batches)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    whole = np.mean([float(tm(torch.from_numpy(x), torch.from_numpy(y)).detach())
                     for x, y in batches])
    np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)


def test_fp16_loss_scale_parity():
    """fp16 grads leave the stages loss-scaled and are unscaled in the update:
    the first steps match float32 to fp16 resolution (the JAX test's bounds),
    and the JAX engine's fp16 losses to 1e-2."""
    results = {}
    for prec in ("fp32", "fp16"):
        jm, params, tm, tp = make_pair(num_stages=2, seed=9)
        cfg = pipe_config()
        if prec == "fp16":
            cfg["fp16"] = {"enabled": True, "loss_scale": 1024.0}
        pe = _port_engine(tm, tp, cfg)
        it = data_iter(seed=13)
        losses = [float(pe.train_batch(it)) for _ in range(2)]
        results[prec] = (losses, pe.canonical_master_params())
        if prec == "fp16":
            je = _jax_engine(jm, params, cfg)
            it = data_iter(seed=13)
            jl = [float(je.train_batch(it)) for _ in range(2)]
            np.testing.assert_allclose(losses, jl, rtol=1e-2)
            assert float(pe.loss_scale()) == 1024.0
    np.testing.assert_allclose(results["fp16"][0][-1], results["fp32"][0][-1], rtol=2e-2)
    for k, v in results["fp16"][1].items():
        np.testing.assert_allclose(v, results["fp32"][1][k], rtol=3e-2, atol=2e-3, err_msg=k)


def test_fp16_overflow_skips_step():
    for build in ("port", "jax"):
        jm, params, tm, tp = make_pair(num_stages=2)
        cfg = pipe_config(fp16={"enabled": True, "loss_scale": 0, "initial_scale_power": 4,
                                "hysteresis": 1})
        eng = _port_engine(tm, tp, cfg) if build == "port" else _jax_engine(jm, params, cfg)
        s0 = float(eng.loss_scale())
        before = (eng.canonical_master_params() if build == "port"
                  else _flat(eng.master_params))

        def bad_iter():
            while True:
                yield (np.ones((16, HIDDEN), np.float32),
                       np.full((16, HIDDEN), 1e30, np.float32))  # cotangents overflow fp16

        eng.train_batch(bad_iter())
        assert eng.skipped_steps == 1, build
        assert float(eng.loss_scale()) == s0 / 2, build
        after = eng.canonical_master_params() if build == "port" else _flat(eng.master_params)
        _assert_close(after, before, tol=0, what=build)


def test_blocked_base_api():
    _, _, tm, tp = make_pair()
    eng = _port_engine(tm, tp, pipe_config())
    with pytest.raises(PipelineError):
        eng.forward(np.zeros((4, HIDDEN)))
    with pytest.raises(PipelineError):
        eng.backward(None)
    with pytest.raises(PipelineError):
        eng.step()


def test_wall_clock_breakdown_timers():
    _, _, tm, tp = make_pair(num_stages=2)
    eng = _port_engine(tm, tp, pipe_config(wall_clock_breakdown=True))
    eng.train_batch(data_iter())
    for name in ["batch_input", "forward_microstep", "backward_microstep",
                 "pipe_send_output", "pipe_recv_input", "pipe_send_grad",
                 "pipe_recv_grad", "step_microstep", "train_batch"]:
        assert name in eng.timers.timers, f"missing timer {name}"
        assert eng.timers.timers[name].elapsed_ > 0 or name in (
            "pipe_send_output", "pipe_recv_input", "pipe_send_grad", "pipe_recv_grad"), name


def test_checkpoint_moves_across_stage_counts(tmp_path):
    """Layer-keyed checkpoints: saved at S = 2, loaded at S = 1 and S = 4 bit
    for bit (params, master, moments), and training goes on the same."""
    _, _, tm, tp = make_pair(num_layers=4, num_stages=2, seed=4)
    src = _port_engine(tm, tp, pipe_config())
    it = data_iter(seed=3)
    for _ in range(2):
        src.train_batch(it)
    src.save_checkpoint(str(tmp_path))
    want = {kind: src._ckpt_export(kind) for kind in ("params", "master", "opt")}
    nxt = [next(it) for _ in range(src.micro_batches)]
    want_loss = float(src.train_batch(iter(nxt)))
    for stages in (1, 4):
        _, _, tm2, tp2 = make_pair(num_layers=4, num_stages=stages, seed=99)
        dst = _port_engine(tm2, tp2, pipe_config())
        dst.load_checkpoint(str(tmp_path))
        assert dst.global_steps == 2
        for kind, flat in want.items():
            got = dst._ckpt_export(kind)
            assert set(got) == set(flat), kind
            for k, v in flat.items():
                assert np.array_equal(got[k], v), (stages, kind, k)
        assert float(dst.train_batch(iter(nxt))) == want_loss


def test_tracer_spans_match_jax():
    """With ``telemetry.pipeline_trace`` on, the port records the JAX
    engine's spans: stage, schedule step, instruction, micro-batch and
    buffer of every executed instruction, train and eval, in order."""
    cfg = pipe_config(telemetry={"pipeline_trace": {"enabled": True}})
    jm, params, tm, tp = make_pair(num_layers=4, num_stages=4)
    cfg4 = dict(cfg, train_batch_size=16 * 4, gradient_accumulation_steps=4)
    je, pe = _jax_engine(jm, params, cfg4), _port_engine(tm, tp, cfg4)
    for eng in (je, pe):
        eng.train_batch(data_iter(seed=1))
        eng.eval_batch(data_iter(seed=2))
    jsteps, psteps = list(je.pipe_trace.steps), list(pe.pipe_trace.steps)
    assert [s["kind"] for s in psteps] == ["train", "eval"]
    for js, ps in zip(jsteps, psteps):
        assert (ps["schedule"], ps["micro_batches"], ps["step"]) == \
            (js["schedule"], js["micro_batches"], js["step"])
        assert [sp[:5] for sp in ps["spans"]] == [sp[:5] for sp in js["spans"]]
    good = psteps[0]["schedule_goodput"]
    assert set(good) == set(jsteps[0]["schedule_goodput"])


def test_initialize_runs_on_the_card_unless_asked_for_the_cpu():
    _, _, tm, tp = make_pair()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deepspeed_tpu_torch.initialize(model=tm, model_parameters=tp,
                                           config_params=pipe_config())
    assert deepspeed_tpu_torch.PipelineEngine is PipelineEngine


def test_memory_manifest_reconciles_and_lint_entry_is_clean():
    from deepspeed_tpu_torch.lint import registry
    from deepspeed_tpu_torch.lint.program_passes import run_program_passes
    from deepspeed_tpu_torch.utils import hbm
    _, _, tm, tp = make_pair(num_stages=2)
    eng = _port_engine(tm, tp, pipe_config())
    rep = hbm.engine_report(eng)
    assert rep["reconciled"], rep["classes"]
    geo = eng.memory_manifest()["geometry"]
    assert geo["num_stages"] == 2 and geo["stage_param_bytes_max"] == 2 * (64 + 8) * 4
    arts = registry.capture_entry("pipeline", "cpu")
    assert [a.name for a in arts] == [f"pipeline:stage{s}_{k}" for s in range(4)
                                      for k in ("fwd", "last_bwd" if s == 3 else "bwd")]
    assert run_program_passes(arts) == []


class RecordingDropout(nn.Module):
    """Dropout at 0.5 from torch's global generator, keeping every mask it
    draws."""

    def __init__(self, dim):
        super().__init__()
        self.masks = []

    def forward(self, x):
        mask = (torch.rand(x.shape) < 0.5).to(x.dtype)
        self.masks.append(mask)
        return x * mask * 2


def test_recompute_replays_the_forward_random_draws():
    """A stage that draws from torch's generator: the BackwardPass's
    recompute sees the ForwardPass's masks, and the window grads are those
    of the model with each micro-batch's mask fixed."""
    torch.manual_seed(0)
    tm = PipelineModule([LayerSpec(Linear, HIDDEN), LayerSpec(RecordingDropout, HIDDEN),
                         LayerSpec(Linear, HIDDEN), LayerSpec(Linear, HIDDEN)],
                        num_stages=2, partition_method="uniform", loss_fn=mse_loss)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0, 0.3)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    eng = _port_engine(tm, None, pipe_config(batch=16 * 4, micro=4))
    seen = _spy_grads(eng)
    batches = [next(data_iter(seed=5)) for _ in range(4)]
    eng.train_batch(iter(batches))
    drop = tm._built_layers[1]
    unique = []
    for m in drop.masks:
        if not any(torch.equal(m, u) for u in unique):
            unique.append(m)
    assert len(drop.masks) == 8 and len(unique) == 4      # each drawn twice, the same
    # the reference: each micro-batch's loss with its mask fixed
    ref = PipelineModule([LayerSpec(Linear, HIDDEN), lambda x: x,
                          LayerSpec(Linear, HIDDEN), LayerSpec(Linear, HIDDEN)],
                         num_stages=1, loss_fn=mse_loss)
    ref.load_state_dict(start)
    total = 0
    for (x, y), m in zip(batches, unique):
        h = ref._built_layers[0](torch.from_numpy(x)) * m * 2
        for idx in (2, 3):
            h = ref._built_layers[idx](h)
        total = total + mse_loss(h, torch.from_numpy(y)) / 4
    total.backward()
    want = {n.replace(".", "/"): p.grad.numpy() for n, p in ref.named_parameters()}
    _assert_close(seen[-1], want, tol=1e-6, what="grads")
