"""The PyTorch port's telemetry session (``deepspeed_tpu_torch/utils/
telemetry.py``) and its wiring into both engines, against the JAX package,
on the CPU.

The tiny GPT-2 of ``tests/test_torch_engine.py`` (float32, the JAX init
carried over) trains in both packages with the same ``telemetry`` block
(metrics, default alerts, goodput, the cluster monitor at world 1, a trace
window) and the tensorboard monitor:
- the same scalar names each step, from step 3 (the JAX engine's donating
  programs compile a second time at step 2, so its first MFU comes a step
  later) and over the run; ``Train/Samples/train_loss``, ``lr`` and (fp16)
  ``loss_scale`` within 1e-5 relative;
- the port's watchdog records each program once (0 recompiles), and a new
  batch shape records again and counts as a recompile;
- the flops a step: the port counts the matrix products (``FlopCounterMode``),
  XLA's cost analysis counts every operation, so the port's count lies
  between 0.75 and 1.0 of the JAX session's (0.83 measured at this size,
  where LayerNorm, softmax, GELU and AdamW weigh most);
- losses bit for bit with telemetry on and off, on the two-step and fused
  paths and under remat "dots";
- the trace window's Chrome trace holds the engine's ``ds_fwd_bwd`` and
  ``ds_apply_update`` ranges; the goodput ledger partitions the run and
  carves an ``AsyncCheckpointer`` save's fence as ``checkpoint_stall``; the
  hang watchdog fires on a stalled step and the ledger bills it to hang; a
  custom alert rule fires through the monitor.
The serving engine with a session: each program recorded once, and the same
``Serving/*`` scalar names each iteration as the JAX engine's on one trace.
"""

import functools
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from test_torch_engine import DIMS, _batches, _config, _jax_params, _port_params  # noqa: E402

STEPS = 5


def _telemetry(root, trace=(1, 3), **over):
    tel = {"enabled": True, "peak_tflops": 1.0, "output_path": root, "job_name": "tel",
           "trace_dir": os.path.join(root, "trace"), "trace_steps": list(trace),
           "metrics": {"enabled": True}, "alerts": {"enabled": True},
           "goodput": {"enabled": True, "ledger_dir": root},
           "cluster": {"enabled": True, "hang_deadline_s": 60.0, "dump_dir": root}}
    tel.update(over)
    return tel


def _cfg(root, gas=1, fp16=False, **tel):
    cfg = _config("AdamW", 0, gas=gas)
    cfg["telemetry"] = _telemetry(root, **tel)
    cfg["tensorboard"] = {"enabled": True, "output_path": root, "job_name": "tb"}
    if fp16:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    return cfg


def _port_engine(cfg, **model_over):
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0,
                              **model_over), device="cpu")
    params = {k: torch.from_numpy(np.array(v)) for k, v in _port_params().items()}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, model_parameters=params,
                                                  config_params=cfg, device="cpu")
    return eng


def _train(eng, steps, gas, to_np=lambda t: t):
    losses = []
    for tokens, labels in _batches(steps * gas):
        loss = eng(to_np(tokens), to_np(labels))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    return losses


def _scalars(root):
    by_step, values = {}, {}
    with open(os.path.join(root, "tb", "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            by_step.setdefault(r["step"], set()).add(r["tag"])
            values.setdefault(r["tag"], []).append(r["value"])
    return by_step, values


def _close(eng):
    if eng._cluster is not None:
        eng._cluster.stop()
    eng.telemetry.close()


@functools.lru_cache(maxsize=None)
def _pair(gas, fp16):
    """(port engine, port root, JAX engine, JAX root) after STEPS steps."""
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    p_root, j_root = tempfile.mkdtemp(), tempfile.mkdtemp()
    eng = _port_engine(_cfg(p_root, gas, fp16))
    _train(eng, STEPS, gas)
    _close(eng)
    jm, jp = _jax_params()
    je = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                         config_params=_cfg(j_root, gas, fp16))
    _train(je, STEPS, gas, to_np=lambda t: t.astype(np.int32))
    je.telemetry.close()
    if je._cluster is not None:
        je._cluster.stop()
    return eng, p_root, je, j_root


CASES = [(2, False), (1, True)]


@pytest.mark.parametrize("gas,fp16", CASES)
def test_scalar_names_and_values_match_jax_engine(gas, fp16):
    eng, p_root, je, j_root = _pair(gas, fp16)
    (p_steps, p_vals), (j_steps, j_vals) = _scalars(p_root), _scalars(j_root)
    assert set(p_vals) == set(j_vals)
    late = [s for s in j_steps if s >= 3 * eng.train_batch_size()]
    assert late and all(p_steps[s] == j_steps[s] for s in late)
    names = ["Train/Samples/train_loss", "Train/Samples/lr"]
    if fp16:
        names.append("Train/Samples/loss_scale")
    for name in names:
        np.testing.assert_allclose(p_vals[name], j_vals[name], rtol=1e-5, err_msg=name)
    assert any(n.startswith("Cluster/") for n in p_vals)
    assert any(n.startswith("Run/Goodput/") for n in p_vals)


@pytest.mark.parametrize("gas,fp16", CASES)
def test_watchdog_records_once_and_flops_within_tolerance(gas, fp16):
    eng, _, je, _ = _pair(gas, fp16)
    wd = eng.telemetry.watchdog
    assert wd.recompiles() == 0
    assert sorted(wd.records) == ["apply_update", "backward", "forward"]
    port_flops = sum(r.flops for v in wd.records.values() for r in v.values()
                     if v is not wd.records["apply_update"])
    jax_rec = je.telemetry.watchdog.records["loss_and_grad"]
    jax_flops = next(iter(jax_rec.values())).flops
    assert 0.75 * jax_flops <= port_flops <= jax_flops, (port_flops, jax_flops)
    # the session's step flops: gas micro-steps' forward and backward
    assert eng.telemetry.flops_executed == pytest.approx(port_flops * gas * STEPS)
    assert eng.telemetry.last_mfu is not None and eng.telemetry.last_mfu > 0


def test_new_batch_shape_records_a_recompile(tmp_path):
    eng = _port_engine(_cfg(str(tmp_path), trace=(100, 101)))
    _train(eng, 2, 1)
    tokens, labels = _batches(1)[0]
    loss = eng(tokens[:, :8], labels[:, :8])
    eng.backward(loss)
    eng.step()
    wd = eng.telemetry.watchdog
    assert wd.compiles("forward") == 2 and wd.recompiles("forward") == 1
    # the backward's input (the 0-d loss) keeps its signature
    assert eng.telemetry.summary()["recompile_count"] == 1
    _close(eng)


@pytest.mark.parametrize("mode", ["two_step", "fused", "remat_dots"])
def test_losses_bitwise_with_telemetry_on_and_off(mode, tmp_path):
    over = {"remat": True, "remat_policy": "dots"} if mode == "remat_dots" else {}
    runs = []
    for on in (False, True):
        cfg = _config("AdamW", 0, gas=1)
        cfg["fused_step"] = mode != "two_step"
        if on:
            cfg["telemetry"] = _telemetry(str(tmp_path))
        eng = _port_engine(cfg, **over)
        runs.append(_train(eng, 4, 1))
        if on:
            assert eng._fused == (mode != "two_step")
            _close(eng)
    assert runs[0] == runs[1]


def test_trace_window_holds_the_named_scopes(tmp_path):
    eng = _port_engine(_cfg(str(tmp_path), trace=(1, 3)))
    _train(eng, 4, 1)
    tel = eng.telemetry
    assert tel.summary()["trace"]["done"] and os.path.exists(tel.trace_path)
    with open(tel.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ds_fwd_bwd", "ds_apply_update"} <= names
    _close(eng)


def test_goodput_carves_the_checkpoint_stall(tmp_path):
    cfg = _cfg(str(tmp_path), trace=(100, 101))
    cfg["resilience"] = {"enabled": True, "save_dir": str(tmp_path / "ckpt"),
                         "save_interval": 2, "async_save": False}
    eng = _port_engine(cfg)
    _train(eng, 3, 1)
    led = eng._goodput
    assert eng._resilience.saves_started == 1
    stall = led.class_seconds["checkpoint_stall"]
    assert stall > 0 and stall == pytest.approx(eng._resilience.last_stall_ms / 1000.0,
                                                abs=1e-9)
    summary = led.finalize(persist=False)
    assert sum(summary["class_seconds"].values()) == pytest.approx(summary["wall_s"], abs=1e-9)
    assert led.class_seconds["compile"] > 0 and led.class_seconds["productive_step"] > 0
    _close(eng)


def test_hang_watchdog_fires_on_a_stalled_step_and_bills_hang(tmp_path):
    cfg = _cfg(str(tmp_path), trace=(100, 101),
               cluster={"enabled": True, "hang_deadline_s": 0.5, "dump_dir": str(tmp_path),
                        "warmup_steps": 1})
    eng = _port_engine(cfg)
    _train(eng, 2, 1)
    forward = eng.module.forward

    def stalled(*a, **k):
        time.sleep(1.5)
        return forward(*a, **k)

    eng.module.forward = stalled
    _train(eng, 1, 1)
    eng.module.forward = forward
    wd = eng._cluster.watchdog
    # the stalled step fires (a step slowed by a loaded host may fire too)
    stalled_fires = [f for f in wd.fired if f["step"] == 2]
    assert len(stalled_fires) == 1 and stalled_fires[0]["last_scope"] == "ds_fwd_bwd"
    assert eng._goodput.hang_steps == len(wd.fired)
    assert eng._goodput.class_seconds["hang"] > 1.0
    assert eng._cluster.recorder.dump_count == len(wd.fired)
    _close(eng)


def test_custom_alert_rule_fires_through_the_monitor(tmp_path):
    rules = [{"name": "loss_high", "kind": "threshold", "metric": "Train/Samples/train_loss",
              "above": 0.0}]
    cfg = _cfg(str(tmp_path), trace=(100, 101),
               alerts={"enabled": True, "rules": rules})
    eng = _port_engine(cfg)
    _train(eng, 2, 1)
    fired = eng.telemetry.alert_engine.fired
    assert [r["rule"] for r in fired] == ["loss_high"]
    _, values = _scalars(str(tmp_path))
    assert values["Alerts/loss_high"][0] == 1.0
    _close(eng)


# ------------------------------------------------------------------ serving
SERVE_ML = 32


def _serve(pkg, root):
    """One trace through ``pkg``'s engine with a session: (schedule logs,
    watchdog records, per-iteration scalar names)."""
    import jax
    jm, jp = _jax_params()
    geo = dict(num_slots=4, block_size=4, num_blocks=33, max_model_len=SERVE_ML,
               prefill_chunk=8, prefix_cache=True,
               request_trace={"enabled": True, "capacity": 64})
    if pkg == "jax":
        from deepspeed_tpu.serve.engine import InferenceEngine
        from deepspeed_tpu.serve.scheduler import Request
        from deepspeed_tpu.utils.telemetry import TelemetrySession
        model, params = jm, jp
    else:
        from deepspeed_tpu_torch.serve.engine import InferenceEngine
        from deepspeed_tpu_torch.serve.scheduler import Request
        from deepspeed_tpu_torch.utils.telemetry import TelemetrySession
        model = GPT2Model(GPT2Config(**dict(DIMS, n_positions=SERVE_ML),
                                     compute_dtype=torch.float32, loss_chunk=0),
                          device="cpu")
        model.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                              device="cpu"))
        params = None
    session = TelemetrySession(output_path=root, job_name="srv")
    eng = InferenceEngine(model, params, telemetry=session, **geo)
    rng = np.random.RandomState(3)
    reqs = [Request(f"r{i}", rng.randint(0, 64, size=5 + i % 7).tolist(), 4 + i % 3,
                    arrival=i // 2, num_beams=4 if i == 5 else 1) for i in range(8)]
    _, logs = eng.run(reqs)
    session.close()
    by_it = {}
    with open(os.path.join(root, "srv", "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            by_it.setdefault(r["step"], set()).add(r["tag"])
    return logs, {k: sum(r.count for r in v.values())
                  for k, v in session.watchdog.records.items()}, by_it


def test_serving_engine_with_a_session_matches_jax(tmp_path):
    p_logs, p_rec, p_names = _serve("port", str(tmp_path / "p"))
    j_logs, j_rec, j_names = _serve("jax", str(tmp_path / "j"))
    assert json.dumps(p_logs) == json.dumps(j_logs)
    assert set(p_rec) == set(j_rec) and all(n == 1 for n in p_rec.values())
    assert {"serve:decode_step", "serve:prefill_chunk"} <= set(p_rec)
    assert p_names == j_names
    assert any(n.startswith("Serving/Latency/") for names in p_names.values() for n in names)
