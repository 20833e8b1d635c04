"""The PyTorch port's memory observatory (``deepspeed_tpu_torch/utils/hbm.py``,
both engines' ``memory_manifest``, the ``telemetry.hbm`` block) against the
JAX package, on the CPU.

- ``memory_manifest`` of the tiny GPT-2's training engine against the JAX
  engine's on the same config: the geometry dict equal key for key, and per
  class the (dtype, shape) signatures and the bytes exactly equal, for
  ZeRO-2, ZeRO-1 with gradient accumulation, an external-master client
  pair (``bench.py``'s ``_shard_optimizer``), ZeRO-Offload and the fused
  step; the live classes (each tensor's storage once) equal the manifest's
  bytes and reconcile with the closed-form model.
- The host arithmetic as the JAX functions compute it: ``leaf_signature``,
  ``modeled_classes`` (training and serving geometries), ``reconcile``,
  ``gpt2_param_count``, ``forecast`` and ``smallest_fitting_delta``,
  ``oom_forensics``, ``diff_reports``; ``hbm_main`` on reports on disk.
- The serving engine's manifest (bf16; in float32 the head shares the
  embedding's storage, which the live count takes once): the pools' and the
  parameter tree's bytes, reconciled with the pool model; ``Memory/*`` scalars from ``end_step``;
  no allocator off the card (``device_memory_stats`` is None, a forecast
  without a budget raises).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.utils import hbm as ph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from test_torch_engine import DIMS, _config, _port_params  # noqa: E402


def _cases():
    return {
        "zero2": lambda: _config("AdamW", 2, gas=1),
        "zero1_gas2": lambda: _config("Adam", 1, gas=2),
        "fused_step": lambda: dict(_config("AdamW", 0, gas=1), fused_step=True),
        "offload": lambda: dict(_config("AdamW", 2, gas=1), zero_optimization={
            "stage": 2, "cpu_offload": True}),
        "external_master": lambda: {"train_batch_size": 2, "steps_per_print": 1000,
                                    "bf16": {"enabled": True},
                                    "zero_optimization": {"stage": 2},
                                    "zero_allow_untested_optimizer": True},
    }


def _engines(case):
    import bench
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer
    from test_torch_engine import _jax_params
    cfg = _cases()[case]()
    ext = case == "external_master"
    jm, jp = _jax_params()
    jeng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=cfg,
                           optimizer=bench._shard_optimizer(32) if ext else None)
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    params = {k: torch.from_numpy(np.array(v)) for k, v in _port_params().items()}
    peng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params, config_params=cfg, device="cpu",
        optimizer=shard_optimizer(32) if ext else None)
    return jeng, peng


@pytest.mark.parametrize("case", list(_cases()))
def test_memory_manifest_equals_jax(case):
    from deepspeed_tpu.utils import hbm as jh
    jeng, peng = _engines(case)
    jman, pman = jeng.memory_manifest(), peng.memory_manifest()
    assert pman["geometry"] == jman["geometry"]
    jsig, jbytes = jh.manifest_signatures(jman)
    psig, pbytes = ph.manifest_signatures(pman)
    assert pbytes == jbytes and psig == jsig
    # the live classes: each tensor's storage once; meta leaves (the grad
    # buffer between the programs) declared, not resident
    live = ph.measure_classes(pman)
    for cls, b in pbytes.items():
        assert live[cls] == (0 if cls == "grads" else b), cls
    classes, ok = ph.reconcile(live, ph.modeled_classes(pman["geometry"]), pbytes)
    assert ok, classes
    assert ph.engine_report(peng)["reconciled"]


def test_leaf_signature_and_models_equal_jax():
    import jax.numpy as jnp
    from deepspeed_tpu.utils import hbm as jh
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16), (torch.int32, jnp.int32),
                    (torch.int8, jnp.int8), (torch.bool, jnp.bool_)):
        assert ph.leaf_signature(torch.zeros((3, 5), dtype=dt)) == \
            jh.leaf_signature(jnp.zeros((3, 5), jdt))
    geos = [
        {"kind": "training", "psi": 1000003, "param_itemsize": 2, "grad_itemsize": 4,
         "dp": 4, "zero_stage": 2, "zero_sharded_fraction": 0.97},
        {"kind": "training", "psi": 5000, "param_itemsize": 2, "grad_itemsize": 2,
         "dp": 1, "zero_stage": 0, "fused": True, "external_master": True,
         "master_numel": 157, "comm_ef_bytes": 4096},
        {"kind": "training", "psi": 5000, "param_itemsize": 2, "grad_itemsize": 2,
         "dp": 8, "zero_stage": 3, "zero_sharded_fraction": 0.5, "offload": True},
        {"kind": "serving", "psi": 9000, "param_itemsize": 2,
         "param_per_device_fraction": 0.5,
         "pool": {"n_layer": 2, "num_blocks": 9, "block_size": 16, "n_head": 4,
                  "head_dim": 8, "itemsize": 2, "shard_factor": 2},
         "draft": {"psi": 100, "param_itemsize": 4,
                   "pool": {"n_layer": 1, "num_blocks": 3, "block_size": 16, "n_head": 2,
                            "head_dim": 4, "itemsize": 4}}},
        {"kind": "decode", "psi": 77, "param_itemsize": 4},
    ]
    for g in geos:
        assert ph.modeled_classes(g) == jh.modeled_classes(g)
    parsed = {"params": 1000, "grads": 0, "master": 5000, "optimizer": 9000}
    modeled = {"params": 1010, "grads": 700, "master": 5400, "optimizer": 9000}
    assert ph.reconcile(parsed, modeled, {"params": 1000}) == \
        jh.reconcile(parsed, modeled, {"params": 1000})
    assert ph.gpt2_param_count(1600, 48, 50304, 1024) == \
        jh.gpt2_param_count(1600, 48, 50304, 1024) == 1557686400


def _forecast_cfg(**over):
    cfg = {"model": {"n_embd": 1600, "n_layer": 48, "vocab_size": 50304,
                     "n_positions": 1024},
           "remat": "dots+attn", "batch_per_device": 8, "seq_len": 1024, "ce_chunk": 0,
           "external_master_shards": 32, "budget_gib": 15.75}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("over", [{}, {"remat": "none", "batch_per_device": 3},
                                  {"budget_gib": 80.0, "external_master_shards": 0},
                                  {"ce_chunk": 128, "remat": "dots"}])
def test_forecast_and_deltas_equal_jax(over):
    from deepspeed_tpu.utils import hbm as jh
    cfg = _forecast_cfg(**over)
    assert ph.forecast(cfg) == jh.forecast(cfg)
    assert ph.smallest_fitting_delta(cfg) == jh.smallest_fitting_delta(cfg)


def test_oom_forensics_and_diff_equal_jax():
    from deepspeed_tpu.utils import hbm as jh
    snap = {"classes": {"params": 300, "optimizer": 900, "master": 600},
            "measured": None, "temp_peak_bytes": 123,
            "forecast_config": _forecast_cfg()}
    assert ph.oom_forensics(snap) == jh.oom_forensics(snap)
    old = {"entries": {"a": {"reconciled": True, "classes": {
        "params": {"parsed_bytes": 1000}, "optimizer": {"parsed_bytes": 5000}}},
        "b": {"reconciled": True, "classes": {}}}}
    new = {"entries": {"a": {"reconciled": False, "classes": {
        "params": {"parsed_bytes": 1000}, "optimizer": {"parsed_bytes": 9000}}}}}
    assert ph.diff_reports(old, new) == jh.diff_reports(old, new)
    assert not ph.diff_reports(old, new)["ok"] and ph.diff_reports(old, old)["ok"]


def test_hbm_main_on_reports(tmp_path, capsys):
    _, peng = _engines("zero2")
    report = ph.engine_report(peng)
    path = tmp_path / "r.json"
    path.write_text(json.dumps(report))
    assert ph.hbm_main(["--report", str(path)]) == 0
    assert "[ok]" in capsys.readouterr().out
    assert ph.hbm_main(["--diff", str(path), str(path)]) == 0
    grown = json.loads(path.read_text())
    grown["classes"]["optimizer"]["parsed_bytes"] *= 2
    (tmp_path / "g.json").write_text(json.dumps(grown))
    assert ph.hbm_main(["--diff", str(path), str(tmp_path / "g.json")]) == 1
    cfg = tmp_path / "f.json"
    cfg.write_text(json.dumps(_forecast_cfg()))
    capsys.readouterr()
    assert ph.hbm_main(["--forecast", str(cfg), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert not out["fits"] and out["fitting_deltas"]
    assert ph.stable_projection(report)["entries"]["engine"]["reconciled"]


def test_serving_manifest_and_memory_scalars(tmp_path):
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.bfloat16), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    eng = InferenceEngine(tm, num_slots=2, block_size=8, num_blocks=9, max_model_len=32,
                          prefill_chunk=8)
    man = eng.memory_manifest()
    _, class_bytes = ph.manifest_signatures(man)
    assert class_bytes["kv_pool"] == 2 * eng.k_pool.numel() * 2
    live = ph.measure_classes(man)
    assert live == class_bytes
    classes, ok = ph.reconcile(live, ph.modeled_classes(man["geometry"]), class_bytes)
    assert ok, classes
    # the training engine's Memory/* scalars, from the installed manifest
    cfg = _config("AdamW", 2, gas=1)
    cfg["telemetry"] = {"enabled": True, "output_path": str(tmp_path), "job_name": "tel",
                        "hbm": {"enabled": True}}
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                   device="cpu")
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, config_params=cfg,
                                                   device="cpu")
    tokens = torch.randint(0, DIMS["vocab_size"], (2, 16))
    loss = teng(tokens, torch.roll(tokens, -1, 1))
    teng.backward(loss)
    teng.step()
    teng.telemetry.close()
    with open(tmp_path / "tel" / "scalars.jsonl") as f:
        tags = {json.loads(line)["tag"]: json.loads(line)["value"] for line in f}
    _, want = ph.manifest_signatures(teng.memory_manifest())
    for cls, b in want.items():
        assert tags[f"Memory/{cls}_bytes"] == b
    assert "Memory/compiled_temp_peak_bytes" in tags
    assert teng.telemetry.memory_snapshot()["classes"] == want
    assert ph.device_memory_stats() is None
    with pytest.raises(ValueError, match="budget"):
        ph.forecast(_forecast_cfg(budget_gib=0))
