"""The PyTorch port's step anatomy (``deepspeed_tpu_torch/utils/anatomy.py``
and the ``telemetry.anatomy`` block) against the JAX package, on the CPU.

- ``analyze_program`` from a program record: without measured slices its
  roofline is JAX's ``roofline`` of the same flops and bytes (exactly) and
  no collective is exposed (world 1); with measured slices each NCCL kernel
  is a row whose overlap is what compute on other streams covers, exposed
  the rest, and the floor grows by the exposed time.
- ``opportunities``, the per-program JSON block, ``program_schedule_events``
  and ``to_anatomy_trace_events`` (its bytes) equal the JAX functions' on a
  JAX-shaped report; a measured row (bytes unknown) is an opportunity
  whatever its size.
- On a tiny CPU engine under ``cpu-test``: each step's predicted floor lies
  at or below its measured wall, the ``Anatomy/*`` scalars are emitted,
  the traced programs' anatomy rides the profile report with nothing
  exposed; ``anatomy_main`` renders saved reports and writes a timeline.
"""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.utils import anatomy as pa
from deepspeed_tpu_torch.utils import roofline as prf


def _jax_report():
    return {"name": "loss_and_grad", "flops": 1e9, "hbm_bytes": 5e8,
            "wire_bytes": {"ici": 4096, "dcn": 1024},
            "exposed_s": {"ici": 2e-6, "dcn": 5e-5},
            "collectives": [
                {"instruction": "rs.1", "op": "reduce-scatter", "line": 7, "level": "dcn",
                 "bytes": 1024, "async": False, "zero_overlap": True, "bucket": None,
                 "comm_s": 5e-5, "overlap_s": 0.0, "exposed_s": 5e-5},
                {"instruction": "ag.2", "op": "all-gather", "line": 9, "level": "ici",
                 "bytes": 4096, "async": True, "zero_overlap": False, "bucket": 0,
                 "comm_s": 4e-6, "overlap_s": 2e-6, "exposed_s": 2e-6},
                {"instruction": "ar.3", "op": "all-reduce", "line": 11, "level": "ici",
                 "bytes": 16, "async": True, "zero_overlap": True, "bucket": None,
                 "comm_s": 1e-7, "overlap_s": 0.0, "exposed_s": 1e-7}],
            "roofline": {"compute_floor_s": 1e-5, "hbm_floor_s": 5e-7,
                         "exposed_ici_s": 2e-6, "exposed_dcn_s": 5e-5,
                         "predicted_floor_s": 6.2e-5, "mfu_ceiling": 0.16},
            "memory": None}


def test_analyze_without_slices_is_the_roofline():
    from deepspeed_tpu.utils import roofline as jrf
    spec = prf.resolve_spec("h100-sxm")
    rep = pa.analyze_program({"flops": 8.9e13, "hbm_bytes": 2.1e11}, spec, name="fused_step")
    want = jrf.roofline(8.9e13, 2.1e11, 0.0, 0.0, jrf.ChipSpec(**spec.to_dict()))
    assert rep["roofline"] == want
    assert rep["collectives"] == [] and rep["exposed_s"] == {"ici": 0.0, "dcn": 0.0}
    assert rep["roofline"]["predicted_floor_s"] == 8.9e13 / 989e12


def test_analyze_measured_collectives():
    spec = prf.resolve_spec("cpu-test")
    slices = [{"op": "gemm", "ts": 0.0, "dur": 100.0, "stream": 7},
              {"op": "ncclDevKernel_ReduceScatter", "ts": 50.0, "dur": 100.0, "stream": 13,
               "scope": "ds_grad_bucket2"},
              {"op": "ncclDevKernel_AllGather", "ts": 300.0, "dur": 40.0, "stream": 13}]
    rep = pa.analyze_program({"flops": 1e6, "hbm_bytes": 1e6}, spec, slices, name="p")
    rows = rep["collectives"]
    assert [r["instruction"] for r in rows] == ["ncclDevKernel_ReduceScatter",
                                                "ncclDevKernel_AllGather"]
    assert rows[0]["overlap_s"] == pytest.approx(50e-6)
    assert rows[0]["exposed_s"] == pytest.approx(50e-6) and rows[0]["bucket"] == 2
    assert rows[1]["zero_overlap"] and rows[1]["exposed_s"] == pytest.approx(40e-6)
    assert rep["exposed_s"]["ici"] == pytest.approx(90e-6)
    assert rep["roofline"]["predicted_floor_s"] == pytest.approx(
        max(1e6 / spec.peak_flops, 1e6 / (spec.hbm_gbps * 1e9)) + 90e-6)
    opp = pa.opportunities([rep])
    assert [o["instruction"] for o in opp] == ["ncclDevKernel_AllGather"]
    assert "NCCL" in opp[0]["hint"]


def test_report_blocks_and_timeline_equal_jax():
    from deepspeed_tpu.utils import anatomy as ja
    from deepspeed_tpu.utils.trace_event import serialize_trace as jser
    from deepspeed_tpu_torch.utils.trace_event import serialize_trace
    reps = [_jax_report(), dict(_jax_report(), name="apply_update")]
    for min_bytes in (0, 1024, 10**6):
        assert pa.opportunities(reps, min_bytes) == ja.opportunities(reps, min_bytes)
    assert pa._program_json(reps[0]) == ja._program_json(reps[0])
    assert pa.program_schedule_events(reps[0], 3, 1, 2, 4, "x ") == \
        ja.program_schedule_events(reps[0], 3, 1, 2, 4, "x ")
    assert serialize_trace(pa.to_anatomy_trace_events(reps)) == \
        jser(ja.to_anatomy_trace_events(reps))


def test_cpu_engine_floor_below_measured_and_main(tmp_path, capsys):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    m = GPT2Model(GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=2,
                             compute_dtype=torch.float32, loss_chunk=0), device="cpu")
    m.init(torch.Generator().manual_seed(0))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=m, device="cpu", config_params={
        "train_batch_size": 2, "steps_per_print": 1000, "bf16": {"enabled": False},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "telemetry": {"enabled": True, "output_path": str(tmp_path), "job_name": "tel",
                      "trace_dir": str(tmp_path / "trace"), "trace_steps": [2, 3],
                      "anatomy": {"enabled": True, "chip": "cpu-test"},
                      "profile": {"enabled": True}}})
    tel = eng.telemetry
    assert tel.anatomy_spec.name == "cpu-test" and tel.peak_tflops == 100.0
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 64, size=(2, 16)).astype(np.int64))
    floors = []
    for _ in range(5):
        loss = eng(tok, torch.roll(tok, -1, 1))
        eng.backward(loss)
        eng.step()
        if tel.last_anatomy is not None:
            floors.append((tel.last_anatomy["predicted_floor_s"],
                           tel.last_anatomy["measured_s"]))
    assert len(floors) == 4 and all(0 < f <= m for f, m in floors)
    summary = tel.summary()["anatomy"]
    assert summary["exposed_ici_ms"] == 0.0 and 0 < summary["mfu_ceiling"] <= 1.0
    programs = tel.last_profile["anatomy"]
    assert {p["name"] for p in programs} == {"forward", "backward", "apply_update"}
    assert all(p["exposed_s"] == {"ici": 0.0, "dcn": 0.0} for p in programs)
    with open(tmp_path / "tel" / "scalars.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"Anatomy/predicted_floor_ms", "Anatomy/mfu_ceiling", "Anatomy/host_gap_ms"} <= tags
    tel.close()
    saved = tmp_path / "anatomy.json"
    saved.write_text(json.dumps({"programs": programs}))
    timeline = tmp_path / "timeline.json"
    assert pa.anatomy_main(["--report", str(saved), "--timeline", str(timeline)]) == 0
    out = capsys.readouterr().out
    assert "backward: floor" in out and "3 program(s)" in out
    assert len(json.loads(timeline.read_text())["traceEvents"]) > 3
