"""The PyTorch port's profile ingest (``deepspeed_tpu_torch/utils/
profile_ingest.py``) and the telemetry session's ``telemetry.profile``
block, against the JAX package, on the CPU.

- The arithmetic on the JAX package's own fixture: the JAX reader's device
  slices of ``tests/unit/fixtures/profile_cpu_mesh.trace.json.gz`` through
  the port's ``summarize_slices`` (the JAX report, plus the port's
  ``slice_names``), ``reconcile_profile`` (ok, drift and unobserved
  verdicts), ``stable_projection``, ``diff_reports`` and the merged
  timeline's bytes, each equal to the JAX function's.
- The Chrome-trace reader: a synthetic card trace (kernel, memcpy and
  memset events on two streams, the GPU-side ``ds_program/*`` and scope
  ranges, an NCCL kernel) gives the slices their program and scope, the
  NCCL kernel's exposure by interval algebra, ``kernel_counts`` and the
  kernel class of the reconciliation (ok, and drift on a miscount; an NCCL
  kernel the catalog does not predict is a drift of its class); a card
  trace with no device event, a malformed file and an empty directory raise.
- A tiny CPU-profiled step: the port's engine with a trace window and the
  profile block; the outermost host ops of its ``torch.profiler`` trace,
  attributed to the watched programs and the engine's scopes, reconcile
  with the session's counters; ``run_reconcile`` and ``profile_main`` on
  the CPU.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.utils import profile_ingest as pi

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit", "fixtures",
                       "profile_cpu_mesh.trace.json.gz")

CATALOG = {
    "jit_loss_and_grad": {
        "program": "loss_and_grad",
        "scopes": {"fusion.1": "ds_fwd_bwd", "reduce-scatter.6": "ds_grad_bucket0",
                   "all-gather.3": "ds_grad_bucket0"},
        "collectives": {
            "reduce-scatter.6": {"level": "dcn", "bytes": 1024, "bucket": 0},
            "all-gather.3": {"level": "ici", "bytes": 512, "bucket": 0},
        },
        "flops": 1000.0, "wire_ici": 512, "wire_dcn": 1024,
        "predicted_exposed_ici_us": 0.0, "predicted_exposed_dcn_us": 90.0,
    },
    "jit_apply_update": {
        "program": "apply_update", "scopes": {"fusion.3": "ds_apply_update"},
        "collectives": {}, "flops": 200.0, "wire_ici": 0, "wire_dcn": 0,
        "predicted_exposed_ici_us": 0.0, "predicted_exposed_dcn_us": 0.0,
    },
}


def _jax_slices():
    from deepspeed_tpu.utils.profile_ingest import device_slices, load_trace
    return device_slices(load_trace(FIXTURE)["traceEvents"])


def _derived(flops=1200.0, ici=512, dcn=1024, wall=0.34):
    return {"flops_per_step": flops, "wire_ici_per_step": ici, "wire_dcn_per_step": dcn,
            "step_wall_ms": wall}


@pytest.mark.parametrize("peak", [None, 1e-6])
def test_summarize_and_reconcile_equal_jax(peak):
    from deepspeed_tpu.utils import profile_ingest as ji
    slices = _jax_slices()
    mine = pi.summarize_slices(slices, catalog=CATALOG, devices=1, steps=1, peak_tflops=peak)
    theirs = ji.summarize_slices(slices, catalog=CATALOG, devices=1, steps=1,
                                 peak_tflops=peak)
    assert mine.pop("slice_names") == {s["op"]: 1 for s in slices}
    assert mine == theirs
    for derived in (_derived(), _derived(flops=2400.0), _derived(wall=None)):
        ours = pi.reconcile_profile(mine, CATALOG, derived, entry="fixture")
        want = ji.reconcile_profile(theirs, CATALOG, derived, entry="fixture")
        assert ours == want
        assert pi.stable_projection(ours) == ji.stable_projection(want)
    empty_p = pi.summarize_slices([], catalog=CATALOG)
    empty_p.pop("slice_names")
    assert pi.reconcile_profile(empty_p, CATALOG, _derived()) == \
        ji.reconcile_profile(ji.summarize_slices([], catalog=CATALOG), CATALOG, _derived())


def test_diff_and_timeline_equal_jax():
    from deepspeed_tpu.utils import profile_ingest as ji
    from deepspeed_tpu.utils.trace_event import serialize_trace as jser
    from deepspeed_tpu_torch.utils.trace_event import serialize_trace
    slices = _jax_slices()
    rep = ji.stable_projection(ji.reconcile_profile(
        ji.summarize_slices(slices, catalog=CATALOG), CATALOG, _derived()))
    bad = json.loads(json.dumps(rep))
    bad["classes"]["compute"]["status"] = "drift"
    bad["scopes_observed"].pop()
    for a, b in ((rep, rep), (rep, bad)):
        assert pi.diff_reports(a, b) == ji.diff_reports(a, b)
    predicted = [{"name": "loss_and_grad",
                  "roofline": {"compute_floor_s": 100e-6, "hbm_floor_s": 50e-6,
                               "mfu_ceiling": 0.5},
                  "collectives": [{"op": "reduce-scatter", "level": "dcn", "instruction": "rs",
                                   "bytes": 1024, "async": True, "zero_overlap": False,
                                   "bucket": 0, "comm_s": 90e-6, "overlap_s": 40e-6,
                                   "exposed_s": 50e-6}]}]
    assert serialize_trace(pi.to_profile_trace_events(slices, CATALOG, predicted)) == \
        jser(ji.to_profile_trace_events(slices, CATALOG, predicted))


def _x(name, cat, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _card_trace():
    """Two steps of a fused program: compute kernels on stream 7, an NCCL
    all-reduce on stream 13 half under compute, a memcpy."""
    ev = []
    for step, t0 in enumerate((0.0, 1000.0)):
        ev += [_x("ds_program/fused_step", "gpu_user_annotation", t0, 600.0),
               _x("ds_fwd_bwd", "gpu_user_annotation", t0, 400.0),
               _x("ds_apply_update", "gpu_user_annotation", t0 + 400.0, 200.0),
               _x("flash_fwd_tc_kernel<bf16>", "kernel", t0 + 10.0, 50.0),
               _x("flash_bwd_dq_tc_kernel", "kernel", t0 + 100.0, 60.0),
               _x("flash_bwd_dkv_tc_kernel", "kernel", t0 + 200.0, 60.0),
               _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t0 + 300.0, 10.0),
               _x("ncclDevKernel_AllReduce_Sum_f32", "kernel", t0 + 380.0, 80.0, tid=13),
               _x("adam_kernel", "kernel", t0 + 420.0, 100.0),
               _x("ds_fwd_bwd", "user_annotation", t0, 300.0, tid=1),
               _x("aten::mm", "cpu_op", t0, 5.0, tid=1)]
    return {"traceEvents": ev}


def test_card_trace_reader_and_kernel_reconcile(tmp_path):
    events = _card_trace()["traceEvents"]
    slices = pi.device_slices(events, device="cuda")
    assert len(slices) == 12 and all(s["module"] == "fused_step" for s in slices)
    assert {s["op"]: s["scope"] for s in slices if s["ts"] < 1000} == {
        "flash_fwd_tc_kernel<bf16>": "ds_fwd_bwd", "flash_bwd_dq_tc_kernel": "ds_fwd_bwd",
        "flash_bwd_dkv_tc_kernel": "ds_fwd_bwd",
        "Memcpy HtoD (Pageable -> Device)": "ds_fwd_bwd",
        "ncclDevKernel_AllReduce_Sum_f32": "ds_fwd_bwd", "adam_kernel": "ds_apply_update"}
    catalog = {"fused_step": {"program": "fused_step", "scopes": {}, "collectives": {},
                              "flops": 5e9, "wire_ici": 0, "wire_dcn": 0,
                              "predicted_exposed_ici_us": 0.0,
                              "predicted_exposed_dcn_us": 0.0}}
    rep = pi.summarize_slices(slices, catalog=catalog, steps=2, peak_tflops=100.0)
    cls = rep["classes"]
    # the all-reduce [380, 460] a step, the adam kernel over [420, 460]:
    # 40 us exposed a step, over the window's two
    assert cls["collective_ici"]["busy_us"] == 160.0
    assert cls["collective_ici"]["exposed_us"] == 80.0
    assert rep["collective_counts"] == {"fused_step": {"ncclDevKernel_AllReduce_Sum_f32": 2}}
    names = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
    assert pi.kernel_counts(rep["slice_names"], names) == dict.fromkeys(names, 2)
    derived = {"flops_per_step": 5e9, "wire_ici_per_step": 0, "wire_dcn_per_step": 0}
    ok = pi.reconcile_profile(rep, catalog, derived, kernels=dict.fromkeys(names, 2))
    assert ok["classes"]["kernels"]["status"] == "ok"
    # the catalog predicts no collective, the trace shows one a step: drift
    assert ok["classes"]["collective_ici"]["status"] == "drift"
    miss = pi.reconcile_profile(rep, catalog, derived, kernels=dict.fromkeys(names, 3))
    assert miss["classes"]["kernels"]["status"] == "drift" and not miss["ok"]
    # the host ops of the same trace, as a CPU ingest reads them
    host = pi.device_slices(events, device="cpu")
    assert [s["op"] for s in host] == ["aten::mm", "aten::mm"]
    assert host[0]["scope"] == "ds_fwd_bwd" and host[0]["module"] == ""
    with pytest.raises(pi.ProfileParseError, match="no kernel"):
        pi.device_slices([e for e in events if e["cat"] not in pi.DEVICE_CATS], "cuda")
    # files: a gzip round trip, malformed and missing traces
    d = tmp_path / "trace_run-a_host0"
    d.mkdir()
    with gzip.open(d / "trace.json.gz", "wt") as f:
        json.dump(_card_trace(), f)
    assert pi.load_trace_dir(str(d))[0] == events
    assert [(r["run"], r["host"]) for r in pi.scan_trace_dirs(str(tmp_path))] == [("run-a", 0)]
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.raises(pi.ProfileParseError, match="bad.json"):
        pi.load_trace(str(tmp_path / "bad.json"))
    (tmp_path / "wrong.json").write_text(json.dumps({"x": 1}))
    with pytest.raises(pi.ProfileParseError, match="no traceEvents"):
        pi.load_trace(str(tmp_path / "wrong.json"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(pi.ProfileParseError, match="no trace files"):
        pi.load_trace_dir(str(tmp_path / "empty"))


def test_cpu_profiled_step_reconciles(tmp_path, capsys):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    m = GPT2Model(GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=2,
                             compute_dtype=torch.float32, loss_chunk=0), device="cpu")
    m.init(torch.Generator().manual_seed(0))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=m, device="cpu", config_params={
        "train_batch_size": 2, "steps_per_print": 1000, "bf16": {"enabled": False},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "telemetry": {"enabled": True, "output_path": str(tmp_path), "job_name": "tel",
                      "trace_dir": str(tmp_path / "trace"), "trace_steps": [1, 3],
                      "profile": {"enabled": True}}})
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 64, size=(2, 16)).astype(np.int64))
    for _ in range(4):
        loss = eng(tok, torch.roll(tok, -1, 1))
        eng.backward(loss)
        eng.step()
    tel = eng.telemetry
    prof = tel.last_profile
    assert prof["steps"] == 2 and prof["classes"]["compute"]["busy_us"] > 0
    assert {"forward", "backward", "apply_update"} <= set(prof["programs"])
    assert {"ds_fwd_bwd", "ds_apply_update"} <= set(prof["scopes"])
    assert prof["reconcile"]["ok"], prof["reconcile"]["classes"]
    assert prof["reconcile"]["classes"]["compute"]["predicted_flops_per_step"] == \
        prof["reconcile"]["classes"]["compute"]["derived_flops_per_step"] > 0
    assert tel.summary()["profile"]["steps"] == 2
    assert tel.profile_snapshot()["report"] is prof
    with open(tmp_path / "tel" / "scalars.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"Profile/compute_ms", "Profile/step_wall_ms", "Profile/host_gap_ms"} <= tags
    # the CLI over the same trace dir (the newest run), and its diff gate
    assert pi.profile_main([str(tmp_path / "trace"), "--host-ops", "--steps", "2"]) == 0
    assert "step wall" in capsys.readouterr().out
    tel.close()


def test_run_reconcile_on_the_cpu(tmp_path):
    report, slices, catalog = pi.run_reconcile(device="cpu", trace_dir=str(tmp_path))
    assert report["ok"], report["classes"]
    assert report["entry"] == pi.RECONCILE_ENTRY and slices
    assert set(catalog) == {"forward", "backward", "apply_update"}
    out = tmp_path / "r.json"
    out.write_text(json.dumps(pi.stable_projection(report)))
    assert pi.profile_main(["--diff", str(out), str(out)]) == 0
