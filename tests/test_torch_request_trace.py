"""The request tracer of the PyTorch port against the JAX package, on the CPU.

- ``HistogramSketch`` percentiles, mean and merge equal the JAX sketch's on
  the same seeded stream;
- a traced port engine and a traced JAX engine (the same tiny float32 GPT-2,
  carried over with ``params_from_jax``) on one seeded trace that preempts
  give bundles equal in every iteration-domain field (the wall-clock fields
  — event times, ``*_ms``, the sketches — cannot agree and are dropped), and
  the port's schedule logs equal its untraced run's;
- ``to_serve_trace_events`` gives the same bytes as the JAX function on one
  bundle fed to both (the JAX golden file is not the oracle: it fails on the
  reference tree);
- the tracer's config block reaches the engine through ``init_inference``;
- the module imports the standard library only.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.serve import request_trace as jax_rt
from deepspeed_tpu.serve.scheduler import Request as JaxRequest
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.serve import request_trace as rt
from deepspeed_tpu_torch.serve.scheduler import Request

ROOT = Path(__file__).resolve().parents[1]
ML = 32
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)


def _cfg(**trace):
    return {"serving": {"block_size": 4, "num_blocks": 13, "max_seqs": 4,
                        "max_model_len": ML, "prefill_chunk": 8,
                        "request_trace": dict({"enabled": True}, **trace)}}


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _trace():
    rng = np.random.RandomState(2)
    reqs = [(f"r{i}", rng.randint(0, 64, size=8).tolist(), 14, dict(arrival=i // 2))
            for i in range(5)]
    reqs.append(("b0", rng.randint(0, 64, size=7).tolist(), 5,
                 dict(num_beams=2, arrival=1)))
    reqs.append(("big", rng.randint(0, 64, size=40).tolist(), 4, {}))   # refused
    return reqs


def test_histogram_sketch_matches_jax():
    rng = np.random.RandomState(0)
    a, b = rt.HistogramSketch(), jax_rt.HistogramSketch()
    parts = [rt.HistogramSketch() for _ in range(3)]
    jparts = [jax_rt.HistogramSketch() for _ in range(3)]
    for i, v in enumerate(rng.lognormal(2.0, 1.5, size=3000)):
        a.add(float(v))
        b.add(float(v))
        parts[i % 3].add(float(v))
        jparts[i % 3].add(float(v))
    a.add(None)
    b.add(None)
    for p in (1, 50, 90, 99, 99.9):
        assert a.percentile(p) == b.percentile(p)
    assert a.mean == b.mean and a.count == b.count
    assert a.to_dict() == b.to_dict()
    merged = rt.HistogramSketch.merged(parts)
    assert merged.to_dict() == jax_rt.HistogramSketch.merged(jparts).to_dict()
    assert merged.to_dict()["buckets"] == a.to_dict()["buckets"]


def _iteration_domain(bundle):
    """The bundle without its wall-clock fields."""
    def rec(r):
        out = {k: v for k, v in r.items() if not k.endswith("_ms")}
        out["events"] = [e[:2] + e[3:] for e in r["events"]]
        return out
    return {
        **{k: v for k, v in bundle.items()
           if k not in ("requests", "live", "iterations", "latency_sketches")},
        "requests": [rec(r) for r in bundle["requests"]],
        "live": [rec(r) for r in bundle["live"]],
        "iterations": [{k: v for k, v in it.items() if k != "t_us"}
                       for it in bundle["iterations"]],
        "latency_metrics": sorted(bundle["latency_sketches"]),
    }


@pytest.fixture(scope="module")
def traced(models):
    jm, jp, tm = models
    slo = {"ttft_ms": 1e6, "tpot_ms": 1e-9}
    teng = deepspeed_tpu_torch.init_inference(tm, config_params=_cfg(slo=slo), device="cpu")
    jeng = deepspeed_tpu.init_inference(jm, jp, config_params=_cfg(slo=slo))
    touts, tlogs = teng.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])
    jouts, jlogs = jeng.run([JaxRequest(r, p, n, **kw) for r, p, n, kw in _trace()])
    return teng, jeng, touts, jouts, tlogs, jlogs


def test_bundle_matches_jax_in_the_iteration_domain(models, traced):
    teng, jeng, touts, jouts, tlogs, jlogs = traced
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert [o.status for o in touts] == ["finished"] * 6 + ["refused"]
    assert json.dumps(tlogs) == json.dumps(jlogs)
    tb, jb = teng.tracer.bundle(), jeng.tracer.bundle()
    assert tb["counts"]["preemptions"] > 0 and tb["counts"]["refused"] == 1
    assert _iteration_domain(tb) == _iteration_domain(jb)
    assert teng.tracer.waste_summary() == jeng.tracer.waste_summary()
    assert teng.tracer.slo_summary()["violated"] == jeng.tracer.slo_summary()["violated"]
    # single-source TTFT: the outputs read the ledger's numbers
    recs = {r["req_id"]: r for r in tb["requests"]}
    for o in touts[:6]:
        assert o.ttft_ms == recs[o.req_id]["ttft_ms"]
        assert o.ttft_iters == recs[o.req_id]["ttft_iters"]
    # tracing changes no decision
    _, _, tm = models
    plain = deepspeed_tpu_torch.init_inference(
        tm, config_params=_cfg(enabled=False), device="cpu")
    assert plain.tracer is None
    pouts, plogs = plain.run([Request(r, p, n, **kw) for r, p, n, kw in _trace()])
    assert json.dumps(plogs) == json.dumps(tlogs)
    assert [o.tokens for o in pouts] == [o.tokens for o in touts]


def test_perfetto_export_equals_jax_bytes(traced):
    teng = traced[0]
    bundle = json.loads(json.dumps(teng.tracer.bundle()))
    ours = rt.serialize_trace(rt.to_serve_trace_events(bundle))
    theirs = jax_rt.serialize_trace(jax_rt.to_serve_trace_events(bundle))
    assert ours == theirs
    assert json.loads(ours)["traceEvents"]


def test_serve_timeline_cli_round_trip(traced, tmp_path):
    teng = traced[0]
    path = teng.tracer.dump(str(tmp_path / "bundle.json"))
    assert rt.serve_timeline_main([path, "-o", str(tmp_path / "out.json")]) == 0
    assert json.load(open(tmp_path / "out.json"))["traceEvents"]


def test_config_block_reaches_the_engine(models, tmp_path):
    """init_inference passes the whole request_trace and speculation blocks,
    as the JAX package's does."""
    _, _, tm = models
    cfg = _cfg(capacity=7, iteration_capacity=9, dump_dir=str(tmp_path),
               slo={"ttft_ms": 5.0, "tpot_ms": 2.0})
    cfg["serving"]["speculation"] = {"enabled": True, "max_draft_tokens": 3,
                                     "draft_pool_blocks": 11}
    eng = deepspeed_tpu_torch.init_inference(tm, config_params=cfg, device="cpu",
                                             draft_model=tm)
    tr = eng.tracer
    assert (tr.capacity, tr.iteration_capacity, tr.dump_dir) == (7, 9, str(tmp_path))
    assert tr.slo == {"ttft_ms": 5.0, "tpot_ms": 2.0}
    assert eng.spec_k == 3 and eng._spec.allocator.num_blocks == 11
    assert eng._spec.params is eng.params            # a self-draft shares weights


def test_request_trace_module_is_stdlib_pure():
    for rel in ("deepspeed_tpu_torch/serve/request_trace.py",
                "deepspeed_tpu_torch/utils/trace_event.py"):
        tree = ast.parse((ROOT / rel).read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add((node.module or "").split(".")[0])
        assert not mods & {"numpy", "torch", "jax"}, (rel, sorted(mods))
