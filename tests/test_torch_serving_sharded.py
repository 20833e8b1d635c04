"""Head-sharded serving in the PyTorch port (``serving.sharding.model`` = 2),
on the CPU, against the JAX package.

Counterparts of ``tests/unit/test_serving_sharded.py`` on its model (vocab
64, width 16, 2 layers, 2 heads, float32) with the JAX weights
(``params_from_jax``). Two gloo processes, one spawn (one thread a rank),
each the same engine on the same requests: the mixed trace's tokens (greedy
and beam) equal the unsharded port's and the JAX sharded engine's on 2
devices, the schedule logs byte for byte; the paged-decode wrapper's plain
version (the kernel path's CPU side) gives the same tokens; the pools hold
one head a rank; the constructor's refusals keep the JAX messages;
``init_inference`` on a tensor-parallel module serves its whole leaves. The
lint registry's ``serving_sharded`` programs record one float32 all-reduce
a layer (torch's fake process group at 2 ranks).

JAX is imported inside the tests, so the spawned workers import only torch.
"""

import functools
import json
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
from deepspeed_tpu_torch.serve.engine import InferenceEngine
from deepspeed_tpu_torch.serve.scheduler import Request

ML = 32
DIMS = dict(vocab_size=64, n_positions=ML, n_embd=16, n_layer=2, n_head=2)
GEOMETRY = dict(num_slots=4, block_size=4, num_blocks=33, max_model_len=ML, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def _jax_model():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32, loss_chunk=0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params():
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    return {k: v.numpy() for k, v in params_from_jax(_jax_model()[1], device="cpu").items()}


def _model(params):
    model = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                      device="cpu")
    model.load_parameters({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return model


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 64, size=n).astype(np.int32).tolist()


def _mixed_trace():
    """Greedy + beam-4 + staggered arrivals (tests/unit/test_serving_sharded.py)."""
    return [Request(f"r{i}", _prompt(i, 5 + i % 7), 6, arrival=i // 3,
                    num_beams=(4 if i == 3 else 1)) for i in range(6)]


def _record(outs, logs):
    return {"tokens": [o.tokens for o in outs], "status": [o.status for o in outs],
            "scores": [o.score for o in outs], "logs": json.dumps(logs)}


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        from deepspeed_tpu_torch.parallel import build_mesh
        params = {k[2:]: v for k, v in np.load(os.path.join(out_dir, "inputs.npz")).items()}
        res = {}
        for kernel in (False, True):
            eng = InferenceEngine(_model(params), sharding={"model": 2}, use_pallas=kernel,
                                  **GEOMETRY)
            res[f"kernel{kernel}"] = _record(*eng.run(_mixed_trace()))
        res["pool_shape"] = list(eng.k_pool.shape)
        res["captured"], res["capture_note"] = eng.captured, eng.capture_note
        res["refusals"] = {}
        for name, kw in (("mirror", dict(mirror=True)),
                         ("speculation", dict(speculation={"enabled": True}))):
            try:
                InferenceEngine(_model(params), sharding={"model": 2}, **kw, **GEOMETRY)
            except ValueError as err:
                res["refusals"][name] = str(err)
        # init_inference on a tensor-parallel module: the whole leaves served
        module = _model(params).with_tp(build_mesh(model=2))
        cfg = {"serving": {"max_seqs": 4, "block_size": 4, "num_blocks": 33,
                           "max_model_len": ML, "prefill_chunk": 8}}
        eng = deepspeed_tpu_torch.init_inference(module, config_params=cfg, device="cpu")
        res["tp_module"] = _record(*eng.run(_mixed_trace()))
        res["tp_module_local"] = [p.numel() for p in module.parameters()]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _gloo_run():
    out_dir = tempfile.mkdtemp(prefix="serving_sharded_")
    np.savez(os.path.join(out_dir, "inputs.npz"),
             **{f"p/{k}": v for k, v in _port_params().items()})
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_worker, args=(port, out_dir), nprocs=2, start_method="spawn",
                       join=True)
    ranks = []
    for r in (0, 1):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


@functools.lru_cache(maxsize=None)
def _unsharded():
    eng = InferenceEngine(_model(_port_params()), **GEOMETRY)
    return _record(*eng.run(_mixed_trace()))


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    from deepspeed_tpu.serve.engine import InferenceEngine as JaxEngine
    from deepspeed_tpu.serve.scheduler import Request as JaxRequest
    jm, jp = _jax_model()
    eng = JaxEngine(jm, jp, sharding={"model": 2}, **GEOMETRY)
    reqs = [JaxRequest(r.req_id, list(r.prompt), r.max_new_tokens, arrival=r.arrival,
                       num_beams=r.num_beams) for r in _mixed_trace()]
    return _record(*eng.run(reqs))


def test_sharded_token_identity_greedy_and_beam(eight_devices):
    """Greedy and beam tokens at sharding.model = 2 equal the unsharded
    port's and the JAX sharded engine's; the beam score survives the
    reduction-order change; scheduling is sharding-blind (the logs byte for
    byte)."""
    ranks = _gloo_run()
    base, jax_ = _unsharded(), _jax_sharded()
    for res in ranks:
        got = res["kernelFalse"]
        assert got["status"] == ["finished"] * 6
        assert got["tokens"] == base["tokens"] == jax_["tokens"]
        assert got["logs"] == base["logs"] == jax_["logs"]
        assert got["scores"][3] == pytest.approx(base["scores"][3], rel=1e-5)
        assert got["scores"][3] == pytest.approx(jax_["scores"][3], rel=1e-5)


def test_sharded_kernel_path_token_identity():
    """``use_pallas`` (the paged-decode wrapper at the local head count; its
    plain version on the CPU) gives the gather path's tokens."""
    for res in _gloo_run():
        assert res["kernelTrue"]["tokens"] == res["kernelFalse"]["tokens"]


def test_sharded_pool_actually_sharded():
    """Each rank's pools hold its n_head / 2 heads; on the CPU nothing is
    captured, and the engine says why."""
    for res in _gloo_run():
        assert res["pool_shape"][3] == DIMS["n_head"] // 2
        assert not res["captured"] and res["capture_note"].startswith("eager")


def test_sharded_constructor_validation():
    """The JAX rules with their messages (tests/unit/test_serving_sharded.py:
    113): n_head divisible, at least 1, no more than the ranks (devices), no
    mirror, no speculation (the last two inside the 2-rank world)."""
    model = _model(_port_params())
    with pytest.raises(ValueError, match="n_head"):
        InferenceEngine(model, sharding={"model": 3}, **GEOMETRY)
    with pytest.raises(ValueError):
        InferenceEngine(model, sharding={"model": 0}, **GEOMETRY)
    cfg16 = GPT2Config(**dict(DIMS, n_head=16, n_layer=1), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="devices"):
        InferenceEngine(GPT2Model(cfg16, device="cpu"), sharding={"model": 16}, **GEOMETRY)
    for res in _gloo_run():
        assert "mirror" in res["refusals"]["mirror"]
        assert "speculation + serving.sharding.model > 1" in res["refusals"]["speculation"]


def test_init_inference_on_a_tensor_parallel_module_serves_whole_leaves():
    """A tensor-parallel module (its leaves slices) through
    ``init_inference``: the serving parameters are its whole leaves, the
    tokens the unsharded engine's, and the module keeps its slices."""
    base = _unsharded()
    whole = sum(int(np.prod(v.shape)) for v in _port_params().values())
    for res in _gloo_run():
        assert res["tp_module"]["tokens"] == base["tokens"]
        assert sum(res["tp_module_local"]) < whole


def test_serving_sharded_lint_records_one_f32_all_reduce_a_layer():
    """The lint registry's ``serving_sharded`` entry, recorded in torch's fake
    process group of 2 ranks: the decode step and the prefill chunk each
    issue exactly one float32 all-reduce a layer and no other collective,
    copy_blocks none; the budget fails a program with one more."""
    from deepspeed_tpu_torch.lint import registry
    from deepspeed_tpu_torch.lint.program_passes import run_program_passes
    arts = {a.name.split(":")[1]: a for a in registry.capture_entry("serving_sharded", "cpu")}
    assert sorted(arts) == ["serve_copy_blocks", "serve_decode_step", "serve_prefill_chunk"]
    for name, art in arts.items():
        comms = [str(op) for op in art.ops if str(op).startswith("c10d::")]
        want = 0 if name == "serve_copy_blocks" else DIMS["n_layer"]
        assert len(comms) == want, comms
        assert all(c.startswith("c10d::allreduce_") and "f32[" in c for c in comms)
    assert run_program_passes(list(arts.values())) == []
    tight = arts["serve_decode_step"]
    tight.manifest["collectives"]["all-reduce"]["max"] = DIMS["n_layer"] - 1
    assert [v.rule for v in run_program_passes([tight])] == ["count-exceeded"]
    assert registry.entry_axis("serving_sharded") == "model"
