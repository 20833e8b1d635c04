"""The PyTorch port's numerics sentinel and desync audit
(``deepspeed_tpu_torch/utils/numerics.py``, ``runtime/utils.py``
``detect_overflow(index=...)`` and the engine's ``numerics`` block) against
the JAX package, on the CPU.

- Subtree names: the port engine's index over the tiny GPT-2 equals the JAX
  index over the JAX model's parameter tree, at depths 1 and 2.
- ``bucket_sumsq`` (float32, 1e-5 relative), ``bucket_nonfinite`` and
  ``detect_overflow(index=...)`` (exact, an inf and a nan seeded into one
  subtree) on the same numpy-seeded tree.
- ``leaf_checksum`` bitwise JAX's over float32, bf16, float16, float64,
  int32, int64, int8, uint8 and bool leaves, and on leaves whose bit
  patterns sum past 2^32 (wrapping); ``compare_audit_rows`` as JAX's.
- The engine: each step's sentinel record (per-subtree grad, weight and
  update norms, nonfinite counts, the loss and the norm) against the JAX
  engine's on the same float32 GPT-2 and batches, within 1e-5 relative (the
  update ratio within 1e-4: it is a difference of two masters that agree to
  float32 rounding); fp16 from an overflowing scale: the same steps skipped,
  the same scales, the loss-scale journal's events, and the overflow
  attributed to the same subtrees.
- The audit at dp = 2 over gloo (2 processes): in sync on an audit step,
  then a seeded one-bit divergence of rank 1's ``wpe`` master, which the
  next update carries into its parameters, named by the next audit; the
  sentinel's sums of squares at ZeRO-2 equal on both ranks and their sum
  the engine's norm squared.
"""

import os
import socket
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.utils import numerics as pn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from test_torch_engine import DIMS, _batches, _config, _port_params  # noqa: E402

STEPS = 4


def _port_engine(cfg, dtype=torch.float32):
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=dtype, loss_chunk=0), device="cpu")
    params = {k: torch.from_numpy(np.array(v)) for k, v in _port_params().items()}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, model_parameters=params,
                                                  config_params=cfg, device="cpu")
    return eng


def _jax_engine(cfg):
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from test_torch_engine import _jax_params
    jm, jp = _jax_params()
    return DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=cfg)


def _numerics_cfg(root, fp16=False, depth=1):
    cfg = _config("AdamW", 0, gas=1)
    cfg["numerics"] = {"enabled": True, "subtree_depth": depth, "dump_dir": root}
    if fp16:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 24, "hysteresis": 2}
    return cfg


def _records(eng, to_np=lambda t: t):
    out = []
    for tokens, labels in _batches(STEPS, micro=2):
        loss = eng(to_np(tokens), to_np(labels))
        eng.backward(loss)
        eng.step()
        out.append(dict(eng._numerics.last_record))
    return out


# ------------------------------------------------------------------ subtrees
@pytest.mark.parametrize("depth", [1, 2])
def test_subtree_names_equal_jax(depth, tmp_path):
    from deepspeed_tpu.utils import numerics as jn
    from test_torch_engine import _jax_params
    eng = _port_engine(_numerics_cfg(str(tmp_path), depth=depth))
    want = jn.build_subtree_index(_jax_params()[1], depth)
    assert eng._sentinel_index.names == want.names
    # each engine leaf sits in the subtree of its JAX path
    jleaves = {pn.subtree_name(p, 99): b for (p, _), b in zip(
        __import__("jax").tree_util.tree_flatten_with_path(_jax_params()[1])[0],
        want.leaf_buckets)}
    names = eng._names
    for i, name in enumerate(names):
        key = name.replace(".", "/")
        assert eng._sentinel_index.leaf_buckets[i] == jleaves[key], name


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "b": rng.normal(size=(5,)).astype(np.float32)},
            "c": [rng.normal(size=(3, 3)).astype(np.float32),
                  rng.normal(size=(11,)).astype(np.float32)],
            "d": rng.normal(size=(4, 6)).astype(np.float32)}


def _both(tree, depth):
    """(JAX index, port index, port leaves) over one numpy tree."""
    import jax
    from deepspeed_tpu.utils import numerics as jn
    jidx = jn.build_subtree_index(tree, depth)
    pidx = pn.build_subtree_index(tree, depth)
    leaves = [torch.from_numpy(np.array(x)) for x in jax.tree_util.tree_leaves(tree)]
    return jidx, pidx, leaves


@pytest.mark.parametrize("depth", [1, 2])
def test_bucket_sumsq_and_nonfinite_equal_jax(depth):
    import jax.numpy as jnp
    from deepspeed_tpu.runtime import utils as jutils
    from deepspeed_tpu.utils import numerics as jn
    tree = _tree()
    tree["c"][1][3] = np.inf
    tree["c"][1][4] = np.nan
    tree["d"][2, 2] = -np.inf
    jidx, pidx, leaves = _both(tree, depth)
    assert pidx.names == jidx.names and pidx.leaf_buckets == jidx.leaf_buckets
    jt = {k: (jnp.asarray(v) if not isinstance(v, (dict, list)) else v) for k, v in tree.items()}
    finite = _tree()
    _, _, fleaves = _both(finite, depth)
    np.testing.assert_allclose(pn.bucket_sumsq(fleaves, pidx).numpy(),
                               np.asarray(jn.bucket_sumsq(finite, jidx)), rtol=1e-5)
    want = np.asarray(jn.bucket_nonfinite(jt, jidx))
    assert pn.bucket_nonfinite(leaves, pidx).tolist() == want.tolist()
    assert sum(want) == 3
    for fp16 in (True, False):
        jo, jc = jutils.detect_overflow(tree, fp16, jidx)
        po, pc = tutils.detect_overflow(leaves, fp16, pidx)
        assert bool(po) == bool(jo) and pc.tolist() == np.asarray(jc).tolist()
    assert tutils.detect_overflow(leaves, True)[1] is None


def _checksum_cases():
    rng = np.random.default_rng(1)
    return {
        "float32": rng.normal(size=(33, 7)).astype(np.float32),
        "bfloat16": rng.normal(size=(65,)).astype(np.float32),
        "float16": rng.normal(size=(9, 9)).astype(np.float16),
        "float64": rng.normal(size=(17,)),
        "int32": rng.integers(-2 ** 31, 2 ** 31, size=(40,), dtype=np.int64).astype(np.int32),
        "int64": rng.integers(-2 ** 40, 2 ** 40, size=(12,), dtype=np.int64),
        "int8": rng.integers(-128, 128, size=(50,)).astype(np.int8),
        "uint8": rng.integers(0, 256, size=(50,)).astype(np.uint8),
        "bool": rng.random(size=(31,)) > 0.5,
        # bit patterns near 2^32 each: the uint32 sum wraps many times
        "wrap_float32": np.full((1000,), -3.0e38, np.float32),
        "wrap_int32": np.full((4099,), -1, np.int32),
    }


@pytest.mark.parametrize("name", list(_checksum_cases()))
def test_leaf_checksum_bitwise_jax(name):
    import jax.numpy as jnp
    from deepspeed_tpu.utils import numerics as jn
    x = _checksum_cases()[name]
    if name == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    elif name == "int64":
        jx, tx = jnp.asarray(x.astype(np.int32)), torch.from_numpy(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = int(np.asarray(jn.leaf_checksum(jx)))
    got = pn.leaf_checksum(tx)
    assert got.dtype == torch.int64 and 0 <= int(got) < 2 ** 32
    assert int(got) == want
    if name.startswith("wrap"):
        # the patterns' plain sum passes 2^32: the wrap is exercised
        bits = tx.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        assert int(bits.sum()) >= 2 ** 32


def test_compare_audit_rows_equals_jax():
    from deepspeed_tpu.utils import numerics as jn
    names = ["params/a", "params/b", "opt/m/a"]
    cases = [([[1, 2, 3]], None), ([[1, 2, 3], [1, 2, 3]], None),
             ([[1, 2, 3], [1, 5, 3], [1, 2, 4]], None),
             ([[1, 2, 3], [1, 2, 3], [9, 2, 3], [9, 2, 3]], [[0, 1], [2, 3]]),
             ([[1, 2, 3], [7, 2, 3], [1, 2, 3], [1, 2, 3]], [[0, 1], [2, 3]])]
    for matrix, slices in cases:
        assert pn.compare_audit_rows(matrix, names, slice_rows=slices) == \
            jn.compare_audit_rows(matrix, names, slice_rows=slices)


# ------------------------------------------------------------------ engine
_KEYS = ("grad_norm_per_subtree", "weight_norm_per_subtree", "nonfinite_per_subtree",
         "subtrees", "overflow", "loss_scale")


def _compare(ours, theirs, ratio_rtol=1e-4):
    for p, j in zip(ours, theirs):
        for key in _KEYS:
            if isinstance(p.get(key), list) and p[key] and isinstance(p[key][0], float):
                np.testing.assert_allclose(p[key], j[key], rtol=1e-5, err_msg=key)
            else:
                assert p.get(key) == j.get(key), key
        np.testing.assert_allclose(p["update_ratio_per_subtree"],
                                   j["update_ratio_per_subtree"], rtol=ratio_rtol)
        np.testing.assert_allclose([p["loss"], p["grad_norm"]], [j["loss"], j["grad_norm"]],
                                   rtol=1e-5)
        assert (p["anomaly"] or {}).get("subtree") == (j["anomaly"] or {}).get("subtree")
        assert (p["anomaly"] or {}).get("per_subtree") == (j["anomaly"] or {}).get("per_subtree")


def test_engine_sentinel_equals_jax(tmp_path):
    ours = _records(_port_engine(_numerics_cfg(str(tmp_path / "p"))))
    theirs = _records(_jax_engine(_numerics_cfg(str(tmp_path / "j"))),
                      to_np=lambda t: t.astype(np.int32))
    assert all(r["nonfinite_total"] == 0 for r in ours)
    _compare(ours, theirs)


def test_engine_fp16_overflow_equals_jax(tmp_path):
    p_eng = _port_engine(_numerics_cfg(str(tmp_path / "p"), fp16=True))
    j_eng = _jax_engine(_numerics_cfg(str(tmp_path / "j"), fp16=True))
    ours = _records(p_eng)
    theirs = _records(j_eng, to_np=lambda t: t.astype(np.int32))
    assert ours[0]["overflow"] and ours[0]["anomaly"]["kind"] == "nonfinite_grad"
    assert [r["overflow"] for r in ours] == [r["overflow"] for r in theirs]
    assert [r["loss_scale"] for r in ours] == [r["loss_scale"] for r in theirs]
    for p, j in zip(ours, theirs):
        assert [c > 0 for c in p["nonfinite_per_subtree"]] == \
            [c > 0 for c in j["nonfinite_per_subtree"]]
        assert (p["anomaly"] or {}).get("subtree") == (j["anomaly"] or {}).get("subtree")
    assert [e["kind"] for e in p_eng._numerics.journal.events] == \
        [e["kind"] for e in j_eng._numerics.journal.events]


def test_manual_trigger_bundle_reads_back(tmp_path):
    cfg = _numerics_cfg(str(tmp_path / "dumps"))
    cfg["telemetry"] = {"enabled": True, "output_path": str(tmp_path), "hbm": {"enabled": True}}
    eng = _port_engine(cfg)
    _records(eng)
    path = eng._numerics.recorder.trigger("manual", {"why": "test"})
    bundle = pn.scan_dump_dir(str(tmp_path / "dumps"))
    assert path and bundle["reason"] == "manual" and len(bundle["steps"]) == STEPS
    assert bundle["hbm"]["classes"]["params"] > 0
    assert "allocator" not in bundle["hbm"]       # no card: no allocator to read
    eng.telemetry.close()


# ------------------------------------------------------------------ dp = 2
def _audit_worker(rank, port, params, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        out = {}
        for stage, bf16 in ((0, False), (2, True)):
            tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0),
                           device="cpu")
            ps = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
            cfg = _config("AdamW", stage, gas=1, micro=1, dp=2)
            cfg["bf16"] = {"enabled": bf16}
            cfg["numerics"] = {"enabled": True, "audit_interval": 2,
                               "dump_dir": os.path.join(out_dir, f"d{rank}")}
            eng, _, _, _ = deepspeed_tpu_torch.initialize(
                model=tm, model_parameters=ps, device="cpu", dist_init_required=False,
                config_params=cfg)
            records = []
            for step, (tokens, labels) in enumerate(_batches(4, micro=1)):
                if stage == 0 and step == 2 and rank == 1:
                    with torch.no_grad():   # one bit of one element of rank 1's wpe master
                        w = eng.master_params["wpe"].view(torch.int32)
                        w.view(-1)[5] ^= 1
                loss = eng(tokens, labels)
                eng.backward(loss)
                eng.step()
                records.append(eng._numerics.last_record)
            out[stage] = {"desync": eng._numerics.desync,
                          "audit_runs": eng._numerics.audit_runs,
                          "gss": [r["grad_norm_per_subtree"] for r in records],
                          "norm": [r["grad_norm"] for r in records]}
            if eng._numerics.desync is not None:
                eng._numerics.desync = dict(eng._numerics.desync)
        torch.save(out, os.path.join(out_dir, f"audit_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_desync_audit_and_sentinel_at_dp2_over_gloo():
    params = _port_params()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_audit_worker, args=(port, params, out_dir), nprocs=2,
                           start_method="spawn", join=True)
        res = [torch.load(os.path.join(out_dir, f"audit_{r}.pt")) for r in (0, 1)]
    for r in res:
        # steps 2 and 4 audit; the flip lands before step 3, the audit at 4 names it
        assert r[0]["audit_runs"] == 2
        assert r[0]["desync"]["step"] == 4 and r[0]["desync"]["subtree"] == "params/wpe"
        assert r[0]["desync"]["diverging_replicas"] == [1]
        assert r[2]["desync"] is None and r[2]["audit_runs"] == 2
    # ZeRO-2: the sharded leaves' squares summed over the ranks — every rank
    # holds the same per-subtree values, whose squares sum to the norm squared
    assert res[0][2]["gss"] == res[1][2]["gss"]
    for gss, norm in zip(res[0][2]["gss"], res[0][2]["norm"]):
        np.testing.assert_allclose(sum(g * g for g in gss), norm * norm, rtol=1e-5)
