"""The port's host-tier CPU Adam (ZeRO-Offload) against the JAX package's.

The native kernel (``deepspeed_tpu_torch/csrc/cpu_adam.cpp``, built by g++
at first use) is held bit for bit against the JAX package's
``DeepSpeedCPUAdam`` on the same numpy inputs: the same source built with the
same flags gives the same bits. The port's added entries (bf16 / fp16 grads,
fp16 output) compute the values of the fp32-converted grads, and the bf16
and fp16 outputs equal round-to-nearest-even casts of the master. The plain
version agrees within 1e-6 relative (the compiler may fuse a multiply-add
that torch rounds twice). The pipeline tests are the counterparts of
``tests/unit/test_offload_pipeline.py``: pipelined and serial walks
bit-equal, the chunk cap's splits, the autotune and the timing schema. The
``cuda``-marked test holds the stream pipeline on the card against the
serial walk and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import cpu_adam as ca
from deepspeed_tpu_torch.runtime.zero.sharding import chunk_spans

HYPER = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1)


def _params(rng):
    # keys in sorted order: jax.tree_util walks a dict in key order, torch's
    # pytree in insertion order, and the flat buffers follow the walk
    return {"b": rng.normal(size=(129,)).astype(np.float32),
            "w": rng.normal(size=(33, 17)).astype(np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax_opt(params, **kw):
    from deepspeed_tpu.ops.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
    opt = JaxCPUAdam(params, **kw)
    assert opt._lib is not None, "the JAX package's native build failed"
    return opt


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adamw", [True, False])
def test_native_step_bit_identical_to_jax(adamw, bias_correction):
    rng = np.random.default_rng(0)
    params = _params(rng)
    theirs = _jax_opt(params, adamw=adamw, bias_correction=bias_correction)
    mine = ca.DeepSpeedCPUAdam(_torch_tree(params), adamw=adamw,
                               bias_correction=bias_correction)
    for step in range(1, 5):
        g = _params(rng)
        theirs.step(theirs.flatten_grads(g), step=step, grad_scale=0.5, **HYPER)
        mine.step(mine.flatten_grads(_torch_tree(g)), step=step, grad_scale=0.5, **HYPER)
    for a, b in ((mine.fp32, theirs.fp32), (mine.exp_avg, theirs.exp_avg),
                 (mine.exp_avg_sq, theirs.exp_avg_sq)):
        np.testing.assert_array_equal(a.numpy(), b)
    got = mine.params_tree()
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), theirs.params_tree()[k])


def _grads_as(g32, dtype):
    """(the grads in ``dtype``, their exact float32 values)."""
    g = torch.from_numpy(g32).to(dtype)
    return g, g.float().numpy()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_copy_entries_match_jax(grad_dtype, out_dtype):
    """Each ds_adam_step_<grad>_copy_<out> entry: the master, moments and
    copy of JAX's fused step on the float32 values of the grads; the copy is
    the round-to-nearest-even cast (JAX's ml_dtypes bf16, torch's fp16)."""
    import ml_dtypes
    rng = np.random.default_rng(1)
    params = _params(rng)
    theirs = _jax_opt(params)
    mine = ca.DeepSpeedCPUAdam(_torch_tree(params))
    out = torch.empty(mine.numel, dtype=out_dtype)
    before = ca.adam_step_native.launches
    for step in range(1, 4):
        g, g32 = _grads_as(rng.normal(size=mine.numel).astype(np.float32) * 3, grad_dtype)
        bf = theirs.step_and_cast_bf16(g32, step=step, grad_scale=0.25, **HYPER)
        ca.adam_step_native(mine.fp32, g, mine.exp_avg, mine.exp_avg_sq, out, step=step,
                            grad_scale=0.25, **HYPER)
    assert ca.adam_step_native.launches == before + 3
    np.testing.assert_array_equal(mine.fp32.numpy(), theirs.fp32)
    np.testing.assert_array_equal(mine.exp_avg_sq.numpy(), theirs.exp_avg_sq)
    if out_dtype == torch.bfloat16:
        np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                      np.asarray(bf).view(np.int16))
        np.testing.assert_array_equal(
            out.view(torch.int16).numpy(),
            theirs.fp32.astype(ml_dtypes.bfloat16).view(np.int16))
    else:
        np.testing.assert_array_equal(out.numpy(), theirs.fp32.astype(np.float16))


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adamw", [True, False])
def test_plain_version_matches_native(adamw, bias_correction):
    rng = np.random.default_rng(2)
    n = 4099
    state = [torch.from_numpy(rng.normal(size=n).astype(np.float32)),
             torch.zeros(n), torch.zeros(n)]
    plain = [t.clone() for t in state]
    out_n, out_p = torch.empty(n, dtype=torch.bfloat16), torch.empty(n, dtype=torch.bfloat16)
    kw = dict(grad_scale=0.5, adamw=adamw, bias_correction=bias_correction, **HYPER)
    for step in range(1, 6):
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(torch.bfloat16)
        ca.adam_step_native(*state[:1], g, *state[1:], out_n, step=step, **kw)
        ca.cpu_adam_plain(*plain[:1], g, *plain[1:], out_p, step=step, **kw)
    for a, b in zip(state, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out_n.float().numpy(), out_p.float().numpy(),
                               rtol=2 ** -8, atol=0)


def test_native_wrapper_checks_and_threads():
    lib = ca.load_cpu_adam()
    assert lib.ds_adam_threads() >= 1
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous CPU tensor"):
        ca.adam_step_native(p, torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8),
                            torch.zeros(8), step=1, **HYPER)   # bf16 grads need a copy
    with pytest.raises(ValueError, match="contiguous CPU tensor"):
        ca.adam_step_native(p, torch.zeros(7), torch.zeros(8), torch.zeros(8), step=1,
                            **HYPER)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises at first use; nothing falls back."""
    (tmp_path / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build cpu_adam.cpp"):
        ca.load_cpu_adam()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ca.DeepSpeedCPUAdam({"w": torch.zeros(4)})


def test_host_build_keyed_on_source_and_cpu(monkeypatch):
    first = _build.host_target("cpu_adam")
    monkeypatch.setattr(_build, "_cpu_flags", lambda: b"x86_64 flags : sse2")
    assert _build.host_target("cpu_adam") != first


@pytest.mark.parametrize("cap", [None, 0, 1, 3, 4, 7, 10, 16, 1000])
def test_chunk_spans_matches_jax(cap):
    from deepspeed_tpu.runtime.zero.sharding import chunk_spans as jax_chunk_spans
    for total in (0, 1, 4, 8, 10, 17, 64, 1001):
        assert chunk_spans(total, cap) == jax_chunk_spans(total, cap), (total, cap)


# ------------------------------------------------------------------ the pipeline
# counterparts of tests/unit/test_offload_pipeline.py:89,156,178,218,245

def _leaves(rng, n_leaves=8, size=2000):
    return {f"p{i}": rng.normal(size=(size,)).astype(np.float32) for i in range(n_leaves)}


def _run_steps(opt, grads_seq, **hyper):
    out = None
    for step, g in enumerate(grads_seq, start=1):
        out = opt.step_regions(opt.begin_grad_fetch(_torch_tree(g)), step=step, **hyper)
    return out


def test_pipelined_step_bit_equal_to_serial():
    """Chunking and overlap change no bit: Adam is elementwise. The pipelined
    walk's bf16 copy is the cast of the master it leaves."""
    rng = np.random.default_rng(0)
    params = _leaves(rng, n_leaves=6, size=3001)   # odd size: chunks don't divide evenly
    grads_seq = [_leaves(rng, n_leaves=6, size=3001) for _ in range(3)]
    hyper = dict(lr=1e-2, weight_decay=0.01, grad_scale=0.5)
    serial = ca.DeepSpeedCPUAdam(_torch_tree(params), pipeline=False)
    serial.transfer_executor = ca.SerialTransferExecutor()
    piped = ca.DeepSpeedCPUAdam(_torch_tree(params), pipeline=True, pipeline_depth=3,
                                max_region_elements=512)   # ~6 chunks a leaf
    try:
        _run_steps(serial, grads_seq, **hyper)
        out = _run_steps(piped, grads_seq, out_dtype=torch.bfloat16, **hyper)
        for a, b in ((piped.fp32, serial.fp32), (piped.exp_avg, serial.exp_avg),
                     (piped.exp_avg_sq, serial.exp_avg_sq)):
            assert torch.equal(a, b)
        for k, t in piped.params_tree().items():
            assert torch.equal(out[k], t.to(torch.bfloat16)), k
        assert piped.last_step_timing["n_work_items"] == 6 * 6
    finally:
        piped.close()


def test_pipelined_timing_schema():
    rng = np.random.default_rng(2)
    params = _leaves(rng, n_leaves=4, size=900)
    opt = ca.DeepSpeedCPUAdam(_torch_tree(params), max_region_elements=256)
    try:
        opt.step_regions(opt.begin_grad_fetch(_torch_tree(_leaves(rng, 4, 900))), step=1,
                         lr=1e-3)
        t = opt.last_step_timing
    finally:
        opt.close()
    for key in ("fetch_wait", "host_adam", "push", "total", "fetch_busy",
                "push_busy", "pipeline_depth", "region_cap", "n_work_items", "regions"):
        assert key in t, key
    assert t["pipeline_depth"] == 2 and t["region_cap"] == 256
    assert t["n_work_items"] == 4 * -(-900 // 256)
    assert len(t["regions"]) == 4
    for r in t["regions"]:
        assert r["chunks"] == -(-900 // 256) and r["size"] == 900
        assert r["fetch"] >= 0 and r["adam"] > 0 and r["push"] >= 0
    assert t["total"] >= t["host_adam"] > 0


def test_region_cap_splits_and_covers():
    cap = 1024
    rng = np.random.default_rng(3)
    params = {"big": rng.normal(size=(5000,)).astype(np.float32),
              "small": rng.normal(size=(100,)).astype(np.float32)}
    opt = ca.DeepSpeedCPUAdam(_torch_tree(params), max_region_elements=cap)
    try:
        handles = opt.begin_grad_fetch({k: torch.zeros(v.shape) for k, v in params.items()})
        covered = {}
        for it in handles:
            assert it.hi - it.lo <= cap
            covered.setdefault(it.region.leaf, []).append((it.lo, it.hi, it.region.size))
        assert len(covered) == 2
        for spans in covered.values():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == spans[0][2]
            for (_, a_hi, _), (b_lo, _, _) in zip(spans, spans[1:]):
                assert b_lo == a_hi   # contiguous, non-overlapping
        assert len([it for it in handles if it.region.size == 5000]) == -(-5000 // cap)
        opt.step_regions(handles, step=1, lr=1e-3)
    finally:
        opt.close()


def test_autotune_sets_cap_once_and_respects_pin():
    rng = np.random.default_rng(4)
    params = _torch_tree(_leaves(rng, n_leaves=3, size=4000))
    auto = ca.DeepSpeedCPUAdam(params)   # max_region_elements="auto"
    try:
        assert not auto._autotuned and auto.region_cap() == 8 << 20
        auto.step_regions(auto.begin_grad_fetch(params), step=1, lr=1e-3)
        assert auto._autotuned
        assert (1 << 20) <= auto._auto_cap <= (64 << 20)
        cap_after_first = auto._auto_cap
        auto.step_regions(auto.begin_grad_fetch(params), step=2, lr=1e-3)
        assert auto._auto_cap == cap_after_first   # tunes once, not every step
    finally:
        auto.close()
    pinned = ca.DeepSpeedCPUAdam(params, max_region_elements=512)
    try:
        pinned.step_regions(pinned.begin_grad_fetch(params), step=1, lr=1e-3)
        assert not pinned._autotuned and pinned.region_cap() == 512
    finally:
        pinned.close()
    with pytest.raises(ValueError, match="max_region_elements"):
        ca.DeepSpeedCPUAdam(params, max_region_elements=-5)


def test_serial_executor_disables_chunking():
    rng = np.random.default_rng(5)
    params = _torch_tree(_leaves(rng, n_leaves=3, size=3000))
    opt = ca.DeepSpeedCPUAdam(params, pipeline=False, max_region_elements=512)
    assert opt.region_cap() is None   # the cap applies to the pipelined walk only
    handles = opt.begin_grad_fetch(params)
    assert len(handles) == 3
    opt.step_regions(handles, step=1, lr=1e-3)
    assert opt.last_step_timing["pipeline_depth"] == 1
    assert opt.last_step_timing["region_cap"] == 0


def test_skipped_walk_is_drained_and_trees_load():
    """A walk begun and never stepped (an fp16 overflow) leaves the state as
    it was; the next walk steps as if it never began. ``load_trees`` and the
    tree views round-trip."""
    rng = np.random.default_rng(6)
    params = _torch_tree(_leaves(rng, n_leaves=2, size=700))
    a = ca.DeepSpeedCPUAdam(params, max_region_elements=128, pipeline_depth=3)
    b = ca.DeepSpeedCPUAdam(params, max_region_elements=128, pipeline_depth=3)
    g = _torch_tree(_leaves(rng, n_leaves=2, size=700))
    try:
        before = a.fp32.clone()
        a.begin_grad_fetch(g)
        assert torch.equal(a.fp32, before)
        a.step_regions(a.begin_grad_fetch(g), step=1, lr=1e-2)
        b.step_regions(b.begin_grad_fetch(g), step=1, lr=1e-2)
        assert torch.equal(a.fp32, b.fp32)
        new = {k: torch.full_like(v, 0.5) for k, v in params.items()}
        a.load_trees(master_tree=new, exp_avg_tree=new)
        assert all(torch.equal(a.params_tree()[k], new[k]) for k in new)
        assert all(torch.equal(a.exp_avg_tree()[k], new[k]) for k in new)
        assert torch.equal(a.exp_avg_sq, b.exp_avg_sq)
    finally:
        a.close()
        b.close()


@pytest.mark.cuda
def test_cuda_stream_pipeline_bit_equal_to_serial():
    """On the card: bf16 grads in device memory through the pinned rings and
    the two copy streams, against the serial walk over the same grads on the
    host; the device params receive the bf16 cast of the master."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    params = _torch_tree(_leaves(rng, n_leaves=5, size=70001))
    serial = ca.DeepSpeedCPUAdam(params, pipeline=False)
    piped = ca.DeepSpeedCPUAdam(params, pipeline_depth=3, max_region_elements=16384)
    out = {k: torch.empty(v.shape, dtype=torch.bfloat16, device="cuda")
           for k, v in params.items()}
    try:
        for step in range(1, 4):
            g = {k: torch.from_numpy(v).cuda().to(torch.bfloat16)
                 for k, v in _leaves(rng, n_leaves=5, size=70001).items()}
            piped.step_regions(piped.begin_grad_fetch(g), step=step, grad_scale=0.5,
                               out=out, **HYPER)
            serial.step_regions(serial.begin_grad_fetch({k: v.cpu() for k, v in g.items()}),
                                step=step, grad_scale=0.5, out_dtype=torch.bfloat16, **HYPER)
        torch.cuda.synchronize()
        for a, b in ((piped.fp32, serial.fp32), (piped.exp_avg, serial.exp_avg),
                     (piped.exp_avg_sq, serial.exp_avg_sq)):
            assert torch.equal(a, b)
        for k, t in piped.params_tree().items():
            assert torch.equal(out[k].cpu(), t.to(torch.bfloat16)), k
        assert piped.last_step_timing["n_work_items"] == 5 * -(-70001 // 16384)
    finally:
        piped.close()
