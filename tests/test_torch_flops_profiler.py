"""The PyTorch port's flop and byte count (``deepspeed_tpu_torch/utils/
flops_profiler.py``), its kernel ops' formulas, the roofline
(``utils/roofline.py``) and ``DeepSpeedEngine.flops_profile``, on the CPU.

- ``roofline``, the floor functions and ``resolve_spec`` against the JAX
  module's arithmetic (exactly, on the same spec); the H100 row holds the
  data sheet's figures; ``detect_chip`` without a card is ``cpu-test``.
- Each kernel op, run on meta tensors under the flop counter, counts its
  formula, and the formula equals the flop counter's count of the kernel's
  plain version on CPU tensors: the flash forward, the fused block (both
  designs' launch pairs), block-sparse over its active blocks (a dense
  layout equals the dense plain version; a sparse one its share; under
  ``causal`` the blocks above the diagonal are left out). The flash and
  block-sparse backward follow torch's SDPA-backward convention (five
  products, ``sdpa_backward_flop_count``) where the plain version's
  autograd runs four.
- A matrix product counts exactly 2MNK flops and (MK + KN + MN) elements of
  bytes; a view moves none; ``profile`` on meta tensors and on CPU tensors
  (temp bytes not measured off the card).
- ``gpt2_train_flops`` equals the telemetry session's count of a tiny GPT-2
  engine's step, without remat and under "dots" (the plain attention path;
  the formula the card's run states beforehand is the same one with the
  kernel ops); ``flops_profile`` of that engine reports the step's flops
  and leaves the next step's loss and master bit for bit as without it.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, sdpa_backward_flop_count

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops import block_sparse_attention as bs
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_block as fb
from deepspeed_tpu_torch.utils import flops_profiler as fp
from deepspeed_tpu_torch.utils import roofline as prf

B, H, T, D = 2, 3, 64, 16


def _count(fn, *args):
    fp.register_kernel_formulas()
    c = FlopCounterMode(display=False)
    with c:
        fn(*args)
    return c.get_total_flops()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cpu(*shape, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).requires_grad_(grad)


# ------------------------------------------------------------------ roofline
def test_roofline_equals_jax():
    from deepspeed_tpu.utils import roofline as jrf
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, ei, ed, m = (float(x) for x in rng.uniform(0, 1e13, size=5))
        spec_p = prf.resolve_spec("cpu-test", 0, rng.uniform(100, 900), 0, 0)
        spec_j = jrf.resolve_spec("cpu-test", 0, spec_p.hbm_gbps, 0, 0)
        assert spec_p.to_dict() == spec_j.to_dict()
        assert prf.roofline(f, b, ei / 1e12, ed / 1e12, spec_p, measured_seconds=m / 1e12) \
            == jrf.roofline(f, b, ei / 1e12, ed / 1e12, spec_j, measured_seconds=m / 1e12)
        assert prf.comm_seconds(b, "dcn", spec_p) == jrf.comm_seconds(b, "dcn", spec_j)
    assert prf.CHIP_SPECS["cpu-test"].to_dict() == jrf.CHIP_SPECS["cpu-test"].to_dict()


def test_h100_row_and_detection():
    h = prf.resolve_spec("h100-sxm")
    assert (h.peak_tflops, h.hbm_gbps, h.ici_gbps, h.dcn_gbps) == (989.0, 3350.0, 450.0, 50.0)
    assert prf.resolve_spec("h100-sxm", peak_tflops=500.0).peak_tflops == 500.0
    assert set(prf.CHIP_SPECS) == {"h100-sxm", "cpu-test"}
    assert prf.detect_chip() == "cpu-test"
    with pytest.raises(ValueError, match="unknown chip"):
        prf.resolve_spec("tpu-v5e")


# ------------------------------------------------------------------ kernels
def test_flash_forward_formula_equals_plain_version():
    want = 4 * B * H * T * T * D
    got = _count(fa.FLASH_FWD_OP, _meta(B, H, T, D), _meta(B, H, T, D), _meta(B, H, T, D),
                 None, True, 0.25, 0.0, 0, 0, 0)
    q, k, v = (_cpu(B, H, T, D, seed=s) for s in range(3))
    plain = _count(fa.flash_attention_reference, q, k, v, True, 0.25)
    assert got == plain == want == fp.KERNEL_FLOPS["flash_fwd"]((B, H, T, D), (B, H, T, D))


def test_flash_backward_follows_the_sdpa_convention():
    m = [_meta(B, H, T, D) for _ in range(4)]
    lse = _meta(B, H, T, dtype=torch.float32)
    args = (*m, lse, lse, None, True, 0.25, 0.0, 0, 0, 0)
    dq = _count(torch.ops.deepspeed_tpu_torch.flash_bwd_dq, *args)
    dkv = _count(torch.ops.deepspeed_tpu_torch.flash_bwd_dkv, *args)
    shape = (B, H, T, D)
    assert dq + dkv == sdpa_backward_flop_count(shape, shape, shape, shape)
    assert (dq, dkv) == (2 * B * H * T * T * D, 8 * B * H * T * T * D)
    # the plain version's autograd: four products (no score recompute)
    q, k, v = (_cpu(B, H, T, D, seed=s, grad=True) for s in range(3))
    out, _ = fa.flash_attention_reference(q, k, v, True, 0.25)
    g = torch.randn_like(out)
    assert _count(lambda: torch.autograd.grad(out, (q, k, v), g)) == 4 * (dq + dkv) // 5


@pytest.mark.parametrize("kind", ["dense", "sparse", "sparse_causal"])
def test_block_sparse_formula_counts_active_blocks(kind):
    block, nb = 16, T // 16
    rng = np.random.default_rng(3)
    layout = (np.ones((H, nb, nb), np.int64) if kind == "dense"
              else (rng.random((H, nb, nb)) < 0.5).astype(np.int64))
    causal = kind == "sparse_causal"
    counts, cols, _, _ = bs.build_luts(layout)
    active = bs.active_blocks(counts, cols, nb, causal)
    want_active = int(sum((layout[h, i, j] != 0) and (not causal or j <= i)
                          for h in range(H) for i in range(nb) for j in range(nb)))
    assert active == want_active
    q = _meta(B, H, T, D)
    fwd = _count(torch.ops.deepspeed_tpu_torch.bs_fwd, q, q, q, 0, causal, 0.25, block,
                 active)
    lse = _meta(B, H, T, dtype=torch.float32)
    bwd_args = (q, q, q, q, lse, lse, 0, causal, 0.25, block, active)
    bwd = (_count(torch.ops.deepspeed_tpu_torch.bs_bwd_dq, *bwd_args)
           + _count(torch.ops.deepspeed_tpu_torch.bs_bwd_dkv, *bwd_args))
    assert fwd == 4 * B * active * block * block * D
    assert bwd == 10 * B * active * block * block * D
    # the plain version computes the dense product; the kernels its active share
    qc, kc, vc = (_cpu(B, H, T, D, seed=s) for s in range(3))
    plain = _count(bs.dense_blocksparse_attention, qc, kc, vc, layout, block, False)
    assert fwd * (H * nb * nb) == plain * active


@pytest.mark.parametrize("tensor_cores", [True, False])
def test_fused_block_formula_equals_plain_version(tensor_cores):
    Bf, Tf, E, Hf = 2, 32, 64, 4
    x = _meta(Bf, Tf, E)
    f32 = dict(dtype=torch.float32)
    ln, bqkv, bp = _meta(E, **f32), _meta(3 * E, **f32), _meta(E, **f32)
    wq, wp = _meta(E, 3 * E), _meta(E, E)
    ops = torch.ops.deepspeed_tpu_torch
    if tensor_cores:
        ws = _meta(3, Bf, Hf, Tf, E // Hf)
        got = (_count(ops.fused_block_qkv_tc, x, ln, ln, wq, bqkv, Hf, 1e-5)
               + _count(ops.fused_block_attn_tc, x, ws, wp, bp, Hf, True, 0.25))
    else:
        ws = _meta(2, Bf, Tf, E)
        got = (_count(ops.fused_block_kv, x, ln, ln, wq, bqkv, 1e-5)
               + _count(ops.fused_block_q, x, ws, ln, ln, wq, bqkv, wp, bp, Hf, True, 0.25,
                        1e-5))
    xs = [_cpu(*s, seed=i) for i, s in enumerate(
        ((Bf, Tf, E), (E,), (E,), (E, 3 * E), (3 * E,), (E, E), (E,)))]
    plain = _count(fb.fused_block_plain, *xs, Hf, True, None, 1e-5)
    assert got == plain == 2 * Bf * Tf * E * 4 * E + 4 * Bf * Hf * Tf * Tf * (E // Hf)


# ------------------------------------------------------------------ profile
def test_matmul_flops_and_bytes_exact():
    M, K, N = 48, 32, 80
    for make in (_meta, lambda *s: _cpu(*s).to(torch.bfloat16)):
        a, b = make(M, K), make(K, N)
        rep = fp.profile(torch.mm, a, b, peak_tflops=1.0)
        assert rep["flops"] == 2 * M * N * K
        assert rep["bytes_accessed"] == (M * K + K * N + M * N) * 2
        assert rep["argument_bytes"] == (M * K + K * N) * 2
        assert rep["output_bytes"] == M * N * 2
        assert rep["temp_bytes"] is None                 # off the card: not measured
        assert rep["optimal_seconds"] == 2 * M * N * K / 1e12
    view = fp.profile(lambda t: t.view(-1).t(), _meta(4, 4))
    assert view["bytes_accessed"] == 0 and view["flops"] == 0
    assert "not measured" in fp.format_report(rep)
    assert fp.mfu({"flops": 2e12}, 2.0, 1.0) == 1.0


DIMS = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4)


def _engine(remat, telemetry=True):
    cfg = GPT2Config(**DIMS, remat=bool(remat), remat_policy=remat or "dots",
                     use_flash_attention=True, loss_chunk=8, compute_dtype=torch.float32)
    m = GPT2Model(cfg, device="cpu")
    m.init(torch.Generator().manual_seed(0))
    config = {"train_batch_size": 2, "steps_per_print": 1000, "bf16": {"enabled": False},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0}
    if telemetry:
        config["telemetry"] = {"enabled": True, "peak_tflops": 1.0}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=m, config_params=config, device="cpu")
    return eng


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, DIMS["vocab_size"], size=(2, 32)).astype(np.int64))
    return tok, torch.roll(tok, -1, 1)


def _step(eng, batch):
    loss = eng(*batch)
    eng.backward(loss)
    eng.step()
    return loss.detach()


@pytest.mark.parametrize("remat", [None, "dots"])
def test_gpt2_train_flops_equals_the_session_count(remat):
    eng = _engine(remat)
    _step(eng, _batch())
    recs = eng.telemetry.watchdog.records
    counted = sum(next(iter(recs[n].values())).flops for n in ("forward", "backward"))
    want = fp.gpt2_train_flops(DIMS["n_embd"], DIMS["n_layer"], DIMS["n_head"],
                               DIMS["vocab_size"], 32, 2, remat=remat or False, flash=False)
    assert counted == want
    assert fp.gpt2_train_flops(1600, 48, 25, 50304, 1024, 8, remat="dots") == 89348741529600
    eng.telemetry.close()


def test_flops_profile_reports_and_changes_nothing():
    a, b = _engine(None, telemetry=False), _engine(None, telemetry=False)
    batch = _batch()
    _step(a, batch)
    _step(b, batch)
    rep = a.flops_profile(*_batch(1), peak_tflops=1.0)
    want = fp.gpt2_train_flops(DIMS["n_embd"], DIMS["n_layer"], DIMS["n_head"],
                               DIMS["vocab_size"], 32, 2, flash=False)
    assert rep["flops"] == want == rep["program_flops"]["loss_and_grad"]
    assert rep["programs"] == ["loss_and_grad", "apply_update"]
    assert rep["bytes_accessed"] > rep["argument_bytes"] > 0
    assert rep["params"] == sum(p.numel() for p in a.module.parameters())
    assert all(p.grad is None for p in a.module.parameters())
    la, lb = _step(a, batch), _step(b, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(a._master, b._master))
    assert "flops" in fp.format_report(rep, "step")
