#!/usr/bin/env python3
"""The tensor-core block-sparse forward (``bs_fwd_tc``) against variants of
its occupancy and ring depth, on a CUDA card.

    python3 scripts/block_sparse_fwd_variants.py

Builds scratch copies of ``deepspeed_tpu_torch/csrc/block_sparse_attention_tc.cu``
into ``build/variants/``, each with one edit: ``one-cta`` gives the forward
at a 64-wide head one CTA an SM instead of two (its launch bound's minimum
blocks 1), ``three-stages`` deepens the K/V ring from 2 to 3 stages. Then it
launches each copy at the long-sequence path's shape (``[1,16,8192,64]``
bf16, the Variable layout at block 256, causal; inputs rotating over 3 sets
from seed 1), checks that every copy's out and lse equal the product's bit
for bit, and prints each one's registers and spill bytes and its device time
per launch: CUDA-graph replays of 3 launches, every copy timed in turns (in
order, then in reverse, twice). Needs nvcc and one card; the product's build
and kernel are untouched.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import _build  # noqa: E402
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa  # noqa: E402

BOUND = "__launch_bounds__(dq_threads<NWG>(), DP == 64 ? 2 : 1)\nbs_fwd_tc_kernel"
STAGES = "constexpr int kStages = 2;"


def variants(src):
    edits = {"product": src,
             "one-cta": src.replace(BOUND, BOUND.replace("DP == 64 ? 2 : 1", "1")),
             "three-stages": src.replace(STAGES, STAGES.replace("2", "3"))}
    for name, text in edits.items():
        if name != "product" and text == src:
            raise RuntimeError(f"variant {name}: its edit no longer applies to the source")
    return edits


def build_all(edits):
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in edits.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [(cs._demangle(n), r, s) for n, r, s in cs._ptxas_kernels(log) if "bs_fwd" in n]
        print(f"[variants] {name}: (kernel, registers, spill bytes) {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main():
    card = cs.phase_device()
    libs = build_all(variants((_build.CSRC / "block_sparse_attention_tc.cu").read_text()))
    B, H, T, D = cs.BS_SHAPE
    layout = cs.long_sparsity().make_layout(T)
    kw = dict(block=256, causal=True, sm_scale=D ** -0.5)
    luts = bsa.device_luts(layout, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sets = [[torch.randn(cs.BS_SHAPE, generator=gen, device="cuda").bfloat16()
             for _ in range(3)] for _ in range(3)]

    def use(name):     # the wrapper's library, argument types set anew
        _build._LIBS["block_sparse_attention_tc"] = libs[name]
        libs[name].bs_dq_tc.argtypes = None

    outs = {}
    for name in libs:
        use(name)
        outs[name] = bsa.block_sparse_fwd(*sets[0], luts, **kw)
    torch.cuda.synchronize()
    same = {n: all(torch.equal(a, b) for a, b in zip(o, outs["product"]))
            for n, o in outs.items()}
    print(f"[variants] out and lse bit-identical to the product's: {same}", flush=True)
    times = {n: [] for n in libs}
    order = list(libs) + list(reversed(list(libs)))
    for _ in range(2):
        for name in order:
            use(name)
            times[name].append(cs.graph_ms(
                lambda i: bsa.block_sparse_fwd(*sets[i % 3], luts, **kw), 3))
    print(f"[variants] {card}: ms per launch (mean, turns) "
          + json.dumps({n: [statistics.mean(t), t] for n, t in times.items()}), flush=True)
    if not all(same.values()):
        raise AssertionError("a variant computes other bits than the product")


if __name__ == "__main__":
    main()
