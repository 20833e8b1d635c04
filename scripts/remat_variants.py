#!/usr/bin/env python3
"""GPT-2 1.5B at the published config's widths and batch (``bench.py:391-420``:
48 x 1600, 25 heads, vocab 50304, T = 1024, batch 8, flash attention,
``loss_chunk`` 128, bf16 parameters) through one forward + backward under
four ways of keeping activations, on a CUDA card.

    python3 scripts/remat_variants.py [--reps 4]

Variants: ``none`` (no remat), ``full`` (remat with no policy: the block
inputs only, no selective-checkpoint dispatch modes), ``dots`` (the port's
remat "dots": the products kept through torch's selective-checkpoint
contexts, the block's last product announced and recomputed) and
``dots-keep-last`` (the same with the ``ds_dot:mlp_proj`` announcement
suppressed, so torch keeps the MLP's second product as well: what its
contexts keep without the announcement). Every variant runs in turns,
``reps`` rounds in order and in reverse, on the same seeded tokens and
weights. For each it prints the loss (equal across variants up to the
recompute's summation order), the peak of ``max_memory_allocated`` above
the weights, the host time until ``backward`` returns (the enqueue; no
sync inside the model's flash path), the wall after a sync, and the device
span between CUDA events at the two ends, as medians. Needs one card.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.models import gpt2  # noqa: E402

WIDTHS = dict(vocab_size=50304, n_positions=1024, n_embd=1600, n_layer=48, n_head=25,
              use_flash_attention=True, loss_chunk=128)
BATCH = 8
VARIANTS = {"none": dict(remat=False), "full": dict(remat=True, remat_policy=None),
            "dots": dict(remat=True, remat_policy="dots"),
            "dots-keep-last": dict(remat=True, remat_policy="dots")}


def _suppress_last(name_fn):
    def named(x, name):
        return x if name == "ds_dot:mlp_proj" else name_fn(x, name)
    return named


def run(model, tokens, labels, variant):
    import dataclasses
    model.config = dataclasses.replace(model.config, **VARIANTS[variant])
    name_fn = gpt2.checkpoint_name
    if variant == "dots-keep-last":
        gpt2.checkpoint_name = _suppress_last(name_fn)
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss = model(tokens, labels)
        loss.backward()
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        gpt2.checkpoint_name = name_fn
    model.zero_grad(set_to_none=True)
    return {"loss": loss.item(), "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "enqueue_ms": (t1 - t0) * 1e3, "wall_ms": (t2 - t0) * 1e3,
            "device_ms": start.elapsed_time(end)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = torch.cuda.get_device_name(0)
    model = gpt2.GPT2Model(gpt2.GPT2Config(**WIDTHS))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    model.to(torch.bfloat16)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, WIDTHS["vocab_size"], size=(BATCH, WIDTHS["n_positions"]))
    tokens = torch.from_numpy(tokens).cuda()
    labels = torch.roll(tokens, -1, 1)
    for v in VARIANTS:          # warm-up: kernel builds, cuBLAS plans, the allocator
        run(model, tokens, labels, v)
    order = list(VARIANTS)
    rows = {v: [] for v in VARIANTS}
    for r in range(args.reps):
        for v in (order if r % 2 == 0 else order[::-1]):
            rows[v].append(run(model, tokens, labels, v))
    out = {"card": card, "batch": BATCH, "reps": args.reps}
    for v, rs in rows.items():
        out[v] = {k: statistics.median(r[k] for r in rs) for k in rs[0]}
        out[v]["loss"] = rs[0]["loss"]
        out[v]["enqueue_ms_all"] = [r["enqueue_ms"] for r in rs]
        out[v]["wall_ms_all"] = [r["wall_ms"] for r in rs]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
