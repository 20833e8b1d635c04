#!/usr/bin/env python3
"""What the dispatcher op around the paged-decode kernel costs the host.

    python3 scripts/paged_decode_dispatch.py

``paged_decode_attention`` launches its kernel through the dispatcher op
``deepspeed_tpu_torch::paged_decode``. This times, at GPT-2 1.5B's serving
shapes (bf16, 25 heads of 64, pages of 16, 8 slots of up to 64 pages, the
serving mix of lengths, random pools from seed 0), the host's wall per call
of the wrapper (through the op) against the wrapper's body before the op
existed (its checks, the shape rule and ``_launch``, called directly), in
turns (op, direct, direct, op), each turn 48 x 50 calls (one decode step's
layers, fifty times) ended by a synchronize; and the device time of the
same 48 launches replayed from a CUDA graph through each path, which the op
should not change. Prints one JSON line. Needs nvcc and one card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LAYERS, STEPS = 48, 50
S, NH, HD, BS, MB, NB = 8, 25, 64, 16, 64, 513
LENGTHS = [1, 17, 300, 1024, 64, 511, 777, 1000]


def main():
    if not torch.cuda.is_available():
        print("paged_decode_dispatch: no CUDA device", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import paged_attention as pa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    kp = torch.randn(LAYERS, NB, BS, NH, HD, generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn(LAYERS, NB, BS, NH, HD, generator=g, device="cuda").to(torch.bfloat16)
    q = torch.randn(S, NH, 1, HD, generator=g, device="cuda").to(torch.bfloat16)
    tables = (torch.randperm(NB - 1, generator=g, device="cuda")[:S * MB] + 1
              ).to(torch.int32).reshape(S, MB)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")

    def via_op(li):
        return pa.paged_decode_attention(q, kp, vp, li, tables, lengths, block_size=BS)

    def direct(li):
        # the wrapper's body before the op: the checks, the rule, the launch
        pa._check(q, kp, vp, li, tables, lengths, BS)
        return pa._launch(q, kp, vp, li, tables, lengths, BS,
                          pa.cluster_design(q.dtype, q.shape[3]))

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            for li in range(LAYERS):
                fn(li)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (STEPS * LAYERS) * 1e6

    def graph_us(fn, replays=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for li in range(LAYERS):
                fn(li)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for li in range(LAYERS):
                fn(li)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * LAYERS) * 1e3

    for fn in (via_op, direct):           # builds, the TMA maps, warm-up
        host_us(fn)
    turns = {"op": [], "direct": []}
    for name in ("op", "direct", "direct", "op"):
        turns[name].append(host_us(via_op if name == "op" else direct))
    same = torch.equal(via_op(0), direct(0))
    out = {"card": card, "host_us_a_call": {k: sum(v) / len(v) for k, v in turns.items()},
           "host_us_turns": turns,
           "device_us_a_launch_graphed": {"op": graph_us(via_op), "direct": graph_us(direct)},
           "op_output_equals_direct": same, "calls_a_turn": STEPS * LAYERS}
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
