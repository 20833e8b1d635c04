#!/usr/bin/env python3
"""Where the time of one paged-decode launch goes, CTA by CTA, on a CUDA card.

    python3 scripts/paged_decode_timeline.py

Builds a scratch copy of ``deepspeed_tpu_torch/csrc/paged_decode.cu`` into
``build/timeline/`` in which consumer warp 1, lane 0 of every CTA of the
cluster design reads ``%globaltimer`` at six points: entry; after the setup
barrier (page ids read, q loaded); after its first unit's data arrived; after
its last unit; after the first cluster barrier (all splits done); at exit.
Then it launches that copy at GPT-2 1.5B's serving shapes (bf16, 48 layers,
25 heads of 64, pages of 16, 8 slots of up to 64 pages, random pools from
seed 0) with the serving mix of lengths and with every slot at 1024, and
prints, for the CTAs with the most units (the critical path) and over all
CTAs, each phase in microseconds, with the device time of 48 launches
replayed from a CUDA graph beside the uninstrumented kernel's. The timer
reads cost a few instructions a CTA. Needs nvcc and one card; the product's
build and kernel are untouched.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops import _build, paged_attention as pa  # noqa: E402

LENGTHS = {"mixed": [1, 17, 300, 1024, 64, 511, 777, 1000], "all 1024": [1024] * 8}
NL, NB, BS, NH, HD, S, MB = 48, 513, 16, 25, 64, 8, 64
POINTS = ("entry", "setup", "first data", "last unit", "cluster barrier", "exit")
STAMP = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tl_t[{}]));'


def instrumented_source() -> str:
    """The kernel source with the timer reads; every anchor must occur once."""
    src = (_build.CSRC / "paged_decode.cu").read_text()
    edits = [
        ("namespace {\n",
         "namespace {\n__device__ long long* g_timeline;\n", 0),
        ("int CH, int L, float qscale) {\n",
         "int CH, int L, float qscale) {\n  long long tl_t[6] = {0, 0, 0, 0, 0, 0};\n  "
         + STAMP.format(0) + "\n", 0),
        ("  __syncthreads();                        // barriers initialised, page ids in\n",
         None, 1),
        ("      tc::mbar_wait(&full[st], (j / kStages) & 1);\n", "j == 0", 2),
        ("    // The lanes' states into the warp's: rescale to the warp's max, then sum\n",
         None, 3),
        ("  cluster.sync();\n  const int half = D / 2;\n", None, 4),
        ("  cluster.sync();                         // peers may still read this CTA\n}",
         None, 5),
    ]
    for anchor, how, point in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in paged_decode.cu: {anchor!r}")
        if point == 0:
            src = src.replace(anchor, how)
        elif how == "j == 0":
            src = src.replace(anchor, anchor + "      if (j == 0) " + STAMP.format(2) + "\n")
        elif point == 1:              # a CTA with no unit: first data = setup
            src = src.replace(anchor, anchor + "  " + STAMP.format(1) + "\n  tl_t[2] = tl_t[1];\n")
        elif point == 5:
            src = src.replace(anchor, anchor[:-1] + "  " + STAMP.format(5) + "\n"
                              "  if (threadIdx.x == 32) {\n"
                              "    unsigned smid;\n"
                              "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
                              "    long long* p = g_timeline + 8LL * ((blockIdx.z * gridDim.y + "
                              "blockIdx.y) * gridDim.x + blockIdx.x);\n"
                              "    for (int i = 0; i < 6; ++i) p[i] = tl_t[i];\n"
                              "    p[6] = n_units;\n    p[7] = smid;\n  }\n}")
        else:
            src = src.replace(anchor, anchor + "  " + STAMP.format(point) + "\n")
    return src + (
        '\nextern "C" int paged_decode_timeline(long long* buf) {\n'
        "  return static_cast<int>(cudaMemcpyToSymbol(g_timeline, &buf, sizeof(buf)));\n}\n")


def build():
    out = ROOT / "build" / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    (out / "paged_decode_timeline.cu").write_text(instrumented_source())
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
           str(out / "libpaged_decode_timeline.so"), str(out / "paged_decode_timeline.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out / "libpaged_decode_timeline.so"))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_cluster.argtypes = [vp] * 6 + [i32] * 11 + [f32, i32, vp]
    lib.paged_decode_pool_map.argtypes = [vp, vp, i32, ctypes.c_longlong,
                                          ctypes.c_longlong] + [i32] * 5
    lib.paged_decode_timeline.argtypes = [vp]
    for fn in (lib.paged_decode_cluster, lib.paged_decode_pool_map, lib.paged_decode_timeline):
        fn.restype = ctypes.c_int
    return lib


def graph_ms(fn, replays=20):
    """Mean device time of fn(0) .. fn(NL - 1) captured as a CUDA graph."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for li in range(NL):
            fn(li)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * NL)


def main():
    if not torch.cuda.is_available():
        sys.exit("paged_decode_timeline: needs a CUDA device")
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kp = torch.randn((NL, NB, BS, NH, HD), generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn((NL, NB, BS, NH, HD), generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((S, NH, 1, HD), generator=gen, device="cuda", dtype=torch.bfloat16)
    tables = (torch.randperm(NB - 1, generator=gen, device="cuda") + 1)[:S * MB]
    tables = tables.reshape(S, MB).to(torch.int32).contiguous()
    plan = pa.cluster_plan(NH, HD, BS, MB, torch.bfloat16)
    maps = [pa._pool_map(lib, pool, plan) for pool in (kp, vp)]
    n_cta = plan.splits * (NH // plan.heads_per_group) * S
    stamps = torch.zeros((n_cta, 8), dtype=torch.int64, device="cuda")
    if lib.paged_decode_timeline(stamps.data_ptr()):
        raise RuntimeError("paged_decode_timeline: cudaMemcpyToSymbol failed")
    out = torch.empty_like(q)
    print(torch.cuda.get_device_name(0), flush=True)
    for mix, lens in LENGTHS.items():
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def launch(li):
            err = lib.paged_decode_cluster(
                q.data_ptr(), maps[0], maps[1], out.data_ptr(), tables.data_ptr(), ln.data_ptr(),
                S, NH, HD, MB, BS, li, plan.heads_per_group, plan.tokens_per_box,
                plan.boxes_per_page, plan.splits, plan.lanes, HD ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"paged_decode_cluster: cudaError {err}")

        for li in range(8):           # warm; the last launch's stamps are read
            launch(li)
        torch.cuda.synchronize()
        t = stamps.cpu().numpy()
        t0 = t[:, 0].min()
        units = t[:, 6]
        longest = units == units.max()
        phases = {f"{POINTS[i]} -> {POINTS[i + 1]}": (t[:, i + 1] - t[:, i]) / 1e3
                  for i in range(5)}
        res = {"lengths": mix, "ctas": int(n_cta), "sms": int(len(set(t[:, 7].tolist()))),
               "span_us": float((t[:, 5].max() - t0) / 1e3),
               "start_spread_us": float((t[:, 0].max() - t0) / 1e3),
               "longest_units": int(units.max()), "longest_ctas": int(longest.sum()),
               "longest_us": {k: float(v[longest].mean()) for k, v in phases.items()},
               "longest_per_unit_us": float(
                   (phases["first data -> last unit"][longest] / max(units.max() - 1, 1)).mean()),
               "median_all_us": {k: float(np.median(v)) for k, v in phases.items()},
               "instrumented_ms": graph_ms(launch),
               "kernel_ms": graph_ms(lambda li: pa.paged_decode_attention(
                   q, kp, vp, li, tables, ln, block_size=BS))}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
