#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --probe N    # one offload-capacity probe at N layers
    python3 chip_smoke.py --launched   # the [launcher] phase's child (the runner starts it)

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device — requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them, and the host's CPU model,
   cores and memory;
2. build — compiles every CUDA kernel of the serving and training paths
   from ``csrc/`` (one ``nvcc`` per source, all at once); prints each
   file's registers and spills, and each paged-decode and tensor-core
   fused-block kernel's;
3. kernels — holds the paged-decode kernel's cluster design (each history
   split across a thread-block cluster, pages staged by TMA) against its
   plain PyTorch version on card tensors at GPT-2 1.5B's serving shapes in
   bf16, float16 and float32, checking that each launch ran that design,
   and the first design in bf16; then times both designs (in turns), the
   plain version and SDPA on the pre-gathered view at the serving mix of
   lengths and with every slot at 1024, beside the byte bound of each:
   device times by CUDA events around CUDA-graph replays of the calls
   (layers rotating), and the cluster design's eager loop, which the host's
   enqueue cost bounds;
4. serving — GPT-2 1.5B (48 x 1600, 25 heads, vocab 50304, bf16, random
   weights from seed 0) through ``init_inference`` with the paged-decode
   kernel on, its ``decode_step`` and ``prefill_chunk`` CUDA graphs captured
   once each when the engine is built, over a seeded trace of 10 requests;
   checks that every request finishes, that the kernel ran once per layer
   per decode step (counted through the replays), each time in the cluster
   design, one replay a decode step and a prefill chunk, that the first
   decode step's replay equals the eager program on the same pools bit for
   bit, and that its logits agree with the gather path on the same pools
   (bf16, and float32 pools through the same kernel); the graph pool's
   bytes; the engine's ``memory_manifest()`` against its live tensors, the
   pool model and the allocator; then a short ``torch.profiler`` window for where the time goes
   and the busy share, whose trace must hold as many cluster-design kernels
   as the launch counter moved (48 x the window's decode replays);
   ``[serving-graphs]`` — the same trace on a second engine driven by the
   eager programs: tokens and schedule logs identical, its decode step,
   TTFT, tok/s and busy share beside the graphed engine's;
   ``[serving-memory]`` — the device memory free before and after these two
   phases, and after the cuBLAS workspaces the engines' capture stream kept
   are cleared;
5. flash kernels — the forward, dq and dk/dv kernels against the plain
   version (out, lse, dq, dk, dv) at the training shape, at the published
   config's (batch 8) and at edge cases
   (ragged T, T = 9000, D = 32 and 128, float32, float16, key bias, dropout at
   rates 0.1 and 0.5, global offsets with and without the causal mask, bf16 at
   D = 256) and at the BERT path's shape (non-causal with a key bias); checks
   that each case ran the design the shape rule names (tensor cores for
   bf16/fp16 at D <= 128, else CUDA cores) in all three kernels; times at the
   training shape beside the plain version, SDPA and the CUDA-core design of
   each kernel on the same inputs;
6. training — GPT-2 1.5B (the same widths, ``use_flash_attention``, no remat)
   through ``initialize`` at ZeRO-2 in bf16, micro-batch 4 x 2 accumulation
   steps, for 12 optimizer steps on one seeded batch; checks the first
   micro-batch's loss and per-layer grad norms against the plain attention
   path (bf16 at full depth, float32 at 4 layers), that the losses are finite
   and fall, that each flash kernel ran once per layer per micro-step and on
   the tensor cores each time; then a profiler window of one step;
   published config — GPT-2 1.5B at ``bench.py:391-420`` exactly (remat
   "dots", batch 8 in one micro-step, flash attention, bf16, ZeRO-2 with
   ``zero_allow_untested_optimizer`` and the external-master client pair of
   ``bench.py:354-388``, here ``shard_optimizer``) through ``initialize``
   for 12 steps on ``np.random.default_rng(0)`` tokens; checks 96 / 48 / 48
   flash launches a step on the tensor cores (the recompute replays the
   forward), the loss the same at every step, the client state moving, the
   params unchanged, the loss and per-layer grad norms of batch 8 against
   the plain attention path, and remat against no remat at batch 8 (loss
   and 49 per-layer grad norms); at 4 layers, "dots+attn" launches the forward
   once a layer and ``cpu_checkpointing`` gives the same grads at a lower
   peak; a profiler window; the pair at gas 1 takes the fused step (the
   update at ``forward()``), and a second ``forward()`` before ``step()``
   raises ("rotation") while ``zero_grad()`` drops the pending window;
   then a fused engine and one held to the two-step path, side by side
   for 3 steps: the client state (shard, m1, m2) and the losses bit for
   bit after each step; each step's synchronizing calls are counted
   (``torch.cuda.set_sync_debug_mode("warn")``);
   telemetry — ``[train-telemetry]``: the published config again with the
   ``telemetry`` block on (a 2-step ``torch.profiler`` window, the metric
   catalog, the default alert rules, the goodput ledger, the cluster
   monitor at world 1 with a hang deadline) and the tensorboard monitor's
   JSONL, for 8 steps: the losses bit for bit ``[train-published]``'s, no
   more synchronizing calls a step than without telemetry, the exported
   trace holding as many ``flash_fwd_tc`` kernels as the launch counter
   moved in its window (96 a step), the fused step recorded once by the
   compile watchdog, no alert fired, the ``Train/*`` scalars the JAX engine
   emits; the step ms beside ``[train-published]``'s, the session's MFU
   beside 6N x tokens/s, the goodput classes;
   observatories — ``[train-observatories]``: the published config again
   with the numerics sentinel (depth 1, a desync audit every 4 steps, the
   dump directory a ``tempfile.mkdtemp()``) and ``telemetry.anatomy``
   (the H100's data-sheet roofline), ``telemetry.profile`` (a 2-step
   window) and ``telemetry.hbm`` on, for 8 steps: the losses bit for bit
   and the synchronizing calls a step equal to ``[train-published]``'s;
   the sentinel's per-subtree sums of squares against
   ``[train-published]``'s norm (1e-5), no nonfinite count, two audits at
   world 1 in agreement, a manual trigger's bundle read back with its
   allocator summary; the memory manifest equal to the engine's tensors,
   reconciled with the ZeRO model and under ``memory_allocated``; the
   trace's flash kernels equal to the counters' move in the window and
   the profile reconciled; the anatomy's floor under every measured step;
   the counted flops a step equal to ``gpt2_train_flops`` (the flash
   backward's five products included), stated in the code before the run;
   ``flops_profile`` of the step;
   fp16 loop — ``[fp16-optimizer]``: ``FP16_Optimizer("adamw")`` in a
   custom loop (no ``initialize``) on GPT-2 at the 1.5B widths in fp16, no
   remat, micro-batch 2 x 1024, clip 1.0, from a scale of 2^24 with
   hysteresis 2, 16 steps: a skipped step leaves the master bit for bit,
   the scale follows the scaler's rule, the clean losses are finite and
   falling, 48 / 48 / 48 flash launches a step on the tensor cores; the
   losses within 2e-3 of ``initialize``'s fp16 engine with the same steps
   skipped; step ms, the peak, the journal's events;
   fused step — ``[train-fused]``: the same model and batch with AdamW, no
   clipping, WarmupLR, ZeRO-2: ``fused_step`` against the two-step path for
   12 steps each: the losses and the master bit for bit, the peak device
   memory of both and the call that holds each peak, the median step ms
   and its spread, the busy share of a profiler window, 96 / 48 / 48 flash
   launches a step on the tensor cores; then at 12 layers in fp16 (dynamic
   scale from 2^24,
   hysteresis 1, SGD with momentum, clipping 1.0), fused and two-step
   engines side by side for 10 steps: each step's skip, scale and master
   bit for bit, a skip leaving the master as it was;
   ZeRO-Offload — ``[train-offload]``: the same model (remat "dots", batch 8
   in one micro-step) with TRAIN_CONFIG's AdamW, WarmupLR and clipping at
   ZeRO-2 with ``cpu_offload``, 12 steps, against the device engine on the
   same config (and that engine with its clip kept in float32, as the host
   step folds it): the master after step 1, the losses, the peak device
   memory (at least 17 GB lower), 96 / 48 / 48 flash launches a step on the
   tensor cores, every host step on the native CPU Adam
   (``csrc/cpu_adam.cpp``, built by g++), that kernel against its plain
   version on one chunk of the run's own state and grads (and its time at
   one thread, and its bound from the host's memory rate: the fastest of a
   read, a copy and a triad over 2 GiB buffers at the kernel's thread count), the pipeline's lanes, a profiler
   window; ``[checkpoint]``: in a ``tempfile.mkdtemp()`` directory (its free
   bytes, the reckoned bytes of each round trip and the disk's write rate of
   one fsynced 1 GiB file printed first; too little room raises), (1) the
   slice-2 training config at 12 layers (cut from 48) saved after 4 steps,
   a fresh engine from another init loaded and trained 4 more: params,
   master and moments
   after the load and the 4 losses bit for bit against the uninterrupted
   run, the save timed by stage (snapshot, payload write, hash + manifest,
   fsync + rename) and the load (verify, read, place), with their GB/s;
   (2) the published config at 12 layers (cut from 48) with the
   ``resilience`` block saving every 4 steps on the writer thread for 12
   steps (the step times with a commit in
   flight against those without, each save's stall, 3 commits verified),
   then ``auto_resume`` in a fresh engine at step 12 bit for bit; (3) the
   offload host tier at 12 layers round-tripped bit for bit, then loaded
   into a device engine: its master bit for bit, its losses within
   ``[train-offload]``'s bound; ``[offload-large]``:
   1600-wide GPT-2 at LARGE_LAYERS (5.0 B params), which the device engine
   could not hold (16 B a parameter), with full remat for 3 steps;
   ``[offload-capacity]``: ``bench.py``'s ``max_params_offload``, the deepest
   1600-wide GPT-2 whose bf16 params, grads and full-remat activations fit,
   each depth probed in a fresh process (``chip_smoke.py --probe N``);
7. block-sparse kernels — the forward, dq and dk/dv kernels against the plain
   version (out, lse, dq, dk, dv) at the long-sequence path's shape (the
   Variable layout at block 256, T = 8192, causal) and at layouts of blocks
   16 to 128 (Fixed in float32, a bidirectional BigBird under the causal
   mask, float16 at D = 128 and D = 80, D = 256, a bidirectional layout
   without the causal mask, a layout with an empty row and column in float32
   and bf16, Longformer's global rows unmasked), checking by the launch counts that
   each case's three kernels ran the design the shape rule names (tensor
   cores for bf16/fp16 at D <= 128 a multiple of 8 and blocks of 64k); at the
   main shape (and, for the forward, on the Longformer case, whose rows
   split), each kernel's two designs against each other and two launches bit
   for bit; times of the tensor-core forward and, on the same inputs in
   turns, of the CUDA-core one by CUDA-graph replays; of the tensor-core
   backward and, in turns, of the CUDA-core one, both with and without the
   layout's global column; beside the plain version and SDPA with the layout
   as a boolean mask;
8. long-sequence training — GPT-2 at n_embd 1024 (16 heads, 12 layers, vocab
   50304, T = 8192, bf16, remat "dots") with block-sparse attention
   (``tests/perf/long_seq_model_perf.py``'s layout) through ``initialize`` at
   ZeRO-2 with Adam, 10 optimizer steps on one seeded batch; checks the loss
   and per-layer grad norms of the kernel path against the plain path at 2
   layers (bf16 at T = 8192, float32 at T = 2048), that the losses are finite
   and fall, and that each block-sparse kernel ran once per layer per step
   (the forward twice: the recompute's), on the tensor cores each time;
   a profiler window of one step; then the same model without remat (the
   kernel-vs-plain check at 2 layers, and 5 steps with the forward once a
   layer) and with dense flash attention for 6 steps, for the sparse/dense
   step ratio; ``[onebit-long]`` — the same model at full size (12 layers,
   remat "dots") with 1-bit Adam (lr 1e-4, ``freeze_step`` 3) at ZeRO 0 for
   8 steps, into the frozen phase: the block-sparse launches as above, all
   on the tensor cores; finite, falling losses; each warmup step's moments
   and master against the no-bias-correction formula written out here on
   the card's own grads; at the first frozen step ``exp_avg_sq`` unchanged
   bit for bit and the worker error non-zero, the exchange's error-feedback
   identity (m + we + se = out + we' + se', 4e-6) and the exchange equal to
   the same function on the CPU from copies of its inputs (1e-5); step ms
   and peak beside ``[long]``'s Adam ZeRO-2 step;
9. fused-block kernels — the two entries of the fused transformer block in
   the design the shape rule names (tensor cores: LayerNorm + qkv, then
   attention + projection; CUDA cores: K/V pass, q pass) and the wrapper
   against their plain versions at GPT-2 124M's shape (x [8, 1024, 768], 12
   heads, bf16, causal) and at the JAX tests' shape in float32 (causal and
   not), a ragged T, float16, E = 1024 with 16 heads, B = 1 at T = 4096,
   E = 1600 with 25 heads and head dim 128, float32 at E = 1024 (the
   CUDA-core design at 16 rows a CTA) and bf16 at E = 1600 with 20 heads of
   80 (the CUDA-core design at head dim 128), checking by the launch counts
   that each case ran that design; gradients through the wrapper against
   autograd of the plain version; times of the tensor-core design, of the
   CUDA-core design on the same inputs and of the unfused composition the
   model would otherwise run, in turns, beside the plain versions;
10. fused training — GPT-2 124M (768 x 12, 12 heads, vocab 50304, T = 1024,
   ``fused_block``) through ``initialize`` at ZeRO-2 in bf16 with AdamW,
   micro-batch 8, 10 steps on one seeded batch; checks the first
   micro-batch's loss and per-layer grad norms against the plain path (bf16
   at full depth, float32 at 2 layers), that the losses are finite and fall
   and that the wrapper ran 12 times per micro-step, each time on the
   tensor-core design; a profiler window; then the same model with flash
   attention for the fused/unfused step ratio;
11. BERT training — BERT-large (24 x 1024, 16 heads, vocab 30522, seq 512,
   micro-batch 16, flash attention with the padding mask as a key bias)
   through ``initialize`` at ZeRO-2 in bf16 with LAMB, 10 steps on one seeded
   masked-LM batch whose attention mask rides in the batch; the same checks
   (each flash kernel 24 times per micro-step, on the tensor cores); then one
   BERT-large layer
   forward + backward at two shapes with the mask and train-mode dropout
   against the dense attention path under the same seeds, and its time;
12. single-card paths — the ported code that fits one card and had run
   only on the CPU: the sparse ``MatMul`` (sdd, dsd, dds) and ``Softmax`` at
   the Variable layout (T = 8192, 16 heads, block 256) against float32 dense
   masked products; ``SparseSelfAttention``'s masked path (a key-padding
   and a causal attention mask) against its kernel path (the block-sparse
   kernels, forward and backward); ``BertModel`` and
   ``BertForQuestionAnswering`` at BERT-large, seq 512, micro-batch 16
   through ``initialize`` (the QA engine with ``fused_step`` and LAMB):
   kernel against plain and 3 steps; one BERT-large layer post-LN
   with dropout, flash against dense, and the flash forward's dropout keep
   mask against ``dropout_keep_reference`` bit for bit; the memory knobs
   against the layer without them, with both peaks; remat "attn", "flash"
   and "dots+attn-lean" at 4 layers of the 1.5B (the forward once a layer,
   grads against no remat);
13. the rest of serving, last (the offload-capacity probes measure the
   headroom this process leaves them): ``[serving-spec]`` —
   speculation with K = 4: in float32 with a self-draft (tokens equal to the plain float32 engine's, fewer target
   steps, acceptance at least 0.9, the verify and the draft's two programs
   captured once each) and with a rejecting draft (GPT-2 124M's shape, seed
   1: tokens equal, rollbacks, the allocator's free pages back), then in
   bf16 (tok/s, decode-domain ms and token agreement against plain bf16,
   the first divergence and the plain row's top-2 gap there);
   ``[serving-mirror]`` — bf16 on the gather path with ``mirror=True``: the
   graphed programs bitwise equal to the eager dense oracle at every
   prefill chunk and decode step; ``[serving-restart]`` — the trace with
   the prefix cache and ``request_trace`` on against it off (identical
   logs, the ledger, the Perfetto export, TTFT / TPOT percentiles), stopped
   at the first iteration with 6 running groups, saved with ``save_server``
   in a ``tempfile.mkdtemp()`` directory and restored into a fresh engine
   (tokens identical, fewer prefill chunks than a cold restart, the graphs
   captured anew; the snapshot's bytes and the walls by stage), and float32
   ``generate`` / ``beam_search`` against the float32 engine's tokens;
   ``[serving-fleet]`` — ``serve/sim.py``'s fleet path in this process: two
   1.5B replicas in bf16 sharing one parameter set (8 slots and 129 pages
   of 16 each), the paged-decode kernel on, the prefix cache and affinity
   routing over a seeded trace of 24 requests sharing a 64-token system
   prompt, replica 1 killed at iteration 12 with a warm failover, then the
   same trace with a cold one: every request finished, each replica's
   ``decode_step`` and ``prefill_chunk`` captured once, the kernel 48 times
   a decode replay in the cluster design, the merged fleet percentiles equal
   to the single stream's, warm and cold failover token-identical with
   fewer prefill chunks warm; fleet tok/s, TTFT and TPOT p50/p99, the
   failover's save and load walls;
   ``[resnet]`` — the CIFAR ResNet (width 32, stages (2, 2, 2), GroupNorm 8)
   through ``initialize`` at batch 256 on seeded synthetic CIFAR-shaped
   batches (docs/cifar.md: Adam, OneCycle), ZeRO 0 in float32 then ZeRO 2
   (bf16 parameters, float32 compute), 4 steps each: losses falling, the
   first step's loss and grad norm against the CPU's, and one backward's
   grads against the CPU's (TRAIN_TOL_F32), TF32 off;
   ``[crash-sim]`` — ``ds-tpu-torch crash-sim`` and ``crash-sim --goodput``
   on the card while the same two run on the CPU in child processes: every
   scenario recovered, the transcripts byte for byte the CPU's;
   ``[lint]`` — ``ds-tpu-torch lint`` in this process over every ported
   lint-registry entry on the card, then on the CPU: both exit 0 (no
   violation outside the shipped allowlist, no stale entry) with the same
   vids; each program's recorded kernel ops, the paged-decode op once a
   layer in the serving decode step and as often in all as its wrapper
   counted; ``[launcher]`` — ``python -m deepspeed_tpu_torch.launcher.runner
   --num_gpus 1 chip_smoke.py --launched``: the child (bench.py:406-420's
   widths and engine config at 4 of 48 layers, no remat, 4 steps) prints its
   env identity, losses, optimizer-state digest and flash launches, and its
   losses and state equal the same run's in this process bit for bit, at
   4 x (1, 1, 1) flash launches a step;
14. result — one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores

# GPT-2 1.5B at bench.py's widths, and the serving geometry of this run
MODEL = dict(vocab_size=50304, n_positions=1024, n_embd=1600, n_layer=48, n_head=25)
SERVING = {"max_seqs": 8, "block_size": 16, "max_model_len": 1024,
           "num_blocks": 513, "prefill_chunk": 128, "use_pallas_decode": True}
KERNEL_LENGTHS = [1, 17, 300, 1024, 64, 511, 777, 1000]
BF16_TOL = (1e-2, 1e-2)         # atol, rtol: both sides sum in f32, round once to bf16
F32_TOL = (1e-5, 1e-5)          # summation order only
# First decode step, kernel vs gather path, on logits of std ~0.8. In bf16 the
# gather path rounds the softmax weights to bf16 before the value product and
# the kernel keeps them in f32, and 48 bf16 layers carry the difference to the
# logits (0.078 on this seed, PERF.md). The same step in float32 on the same
# pools leaves only the summation order, which is the kernel's real check.
LOGITS_TOL = 0.15
LOGITS_TOL_F32 = 1e-4

# training: GPT-2 1.5B at bench.py:406-420's widths (no remat, T = 1024,
# micro-batch 4 x 2, AdamW): the AdamW path beside the published config
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
TRAIN_MODEL = dict(MODEL, use_flash_attention=True, remat=False, loss_chunk=128)
TRAIN_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
                "zero_optimization": {"stage": 2},
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "betas": [0.9, 0.95],
                                         "weight_decay": 0.1}},
                "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4}},
                "gradient_clipping": 1.0, "steps_per_print": 1000}
TRAIN_STEPS = 12
FLASH_SHAPE = (4, 25, 1024, 64)  # B, H, T, D of the training path
PUBLISHED_FLASH_SHAPE = (8, 25, 1024, 64)  # the published config's (batch 8)
# kernels vs plain: max |err| / max |ref| per output. bf16/fp16: the kernel
# rounds the scaled q and the probabilities to the operand type where the
# plain version keeps float32, a few ulps of 2**-8; float32: summation order.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
# first micro-batch, kernel path vs plain attention path: |loss diff| and the
# max relative difference of the 49 per-layer grad norms. bf16 rounds at
# other points in the two attention paths, and 48 layers carry it; float32
# at 4 layers leaves summation order only.
TRAIN_TOL_BF16 = (2e-2, 5e-2)
TRAIN_TOL_F32 = 1e-4


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters, warmup=3):
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n, replays=20):
    """Mean device time of one of ``fn(0) .. fn(n - 1)``: the n calls
    captured once as a CUDA graph and replayed between CUDA events, so that
    the host's enqueue cost (more than a 10 us kernel takes, in an eager loop
    of Python calls) drops out."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    del graph
    return ms


def phase_device(quiet=False):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    if not quiet:
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from deepspeed_tpu_torch.ops import _build
    t0 = time.perf_counter()
    builds = _build.build("paged_decode", "flash_attention", "block_sparse_attention",
                          "block_sparse_attention_tc", "fused_block", "fused_block_tc")
    log(f"[build] {sorted(builds)} in {time.perf_counter() - t0:.2f} s")
    for b in builds.values():
        kernels = _ptxas_kernels(b.log)
        regs = [r for _, r, _ in kernels]
        log(f"[build] {b.name}: {len(kernels)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers; spilling: "
            + (", ".join(f"{n} ({s} B)" for n, _, s in kernels if s) or "none"))
        if b.name in ("paged_decode", "fused_block_tc", "block_sparse_attention_tc"):
            log(f"[build] {b.name} per kernel (registers, spill-store bytes): " + "; ".join(
                f"{_demangle(n)} {r}, {s}" for n, r, s in kernels))


def _demangle(name):
    """A short label for a paged-decode, tensor-core fused-block or
    tensor-core block-sparse kernel's mangled name: its kind, dtype and
    integer template arguments."""
    kind = next(k for k in ("cluster", "qkv", "attn", "bs_dkv", "bs_dq", "bs_fwd", "")
                if k in name) or "first"
    dtype = ("bf16" if "bfloat16" in name else "f16" if "half" in name else "f32")
    ints = re.findall(r"Li(\d+)E", name)
    label = {"cluster": ", NP ", "qkv": ", NC ", "attn": ", DP/NC ", "bs_dkv": ", DP/NWG ",
             "bs_dq": ", DP/NWG ", "bs_fwd": ", DP/NWG "}.get(kind, "")
    return f"{kind}<{dtype}{label + '/'.join(ints) if ints else ''}>"


def _ptxas_kernels(log_text):
    """(entry name, registers, spill-store bytes) of each kernel in nvcc's
    ``-Xptxas -v`` output."""
    kernels, name, spill = [], None, 0
    for line in log_text.splitlines():
        if "Function properties for" in line:
            name, spill = line.split("Function properties for", 1)[1].strip(), 0
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].rsplit(",", 1)[-1])
        elif "Used" in line and "registers" in line and name:
            kernels.append((name, int(line.split("Used", 1)[1].split("registers")[0]), spill))
            name = None
    return kernels


def _within(y, ref, tol):
    err = (y.float() - ref.float()).abs()
    return float(err.max()), bool((err <= tol[0] + tol[1] * ref.float().abs()).all())


def phase_kernels():
    """paged_decode against its plain version at the serving path's shapes in
    bf16, float16 and float32, each on the design the shape rule names (the
    cluster design) and the bf16 case on the first design too; then times at
    the mixed and the all-full lengths: both designs, the plain version and
    SDPA on the pre-gathered view."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    c = MODEL
    S, NH, HD, NL = SERVING["max_seqs"], c["n_head"], c["n_embd"] // c["n_head"], c["n_layer"]
    NB, BS = SERVING["num_blocks"], SERVING["block_size"]
    MB = SERVING["max_model_len"] // BS
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kp = torch.randn((NL, NB, BS, NH, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((NL, NB, BS, NH, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((S, NH, 1, HD), generator=gen, device=dev, dtype=torch.bfloat16)
    tables = (torch.randperm(NB - 1, generator=gen, device=dev) + 1)[:S * MB]
    tables = tables.reshape(S, MB).to(torch.int32).contiguous()
    lengths = torch.tensor(KERNEL_LENGTHS, dtype=torch.int32, device=dev)
    if not pa.cluster_design(torch.bfloat16, HD):
        raise AssertionError("the shape rule does not send the serving shape to the "
                             "cluster design")

    def check(qd, kd, vd, layers, tol):
        worst = 0.0
        before = pa.paged_decode_attention.cluster_launches
        for li in layers:
            y = pa.paged_decode_attention(qd, kd, vd, li, tables, lengths, block_size=BS)
            ref = pa.paged_decode_reference(qd, kd, vd, li, tables, lengths, block_size=BS)
            torch.cuda.synchronize()
            err, ok = _within(y, ref, tol)
            worst = max(worst, err)
            if not ok or not torch.isfinite(y).all():
                raise AssertionError(f"paged_decode {qd.dtype} layer {li}: max abs err {err}")
        if pa.paged_decode_attention.cluster_launches - before != len(layers):
            raise AssertionError(f"paged_decode {qd.dtype}: not every launch ran the "
                                 "cluster design")
        return worst

    worst = check(q, kp, vp, (0, NL // 2, NL - 1), BF16_TOL)
    err_f16 = check(q.half(), kp[:2].half(), vp[:2].half(), (0, 1), BF16_TOL)
    err_f32 = check(q.float(), kp[:2].float(), vp[:2].float(), (0, 1), F32_TOL)
    old = pa._launch(q, kp, vp, NL - 1, tables, lengths, BS, cluster=False)
    err_old, ok = _within(old, pa.paged_decode_reference(q, kp, vp, NL - 1, tables, lengths,
                                                         block_size=BS), BF16_TOL)
    if not ok:
        raise AssertionError(f"paged_decode, first design: max abs err {err_old}")
    log(f"[kernels] paged_decode cluster design, max abs err: bf16 {worst!r}, f16 "
        f"{err_f16!r} (tol {BF16_TOL}), f32 {err_f32!r} (tol {F32_TOL}); first design bf16 "
        f"{err_old!r}")

    def bound(lens):
        live = sum(min(int(n), MB * BS) for n in lens)
        nbytes = (2 * live * NH * HD * 2            # K and V of the live history
                  + 2 * q.numel() * 2               # q in, out
                  + tables.numel() * 4 + lengths.numel() * 4)
        flops = 4 * live * NH * HD                  # q.k and p.v
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def timings(lens):
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        # device times from CUDA-graph replays, the launches rotating through
        # the layers so each finds its pages outside L2; the two designs in
        # turns (cluster, first, first, cluster); then the eager loop of the
        # cluster design, which the host's enqueue cost bounds
        new = lambda i: pa.paged_decode_attention(q, kp, vp, i % NL, tables, ln, block_size=BS)
        first = lambda i: pa._launch(q, kp, vp, i % NL, tables, ln, BS, cluster=False)
        kernel_a, old_a, old_b, kernel_b = (graph_ms(f, NL) for f in (new, first, first, new))
        eager = time_ms(new, 480)
        plain = graph_ms(lambda i: pa.paged_decode_reference(
            q, kp, vp, i % NL, tables, ln, block_size=BS), 8, replays=4)
        # SDPA on the pre-gathered dense view of 4 layers (the port never calls it)
        pos = torch.arange(MB * BS, device=dev)
        mask = (pos[None, :] < ln[:, None].long())[:, None, None, :]
        views = [(kp[li][tables.long()].reshape(S, MB * BS, NH, HD).transpose(1, 2).contiguous(),
                  vp[li][tables.long()].reshape(S, MB * BS, NH, HD).transpose(1, 2).contiguous())
                 for li in range(4)]
        library = graph_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q, views[i % 4][0], views[i % 4][1], attn_mask=mask), 4)
        b_ms, b_by = bound(lens)
        ms = (kernel_a + kernel_b) / 2
        return {"ms": ms, "ms_runs": [kernel_a, kernel_b], "eager_ms": eager,
                "old_ms": (old_a + old_b) / 2, "old_ms_runs": [old_a, old_b],
                "plain_ms": plain, "library_ms": library, "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / ms}

    mixed = timings(KERNEL_LENGTHS)
    full = timings([MB * BS] * S)
    log(f"[kernels] paged_decode lengths {KERNEL_LENGTHS}: {json.dumps(mixed)}")
    log(f"[kernels] paged_decode lengths all {MB * BS}: {json.dumps(full)}")
    del kp, vp
    torch.cuda.empty_cache()
    return {"name": "paged_decode", "route": "cuda", "design": "cluster",
            "source": "deepspeed_tpu_torch/csrc/paged_decode.cu",
            "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:45:_decode_kernel",
            "launches": None, "max_abs_err": worst, "max_abs_err_f16": err_f16,
            "max_abs_err_f32": err_f32, "tol": list(BF16_TOL), "kernel_ms": mixed["ms"],
            "ms": mixed["ms"], "eager_ms": mixed["eager_ms"], "old_ms": mixed["old_ms"],
            "plain_ms": mixed["plain_ms"],
            "library_ms": mixed["library_ms"], "bound_ms": mixed["bound_ms"],
            "bound_by": mixed["bound_by"], "full_ms": full["ms"], "full_old_ms": full["old_ms"],
            "full_plain_ms": full["plain_ms"], "full_bound_ms": full["bound_ms"],
            "full_library_ms": full["library_ms"]}


def _trace(vocab):
    from deepspeed_tpu_torch.serve.scheduler import Request
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(8):
        n = int(rng.randint(64, 897))
        reqs.append(Request(f"greedy{i}", rng.randint(0, 50257, size=n).tolist(), 64,
                            arrival=int(rng.randint(0, 16))))
    reqs.append(Request("beam4", rng.randint(0, 50257, size=192).tolist(), 64,
                        num_beams=4, eos_token_id=50256, arrival=4))
    reqs.append(Request("sampled", rng.randint(0, 50257, size=320).tolist(), 64,
                        temperature=0.8, top_k=50, seed=1, arrival=8))
    assert all(max(r.prompt) < vocab for r in reqs)
    return reqs


def _timed(eng, name):
    """Wrap the engine's attribute ``name`` (a program or a method) so each
    call is fenced by ``torch.cuda.synchronize()`` and timed; returns the
    record {"calls", "seconds"}."""
    fn = getattr(eng, name)
    rec = {"calls": 0, "seconds": 0.0}

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        rec["seconds"] += time.perf_counter() - t
        rec["calls"] += 1
        return out

    setattr(eng, name, timed)
    return rec


def _ms(rec):
    return rec["seconds"] / max(rec["calls"], 1) * 1e3


def _check_graphs(eng, names, tag):
    graphs = eng.graphs()
    if set(graphs) != set(names) or any(g.captures != 1 for g in graphs.values()):
        raise AssertionError(f"[{tag}] expected one capture of each of {sorted(names)}, got "
                             f"{ {k: g.captures for k, g in graphs.items()} }")
    return graphs


def _graph_bytes(eng):
    return sum(g.pool_bytes for g in eng.graphs().values())


def phase_serving():
    """The main serving path through the CUDA-graphed programs; returns the
    run's record for the later serving phases (the model, outputs, logs)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention
    from deepspeed_tpu_torch.serve.paged import build_paged_programs, serving_params

    torch.cuda.reset_peak_memory_stats()
    cfg = GPT2Config(**MODEL, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = deepspeed_tpu_torch.init_inference(model, config_params={"serving": SERVING})
    torch.cuda.synchronize()
    graphs = _check_graphs(eng, ("decode_step", "prefill_chunk"), "serving")
    pool_bytes = _graph_bytes(eng)
    log(f"[serving] model + engine built (both programs captured) in "
        f"{time.perf_counter() - t0:.2f} s; graph pool {pool_bytes} bytes "
        f"(memory_reserved over the captures), "
        f"{ {k: g.pool_bytes for k, g in graphs.items()} }")
    gather = build_paged_programs(model, num_slots=eng.num_slots, block_size=eng.block_size,
                                  max_blocks=eng.max_blocks, prefill_chunk=eng.prefill_chunk,
                                  use_pallas=False)["decode_step"]
    graphed_decode = eng._decode
    eager_decode = eng._raw["decode_step"]
    params32 = serving_params(model, torch.float32)

    def first_step_check(p, host_inputs, k_pool, v_pool, out):
        """The first decode step (the graph's replay) against the eager
        program on copies of the same pools, bit for bit; against the gather
        path in bf16 (the served logits), and once more in float32 on the
        same pool contents, where only summation order differs."""
        toks, pos, tables, active = (torch.as_tensor(a, device="cuda") for a in host_inputs)
        e = eager_decode(p, toks, pos, tables, active, k_pool.clone(), v_pool.clone())
        st["graph_vs_eager_bitwise"] = bool(torch.equal(out, e))
        b = gather(p, toks, pos, tables, active, k_pool.clone(), v_pool.clone())
        a = out
        k32, v32 = k_pool.float(), v_pool.float()
        a32 = eager_decode(params32, toks, pos, tables, active, k32.clone(), v32.clone())
        b32 = gather(params32, toks, pos, tables, active, k32, v32)
        a, b, a32, b32 = (t[active] for t in (a, b, a32, b32))
        if not all(torch.isfinite(t).all() for t in (a, b, a32, b32)):
            raise AssertionError("non-finite logits in the first decode step")
        err, err32 = float((a - b).abs().max()), float((a32 - b32).abs().max())
        st.update(first_err=err, first_err_f32=err32, logit_std=float(b.std()),
                  first_argmax_agree=float((a.argmax(-1) == b.argmax(-1)).float().mean()))
        if not st["graph_vs_eager_bitwise"]:
            raise AssertionError("first decode step: the graph's logits differ from the "
                                 "eager program's on the same pools")
        if not (err <= LOGITS_TOL and err32 <= LOGITS_TOL_F32):
            raise AssertionError(
                f"first decode step, kernel vs gather: logits differ by {err} in bf16 "
                f"(tol {LOGITS_TOL}), {err32} in float32 (tol {LOGITS_TOL_F32})")

    # count decode steps, time them, and check the first one
    st = {"steps": 0, "seconds": 0.0}

    def decode(p, toks, pos, tables, active, k_pool, v_pool):
        pre = (k_pool.clone(), v_pool.clone()) if st["steps"] == 0 else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = graphed_decode(p, toks, pos, tables, active, k_pool, v_pool)
        torch.cuda.synchronize()
        st["seconds"] += time.perf_counter() - t
        if pre is not None:
            launched = (paged_decode_attention.launches,
                        paged_decode_attention.cluster_launches)
            first_step_check(p, (toks, pos, tables, active), *pre, out)
            # checks are not the main path
            paged_decode_attention.launches, paged_decode_attention.cluster_launches = launched
        st["steps"] += 1
        return out

    eng._decode = decode
    reqs = _trace(cfg.vocab_size)
    paged_decode_attention.launches = paged_decode_attention.cluster_launches = 0
    t0 = time.perf_counter()
    outs, logs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    cluster_launches = paged_decode_attention.cluster_launches

    if [o.status for o in outs] != ["finished"] * len(reqs):
        raise AssertionError(f"unfinished requests: {[(o.req_id, o.status) for o in outs]}")
    for r, o in zip(reqs, outs):
        if not 0 < len(o.tokens) <= r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in o.tokens):
            raise AssertionError(f"{r.req_id}: bad tokens {o.tokens[:8]}...")
    if st["steps"] == 0 or launches != cfg.n_layer * st["steps"]:
        raise AssertionError(f"paged_decode launches {launches} != {cfg.n_layer} x "
                             f"{st['steps']} decode steps")
    if cluster_launches != launches:
        raise AssertionError(f"only {cluster_launches} of {launches} paged_decode launches "
                             "ran the cluster design")
    chunks = sum(1 for g in logs if g["prefill"] is not None)
    replays = {k: g.replays for k, g in graphs.items()}
    if replays != {"decode_step": st["steps"], "prefill_chunk": chunks}:
        raise AssertionError(f"graph replays {replays} != {st['steps']} decode steps, "
                             f"{chunks} prefill chunks")
    n_tok = sum(len(o.tokens) for o in outs)
    ttft = [o.ttft_ms for o in outs]
    res = {"requests": len(outs), "iterations": len(logs), "decode_steps": st["steps"],
           "prefill_chunks": chunks,
           "preemptions": sum(o.preemptions for o in outs),
           "output_tokens": n_tok, "wall_s": wall, "tok_s": n_tok / wall,
           "decode_step_ms": st["seconds"] / st["steps"] * 1e3,
           "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": max(ttft),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graph_pool_bytes": pool_bytes,
           "captures": {k: g.captures for k, g in graphs.items()}, "replays": replays,
           "paged_decode_launches": launches, "cluster_launches": cluster_launches,
           "first_step_graph_vs_eager_bitwise": st["graph_vs_eager_bitwise"],
           "first_step_logits_max_abs_diff": st["first_err"],
           "first_step_logits_max_abs_diff_f32": st["first_err_f32"],
           "first_step_logit_std": st["logit_std"],
           "first_step_argmax_agreement": st["first_argmax_agree"],
           "logits_tol": [LOGITS_TOL, LOGITS_TOL_F32]}
    eng._decode = graphed_decode
    res["busy_share"] = profile(eng, cfg)
    res["memory_manifest"] = serving_manifest_check(eng)
    log(f"[serving] {json.dumps(res)}")
    del eng, params32, gather
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "captures": graphs["decode_step"].captures,
            "replays": replays["decode_step"], "model": model, "outs": outs,
            "logs": logs, "stats": res}


def serving_manifest_check(eng):
    """The serving engine's ``memory_manifest()`` on the card: each class's
    bytes equal to its live tensors' (one storage once), reconciled with
    the pool model, within what the allocator holds."""
    from deepspeed_tpu_torch.utils import hbm
    manifest = eng.memory_manifest()
    _, class_bytes = hbm.manifest_signatures(manifest)
    live = hbm.measure_classes(manifest)
    classes, ok = hbm.reconcile(live, hbm.modeled_classes(manifest["geometry"]),
                                class_bytes)
    allocated = torch.cuda.memory_allocated()
    if live != class_bytes or not ok or sum(class_bytes.values()) > allocated:
        raise AssertionError(f"[serving] memory manifest {class_bytes}, live {live}, "
                             f"reconcile {classes}, allocated {allocated}")
    return {"classes": class_bytes, "allocated": allocated}


def profile(eng, cfg):
    """Where the time goes: a short window of 8 requests (64-token prompts,
    8 new tokens) under torch.profiler; device-busy share and top kernels.
    The paged-decode kernels the trace saw are held to the launch counter's
    move over the window, and on a graphed engine to n_layer x the decode
    graph's replays: the counter is proven against kernel executions.
    Returns the busy share."""
    from torch.profiler import ProfilerActivity
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention
    from deepspeed_tpu_torch.serve.scheduler import Request
    rng = np.random.RandomState(1)
    reqs = [Request(f"p{i}", rng.randint(0, 50257, size=64).tolist(), 8) for i in range(8)]
    graph = eng.graphs().get("decode_step")
    replays0 = graph.replays if graph is not None else 0
    launches0 = paged_decode_attention.cluster_launches
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] window {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / wall_us:.3f} of the window)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  {e.key[:90]}")
    traced = sum(e.count for e in events if "paged_decode_cluster" in e.key)
    counted = paged_decode_attention.cluster_launches - launches0
    want = counted if graph is None else cfg.n_layer * (graph.replays - replays0)
    log(f"[profile] paged_decode_cluster kernels in the trace {traced}, counter {counted}"
        + ("" if graph is None else f", {cfg.n_layer} x {graph.replays - replays0} replays"))
    if not traced == counted == want or traced == 0:
        raise AssertionError(f"[profile] paged_decode_cluster: {traced} kernels traced, "
                             f"counter moved {counted}, expected {want}")
    return busy_us / wall_us


def phase_serving_graphs(srv):
    """The same trace through the eager programs (``_raw``) of a second
    engine on the same model: tokens and schedule logs identical to the
    graphed run of ``[serving]`` (whose first step was bit for bit the
    eager program's on the same pools); the eager engine's decode step,
    TTFT, tok/s and busy share beside the graphed one's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.serve.paged import EagerProgram
    model = srv["model"]
    eng = deepspeed_tpu_torch.init_inference(model, config_params={"serving": SERVING})
    for attr, name in (("_decode", "decode_step"), ("_prefill", "prefill_chunk")):
        setattr(eng, attr, EagerProgram(eng._raw[name], name, eng._raw["inputs"][name],
                                        eng.params, eng.k_pool, eng.v_pool))
    rec = _timed(eng, "_decode")
    t0 = time.perf_counter()
    outs, logs = eng.run(_trace(model.config.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [o.tokens for o in outs] != [o.tokens for o in srv["outs"]]:
        bad = [o.req_id for o, g in zip(outs, srv["outs"]) if o.tokens != g.tokens]
        raise AssertionError(f"[serving-graphs] eager and graphed tokens differ: {bad}")
    if json.dumps(logs) != json.dumps(srv["logs"]):
        raise AssertionError("[serving-graphs] eager and graphed schedule logs differ")
    n_tok = sum(len(o.tokens) for o in outs)
    g = srv["stats"]
    res = {"tokens_identical": True, "logs_identical": True, "first_step_bitwise": True,
           "eager": {"decode_step_ms": _ms(rec), "tok_s": n_tok / wall, "wall_s": wall,
                     "ttft_ms_median": statistics.median(o.ttft_ms for o in outs),
                     "ttft_ms_max": max(o.ttft_ms for o in outs)},
           "graphed": {k: g[k] for k in ("decode_step_ms", "tok_s", "wall_s", "ttft_ms_median",
                                         "ttft_ms_max", "busy_share")}}
    res["eager"]["busy_share"] = profile(eng, model.config)
    log(f"[serving-graphs] {json.dumps(res)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


SPEC_K = 4
DRAFT_MODEL = dict(vocab_size=50304, n_positions=1024, n_embd=768, n_layer=12, n_head=12)


def _spec_config(**over):
    return {"serving": dict(SERVING, speculation={"enabled": True, "max_draft_tokens": SPEC_K},
                            **over)}


def _seeded_model(dims, dtype, seed):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**dims, compute_dtype=dtype))
    model.init(torch.Generator(device="cuda").manual_seed(seed))
    return model


def _serve(eng, reqs):
    """Run ``reqs``; the outputs, logs, wall, and the decode domain's time
    (``_decode_all`` or ``_speculate_all`` + a plain ``_decode_all``)."""
    dom = [_timed(eng, "_decode_all")]
    if eng._spec is not None:
        dom.append(_timed(eng, "_speculate_all"))
    t0 = time.perf_counter()
    outs, logs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [o.status for o in outs] != ["finished"] * len(reqs):
        raise AssertionError(f"unfinished requests: {[(o.req_id, o.status) for o in outs]}")
    iters = sum(1 for g in logs if g["decode"] or g.get("spec"))
    dom_s = sum(r["seconds"] for r in dom)
    n_tok = sum(len(o.tokens) for o in outs)
    return outs, logs, {"wall_s": wall, "tok_s": n_tok / wall, "output_tokens": n_tok,
                        "decode_iterations": iters,
                        "decode_domain_ms_per_iteration": dom_s / max(iters, 1) * 1e3,
                        "target_steps": eng.target_steps}


def phase_serving_spec():
    """Speculative decoding at GPT-2 1.5B with K = 4: float32 with a
    self-draft and with a rejecting draft (GPT-2 124M's shape, seed 1),
    token for token against the plain float32 engine; then bf16, reported
    against plain bf16. Returns the float32 model and plain outputs."""
    import deepspeed_tpu_torch
    init = deepspeed_tpu_torch.init_inference
    reqs = functools.partial(_trace, MODEL["vocab_size"])
    model32 = _seeded_model(MODEL, torch.float32, 0)
    plain = init(model32, config_params={"serving": SERVING})
    p_outs, _, p_stats = _serve(plain, reqs())
    plain_steps = plain.target_steps
    del plain
    res = {"plain_f32": p_stats}

    spec = init(model32, config_params=_spec_config(), draft_model=model32)
    graphs = _check_graphs(spec, ("decode_step", "prefill_chunk", "spec_verify",
                                  "spec_draft_decode", "spec_draft_prefill"), "serving-spec")
    s_outs, s_logs, s_stats = _serve(spec, reqs())
    summary = spec.spec_summary()
    bad = [o.req_id for o, p in zip(s_outs, p_outs) if o.tokens != p.tokens]
    if bad:
        raise AssertionError(f"[serving-spec] float32 self-draft tokens differ from plain: {bad}")
    if not spec.target_steps < plain_steps:
        raise AssertionError(f"[serving-spec] target steps {spec.target_steps} not below "
                             f"plain's {plain_steps}")
    if summary["spec_acceptance_rate"] < 0.9:
        raise AssertionError(f"[serving-spec] self-draft acceptance "
                             f"{summary['spec_acceptance_rate']} < 0.9")
    res["self_f32"] = dict(s_stats, spec_summary=summary, plain_target_steps=plain_steps,
                           replays={k: g.replays for k, g in graphs.items()},
                           graph_pool_bytes=_graph_bytes(spec))
    del spec, graphs
    gc.collect()
    torch.cuda.empty_cache()

    draft = _seeded_model(DRAFT_MODEL, torch.float32, 1)
    rej = init(model32, config_params=_spec_config(), draft_model=draft)
    free0 = rej.scheduler.allocator.num_free
    r_outs, r_logs, r_stats = _serve(rej, reqs())
    bad = [o.req_id for o, p in zip(r_outs, p_outs) if o.tokens != p.tokens]
    if bad:
        raise AssertionError(f"[serving-spec] float32 rejecting-draft tokens differ: {bad}")
    rollbacks = sum(1 for g in r_logs for _, m, a, _ in g.get("spec", []) if a < m)
    if rollbacks == 0:
        raise AssertionError("[serving-spec] the rejecting draft never rolled back")
    if rej.scheduler.allocator.num_free != free0:
        raise AssertionError(f"[serving-spec] allocator free {rej.scheduler.allocator.num_free}"
                             f" != {free0} after the trace drained")
    res["rejecting_f32"] = dict(r_stats, spec_summary=rej.spec_summary(), rollbacks=rollbacks,
                                num_free_restored=True)
    del rej, draft
    gc.collect()
    torch.cuda.empty_cache()

    model16 = _seeded_model(MODEL, torch.bfloat16, 0)
    plain16 = init(model16, config_params={"serving": SERVING})
    gaps = {}
    sample = plain16._sample_token

    def recording(g, row, position):
        top2 = np.partition(row, -2)[-2:]
        gaps[(g.req.req_id, position)] = float(top2[1] - top2[0])
        return sample(g, row, position)

    plain16._sample_token = recording
    q_outs, _, q_stats = _serve(plain16, reqs())
    del plain16
    spec16 = init(model16, config_params=_spec_config(), draft_model=model16)
    b_outs, _, b_stats = _serve(spec16, reqs())
    agree = total = 0
    first = None
    for o, q in zip(b_outs, q_outs):
        for i, (a, b) in enumerate(zip(o.tokens, q.tokens)):
            total += 1
            agree += a == b
            if a != b and first is None:
                first = {"req": o.req_id, "position": i, "plain_top2_gap": gaps.get((o.req_id, i))}
    res["bf16"] = {"plain": q_stats, "spec": dict(b_stats, spec_summary=spec16.spec_summary()),
                   "token_agreement": agree / total, "first_divergence": first}
    log(f"[serving-spec] {json.dumps(res)}")
    del spec16, model16
    gc.collect()
    torch.cuda.empty_cache()
    return model32, p_outs


def phase_serving_mirror():
    """The dense mirror at GPT-2 1.5B in bf16 on the gather path, graphed
    programs against the eager dense oracle, bitwise every prefill chunk and
    decode step of the 10-request trace."""
    import deepspeed_tpu_torch
    model = _seeded_model(MODEL, torch.bfloat16, 0)
    eng = deepspeed_tpu_torch.init_inference(
        model, config_params={"serving": dict(SERVING, use_pallas_decode=False)}, mirror=True)
    _check_graphs(eng, ("decode_step", "prefill_chunk"), "serving-mirror")
    outs, logs, stats = _serve(eng, _trace(MODEL["vocab_size"]))
    chunks = sum(1 for g in logs if g["prefill"] is not None)
    steps = sum(1 for g in logs if g["decode"])
    if eng.mirror_checks != chunks + steps:
        raise AssertionError(f"[serving-mirror] {eng.mirror_checks} checks != {chunks} chunks "
                             f"+ {steps} decode steps")
    log(f"[serving-mirror] {json.dumps(dict(stats, mirror_checks=eng.mirror_checks, prefill_chunks=chunks, decode_steps=steps, bitwise=True))}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


RESTART_SERVING = dict(SERVING, prefix_cache={"enabled": True})
RESTART_TRACE = {"enabled": True, "capacity": 64}
RESTART_KILL_RUNNING = 6


def phase_serving_restart(model32, outs32):
    """The request tracer, warm restart and GPT-2's decoders: (1) the trace
    with ``request_trace`` on against it off (the prefix cache on in both,
    as a warm restart needs); (2) the traced run stopped at the first
    iteration with 6 running groups, saved, restored into a fresh engine and
    finished, against a cold restart of the pending requests; (3) float32
    ``generate`` and ``beam_search`` against the float32 engine's tokens."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.resilience.serve_restart import restore_server, save_server
    from deepspeed_tpu_torch.serve.request_trace import serialize_trace, to_serve_trace_events
    init = deepspeed_tpu_torch.init_inference
    reqs = functools.partial(_trace, MODEL["vocab_size"])
    model = _seeded_model(MODEL, torch.bfloat16, 0)
    traced_cfg = {"serving": dict(RESTART_SERVING, request_trace=RESTART_TRACE)}

    eng = init(model, config_params={"serving": RESTART_SERVING})
    rec = _timed(eng, "_decode")
    ref_outs, ref_logs, _ = _serve(eng, reqs())
    off_ms = _ms(rec)
    del eng
    eng = init(model, config_params=traced_cfg)
    rec = _timed(eng, "_decode")
    t_outs, t_logs, _ = _serve(eng, reqs())
    on_ms = _ms(rec)
    tr = eng.tracer
    if json.dumps(t_logs) != json.dumps(ref_logs):
        raise AssertionError("[serving-restart] traced schedule logs differ from untraced")
    if tr.finished != 10 or len(tr.requests) != 10:
        raise AssertionError(f"[serving-restart] ledger holds {len(tr.requests)} requests")
    events = json.loads(serialize_trace(to_serve_trace_events(tr.bundle())))["traceEvents"]
    res = {"tracer": {"latency": tr.percentiles(), "decode_step_ms_traced": on_ms,
                      "decode_step_ms_untraced": off_ms, "perfetto_events": len(events),
                      "waste": tr.waste_summary()}}
    del eng

    root = tempfile.mkdtemp(prefix="serve_restart_")
    try:
        victim = init(model, config_params=traced_cfg)
        for r in reqs():
            victim.submit(r)
        while len(victim.scheduler.running) < RESTART_KILL_RUNNING:
            victim.step()
            if victim.scheduler.idle:
                raise AssertionError("[serving-restart] the trace drained before the kill")
        kill_it = victim._it
        finished = set(victim.outputs)
        snap = save_server(victim, root)
        save = victim.last_serve_save
        del victim
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        warm = init(model, config_params=traced_cfg)
        build_s = time.perf_counter() - t0
        if not restore_server(warm, snap):
            raise AssertionError("[serving-restart] the snapshot was refused")
        load = warm.last_serve_load
        warm_logs = []
        while not warm.scheduler.idle:
            warm_logs.append(warm.step())
        got = [warm.outputs[r.req_id].tokens for r in ref_outs]
        if got != [o.tokens for o in ref_outs]:
            raise AssertionError("[serving-restart] warm restart tokens differ")
        graphs = _check_graphs(warm, ("decode_step", "prefill_chunk"), "serving-restart")
        if graphs["decode_step"].replays == 0:
            raise AssertionError("[serving-restart] the restored engine replayed no graph")
        warm_chunks = sum(1 for g in warm_logs if g["prefill"] is not None)
        del warm
        cold = init(model, config_params=traced_cfg)
        c_outs, c_logs, _ = _serve(cold, [r for r in reqs() if r.req_id not in finished])
        cold_chunks = sum(1 for g in c_logs if g["prefill"] is not None)
        if not warm_chunks < cold_chunks:
            raise AssertionError(f"[serving-restart] warm {warm_chunks} prefill chunks, not "
                                 f"below cold {cold_chunks}")
        del cold
        res["restart"] = {"kill_iteration": kill_it, "finished_before_kill": len(finished),
                          "tokens_identical": True, "warm_prefill_chunks": warm_chunks,
                          "cold_prefill_chunks": cold_chunks,
                          "restored_captures": {k: g.captures for k, g in graphs.items()},
                          "restored_replays": {k: g.replays for k, g in graphs.items()},
                          "engine_build_s": build_s, "save_s": save, "load_s": load}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # float32 generate / beam_search against the float32 engine (phase_serving_spec)
    trace = _trace(MODEL["vocab_size"])
    by_id = {o.req_id: o for o in outs32}
    for r in trace[:3]:
        out = model32.generate(torch.tensor([r.prompt], device=model32.device), 32)
        if out[0, len(r.prompt):].tolist() != by_id[r.req_id].tokens[:32]:
            raise AssertionError(f"[serving-restart] generate differs from the engine: {r.req_id}")
    beam = next(r for r in trace if r.num_beams > 1)
    seq, score = model32.beam_search(torch.tensor([beam.prompt], device=model32.device),
                                     beam.max_new_tokens, num_beams=beam.num_beams,
                                     eos_token_id=beam.eos_token_id)
    want = by_id[beam.req_id]
    gap = abs(float(score[0]) - want.score)
    if seq[0, len(beam.prompt):].tolist() != want.tokens or gap > 1e-4:
        raise AssertionError(f"[serving-restart] beam_search differs from the engine "
                             f"(score gap {gap})")
    res["decoders_f32"] = {"generate_requests": 3, "generate_tokens": 32,
                           "beam_score": float(score[0]), "engine_beam_score": want.score,
                           "beam_score_gap": gap}
    log(f"[serving-restart] {json.dumps(res)}")


# ------------------------------------------------------------ serving fleet
# the fleet of serve/sim.py --fleet at GPT-2 1.5B: two replicas sharing one
# parameter set, each with its own pool of 8 slots and 129 pages of 16 (a
# pool pair is 634 MB; the cut from 513 pages keeps the warm restart short)
FLEET_ARGS = ["--fleet", "2", "--requests", "24", "--shared-prefix", "64",
              "--kill", "12:1", "--compare-cold-failover", "--no-mirror", "--pallas",
              "--slots", "8", "--block-size", "16", "--num-blocks", "129",
              "--max-model-len", "256", "--prefill-chunk", "32",
              "--vocab-size", str(MODEL["vocab_size"]), "--n-embd", str(MODEL["n_embd"]),
              "--n-layer", str(MODEL["n_layer"]), "--n-head", str(MODEL["n_head"])]


def phase_serving_fleet():
    """``serve-sim``'s fleet path in this process: a seeded trace of 24
    requests sharing a 64-token system prompt routed by prefix affinity over
    two 1.5B replicas, slot 1 killed at iteration 12 and failed over warm,
    then the same trace with a cold failover. Returns the paged-decode
    launches of the run."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention as pda
    from deepspeed_tpu_torch.serve import sim
    from deepspeed_tpu_torch.serve.router import FleetRouter
    from deepspeed_tpu_torch.utils.telemetry import TelemetrySession

    model = GPT2Model(GPT2Config(**MODEL, compute_dtype=torch.bfloat16))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    args = sim.parse_args(FLEET_ARGS + ["--output", os.path.join(root, "telemetry"),
                                        "--snapshot-dir", os.path.join(root, "snap")])
    built, walls, spent = [], [], {"kill": 0.0, "end_step": 0.0}
    build, run, kill, end_step = sim._build, FleetRouter.run, FleetRouter._kill, \
        TelemetrySession.end_step

    def build_recorded(*a, **k):          # every replica of both passes, victims too
        built.append(build(*a, **k))
        return built[-1]

    def run_timed(self, requests):        # the routing loop, failover included
        t = time.perf_counter()
        out = run(self, requests)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    def timed(key, fn):                   # host seconds inside fn, summed
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapper

    pda.launches = pda.cluster_launches = 0
    sim._build, FleetRouter.run = build_recorded, run_timed
    FleetRouter._kill = timed("kill", kill)
    TelemetrySession.end_step = timed("end_step", end_step)
    try:
        rc, info = sim.fleet_run(args, model_params=(model, None))
    finally:
        sim._build, FleetRouter.run, FleetRouter._kill = build, run, kill
        TelemetrySession.end_step = end_step
    launches, cluster = pda.launches, pda.cluster_launches
    shutil.rmtree(root, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"[serving-fleet] serve-sim invariants failed: {info['failures']}")
    warm, cold = info["router"], info["router_cold"]
    outs = info["outputs"]
    if sorted(o.status for o in outs) != ["finished"] * len(outs):
        raise AssertionError(f"[serving-fleet] statuses {[o.status for o in outs]}")
    captures = [{k: g.captures for k, g in e.graphs().items()} for e in built]
    if any(c != {"decode_step": 1, "prefill_chunk": 1} for c in captures):
        raise AssertionError(f"[serving-fleet] captures per replica {captures}")
    rec = info["session"].watchdog
    if rec.recompiles() or not {"serve:decode_step", "serve:prefill_chunk"} <= set(rec.records):
        raise AssertionError(f"[serving-fleet] watchdog {sorted(rec.records)}, "
                             f"{rec.recompiles()} recompiles")
    replays = sum(e.graphs()["decode_step"].replays for e in built)
    if launches != MODEL["n_layer"] * replays or cluster != launches:
        raise AssertionError(f"[serving-fleet] paged-decode launches {launches} (cluster "
                             f"{cluster}) != 48 x {replays} decode replays")
    if info["fleet_latency"] != info["single_stream_latency"]:
        raise AssertionError("[serving-fleet] merged fleet percentiles differ from the "
                             "single stream's")
    chunks = info["failover_compare"]["prefill_chunks"]
    # built: the pass's two replicas, then the warm replacement; then the cold pass's
    victim, successor = built[1], built[2]
    lat = info["fleet_latency"]
    tokens = sum(len(o.tokens) for o in outs)
    res = {"replicas": 2, "requests": len(outs), "kills": warm.kills_applied,
           "routed_tokens": tokens, "wall_s": {"warm": walls[0], "cold": walls[1]},
           "fleet_tok_s": {"warm": tokens / walls[0], "cold": tokens / walls[1]},
           "host_s_in": spent,
           "ttft_ms": [lat["ttft_ms_p50"], lat["ttft_ms_p99"]],
           "tpot_ms": [lat["tpot_ms_p50"], lat["tpot_ms_p99"]],
           "failover_save_s": victim.last_serve_save,
           "failover_load_s": successor.last_serve_load,
           "prefill_chunks": {"warm": list(warm.prefill_chunks),
                              "cold": list(cold.prefill_chunks), "totals": chunks},
           "decode_replays": replays, "paged_decode_launches": launches,
           "captures": captures, "capture_seconds": rec.compile_seconds(),
           "graph_pool_bytes": rec.peak_temp_bytes(),
           "goodput_fleet_fraction": info["goodput_fleet"]["goodput_fraction"]}
    log(f"[serving-fleet] {json.dumps(res)}")
    del info, warm, cold, built, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- training
def _flash_case(B, H, T, D, dtype, causal=True, bias=False, rate=0.0, offsets=(0, 0),
                seed=0):
    """(kernel, plain) results of one case on the same seeded inputs: each a
    list [out, lse, dq, dk, dv] from the forward and from the backward of
    sum(out * g) + sum(lse * g_lse). ``offsets``: the global positions of
    local q and k position 0 (the dropout hash and the causal mask)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((B, H, T, D), generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    g_lse = torch.randn((B, H, T), generator=gen, device="cuda")
    b = (torch.where(torch.rand((B, T), generator=gen, device="cuda") < 0.2, -1e4, 0.0)
         if bias else None)
    dseed = 1234 if rate else None

    def run(kernel):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        if kernel:   # the wrappers' core: kernels under the autograd Function
            out, lse = fa._attend(qs, ks, vs, causal, None, b, rate, dseed, *offsets)
        else:
            out, lse = fa.flash_attention_reference(qs, ks, vs, causal, bias=b,
                                                    dropout_rate=rate, dropout_seed=dseed,
                                                    q_offset=offsets[0], k_offset=offsets[1])
        ((out.float() * g.float()).sum() + (lse * g_lse).sum()).backward()
        return [t.detach().float() for t in (out, lse, qs.grad, ks.grad, vs.grad)]

    return run(True), run(False)


def phase_flash_kernels():
    """The three flash kernels against their plain version at the training
    path's shape and at edge cases; then times at the main shape."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    cases = [  # (B, H, T, D, dtype, causal, bias, rate[, (q_offset, k_offset)])
        (*FLASH_SHAPE, torch.bfloat16, True, False, 0.0),   # the main path
        (*PUBLISHED_FLASH_SHAPE, torch.bfloat16, True, False, 0.0),  # published config
        (2, 4, 200, 64, torch.bfloat16, True, False, 0.0),  # ragged tail
        (1, 1, 9000, 64, torch.bfloat16, True, False, 0.0), # past the TPU's VMEM cap
        (2, 4, 512, 128, torch.bfloat16, True, False, 0.0), # D = 128
        (2, 4, 256, 64, torch.float32, True, False, 0.0),
        (2, 4, 256, 64, torch.float16, True, False, 0.0),
        (2, 4, 384, 64, torch.bfloat16, False, True, 0.0),  # key bias, non-causal
        (16, 16, 512, 64, torch.bfloat16, False, True, 0.0),  # BERT-large's shape
        (2, 4, 256, 64, torch.float32, True, False, 0.1),   # dropout
        (2, 8, 1024, 64, torch.bfloat16, True, False, 0.1),   # dropout on the tensor cores
        (16, 16, 512, 64, torch.bfloat16, False, True, 0.5),  # BERT's shape, bias, dropout
        (2, 4, 384, 128, torch.float16, False, True, 0.0),  # fp16 D = 128 with bias
        (1, 2, 256, 256, torch.bfloat16, True, False, 0.0),  # bf16 past the shape rule
        (2, 4, 256, 32, torch.bfloat16, True, False, 0.0),  # D = 32: TMA's zero fill to 64
        (2, 4, 384, 32, torch.float16, False, True, 0.0),   # D = 32 with a key bias
        (2, 4, 512, 64, torch.bfloat16, False, False, 0.1, (128, 0)),   # offsets: the hash
        (2, 4, 512, 64, torch.bfloat16, True, False, 0.1, (256, 256)),  # equal, causal
    ]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for case in cases:
        tc_before = _tensor_core_launches()
        got, want = _flash_case(*case)
        torch.cuda.synchronize()
        ran = [a - b for a, b in zip(_tensor_core_launches(), tc_before)]
        if ran != [int(fa._tensor_core_path(case[4], case[3]))] * 3:
            raise AssertionError(f"flash {case}: tensor-core launches (fwd, dq, dk/dv) {ran} "
                                 "disagree with the shape rule")
        tol = FLASH_TOL[case[4]]
        errs = {}
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"flash {case}: non-finite {name}")
            errs[name] = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-6)
        log(f"[flash] {case}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (scaled by max |ref|, tol {tol})")
        if max(errs.values()) > tol:
            raise AssertionError(f"flash kernels vs plain, case {case}: {errs} > {tol}")
        if case == cases[0]:
            main = {n: (float((a - b).abs().max()), errs[n]) for n, a, b in
                    zip(("out", "lse", "dq", "dk", "dv"), got, want)}
        for kern, names in (("fwd", ("out", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            worst[kern] = max(worst[kern], *(errs[n] for n in names))
        del got, want
    torch.cuda.empty_cache()
    return time_flash(main, worst)


def _tensor_core_launches():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    return [fa.flash_attention_fwd.tensor_core_launches,
            fa.flash_attention_bwd_dq.tensor_core_launches,
            fa.flash_attention_bwd_dkv.tensor_core_launches]


def _cuda_core_entries(H, sm_scale):
    """The CUDA-core forward, dq and dk/dv entries called directly on bf16
    inputs that the shape rule sends to the tensor cores: the earlier design,
    timed beside its redesign on the same inputs (no launch counted)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    lib = fa._lib()

    def fwd(q, k, v):
        out, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=q.device)
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
                            lse.data_ptr(), *fa._tail(q, H, sm_scale, True, 0.0, None, 0, 0))
        if err:
            raise RuntimeError(f"flash_fwd: cudaError {err}")
        return out, lse

    def dq(q, k, v, do, lse, delta):
        out = torch.empty_like(q)
        err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), None, out.data_ptr(),
                               *fa._tail(q, H, sm_scale, True, 0.0, None, 0, 0))
        if err:
            raise RuntimeError(f"flash_bwd_dq: cudaError {err}")
        return out

    def dkv(q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), None, dk.data_ptr(),
                                dv.data_ptr(), *fa._tail(q, H, sm_scale, True, 0.0, None, 0, 0))
        if err:
            raise RuntimeError(f"flash_bwd_dkv: cudaError {err}")
        return dk, dv

    return fwd, dq, dkv


def time_flash(main_err, worst):
    """Device times at the main shape, inputs rotating over 4 sets (52 MB a
    set, beyond the 50 MB L2); the plain version and SDPA (forward, and its
    backward for both backward kernels) beside them, and the CUDA-core design
    of each kernel (the earlier design) on the same inputs."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    B, H, T, D = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    sets = []
    for _ in range(4):
        q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, sm_scale=D ** -0.5)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        sets.append((q, k, v, do, lse, delta))
    kw = dict(causal=True, sm_scale=D ** -0.5)
    ms = {
        "fwd": time_ms(lambda i: fa.flash_attention_fwd(*sets[i % 4][:3], **kw), 40),
        "dq": time_ms(lambda i: fa.flash_attention_bwd_dq(*sets[i % 4], **kw), 40),
        "dkv": time_ms(lambda i: fa.flash_attention_bwd_dkv(*sets[i % 4], **kw), 40),
    }
    fma_fwd, fma_dq, fma_dkv = _cuda_core_entries(H, D ** -0.5)
    q, k, v, do, lse, delta = sets[0]
    tc_outs = [*fa.flash_attention_fwd(q, k, v, **kw), fa.flash_attention_bwd_dq(*sets[0], **kw),
               *fa.flash_attention_bwd_dkv(*sets[0], **kw)]
    fma_outs = [*fma_fwd(q, k, v), fma_dq(*sets[0]), *fma_dkv(*sets[0])]
    designs_err = {n: _scaled_err(a.float(), b.float()) for n, a, b in
                   zip(("out", "lse", "dq", "dk", "dv"), tc_outs, fma_outs)}
    del tc_outs, fma_outs
    if max(designs_err.values()) > FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"tensor-core vs CUDA-core flash outputs: {designs_err}")
    earlier = {"fwd": time_ms(lambda i: fma_fwd(*sets[i % 4][:3]), 20),
               "dq": time_ms(lambda i: fma_dq(*sets[i % 4]), 20),
               "dkv": time_ms(lambda i: fma_dkv(*sets[i % 4]), 20)}
    log(f"[flash] the CUDA-core design on the same inputs: fwd {earlier['fwd']!r} ms, "
        f"dq {earlier['dq']!r} ms, dk/dv {earlier['dkv']!r} ms; tensor-core vs CUDA-core "
        f"outputs (scaled by max |value|): "
        + ", ".join(f"{n} {e:.2e}" for n, e in designs_err.items()))

    def fwd_bwd(fn):
        """(forward ms, backward ms) of fn(q, k, v): the backward is the
        whole of dq, dk and dv from one saved graph per input set."""
        fwd = time_ms(lambda i: fn(*sets[i % 4][:3]), 8)
        graphs = []
        for q, k, v, do, _, _ in sets:
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            graphs.append((fn(*qkv), qkv, do))
        bwd = time_ms(lambda i: torch.autograd.grad(
            graphs[i % 4][0], graphs[i % 4][1], graphs[i % 4][2], retain_graph=True), 8)
        return fwd, bwd

    plain_fwd, plain_bwd = fwd_bwd(
        lambda q, k, v: fa.flash_attention_reference(q, k, v, True)[0])
    sdpa_fwd, sdpa_bwd = fwd_bwd(
        lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    del sets
    torch.cuda.empty_cache()

    mm = B * H * T * T * D          # 2 * B*H*T^2*D / 2 flops per causal matmul
    tensor = B * H * T * D * 2      # one bf16 [B, H, T, D]
    row = B * H * T * 4             # one float32 [B, H, T]
    work = {"fwd": (2 * mm, 3 * tensor + tensor + row),
            "dq": (3 * mm, 4 * tensor + 2 * row + tensor),
            "dkv": (4 * mm, 4 * tensor + 2 * row + 2 * tensor)}
    entries = []
    for name, body, line, plain, lib, outs, design in (
            ("fwd", "_fwd_kernel", 132, plain_fwd, sdpa_fwd, ("out", "lse"), "wgmma"),
            ("dq", "_bwd_dq_kernel", 289, plain_bwd, sdpa_bwd, ("dq",), "wgmma"),
            ("dkv", "_bwd_dkv_kernel", 352, plain_bwd, sdpa_bwd, ("dk", "dv"), "wgmma")):
        flops, nbytes = work[name]
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        # max_abs_err: absolute, at the main shape; scaled_err and tol: the
        # error over max |ref|, the main shape's and the worst case's
        e = {"name": f"flash_attention_{name}", "route": "cuda", "design": design,
             "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
             "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}:{body}",
             "launches": None, "max_abs_err": max(main_err[n][0] for n in outs),
             "scaled_err": max(main_err[n][1] for n in outs),
             "worst_scaled_err": worst[name], "tol": FLASH_TOL[torch.bfloat16],
             "kernel_ms": ms[name], "ms": ms[name], "tflop_s": flops / ms[name] / 1e9,
             "fma_ms": earlier[name],        # the CUDA-core design, same inputs
             "plain_ms": plain, "library_ms": lib,
             "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"[flash] {json.dumps(e)}")
        entries.append(e)
    return entries


def _layer_grad_norms(model):
    """float32 grad norm of each block, then of the embeddings and ln_f."""
    groups = [list(b.parameters()) for b in model.blocks]
    groups.append([model.wte, model.wpe, *model.ln_f.parameters()])
    return torch.stack([torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in g))
                        for g in groups]).cpu()


def _plain_loss_backward(model, tokens, labels):
    """The training loss through the plain attention path, each block under
    non-reentrant checkpointing so that only one block's [T, T] scores live
    in the backward; backward run. A flash or fused-block model takes its
    unfused dense attention branch; a sparse model its layout through
    ``dense_blocksparse_attention`` (the JAX package's dense-masked oracle) in
    place of the kernels."""
    from torch.utils.checkpoint import checkpoint
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.block_sparse_attention import dense_blocksparse_attention
    cfg = model.config
    model.config = dataclasses.replace(cfg, use_flash_attention=False, fused_block=False)
    kernel_path = gpt2.block_sparse_attention
    gpt2.block_sparse_attention = dense_blocksparse_attention
    try:
        p = model.params_tree()
        x = model._embed(p, tokens)
        for bp in p["blocks"]:
            x = checkpoint(model._block, x, bp, use_reentrant=False)
        x = model._layer_norm(x, p["ln_f"], cfg.layer_norm_epsilon)
        loss = model._chunked_ce(x, p["wte"], labels.long(), cfg.loss_chunk)
        loss.backward()
    finally:
        model.config = cfg
        gpt2.block_sparse_attention = kernel_path
    return loss.detach()


def _kernel_vs_plain(model, tokens, labels):
    """(loss, per-layer grad norms) of the kernel path and the plain path of
    one micro-batch through ``model``'s own parameters; grads cleared."""
    loss_k = model(tokens, labels)
    loss_k.backward()
    loss_k = loss_k.detach()
    norms_k = _layer_grad_norms(model)
    model.zero_grad(set_to_none=True)
    loss_p = _plain_loss_backward(model, tokens, labels)
    norms_p = _layer_grad_norms(model)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return (loss_k.item(), loss_p.item(), float(((norms_k - norms_p).abs() / norms_p).max()))


def phase_training():
    """GPT-2 1.5B through deepspeed_tpu_torch.initialize on the card."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.ops import flash_attention as fa

    # the same check in float32 at a cut depth, where only summation order differs
    cfg32 = GPT2Config(**dict(TRAIN_MODEL, n_layer=4), compute_dtype=torch.float32)
    m32 = GPT2Model(cfg32)
    m32.init(torch.Generator(device="cuda").manual_seed(0))
    tokens, labels = _train_batch(cfg32.vocab_size)
    mb = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    l32k, l32p, n32 = _kernel_vs_plain(m32, tokens[:mb], labels[:mb])
    log(f"[train] float32 4 layers, kernel vs plain: loss {l32k!r} vs {l32p!r}, "
        f"per-layer grad norms max rel diff {n32!r} (tol {TRAIN_TOL_F32})")
    if abs(l32k - l32p) > TRAIN_TOL_F32 * abs(l32p) or n32 > TRAIN_TOL_F32:
        raise AssertionError("float32 kernel path disagrees with the plain path")
    del m32
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = GPT2Config(**TRAIN_MODEL)
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=TRAIN_CONFIG)
    torch.cuda.synchronize()
    log(f"[train] GPT-2 {n_params / 1e9:.3f}B + engine built in "
        f"{time.perf_counter() - t0:.2f} s; grad dtype {engine._grad_dtype}, "
        f"accumulator {engine._acc_dtype}")

    lk, lp, nrel = _kernel_vs_plain(engine.module, tokens[:mb], labels[:mb])
    log(f"[train] bf16 48 layers, first micro-batch kernel vs plain: loss {lk!r} vs {lp!r}, "
        f"per-layer grad norms max rel diff {nrel!r} (tol {TRAIN_TOL_BF16})")
    if abs(lk - lp) > TRAIN_TOL_BF16[0] or nrel > TRAIN_TOL_BF16[1]:
        raise AssertionError("bf16 kernel path disagrees with the plain path")
    torch.cuda.empty_cache()

    gas = engine.gradient_accumulation_steps()
    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for f in launchers:
        f.launches = f.tensor_core_launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        window = []
        for m in range(gas):
            loss = engine(tokens[m * mb:(m + 1) * mb], labels[m * mb:(m + 1) * mb])
            engine.backward(loss)
            engine.step()
            window.append(loss.detach())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(torch.stack(window).mean()))
    launches = [f.launches for f in launchers]
    micro = TRAIN_STEPS * gas
    log(f"[train] step losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and decreasing: {losses}")
    if launches != [cfg.n_layer * micro] * 3:
        raise AssertionError(f"flash launches {launches} != {cfg.n_layer} x {micro} "
                             "micro-steps each")
    if _tensor_core_launches() != launches:
        raise AssertionError(f"tensor-core launches (fwd, dq, dk/dv) {_tensor_core_launches()}: "
                             f"not every launch of {launches} ran the tensor cores")
    step = statistics.median(step_s[2:])
    tok_s = TRAIN_CONFIG["train_batch_size"] * cfg.n_positions / step
    res = {"steps": TRAIN_STEPS, "micro_steps": micro, "loss_first": losses[0],
           "loss_last": losses[-1], "step_ms_median": step * 1e3,
           "step_ms_all": [s * 1e3 for s in step_s], "tokens_per_s": tok_s,
           "params": n_params, "mfu": tok_s * 6 * n_params / BF16_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flash_launches": launches, "tensor_core_launches": _tensor_core_launches(),
           "first_micro_loss_kernel": lk,
           "first_micro_loss_plain": lp, "grad_norm_max_rel_diff": nrel,
           "f32_4_layer": [l32k, l32p, n32],
           "tol_bf16": list(TRAIN_TOL_BF16), "tol_f32": TRAIN_TOL_F32}
    log(f"[train] {json.dumps(res)}")
    profile_training(engine, tokens, labels)
    del engine, model
    torch.cuda.empty_cache()
    return launches


def _train_batch(vocab):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab, size=(TRAIN_CONFIG["train_batch_size"],
                                         TRAIN_MODEL["n_positions"]))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    return (torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda())


def profile_training(engine, tokens, labels):
    """Where the time goes: one optimizer step under torch.profiler;
    device-busy share and top kernels."""
    from torch.profiler import ProfilerActivity
    mb = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for m in range(engine.gradient_accumulation_steps()):
            engine.backward(engine(tokens[m * mb:(m + 1) * mb], labels[m * mb:(m + 1) * mb]))
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile-train] window {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / wall_us:.3f} of the window)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        log(f"[profile-train] {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
            f"{e.key[:90]}")


# --------------------------------------------- the main path's published config
# bench.py:391-420 bench_1p5b_engine, nothing cut: remat "dots", batch 8 in one
# micro-step, flash attention, loss_chunk 128, bf16, ZeRO-2 with the
# external-master client pair of bench.py:354-388 at dp 32
PUBLISHED_MODEL = dict(MODEL, remat=True, remat_policy="dots", use_flash_attention=True,
                       loss_chunk=128)
PUBLISHED_CONFIG = {"train_batch_size": 8, "steps_per_print": 1000, "bf16": {"enabled": True},
                    "zero_optimization": {"stage": 2}, "zero_allow_untested_optimizer": True}
PUBLISHED_STEPS = 12
# remat against no remat on one micro-batch: the recompute runs the same
# kernels on the same inputs, so only a reordered sum could differ
REMAT_TOL = 1e-3
REMAT_COMPARE_BATCH = 8         # the no-remat run at batch 8 fits the card


def _published_batch(vocab):
    """bench.py:423-425: tokens from np.random.default_rng(0), labels rolled."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(PUBLISHED_CONFIG["train_batch_size"],
                                          MODEL["n_positions"])).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()


def _loss_and_norms(model, tokens, labels):
    """(loss, per-layer grad norms) of one forward + backward; grads cleared."""
    loss = model(tokens, labels)
    loss.backward()
    norms = _layer_grad_norms(model)
    model.zero_grad(set_to_none=True)
    return loss.detach(), norms


def _flash_counts():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    return [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)]


def _zero_flash_counts():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        f.launches = f.tensor_core_launches = 0


def _cut_model(n_layer, **over):
    """GPT-2 at the published widths and n_layer layers, bf16 parameters as
    the engine holds them."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**dict(PUBLISHED_MODEL, n_layer=n_layer, **over)))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model.to(torch.bfloat16)


def remat_policy_checks(tokens, labels):
    """At 4 layers: "dots+attn" keeps the flash op's (out, lse), so the
    forward kernel runs once a layer; cpu_checkpointing moves the block
    inputs to pinned host memory: the grads equal the device-resident full
    remat's and the peak device memory is lower."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    out = {}
    for policy, fwd in (("dots", 8), ("dots+attn", 4)):
        model = _cut_model(4, remat_policy=policy)
        _zero_flash_counts()
        _loss_and_norms(model, tokens, labels)
        counts = _flash_counts()
        out[policy] = counts
        log(f"[train-published] 4 layers, remat {policy!r}: flash launches (fwd, dq, dk/dv) "
            f"{counts}")
        if counts != [fwd, 4, 4]:
            raise AssertionError(f"remat {policy!r} at 4 layers: flash launches {counts} != "
                                 f"[{fwd}, 4, 4]")
        del model
    model = _cut_model(4, remat_policy=None)
    runs = {}
    for offload in (False, True):
        checkpointing.reset()
        checkpointing.configure(checkpoint_in_cpu=offload)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, norms = _loss_and_norms(model, tokens, labels)
        torch.cuda.synchronize()
        runs[offload] = (loss.item(), norms, torch.cuda.max_memory_allocated() - base)
    checkpointing.reset()
    (l_dev, n_dev, peak_dev), (l_cpu, n_cpu, peak_cpu) = runs[False], runs[True]
    rel = float(((n_cpu - n_dev).abs() / n_dev).max())
    out["cpu_checkpointing"] = {"loss": [l_dev, l_cpu], "grad_norm_max_rel_diff": rel,
                                "bit_identical": l_dev == l_cpu and bool(torch.equal(n_dev, n_cpu)),
                                "peak_gb_device_resident": peak_dev / 1e9,
                                "peak_gb_offloaded": peak_cpu / 1e9}
    log(f"[train-published] 4 layers, cpu_checkpointing: {json.dumps(out['cpu_checkpointing'])}")
    if l_cpu != l_dev or rel > REMAT_TOL:
        raise AssertionError("cpu_checkpointing changed the loss or the grads")
    if not peak_cpu < peak_dev:
        raise AssertionError(f"cpu_checkpointing did not lower the peak device memory "
                             f"({peak_cpu} vs {peak_dev} bytes)")
    del model
    torch.cuda.empty_cache()
    return out


def phase_train_published():
    """GPT-2 1.5B at bench.py:391-420 through deepspeed_tpu_torch.initialize:
    remat "dots", batch 8, the external-master client pair, 12 steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer

    tokens, labels = _published_batch(MODEL["vocab_size"])
    policy_checks = remat_policy_checks(tokens, labels)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cfg = GPT2Config(**PUBLISHED_MODEL)
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, optimizer=shard_optimizer(32),
                                                     config_params=PUBLISHED_CONFIG)
    if engine._master is not None:
        raise AssertionError("the external-master pair left a float32 master in the engine")
    if not engine._fused:
        raise AssertionError("the external-master pair at gas 1 did not take the fused step")
    params0 = [p.detach().clone() for p in list(model.parameters())[:4]]
    _zero_flash_counts()
    losses, step_s, m1, syncs, norms = [], [], [], [], []
    for _ in range(PUBLISHED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, n = _count_syncs(lambda: _engine_step(engine, tokens, labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        syncs.append(n)
        m1.append(engine.opt_state["m1"].norm().item())
        norms.append(float(engine._last_grad_norm))
    PUBLISHED.update(losses=losses, step_s=step_s, syncs=syncs, norms=norms)
    launches = _flash_counts()
    tc = _tensor_core_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"[train-published] losses {losses} (fused step); |m1| {m1}")
    if not all(np.isfinite(losses)) or len(set(losses)) != 1:
        raise AssertionError(f"losses not finite and constant (the pair never changes the "
                             f"params): {losses}")
    if not all(m > 0 for m in m1) or len(set(m1)) != len(m1):
        raise AssertionError(f"the client state's m1 is zero or did not change each step: {m1}")
    if not all(torch.equal(a, b.detach()) for a, b in zip(params0, model.parameters())):
        raise AssertionError("the params changed under an external-master pair")
    want = [2 * cfg.n_layer * PUBLISHED_STEPS, cfg.n_layer * PUBLISHED_STEPS,
            cfg.n_layer * PUBLISHED_STEPS]
    if launches != want or tc != want:
        raise AssertionError(f"flash launches {launches} (tensor cores {tc}) != {want}: "
                             "remat 'dots' replays the forward once a layer")
    step = statistics.median(step_s[2:])
    tok_s = PUBLISHED_CONFIG["train_batch_size"] * cfg.n_positions / step
    busy = profile_step("profile-published", engine, tokens, labels, top=20)
    published_rotation_check(engine, tokens, labels)

    # the published path (remat "dots", batch 8) against the plain attention path
    torch.cuda.empty_cache()
    lk, lp, nrel = _kernel_vs_plain(model, tokens, labels)
    log(f"[train-published] batch 8 under remat 'dots', kernel vs plain: loss {lk!r} vs "
        f"{lp!r}, per-layer grad norms max rel diff {nrel!r} (tol {TRAIN_TOL_BF16})")
    if abs(lk - lp) > TRAIN_TOL_BF16[0] or nrel > TRAIN_TOL_BF16[1]:
        raise AssertionError("the published path disagrees with the plain path")

    # remat against no remat on the same micro-batch and params
    mb = REMAT_COMPARE_BATCH
    torch.cuda.empty_cache()
    loss_r, norms_r = _loss_and_norms(model, tokens[:mb], labels[:mb])
    model.config = dataclasses.replace(cfg, remat=False)
    torch.cuda.reset_peak_memory_stats()
    loss_n, norms_n = _loss_and_norms(model, tokens[:mb], labels[:mb])
    peak_no_remat = torch.cuda.max_memory_allocated()
    model.config = cfg
    rel = float(((norms_r - norms_n).abs() / norms_n).max())
    bitwise = bool(loss_r.item() == loss_n.item() and torch.equal(norms_r, norms_n))
    log(f"[train-published] batch {mb}, remat 'dots' vs none: loss {loss_r.item()!r} vs "
        f"{loss_n.item()!r}, 49 per-layer grad norms max rel diff {rel!r} (tol {REMAT_TOL}); "
        f"bit-identical: {bitwise}")
    if loss_r.item() != loss_n.item() or rel > REMAT_TOL:
        raise AssertionError("remat changed the loss or the grads")
    res = {"steps": PUBLISHED_STEPS, "loss": losses[0], "m1_norm": m1,
           "step_ms_median": step * 1e3, "step_ms_all": [t * 1e3 for t in step_s],
           "tokens_per_s": tok_s, "params": n_params, "mfu": tok_s * 6 * n_params / BF16_FLOPS,
           "max_memory_allocated_gb": peak / 1e9,
           "no_remat_batch8_peak_gb": peak_no_remat / 1e9, "device_busy_share": busy,
           "kernel_vs_plain": {"loss": [lk, lp], "grad_norm_max_rel_diff": nrel,
                               "tol": list(TRAIN_TOL_BF16)},
           "flash_launches": launches, "tensor_core_launches": tc,
           "remat_vs_none": {"batch": mb, "loss": [loss_r.item(), loss_n.item()],
                             "grad_norm_max_rel_diff": rel, "bit_identical": bitwise},
           "policies_4_layers": policy_checks}
    log(f"[train-published] {json.dumps(res)}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    published_fused_vs_two_step(tokens, labels)
    return launches


# --------------------------------------------------------- training telemetry
TELEMETRY_STEPS = 8
TELEMETRY_TRACE = (3, 5)        # the profiler window: steps 3 and 4
# the Train/* scalars the JAX engine emits for the published config (bf16:
# no loss_scale)
TELEMETRY_TRAIN_SCALARS = {"Train/Samples/train_loss", "Train/Samples/lr",
                           "Train/Samples/grad_norm"}
PUBLISHED = {}                  # [train-published]'s losses, step times, syncs


def _count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its result,
    the synchronizing calls it made)."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def _engine_step(engine, tokens, labels):
    """One step and its loss on the host: the engine's own fetch with
    telemetry on, ``.item()`` without."""
    loss = engine(tokens, labels)
    engine.backward(loss)
    engine.step()
    if engine.telemetry is not None:
        return engine.telemetry.last_losses[-1]
    return loss.item()


def _trace_kernels(path, name):
    """Kernel events of a Chrome trace whose name holds ``name``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))


def phase_train_telemetry():
    """The published config with every observatory of the telemetry block
    on: a 2-step profiler window, the metric catalog, the default alert
    rules, the goodput ledger, the cluster monitor at world 1 with a hang
    deadline, and the tensorboard monitor's JSONL, for 8 steps. Returns the
    flash launches of the run."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer

    tokens, labels = _published_batch(MODEL["vocab_size"])
    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    cfg = GPT2Config(**PUBLISHED_MODEL)
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count()
    config = dict(PUBLISHED_CONFIG,
                  tensorboard={"enabled": True, "output_path": root, "job_name": "tb"},
                  telemetry={"enabled": True, "peak_tflops": BF16_FLOPS / 1e12,
                             "trace_dir": os.path.join(root, "trace"),
                             "trace_steps": list(TELEMETRY_TRACE),
                             "metrics": {"enabled": True}, "alerts": {"enabled": True},
                             "goodput": {"enabled": True, "ledger_dir": root},
                             "cluster": {"enabled": True, "hang_deadline_s": 300.0,
                                         "dump_dir": root}})
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, optimizer=shard_optimizer(32),
                                                     config_params=config)
    tel = engine.telemetry
    _zero_flash_counts()
    losses, step_s, syncs, window = [], [], [], 0
    for step in range(TELEMETRY_STEPS):
        if step in TELEMETRY_TRACE:
            window = _flash_counts()[0] - window
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, n = _count_syncs(lambda: _engine_step(engine, tokens, labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        syncs.append(n)
    launches = _flash_counts()
    want = PUBLISHED["losses"][:TELEMETRY_STEPS]
    log(f"[train-telemetry] losses {losses}; synchronizing calls a step {syncs} "
        f"(telemetry off: {PUBLISHED['syncs'][:TELEMETRY_STEPS]})")
    if losses != want:
        raise AssertionError(f"telemetry changed the losses: {losses} != {want}")
    if any(a > b for a, b in zip(syncs, PUBLISHED["syncs"])):
        raise AssertionError("telemetry added synchronizing calls to a step")
    in_trace = _trace_kernels(tel.trace_path, "flash_fwd_tc_kernel")
    steps_traced = TELEMETRY_TRACE[1] - TELEMETRY_TRACE[0]
    if in_trace != window or window != 2 * cfg.n_layer * steps_traced:
        raise AssertionError(f"the trace holds {in_trace} flash_fwd_tc kernels, the counter "
                             f"moved {window} in the window (want {2 * cfg.n_layer} a step)")
    records = {k: sorted(r.count for r in v.values()) for k, v in tel.watchdog.records.items()}
    if records != {"fused_step": [1]} or tel.watchdog.recompiles():
        raise AssertionError(f"watchdog records {records}")
    fired = tel.alert_engine.fired
    if fired:
        raise AssertionError(f"alerts fired on a healthy run: {fired}")
    with open(os.path.join(root, "tb", "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    train = {t for t in tags if t.startswith("Train/")}
    if train != TELEMETRY_TRAIN_SCALARS:
        raise AssertionError(f"Train/* scalars {sorted(train)}")
    step = statistics.median(step_s[2:])
    untraced = [t for i, t in enumerate(step_s[2:], 2) if not
                TELEMETRY_TRACE[0] <= i < TELEMETRY_TRACE[1]]
    tok_s = PUBLISHED_CONFIG["train_batch_size"] * cfg.n_positions / step
    gp = engine._goodput.summary()
    first = tel.watchdog.records["fused_step"]
    res = {"steps": TELEMETRY_STEPS, "step_ms_median": step * 1e3,
           "step_ms_median_untraced": statistics.median(untraced) * 1e3,
           "published_step_ms_median": statistics.median(PUBLISHED["step_s"][2:]) * 1e3,
           "step_ms_all": [t * 1e3 for t in step_s],
           "session_mfu": tel.last_mfu, "mfu_6n": tok_s * 6 * n_params / BF16_FLOPS,
           "session_flops_per_step": next(iter(first.values())).flops,
           "flops_6n_per_step": 6 * n_params * PUBLISHED_CONFIG["train_batch_size"]
           * cfg.n_positions,
           "first_call_s": tel.watchdog.compile_seconds(),
           "goodput": {"fraction": gp["goodput_fraction"],
                       "class_seconds": gp["class_seconds"]},
           "syncs_per_step": syncs, "flash_launches": launches,
           "trace_flash_fwd_kernels": in_trace, "scalars": len(tags),
           "summary": tel.summary()}
    log(f"[train-telemetry] {json.dumps(res)}")
    engine._cluster.stop()
    tel.close()
    shutil.rmtree(root, ignore_errors=True)
    del engine, model, tel
    gc.collect()
    torch.cuda.empty_cache()
    return launches

# --------------------------------------------------- device-facing observatories
OBS_STEPS = 8
OBS_TRACE = (3, 5)              # the profiler window: steps 3 and 4
OBS_AUDIT_INTERVAL = 4
OBS_NORM_TOL = 1e-5             # sentinel sum of squares vs the engine's norm^2
FLASH_TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")


def phase_train_observatories():
    """The published config with the numerics sentinel (depth 1, a desync
    audit every 4 steps) and the device-facing telemetry blocks (the
    anatomy at the H100's data-sheet roofline, the profile ingest of a
    2-step trace window, the memory manifest) on, for 8 steps: the losses
    bit for bit ``[train-published]``'s and as many synchronizing calls a
    step; the sentinel's sums of squares against ``[train-published]``'s
    norm, its nonfinite counts 0, the audit at world 1, a manual trigger's
    bundle read back; the manifest against the engine's tensors, the model
    and the allocator; the trace's flash kernels against the launch
    counters; the anatomy's floor under the measured step; the counted
    flops a step against the formula, flash backward included. Returns the
    flash launches of the run."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer
    from deepspeed_tpu_torch.utils import hbm
    from deepspeed_tpu_torch.utils.flops_profiler import format_report, gpt2_train_flops
    from deepspeed_tpu_torch.utils.numerics import scan_dump_dir
    from deepspeed_tpu_torch.utils.profile_ingest import (catalog_from_watchdog, kernel_counts,
                                                          reconcile_profile)

    tokens, labels = _published_batch(MODEL["vocab_size"])
    root = tempfile.mkdtemp(prefix="chip_smoke_observatories_")
    dump_dir = tempfile.mkdtemp(prefix="chip_smoke_numerics_")
    cfg = GPT2Config(**PUBLISHED_MODEL)
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count()
    batch = PUBLISHED_CONFIG["train_batch_size"]
    # stated before the run: the formula at the published shapes, the
    # flash backward's five products included (PERF.md, PR 17)
    want_flops = gpt2_train_flops(cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.vocab_size,
                                  cfg.n_positions, batch, remat="dots", flash=True)
    want_bwd = 10 * batch * cfg.n_head * cfg.n_positions ** 2 * cfg.head_dim * cfg.n_layer
    config = dict(PUBLISHED_CONFIG,
                  numerics={"enabled": True, "subtree_depth": 1,
                            "audit_interval": OBS_AUDIT_INTERVAL, "dump_dir": dump_dir},
                  telemetry={"enabled": True, "output_path": root, "job_name": "tel",
                             "trace_dir": os.path.join(root, "trace"),
                             "trace_steps": list(OBS_TRACE),
                             "anatomy": {"enabled": True, "chip": "h100-sxm"},
                             "profile": {"enabled": True}, "hbm": {"enabled": True}})
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, optimizer=shard_optimizer(32),
                                                     config_params=config)
    tel, num = engine.telemetry, engine._numerics
    _zero_flash_counts()
    losses, step_s, syncs, records, anatomy, window = [], [], [], [], [], None
    for step in range(OBS_STEPS):
        if step == OBS_TRACE[0]:
            window = _flash_counts()
        if step == OBS_TRACE[1]:
            window = [a - b for a, b in zip(_flash_counts(), window)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, n = _count_syncs(lambda: _engine_step(engine, tokens, labels))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        syncs.append(n)
        records.append(num.last_record)
        anatomy.append(tel.last_anatomy)
    launches, tc = _flash_counts(), _tensor_core_launches()
    log(f"[train-observatories] losses {losses}; synchronizing calls a step {syncs} "
        f"(numerics and telemetry off: {PUBLISHED['syncs'][:OBS_STEPS]})")
    if losses != PUBLISHED["losses"][:OBS_STEPS]:
        raise AssertionError("the observatories changed the losses")
    if syncs != PUBLISHED["syncs"][:OBS_STEPS]:
        raise AssertionError("the observatories changed the synchronizing calls a step")
    want = [2 * cfg.n_layer * OBS_STEPS, cfg.n_layer * OBS_STEPS, cfg.n_layer * OBS_STEPS]
    if launches != want or tc != want:
        raise AssertionError(f"flash launches {launches} (tensor cores {tc}) != {want}")

    # the sentinel
    rel = [abs(sum(g * g for g in r["grad_norm_per_subtree"]) - n_ref ** 2) / n_ref ** 2
           for r, n_ref in zip(records, PUBLISHED["norms"])]
    audit = num.summary()
    log(f"[train-observatories] sentinel: subtrees {records[-1]['subtrees']}, grad norms "
        f"{records[-1]['grad_norm_per_subtree']}; sum of squares vs [train-published]'s "
        f"norm^2, max rel diff {max(rel)!r} (tol {OBS_NORM_TOL}); nonfinite "
        f"{[r['nonfinite_total'] for r in records]}; {json.dumps(audit)}")
    if max(rel) > OBS_NORM_TOL or any(r["nonfinite_total"] for r in records):
        raise AssertionError("the sentinel disagrees with the norm, or counted nonfinite")
    if audit["audit_runs"] != OBS_STEPS // OBS_AUDIT_INTERVAL or audit["desync"]:
        raise AssertionError(f"the desync audit: {audit}")
    path = num.recorder.trigger("manual", {"phase": "train-observatories"})
    bundle = scan_dump_dir(dump_dir)
    if path is None or bundle is None or bundle["reason"] != "manual" \
            or len(bundle["steps"]) != OBS_STEPS or "allocator" not in bundle.get("hbm", {}):
        raise AssertionError(f"the manual dump {path} did not read back whole")
    log(f"[train-observatories] manual dump {os.path.basename(path)}: {len(bundle['steps'])} "
        f"steps, hbm {json.dumps(bundle['hbm'])}")

    # the memory manifest
    manifest = engine.memory_manifest()
    _, class_bytes = hbm.manifest_signatures(manifest)
    live = hbm.measure_classes(manifest)
    report = hbm.engine_report(engine)
    allocated = torch.cuda.memory_allocated()
    log(f"[train-observatories] memory manifest {json.dumps(class_bytes)}; live "
        f"{json.dumps(live)}; reconcile {json.dumps(report['classes'])}; "
        f"memory_allocated {allocated}")
    if live != class_bytes or not report["reconciled"] or sum(class_bytes.values()) > allocated:
        raise AssertionError("the memory manifest disagrees with the tensors, the model or "
                             "the allocator")

    # the profile ingest
    prof = tel.last_profile
    traced = kernel_counts(prof["slice_names"], FLASH_TC_KERNELS)
    classes = prof["reconcile"]["classes"]
    rec = reconcile_profile(prof, catalog_from_watchdog(tel.watchdog), {
        "flops_per_step": classes["compute"]["derived_flops_per_step"],
        "wire_ici_per_step": 0, "wire_dcn_per_step": 0,
        "step_wall_ms": classes["step_wall"].get("derived_step_wall_ms")},
        kernels=dict(zip(FLASH_TC_KERNELS, window)))
    log(f"[train-observatories] trace: flash kernels {traced}, counters {window}; "
        f"reconcile {json.dumps(classes)}, kernels "
        f"{json.dumps(rec['classes']['kernels'])}; summary {json.dumps(tel.summary())}")
    if list(traced.values()) != window or not rec["ok"]:
        raise AssertionError("the trace's kernels or the profile's classes disagree")

    # the anatomy and the flop count
    first = next(iter(tel.watchdog.records["fused_step"].values()))
    bwd = sum(v for k, v in first.flops_by_op.items() if "flash_bwd" in k)
    floors = [(a["predicted_floor_s"], a["measured_s"]) for a in anatomy if a is not None]
    step = statistics.median(step_s[2:])
    tok_s = batch * cfg.n_positions / step
    log(f"[train-observatories] flops a step {first.flops:.0f} (stated {want_flops}; flash "
        f"backward {bwd:.0f}, stated {want_bwd}); session MFU {tel.last_mfu!r} against 6N's "
        f"{tok_s * 6 * n_params / BF16_FLOPS!r}; anatomy floor vs measured s {floors}")
    if first.flops != want_flops or bwd != want_bwd:
        raise AssertionError("the counted flops a step differ from the formula")
    if not floors or any(f > m for f, m in floors):
        raise AssertionError("the anatomy's floor lies above the measured step")
    if any(a["exposed_s"]["ici"] for a in prof.get("anatomy", [])):
        raise AssertionError("exposed collective time at world 1")
    profile = engine.flops_profile(tokens, labels, peak_tflops=BF16_FLOPS / 1e12)
    log("[train-observatories] flops_profile of the step:\n" + format_report(profile))
    res = {"steps": OBS_STEPS, "step_ms_median": step * 1e3,
           "published_step_ms_median": statistics.median(PUBLISHED["step_s"][2:]) * 1e3,
           "step_ms_all": [t * 1e3 for t in step_s], "syncs_per_step": syncs,
           "flops_per_step": first.flops, "flops_stated": want_flops,
           "flash_bwd_flops": bwd, "hbm_bytes_per_step": first.hbm_bytes,
           "session_mfu": tel.last_mfu, "mfu_6n": tok_s * 6 * n_params / BF16_FLOPS,
           "anatomy": tel.summary()["anatomy"], "profile": tel.summary()["profile"],
           "memory": class_bytes, "audit": audit, "flash_launches": launches,
           "trace_flash_kernels": traced,
           "flops_profile": {k: profile[k] for k in ("flops", "bytes_accessed",
                                                      "temp_bytes", "optimal_seconds")}}
    log(f"[train-observatories] {json.dumps(res)}")
    tel.close()
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(dump_dir, ignore_errors=True)
    del engine, model, tel, num
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- FP16_Optimizer loop
FP16_OPT_MODEL = dict(MODEL, use_flash_attention=True, remat=False, loss_chunk=128,
                      compute_dtype=torch.float16)
FP16_OPT_BATCH = 2
FP16_OPT_STEPS = 16
FP16_OPT_SCALE_POWER = 24
FP16_OPT = dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, clip_grad=1.0,
                initial_scale_power=FP16_OPT_SCALE_POWER, hysteresis=2)
FP16_OPT_TOL = 2e-3             # loss, custom loop vs initialize's engine


def _fp16_opt_model():
    """GPT-2 1.5B widths in fp16, seed 0, its weights rounded to fp16 (the
    float32 master both sides start from)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**FP16_OPT_MODEL))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model.to(torch.float16)


def phase_fp16_optimizer():
    """``FP16_Optimizer("adamw")`` in a custom loop (no ``initialize``) on
    GPT-2 at the 1.5B widths in fp16, micro-batch 2 x 1024, clip 1.0, from a
    loss scale of 2^24, for 16 steps: each skipped step leaves the master
    bit for bit, the scale falls by the hysteresis rule, the clean steps'
    losses are finite and falling, the flash kernels run once a layer a
    step on the tensor cores; the losses within 2e-3 of ``initialize``'s
    fp16 engine (ZeRO 0, the same AdamW, scaler and clip) with the same
    steps skipped. Returns the flash launches of the loop."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.fp16 import FP16_Optimizer
    from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls

    tokens, labels = _published_batch(MODEL["vocab_size"])
    tokens, labels = tokens[:FP16_OPT_BATCH], labels[:FP16_OPT_BATCH]
    model = _fp16_opt_model()
    torch.cuda.reset_peak_memory_stats()
    opt = FP16_Optimizer(model.parameters(), optimizer="adamw", **FP16_OPT)
    _zero_flash_counts()
    rows, step_s = [], []
    shadow = ls.init_state(0, FP16_OPT_SCALE_POWER, FP16_OPT["hysteresis"])
    for step in range(FP16_OPT_STEPS):
        before = [m.clone() for m in opt.master]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = opt.backward(model(tokens, labels))
        overflow = opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        shadow = ls.update(shadow, overflow, dynamic=True, hysteresis=FP16_OPT["hysteresis"])
        unchanged = all(torch.equal(a, b) for a, b in zip(before, opt.master))
        del before
        rows.append({"step": step + 1, "loss": loss.item(), "overflow": overflow,
                     "scale": opt.cur_scale, "master_unchanged": unchanged})
        if unchanged != overflow or opt.cur_scale != shadow.cur_scale:
            raise AssertionError(f"fp16-optimizer step {step + 1}: {rows[-1]}, the scaler "
                                 f"rule says {shadow.cur_scale}")
    launches, tc = _flash_counts(), _tensor_core_launches()
    peak = torch.cuda.max_memory_allocated()
    clean = [r["loss"] for r in rows if not r["overflow"]]
    journal = list(opt.journal.events)
    log(f"[fp16-optimizer] {json.dumps(rows)}")
    log(f"[fp16-optimizer] journal: {json.dumps(journal)}")
    want = [MODEL["n_layer"] * FP16_OPT_STEPS] * 3
    if launches != want or tc != want:
        raise AssertionError(f"flash launches {launches} (tensor cores {tc}) != {want}")
    if not rows[0]["overflow"] or len(clean) < 4 or not all(np.isfinite(clean)) \
            or not clean[-1] < clean[0]:
        raise AssertionError("the first steps did not overflow, or the clean losses are "
                             "not finite and falling")
    del opt, model
    gc.collect()
    torch.cuda.empty_cache()

    model = _fp16_opt_model()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params={
        "train_batch_size": FP16_OPT_BATCH, "steps_per_print": 1000,
        "bf16": {"enabled": False},
        "fp16": {"enabled": True, "loss_scale": 0,
                 "initial_scale_power": FP16_OPT_SCALE_POWER,
                 "hysteresis": FP16_OPT["hysteresis"]},
        "gradient_clipping": FP16_OPT["clip_grad"],
        "optimizer": {"type": "AdamW", "params": {
            "lr": FP16_OPT["lr"], "betas": list(FP16_OPT["betas"]), "eps": FP16_OPT["eps"],
            "weight_decay": FP16_OPT["weight_decay"]}}})
    eng_rows = []
    for _ in range(FP16_OPT_STEPS):
        skipped = engine.skipped_steps
        loss = engine(tokens, labels)
        engine.backward(loss)
        engine.step()
        eng_rows.append({"loss": loss.item(), "overflow": engine.skipped_steps > skipped,
                         "scale": engine.loss_scale()})
    diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(rows, eng_rows))
    same_skips = [r["overflow"] for r in rows] == [r["overflow"] for r in eng_rows]
    res = {"steps": FP16_OPT_STEPS, "skipped": sum(r["overflow"] for r in rows),
           "scales": [r["scale"] for r in rows], "losses": [r["loss"] for r in rows],
           "engine_losses": [r["loss"] for r in eng_rows],
           "max_loss_diff_vs_engine": diff, "tol": FP16_OPT_TOL,
           "same_steps_skipped": same_skips,
           "step_ms_median_clean": statistics.median(
               [t * 1e3 for t, r in zip(step_s, rows) if not r["overflow"]][1:]),
           "step_ms_all": [t * 1e3 for t in step_s], "max_memory_allocated_gb": peak / 1e9,
           "journal_events": len(journal),
           "flash_launches": launches, "tensor_core_launches": tc}
    log(f"[fp16-optimizer] {json.dumps(res)}")
    if diff > FP16_OPT_TOL or not same_skips:
        raise AssertionError("the custom loop disagrees with initialize's fp16 engine")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def published_fused_vs_two_step(tokens, labels):
    """The published pair at gas 1 through the fused step and through the
    two-step body (the same update on an engine held unfused), side by side
    on the same params and batch: the client state and the losses bit for
    bit after each step. The pair never changes the params, so the loss
    alone cannot tell one update from two or from wrong hyper-parameters;
    the state can."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer
    engines = []
    for fused in (True, False):
        model = GPT2Model(GPT2Config(**PUBLISHED_MODEL))
        model.init(torch.Generator(device="cuda").manual_seed(0))
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                      optimizer=shard_optimizer(32),
                                                      config_params=PUBLISHED_CONFIG)
        eng._fused = fused       # the external-master pair at gas 1 is always fused
        engines.append(eng)
    rows = []
    for step in range(PUBLISHED_COMPARE_STEPS):
        losses, graphs = [], []
        for eng in engines:
            loss = eng(tokens, labels)
            graphs.append(loss.requires_grad)
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
        state_fused, state_two = (e.opt_state for e in engines)
        rows.append({"step": step + 1, "losses": losses,
                     "two_step_took_a_graph": graphs == [False, True],
                     "state_bit_for_bit": {k: bool(torch.equal(state_fused[k], state_two[k]))
                                           for k in sorted(state_two)},
                     "m1_norm": state_fused["m1"].norm().item()})
        log(f"[train-published] fused vs two-step body: {json.dumps(rows[-1])}")
    ok = all(r["two_step_took_a_graph"] and r["losses"][0] == r["losses"][1]
             and all(r["state_bit_for_bit"].values()) for r in rows)
    steps = [e.global_steps for e in engines]
    if not ok or steps != [PUBLISHED_COMPARE_STEPS] * 2:
        raise AssertionError(f"the published pair's fused step differs from its two-step "
                             f"body: {rows}, global_steps {steps}")
    del engines, eng, model, state_fused, state_two
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ the fused step
# GPT-2 1.5B at bench.py:406-409, all 48 layers, under the published config's
# remat "dots" and batch 8 in one micro-step, bf16, ZeRO-2, AdamW with no
# clipping and WarmupLR: fused_step (the update inside forward()) against the
# two-step path on the same seed
FUSED_STEP_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 8,
                     "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                     "optimizer": {"type": "AdamW",
                                   "params": {"lr": 1e-4, "betas": [0.9, 0.95],
                                              "weight_decay": 0.1}},
                     "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4}},
                     "gradient_clipping": 0.0, "steps_per_print": 1000}
FUSED_STEP_STEPS = 12
# fp16 with a dynamic scale high enough that the first steps overflow, hysteresis 1, SGD with momentum (0.9, the beta1 slot) and
# clipping 1.0, at the 1.5B's width; the depth cut to 12 layers (the path is
# the same at any depth)
FP16_LAYERS, FP16_STEPS = 12, 10
FP16_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 8,
               "bf16": {"enabled": False},
               "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 24,
                        "hysteresis": 1},
               "zero_optimization": {"stage": 2},
               "optimizer": {"type": "SGD", "params": {"lr": 1e-3}},
               "gradient_clipping": 1.0, "steps_per_print": 1000}
# steps of the published pair, fused against its two-step body
PUBLISHED_COMPARE_STEPS = 3


def _fused_step_run(fused, tokens, labels):
    """One engine on the 1.5B at FUSED_STEP_CONFIG, ``fused_step`` on or
    off: 12 timed steps, then one step with the peak and the allocation read
    around each call, then a profiler window. Returns (results, master after
    the 12 steps, on the host, so that it weighs on no peak)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    cfg = GPT2Config(**PUBLISHED_MODEL)
    model = GPT2Model(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=dict(FUSED_STEP_CONFIG, fused_step=fused))
    if engine._fused != fused:
        raise AssertionError(f"fused_step={fused}: the engine took fused={engine._fused}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    losses, step_s = _train_steps(engine, tokens, labels, steps=FUSED_STEP_STEPS)
    launches, tc = _flash_counts(), _tensor_core_launches()
    peak = torch.cuda.max_memory_allocated()
    master = [m.detach().cpu() for m in engine._master]
    # one more step, the peak read around each call: where the peak lies;
    # the allocation after each: the two-step path holds the grad tree
    # between backward() and step(), the fused one frees it in forward()
    peaks, after = {}, {}
    loss = None
    for name, call in (("forward", lambda: engine(tokens, labels)),
                       ("backward", lambda: engine.backward(loss)),
                       ("step", engine.step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        after[name] = torch.cuda.memory_allocated() / 1e9
        if name == "forward":
            loss = out
    busy = profile_step(f"profile-fused-step-{'on' if fused else 'off'}", engine, tokens,
                        labels, top=12)
    tag = "fused" if fused else "two-step"
    res = {"path": tag, "losses": losses, **_step_stats(step_s, 8 * cfg.n_positions, n_params),
           "max_memory_allocated_gb": peak / 1e9, "resident_after_build_gb": resident / 1e9,
           "peak_by_call_gb": peaks, "peak_in": max(peaks, key=peaks.get),
           "allocated_after_call_gb": after,
           "device_busy_share": busy, "flash_launches": launches,
           "tensor_core_launches": tc}
    log(f"[train-fused] {tag}: {json.dumps(res)}")
    want = [2 * cfg.n_layer * FUSED_STEP_STEPS, cfg.n_layer * FUSED_STEP_STEPS,
            cfg.n_layer * FUSED_STEP_STEPS]
    if launches != want or tc != want:
        raise AssertionError(f"{tag}: flash launches {launches} (tensor cores {tc}) != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses not finite and falling: {losses}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, master


def fp16_check():
    """fp16 with an overflowing initial scale, SGD, clipping 1.0 at 12
    layers: a fused and a two-step engine side by side on the same batch,
    each step's skip, scale and master compared."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    tokens, labels = _published_batch(MODEL["vocab_size"])
    engines = []
    for fused in (False, True):
        model = GPT2Model(GPT2Config(**dict(PUBLISHED_MODEL, n_layer=FP16_LAYERS,
                                            compute_dtype=torch.float16)))
        model.init(torch.Generator(device="cuda").manual_seed(0))
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config_params=dict(FP16_CONFIG, fused_step=fused))
        if eng._fused != fused:
            raise AssertionError(f"fp16: fused_step={fused} took fused={eng._fused}")
        engines.append(eng)
    two, fused = engines
    rows = []
    for step in range(FP16_STEPS):
        before = [m.clone() for m in fused._master]
        losses = []
        for eng in engines:
            loss = eng(tokens, labels)
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
        skipped = fused.skipped_steps > (rows[-1]["skipped"] if rows else 0)
        rows.append({"step": step + 1, "losses": losses, "skipped": fused.skipped_steps,
                     "skipped_two_step": two.skipped_steps, "scale": fused.loss_scale(),
                     "scale_two_step": two.loss_scale(),
                     "master_bit_for_bit": all(torch.equal(a, b) for a, b in
                                               zip(fused._master, two._master)),
                     "master_unchanged": all(torch.equal(a, b) for a, b in
                                             zip(fused._master, before))})
        log(f"[train-fused] fp16: {json.dumps(rows[-1])}")
        if skipped != rows[-1]["master_unchanged"]:
            raise AssertionError("a skipped step changed the master, or a clean one did not")
        del before
    bad = [r for r in rows if r["skipped"] != r["skipped_two_step"]
           or r["scale"] != r["scale_two_step"] or not r["master_bit_for_bit"]
           or r["losses"][0] != r["losses"][1]]
    n_skip = rows[-1]["skipped"]
    log(f"[train-fused] fp16: {n_skip} of {FP16_STEPS} steps skipped, scales "
        f"{[r['scale'] for r in rows]}; fused = two-step bit for bit: {not bad}")
    if bad or not 0 < n_skip < FP16_STEPS:
        raise AssertionError(f"fp16 fused against two-step: {bad or rows}")
    del engines, two, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {"skipped": n_skip, "scales": [r["scale"] for r in rows],
            "losses": [r["losses"][1] for r in rows]}


def phase_train_fused():
    """The fused step on the 1.5B against the two-step path (losses,
    master, peaks, step ms, busy share, flash launches), then in fp16 with
    SGD at 12 layers. Returns the fused run's flash launches."""
    tokens, labels = _published_batch(MODEL["vocab_size"])
    two, master_two = _fused_step_run(False, tokens, labels)
    fused, master_fused = _fused_step_run(True, tokens, labels)
    diff = max(float((a - b).abs().max()) for a, b in zip(master_fused, master_two))
    scale = max(float(b.abs().max()) for b in master_two)
    del master_two, master_fused
    gc.collect()
    torch.cuda.empty_cache()
    gaps = [abs(a - b) for a, b in zip(fused["losses"], two["losses"])]
    res = {"losses_bit_for_bit": fused["losses"] == two["losses"],
           "loss_max_gap": max(gaps), "master_max_abs_diff_over_max": diff / scale,
           "peak_gb": {"two_step": two["max_memory_allocated_gb"],
                       "fused": fused["max_memory_allocated_gb"]},
           "peak_saving_gb": two["max_memory_allocated_gb"] - fused["max_memory_allocated_gb"],
           "peak_in": {"two_step": two["peak_in"], "fused": fused["peak_in"]},
           "held_after_backward_gb": {
               "two_step": two["allocated_after_call_gb"]["backward"],
               "fused": fused["allocated_after_call_gb"]["backward"]},
           "step_ms_median": {"two_step": two["step_ms_median"],
                              "fused": fused["step_ms_median"]},
           "step_ms_spread": {"two_step": [two["step_ms_min"], two["step_ms_max"]],
                              "fused": [fused["step_ms_min"], fused["step_ms_max"]]},
           "device_busy_share": {"two_step": two["device_busy_share"],
                                 "fused": fused["device_busy_share"]}}
    log(f"[train-fused] fused against two-step: {json.dumps(res)}")
    # one update body on the same grads
    if not res["losses_bit_for_bit"] or diff != 0.0:
        raise AssertionError("the fused step differs from the two-step path")
    res["fp16"] = fp16_check()
    return fused["flash_launches"]


def published_rotation_check(engine, tokens, labels):
    """On the published config's engine (fused, no key): a second forward()
    before step() raises; zero_grad() drops the pending window, so the
    next backward() and step() commit nothing."""
    steps = engine.global_steps
    loss = engine(tokens, labels)
    try:
        engine(tokens, labels)
    except RuntimeError as err:
        if "rotation" not in str(err):
            raise
        msg = str(err)
    else:
        raise AssertionError("a second forward() before step() did not raise")
    engine.zero_grad()
    pending = engine._fused_pending
    engine.backward(loss)
    engine.step()
    log(f"[train-fused] rotation on the published engine: RuntimeError {msg!r}; after "
        f"zero_grad() pending {pending}, global_steps {engine.global_steps} (was {steps})")
    if pending is not None or engine.global_steps != steps:
        raise AssertionError("zero_grad() did not drop the pending fused window")


# ---------------------------------------------------------------- ZeRO-Offload
# GPT-2 1.5B at bench.py:406-420's widths, nothing cut, under the published
# config's remat "dots" and batch 8 in one micro-step, with TRAIN_CONFIG's
# AdamW, WarmupLR and clipping: ZeRO-2 with cpu_offload (the float32 master
# and the Adam moments in the host's memory, the host Adam of
# csrc/cpu_adam.cpp), against the same config on the device engine
OFFLOAD_CONFIG = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=8,
                      gradient_accumulation_steps=1,
                      zero_optimization={"stage": 2, "cpu_offload": True})
OFFLOAD_STEPS = 12
# each loss against the device engine's with the clip factor kept in float32,
# as the host step folds it into its grad scale (the host and the card then
# differ in the order of Adam's float32 operations only); against the device
# engine itself, which rounds the clipped grads back to bf16 (as the JAX
# device path does), this plus that engine's own gap to its float32-clip run
OFFLOAD_LOSS_TOL = 2e-3
OFFLOAD_MASTER_TOL = 1e-6        # x max |master|, after step 1
OFFLOAD_PEAK_SAVING_GB = 17.0    # 12 B x 1.558 B params = 18.7 GB reckoned
# a model the device engine cannot hold (16 B a parameter on the card): 1600
# wide, full remat, 3 steps. The depth is fixed, never chosen at run time:
# the host state is 12 B a parameter (PERF.md §4 says why this depth)
LARGE_LAYERS = 160
LARGE_STEPS = 3
# bench.py:1240-1323's max_params_offload: the deepest 1600-wide GPT-2 whose
# bf16 params and grads and full-remat activations at tokens (4, 1024) fit on
# the card, probed in fresh processes (chip_smoke.py --probe N) at bench.py's
# 8-layer granularity, seeded at (616, 624, 632): with the device memory this
# process holds by then, the limit has been found at 616 and at 624 layers
# (H100 80GB HBM3; a fresh parent leaves room for 632), and these seeds find
# either in two or three probes (632 in four). A seed that misses starts the
# search from the floor: 7 more probes. The analytic ceiling is
# (80 GB - activations) / (4 B x 30.7 M params a layer)
CAPACITY_SEED = (616, 624, 632)
CAPACITY_FLOOR, CAPACITY_CEILING = 48, 640
PROBE_TOKENS = (4, 1024)
PROBE_TIMEOUT_S = 300


def _n_params(n_layer):
    """GPT-2's parameter count at MODEL's widths and ``n_layer`` layers."""
    e = MODEL["n_embd"]
    return n_layer * (12 * e * e + 13 * e) + (MODEL["vocab_size"] + MODEL["n_positions"] + 2) * e


def host_info():
    """The host's CPU model, cores and memory, which the host step's time
    depends on."""
    cpu = ""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            mem[key] = int(val.split()[0]) * 1024
    return {"cpu": cpu, "nproc": len(os.sched_getaffinity(0)),
            "mem_total_gb": mem["MemTotal"] / 1e9,
            "mem_available_gb": mem["MemAvailable"] / 1e9}


def _offload_engine(n_layer, offload, seed=0, **over):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2Model(GPT2Config(**dict(PUBLISHED_MODEL, n_layer=n_layer, **over)))
    model.init(torch.Generator(device="cuda").manual_seed(seed))
    cfg = dict(OFFLOAD_CONFIG, zero_optimization={"stage": 2, "cpu_offload": offload})
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=cfg)
    torch.cuda.synchronize()
    return engine, model.param_count()


def _offload_steps(engine, tokens, labels, steps):
    """(losses, step seconds, master after step 1 on the host, lanes): each
    step fenced by a synchronize."""
    losses, step_s, lanes, master1 = [], [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine(tokens, labels)
        engine.backward(loss)
        engine.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss.item())
        if i == 0:
            master1 = [m.detach().to("cpu", copy=True) for m in engine._master]
        if engine._offload is not None:
            lanes.append(engine.offload_step_timing())
    return losses, step_s, master1, lanes


def _float32_clip(grads, max_norm, norm=None):
    """The engine's clip with the clipped grads kept in float32, as the host
    step folds the clip factor into its float32 grad scale
    (deepspeed_tpu/runtime/engine.py:2113-2115), where the device engine
    rounds them back to the grads' dtype."""
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = g.float() * scale
    return grads


def _median_lanes(lanes):
    keys = ("fetch_wait", "host_adam", "push", "total", "fetch_busy", "push_busy")
    out = {k: statistics.median(t[k] for t in lanes) * 1e3 for k in keys}
    out.update({k: lanes[-1][k] for k in ("pipeline_depth", "region_cap", "n_work_items")})
    return out


def host_memory_rates(threads, gib=2, runs=4):
    """The host's memory rates (GB/s) at ``threads`` threads over ``gib`` GiB
    float32 buffers, each the median of the runs after the first: ``read`` (a
    sum), ``copy`` (b into a) and ``triad`` (a = b + 0.5 c), their bytes
    counted as STREAM counts them (each operand once, no write-allocate)."""
    n = (gib << 30) // 4
    b, c, a = torch.ones(n), torch.full((n,), 2.0), torch.zeros(n)
    kernels = {"read": (lambda: c.sum(), 1), "copy": (lambda: a.copy_(c), 2),
               "triad": (lambda: torch.add(b, c, alpha=0.5, out=a), 3)}
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    rates = {}
    try:
        for name, (fn, operands) in kernels.items():
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            rates[name] = operands * n * 4 / statistics.median(times[1:]) / 1e9
    finally:
        torch.set_num_threads(prev)
    if float(c.sum()) != 2.0 * n or not bool((a == 2.0).all()):
        raise AssertionError("the host memory kernels computed a wrong value")
    return rates


def host_kernel_check(engine, tokens, labels):
    """The native host Adam against its plain version on the main path's
    inputs: one chunk of the engine's own master and moments (copies) and
    of a real bf16 grad, at the autotuned chunk size; its time at every
    thread OpenMP gives it and at one thread."""
    from deepspeed_tpu_torch.ops import cpu_adam as ca
    off = engine._offload
    model = engine.module
    model(tokens, labels).backward()
    grad = model.wte.grad.reshape(-1)
    n = min(off.region_cap(), grad.numel())
    g = grad[:n].cpu()
    model.zero_grad(set_to_none=True)
    h = engine.optimizer.current_hyper()[0]
    kw = dict(step=engine.global_steps + 1, lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
              eps=h["eps"], weight_decay=h["weight_decay"], grad_scale=1.0, adamw=off.adamw)
    state = [t[:n].clone() for t in (off.fp32, off.exp_avg, off.exp_avg_sq)]

    def run(fn):
        p, m, v = (t.clone() for t in state)
        out = torch.empty(n, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        fn(p, g, m, v, out, **kw)
        return time.perf_counter() - t0, p, out

    launches = ca.adam_step_native.launches
    lib = ca.load_cpu_adam()
    threads = lib.ds_adam_threads()
    native = [run(ca.adam_step_native) for _ in range(3)]
    lib.ds_adam_set_threads(1)
    one = run(ca.adam_step_native)
    lib.ds_adam_set_threads(threads)
    plain = run(ca.cpu_adam_plain)
    ca.adam_step_native.launches = launches   # the check's launches are not the path's
    err = float((native[0][1] - plain[1]).abs().max())
    out_err = float((native[0][2].float() - plain[2].float()).abs().max())
    scale = float(plain[1].abs().max())
    ms = statistics.median(r[0] for r in native) * 1e3
    nbytes = n * (3 * 4 * 2 + 2 + 2)   # p, m, v read and written; the grad; the copy
    rates = host_memory_rates(threads)
    res = {"elements": n, "threads": threads, "max_abs_err": err, "out_max_abs_err": out_err,
           "max_abs_master": scale, "ms": ms, "ms_one_thread": one[0] * 1e3,
           "plain_ms": plain[0] * 1e3, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
           "host_memory_gb_per_s": rates,
           "bound_ms": nbytes / max(rates.values()) / 1e6, "bound_by": "bytes"}
    log(f"[train-offload] host kernel vs plain: {json.dumps(res)}")
    if not err <= 1e-6 * scale or out_err > 2 ** -7 * scale:
        raise AssertionError("the native host Adam disagrees with its plain version")
    return res


def phase_train_offload():
    """GPT-2 1.5B with ZeRO-Offload through deepspeed_tpu_torch.initialize,
    12 steps, against the device engine on the same config and batch, and
    against that engine with its clip in float32."""
    from deepspeed_tpu_torch.ops import cpu_adam as ca
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    tokens, labels = _published_batch(MODEL["vocab_size"])
    n_layer = PUBLISHED_MODEL["n_layer"]

    engine, n_params = _offload_engine(n_layer, offload=False)
    torch.cuda.reset_peak_memory_stats()
    dev_losses, dev_s, dev_master1, _ = _offload_steps(engine, tokens, labels, OFFLOAD_STEPS)
    dev_peak = torch.cuda.max_memory_allocated()
    del engine
    log(f"[train-offload] device engine: losses {dev_losses}; peak {dev_peak / 1e9:.3f} GB")
    rounding_clip = engine_mod.clip_grads_by_global_norm
    engine_mod.clip_grads_by_global_norm = _float32_clip
    try:
        engine, _ = _offload_engine(n_layer, offload=False)
        f32_losses = _offload_steps(engine, tokens, labels, OFFLOAD_STEPS)[0]
    finally:
        engine_mod.clip_grads_by_global_norm = rounding_clip
    del engine
    log(f"[train-offload] device engine, clip in float32: losses {f32_losses}")

    engine, _ = _offload_engine(n_layer, offload=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    native0 = ca.adam_step_native.launches
    losses, step_s, master1, lanes = _offload_steps(engine, tokens, labels, OFFLOAD_STEPS)
    peak = torch.cuda.max_memory_allocated()
    native = ca.adam_step_native.launches - native0
    launches, tc = _flash_counts(), _tensor_core_launches()
    log(f"[train-offload] offload engine: losses {losses}; peak {peak / 1e9:.3f} GB")

    scale = max(float(m.abs().max()) for m in dev_master1)
    master_err = max(float((a - b).abs().max()) for a, b in zip(master1, dev_master1))
    del dev_master1, master1
    loss_err = max(abs(a - b) for a, b in zip(losses, dev_losses))
    loss_err_f32 = max(abs(a - b) for a, b in zip(losses, f32_losses))
    clip_rounding = max(abs(a - b) for a, b in zip(f32_losses, dev_losses))
    want = [2 * n_layer * OFFLOAD_STEPS, n_layer * OFFLOAD_STEPS, n_layer * OFFLOAD_STEPS]
    work_items = sum(t["n_work_items"] for t in lanes)
    checks = {
        "master_after_step_1": master_err <= OFFLOAD_MASTER_TOL * scale,
        "losses_vs_float32_clip_device": loss_err_f32 <= OFFLOAD_LOSS_TOL,
        "losses_vs_device": loss_err <= clip_rounding + OFFLOAD_LOSS_TOL,
        "losses_fall": bool(all(np.isfinite(losses)) and losses[-1] < losses[0]),
        "peak_saving": (dev_peak - peak) / 1e9 >= OFFLOAD_PEAK_SAVING_GB,
        "flash_launches": launches == want and tc == want,
        "native_host_step": native == work_items > 0,
    }
    kernel = host_kernel_check(engine, tokens, labels)
    busy = profile_step("profile-offload", engine, tokens, labels, top=12)
    stats = _step_stats(step_s, OFFLOAD_CONFIG["train_batch_size"] * MODEL["n_positions"],
                        n_params)
    dev_stats = _step_stats(dev_s, OFFLOAD_CONFIG["train_batch_size"] * MODEL["n_positions"],
                            n_params)
    stats["max_memory_allocated_gb"] = peak / 1e9
    res = {"steps": OFFLOAD_STEPS, "params": n_params, **stats,
           "device_engine": {"step_ms_median": dev_stats["step_ms_median"],
                             "tokens_per_s": dev_stats["tokens_per_s"],
                             "peak_gb": dev_peak / 1e9, "losses": dev_losses},
           "losses": losses, "loss_max_abs_diff": loss_err,
           "float32_clip_device_losses": f32_losses,
           "loss_max_abs_diff_vs_float32_clip_device": loss_err_f32,
           "device_engine_clip_rounding_gap": clip_rounding,
           "master_step1_max_abs_diff": master_err, "master_max_abs": scale,
           "peak_saving_gb": (dev_peak - peak) / 1e9,
           "host_state_gb": 3 * engine._offload.numel * 4 / 1e9,
           "lanes_ms_median_steps_3_12": _median_lanes(lanes[2:]),
           "flash_launches": launches, "tensor_core_launches": tc,
           "native_launches": native, "work_items": work_items,
           "device_busy_share": busy, "host_kernel": kernel, "checks": checks}
    log(f"[train-offload] {json.dumps(res)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[train-offload] failed: {failed}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, clip_rounding


# ---------------------------------------------------------------- checkpointing
# save -> continue against fresh engine -> load -> continue, at GPT-2 1.5B's
# full width in bf16: (1) the slice-2 config (TRAIN_MODEL, TRAIN_CONFIG) at
# CKPT_FULL_LAYERS layers, its whole state; (2) the published config (bench.py:391-420) at
# CKPT_PUBLISHED_LAYERS layers with the engine's resilience block saving every
# CKPT_INTERVAL steps on the writer thread, then auto_resume; (3) ZeRO-Offload's host tier at
# CKPT_OFFLOAD_LAYERS (the code path is the same at any depth), then its
# checkpoint into a device engine
CKPT_STEPS = 4                  # steps before the save, and after it
CKPT_ASYNC_STEPS = 12
CKPT_INTERVAL = 4
CKPT_BASELINE_STEPS = 3         # after the last commit: steps with none in flight
CKPT_OFFLOAD_LAYERS = 12
# the full-state round trip at 12 of the 48 layers (cut from 48, which took
# 115 s of save and load, to keep the whole script inside its time limit;
# the path is the same at any depth)
CKPT_FULL_LAYERS = 12
# the published config's three async saves at 12 of the 48 layers (cut from
# 48 to keep the whole script inside its time limit on a host with a slow
# disk, PERF.md; the path is the same at any depth)
CKPT_PUBLISHED_LAYERS = 12
CKPT_FREE_FACTOR = 1.2          # free bytes needed over the largest round trip
CKPT_PROBE_BYTES = 1 << 30      # the disk's write rate: one file, written and fsynced


def _ckpt_batches(n, rows):
    """``n`` seeded batches of ``rows`` x 1024 tokens on the card."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, MODEL["vocab_size"], size=(rows, MODEL["n_positions"]))
        labels = np.roll(tokens, -1, axis=1)
        out.append((torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()))
    return out


def _ckpt_train(engine, batches):
    """Step losses (the mean over the window's micro-batches) and step seconds."""
    gas = engine.gradient_accumulation_steps()
    losses, step_s = [], []
    for tokens, labels in batches:
        mb = tokens.shape[0] // gas
        torch.cuda.synchronize()
        t = time.perf_counter()
        window = []
        for m in range(gas):
            loss = engine(tokens[m * mb:(m + 1) * mb], labels[m * mb:(m + 1) * mb])
            engine.backward(loss)
            engine.step()
            window.append(loss.detach())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(torch.stack(window).float().mean()))
    return losses, step_s


def disk_write_rate(path):
    """GB/s of one CKPT_PROBE_BYTES file written and fsynced in ``path``."""
    block = np.frombuffer(os.urandom(64 << 20), np.uint8)
    probe = os.path.join(path, "write_probe.bin")
    t0 = time.perf_counter()
    with open(probe, "wb") as f:
        for _ in range(CKPT_PROBE_BYTES // block.size):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    os.remove(probe)
    return CKPT_PROBE_BYTES / dt / 1e9


def _gbps(nbytes, s):
    return nbytes / s / 1e9 if s > 0 else None


def _snapshot_bytes(snapshot):
    """Bytes of the snapshot's arrays by class: params, master, optimizer
    state (device layout or offload regions), the rest."""
    out = {"params": 0, "master": 0, "optimizer": 0, "other": 0}
    for name, (kind, payload) in snapshot["files"].items():
        if kind != "npz":
            continue
        for key, arr in payload.items():
            if name.startswith("mp_rank"):
                cls = "params"
            elif key.startswith("master/"):
                cls = "master"
            elif key.startswith(("opt/", "exp_avg")):
                cls = "optimizer"
            else:
                cls = "other"
            out[cls] += arr.nbytes
    return out


def _timed_save(engine, save_dir):
    """save_checkpoint in its two phases, timed: (snapshot, record)."""
    from deepspeed_tpu_torch.checkpoint import checkpointing as ckpt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snapshot = ckpt.snapshot_checkpoint(engine)
    snap_s = time.perf_counter() - t0
    ckpt.write_snapshot(snapshot, save_dir)
    wall = time.perf_counter() - t0
    classes = _snapshot_bytes(snapshot)
    host = sum(classes.values())
    tag_dir = os.path.join(save_dir, snapshot["tag"])
    files = {n: os.path.getsize(os.path.join(tag_dir, n)) for n in sorted(os.listdir(tag_dir))}
    disk = sum(files.values())
    sec = snapshot["seconds"]
    rec = {"wall_s": wall, "bytes_by_class": classes, "file_bytes": files,
           "snapshot_s": snap_s, "snapshot_gb_per_s": _gbps(host, snap_s),
           "write_s": sec["write"], "write_gb_per_s": _gbps(disk, sec["write"]),
           "hash_manifest_s": sec["hash_manifest"],
           "hash_gb_per_s": _gbps(disk, sec["hash_manifest"]),
           "fsync_rename_s": sec["fsync_rename"]}
    return snapshot, rec


def _timed_load(engine, save_dir):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, _ = engine.load_checkpoint(save_dir)
    wall = time.perf_counter() - t0
    if path is None:
        raise AssertionError(f"[checkpoint] nothing loaded from {save_dir}")
    disk = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))
    sec = engine.last_checkpoint_load
    return {"wall_s": wall, "verify_s": sec["verify"], "verify_gb_per_s": _gbps(disk, sec["verify"]),
            "read_s": sec["read"], "read_gb_per_s": _gbps(disk, sec["read"]),
            "place_s": sec["place"]}


def npz_read_rates(path, turns=2):
    """GB/s of reading every member of the npz archive ``path`` through
    ``np.load`` and through the checkpoint loader's ``NpzFile``, in turns
    (np.load, NpzFile, NpzFile, np.load), and whether they read the same."""
    from deepspeed_tpu_torch.checkpoint.checkpointing import NpzFile
    nbytes = os.path.getsize(path)
    times = {"np_load": [], "NpzFile": []}
    same = True
    for order in [("np_load", "NpzFile"), ("NpzFile", "np_load")] * (turns // 2):
        for name in order:
            t0 = time.perf_counter()
            with (np.load(path) if name == "np_load" else NpzFile(path)) as data:
                arrays = {k: data[k] for k in data.files}
            times[name].append(time.perf_counter() - t0)
            if name == "NpzFile":
                with np.load(path) as want:
                    same &= all(np.array_equal(arrays[k], want[k]) for k in want.files)
            del arrays
    return {name: nbytes / min(t) / 1e9 for name, t in times.items()}, same


def _device_state_equal(engine, snapshot):
    """Whether the engine's params, master and optimizer state equal the
    snapshot's arrays bit for bit, leaf by leaf on the card."""
    from deepspeed_tpu_torch.checkpoint import checkpointing as ckpt
    params = snapshot["files"][ckpt.model_states_name() + ".npz"][1]
    optim = snapshot["files"][ckpt.optim_states_name(0) + ".npz"][1]
    same = {"params": True, "master": True, "optimizer": True}
    for key, i in engine._ckpt_keys():
        p = engine._params[i].detach()
        same["params"] &= torch.equal(p.float(), torch.from_numpy(params[key]).cuda().view(p.shape))
        m = engine._master[i]
        same["master"] &= torch.equal(m.reshape(-1), torch.from_numpy(optim[f"master/{key}"]).cuda())
        for field in engine.opt_state._fields:
            t = getattr(engine.opt_state, field)[i]
            same["optimizer"] &= torch.equal(
                t.reshape(-1), torch.from_numpy(optim[f"opt/{field}/{key}"]).cuda())
    return same


def _ckpt_full_state(root, n_layer):
    """Part 1: the slice-2 config's whole state, saved, reloaded into a fresh
    engine (another init) and continued against the uninterrupted run."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    def build(seed):
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT2Model(GPT2Config(**dict(TRAIN_MODEL, n_layer=n_layer)))
        model.init(torch.Generator(device="cuda").manual_seed(seed))
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=TRAIN_CONFIG)
        return engine

    save_dir = os.path.join(root, "full")
    batches = _ckpt_batches(2 * CKPT_STEPS, TRAIN_CONFIG["train_batch_size"])
    engine = build(0)
    before, _ = _ckpt_train(engine, batches[:CKPT_STEPS])
    snapshot, save = _timed_save(engine, save_dir)
    uninterrupted, _ = _ckpt_train(engine, batches[CKPT_STEPS:])
    del engine
    engine = build(1)
    load = _timed_load(engine, save_dir)
    same = _device_state_equal(engine, snapshot)
    del snapshot
    gc.collect()
    _zero_flash_counts()
    resumed, step_s = _ckpt_train(engine, batches[CKPT_STEPS:])
    launches, tc = _flash_counts(), _tensor_core_launches()
    want = [n_layer * engine.gradient_accumulation_steps() * CKPT_STEPS] * 3
    del engine
    res = {"n_layer": n_layer, "losses_before_save": before, "uninterrupted": uninterrupted,
           "resumed": resumed, "resumed_step_ms": [s * 1e3 for s in step_s],
           "state_bit_equal_after_load": same, "save": save, "load": load,
           "flash_launches_resumed": launches, "tensor_core_launches_resumed": tc}
    log(f"[checkpoint] full state: {json.dumps(res)}")
    checks = {"state_bit_equal": all(same.values()),
              "losses_bit_equal": resumed == uninterrupted,
              "flash_launches": launches == want and tc == want}
    return res, checks


def _ckpt_published(root):
    """Part 2: the published config at CKPT_PUBLISHED_LAYERS layers with the
    resilience block (async saves every CKPT_INTERVAL steps), then
    auto_resume in a fresh engine."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import checkpointing as ckpt
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer

    save_dir = os.path.join(root, "published")
    block = {"enabled": True, "save_dir": save_dir, "save_interval": CKPT_INTERVAL,
             "async_save": True}

    def build(seed, resilience):
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT2Model(GPT2Config(**dict(PUBLISHED_MODEL, n_layer=CKPT_PUBLISHED_LAYERS)))
        model.init(torch.Generator(device="cuda").manual_seed(seed))
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, optimizer=shard_optimizer(32),
            config_params=dict(PUBLISHED_CONFIG, resilience=resilience))
        return engine

    tokens, labels = _published_batch(MODEL["vocab_size"])
    engine = build(0, block)
    writer = engine._resilience
    steps, stalls = [], []
    for i in range(CKPT_ASYNC_STEPS + CKPT_BASELINE_STEPS):
        if i == CKPT_ASYNC_STEPS:
            t = time.perf_counter()
            writer.wait()
            last_commit_wait_s = time.perf_counter() - t
        busy = writer.in_flight
        started = writer.saves_started
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine(tokens, labels)
        engine.backward(loss)
        engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        saved = writer.saves_started > started
        if saved:
            stalls.append(writer.last_stall_ms)
        steps.append({"step": i + 1, "ms": dt * 1e3, "commit_in_flight": busy or writer.in_flight,
                      "saved": saved})
    committed = writer.saves_committed
    del engine, writer
    tags = sorted(n for n in os.listdir(save_dir) if n.startswith("global_step"))
    verified = {t: ckpt.verify_checkpoint(os.path.join(save_dir, t)) for t in tags}
    # steps 1-2 warm up; a save step carries its own snapshot stall
    in_flight = [s["ms"] for s in steps[2:] if s["commit_in_flight"] and not s["saved"]]
    none = [s["ms"] for s in steps[2:] if not s["commit_in_flight"] and not s["saved"]]

    engine = build(1, dict(block, save_interval=0, auto_resume=True))
    tag_dir = os.path.join(save_dir, f"global_step{CKPT_ASYNC_STEPS}")
    with np.load(os.path.join(tag_dir, ckpt.model_states_name() + ".npz")) as data:
        params_equal = all(torch.equal(engine._params[i].detach().float(),
                                       torch.from_numpy(data[key]).cuda())
                           for key, i in engine._ckpt_keys())
    with np.load(os.path.join(tag_dir, ckpt.optim_states_name(0) + ".npz")) as data:
        opt_equal = all(torch.equal(engine.opt_state[k], torch.from_numpy(data[f"opt/{k}"]).cuda())
                        for k in ("shard", "m1", "m2"))
    resumed_at = engine.global_steps
    load = dict(engine.last_checkpoint_load)
    del engine
    readers, readers_same = npz_read_rates(os.path.join(tag_dir, ckpt.optim_states_name(0)
                                                        + ".npz"))
    res = {"steps": steps, "stall_ms": stalls, "saves_committed": committed,
           "last_commit_wait_s": last_commit_wait_s,
           "step_ms_median_commit_in_flight": statistics.median(in_flight) if in_flight else None,
           "step_ms_median_no_commit": statistics.median(none) if none else None,
           "tags": tags, "verified": {t: list(v) for t, v in verified.items()},
           "save_bytes": {t: sum(os.path.getsize(os.path.join(save_dir, t, n))
                                 for n in os.listdir(os.path.join(save_dir, t))) for t in tags},
           "auto_resume_global_steps": resumed_at, "auto_resume_load": load,
           "auto_resume_params_bit_equal": params_equal,
           "auto_resume_client_state_bit_equal": opt_equal,
           "optim_file_read_gb_per_s": readers}
    log(f"[checkpoint] published, async: {json.dumps(res)}")
    checks = {"three_async_commits": committed == 3 and len(tags) == 3,
              "tags_verified": all(v == (True, "ok") for v in verified.values()),
              "auto_resume_step": resumed_at == CKPT_ASYNC_STEPS,
              "auto_resume_state": params_equal and opt_equal,
              "npz_readers_agree": readers_same,
              "step_ms_both_kinds": bool(in_flight and none)}
    return res, checks


def _ckpt_offload(root, clip_rounding):
    """Part 3: the host tier at CKPT_OFFLOAD_LAYERS, saved, reloaded into a
    fresh offload engine and continued bit for bit, then into a device
    engine (the other layout)."""
    from deepspeed_tpu_torch.checkpoint import checkpointing as ckpt
    save_dir = os.path.join(root, "offload")
    n_layer = CKPT_OFFLOAD_LAYERS
    batches = _ckpt_batches(2 * CKPT_STEPS, OFFLOAD_CONFIG["train_batch_size"])
    engine, _ = _offload_engine(n_layer, offload=True)
    _ckpt_train(engine, batches[:CKPT_STEPS])
    snapshot, save = _timed_save(engine, save_dir)
    uninterrupted, _ = _ckpt_train(engine, batches[CKPT_STEPS:])
    del engine
    regions = snapshot["files"][ckpt.offload_states_name(0) + ".npz"][1]

    def host_equal(engine):
        off = engine._offload
        bufs = {"master": off.fp32, "exp_avg": off.exp_avg, "exp_avg_sq": off.exp_avg_sq}
        for li, (key, i) in enumerate(engine._ckpt_keys()):
            r = off._regions[i]
            for prefix, buf in bufs.items():
                if not torch.equal(buf[r.offset:r.offset + r.size],
                                   torch.from_numpy(regions[f"{prefix}/r{li}_{r.offset}"])):
                    return False
        return True

    engine, _ = _offload_engine(n_layer, offload=True, seed=1)
    load = _timed_load(engine, save_dir)
    same = host_equal(engine)
    resumed, _ = _ckpt_train(engine, batches[CKPT_STEPS:])
    del engine

    engine, _ = _offload_engine(n_layer, offload=False, seed=1)
    dev_load = _timed_load(engine, save_dir)
    manifest = snapshot["files"]["offload_manifest_0.json"][1]
    tags = {r["leaf"]: r["tag"] for r in manifest["regions"]}
    master_equal = all(
        torch.equal(engine._master[i].reshape(-1),
                    torch.from_numpy(regions[f"master/{tags[li]}"]).cuda())
        for li, (key, i) in enumerate(engine._ckpt_keys()))
    device, _ = _ckpt_train(engine, batches[CKPT_STEPS:])
    del engine, snapshot, regions
    gap = max(abs(a - b) for a, b in zip(device, uninterrupted))
    res = {"n_layer": n_layer, "save": save, "load": load, "host_state_bit_equal": same,
           "uninterrupted": uninterrupted, "resumed": resumed,
           "device_engine_load": dev_load, "device_master_bit_equal": master_equal,
           "device_engine_losses": device, "device_vs_offload_max_abs": gap,
           "tolerance": OFFLOAD_LOSS_TOL + clip_rounding}
    log(f"[checkpoint] offload: {json.dumps(res)}")
    checks = {"offload_state_bit_equal": same, "offload_losses_bit_equal": resumed == uninterrupted,
              "device_master_bit_equal": master_equal,
              "device_losses": gap <= OFFLOAD_LOSS_TOL + clip_rounding}
    return res, checks


def phase_checkpoint(clip_rounding):
    """Checkpointing at GPT-2 1.5B's width: the full state round trip, async
    saves of the published config with auto_resume, the offload host tier.
    ``clip_rounding`` is [train-offload]'s device-engine clip-rounding gap."""
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        n_pub, n_off = _n_params(CKPT_PUBLISHED_LAYERS), _n_params(CKPT_OFFLOAD_LAYERS)
        reckoned = {"full_state": 16 * _n_params(CKPT_FULL_LAYERS),  # params widened,
                    # master, two moments
                    "published_3_saves": 3 * (4 * n_pub + 3 * 4 * (n_pub // 32)),
                    "offload": 16 * n_off}
        free = shutil.disk_usage(root).free
        rate = disk_write_rate(root)
        log(f"[checkpoint] dir {root}; free {free} B; reckoned bytes {json.dumps(reckoned)}; "
            f"disk write rate {rate:.3f} GB/s ({CKPT_PROBE_BYTES} B written and fsynced)")
        need = CKPT_FREE_FACTOR * max(reckoned.values())
        if free < need:
            raise AssertionError(f"[checkpoint] {free} B free in {root}, {need:.0f} B needed "
                                 f"({CKPT_FREE_FACTOR} x the largest round trip)")
        checks = {}
        full, c = _ckpt_full_state(root, CKPT_FULL_LAYERS)
        checks.update(c)
        shutil.rmtree(os.path.join(root, "full"))
        published, c = _ckpt_published(root)
        checks.update(c)
        shutil.rmtree(os.path.join(root, "published"))
        offload, c = _ckpt_offload(root, clip_rounding)
        checks.update(c)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[checkpoint] checks {json.dumps(checks)}; host "
            f"{json.dumps(host_info())}; disk write rate {rate!r} GB/s")
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"[checkpoint] failed: {failed}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_offload_large():
    """A model the device engine cannot hold: LARGE_LAYERS x 1600 with full
    remat, ZeRO-Offload, batch 8 x 1024, LARGE_STEPS steps."""
    host = host_info()
    n_est = _n_params(LARGE_LAYERS)
    if 12 * n_est > host["mem_available_gb"] * 1e9:
        raise AssertionError(f"[offload-large] the host state ({12 * n_est / 1e9:.1f} GB) "
                             f"exceeds MemAvailable ({host['mem_available_gb']:.1f} GB)")
    tokens, labels = _published_batch(MODEL["vocab_size"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, n_params = _offload_engine(LARGE_LAYERS, offload=True, remat_policy=None)
    build_s = time.perf_counter() - t0
    losses, step_s, _, lanes = _offload_steps(engine, tokens, labels, LARGE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    res = {"n_layer": LARGE_LAYERS, "params": n_params, "losses": losses,
           "step_ms_all": [s * 1e3 for s in step_s], "engine_build_s": build_s,
           "tokens_per_s": OFFLOAD_CONFIG["train_batch_size"] * MODEL["n_positions"]
           / statistics.median(step_s[1:]),
           "max_memory_allocated_gb": peak / 1e9, "device_total_gb": total / 1e9,
           "host_state_gb": 3 * engine._offload.numel * 4 / 1e9,
           "device_engine_reckoned_gb": 16 * n_params / 1e9,
           "lanes_ms_last": _median_lanes(lanes[-1:]), "host": host}
    log(f"[offload-large] {json.dumps(res)}")
    if not (all(np.isfinite(losses)) and losses[1] != losses[0] and peak < total):
        raise AssertionError("[offload-large] losses not finite, not moving, or the peak "
                             "above the card's memory")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def probe_offload_footprint(n_layer):
    """One probe (its own process): a 1600-wide GPT-2 at ``n_layer`` layers,
    full remat, flash; bf16 params made on the card at 0.01 (the model built
    on ``meta``, never through a float32 init); one forward and backward at
    tokens PROBE_TOKENS keeping bf16 grads. Prints PROBE_OK or, when the card
    runs out of memory, PROBE_OOM."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    cfg = GPT2Config(**dict(MODEL, n_layer=n_layer), remat=True, use_flash_attention=True)
    model = GPT2Model(cfg, device="meta").to(torch.bfloat16)
    n_params = model.param_count()
    try:
        model = model.to_empty(device="cuda")
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(0.01)
        tokens = torch.zeros(PROBE_TOKENS, dtype=torch.long, device="cuda")
        loss = model(tokens, tokens)
        loss.backward()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        print(f"PROBE_OOM {n_layer} {n_params}", flush=True)
        return
    if not math.isfinite(loss.item()):
        raise AssertionError(f"probe {n_layer}: loss {loss.item()}")
    if any(p.grad is None or p.grad.dtype != torch.bfloat16 for p in model.parameters()):
        raise AssertionError(f"probe {n_layer}: grads missing or not bf16")
    print(f"PROBE_OK {n_layer} {n_params} {torch.cuda.max_memory_allocated()}", flush=True)


def _probe(n_layer):
    """(fits, params, peak bytes, seconds) of one probe in a fresh process."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--probe",
                          str(n_layer)], capture_output=True, text=True,
                         timeout=PROBE_TIMEOUT_S, cwd=str(Path(__file__).resolve().parent))
    dt = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        word, *rest = line.split() or [""]
        if word == "PROBE_OK" and res.returncode == 0:
            return True, int(rest[1]), int(rest[2]), dt
        if word == "PROBE_OOM" and res.returncode == 0:
            return False, int(rest[1]), 0, dt
    raise RuntimeError(f"probe {n_layer} failed (exit {res.returncode}):\n"
                       f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")


def phase_offload_capacity():
    """bench.py's max_params_offload on the card: the deepest 1600-wide GPT-2
    (8-layer steps) whose offload footprint fits, seeded at CAPACITY_SEED."""
    gc.collect()
    torch.cuda.empty_cache()
    # the probes run in other processes and get what this one leaves: free
    # the cuBLAS workspaces the earlier phases made (32 MiB for each stream
    # and handle that ran a product; no CUDA graph is alive here), so that
    # the capacity does not depend on how many of those the phases used
    reserved_held = torch.cuda.memory_reserved()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    probes = {}

    def fits(n):
        if n not in probes:
            probes[n] = _probe(n)
            ok, params, peak, dt = probes[n]
            log(f"[offload-capacity] {n} layers ({params / 1e9:.3f} B params): "
                f"{'fits' if ok else 'out of memory'}, peak {peak / 1e9:.2f} GB, {dt:.1f} s")
        return probes[n][0]

    lo, hi = None, None
    for n in CAPACITY_SEED:
        if fits(n):
            lo = n
        else:
            hi = n
            break
    if lo is None:
        lo = CAPACITY_FLOOR
        if not fits(lo):
            raise AssertionError(f"[offload-capacity] {lo} layers do not fit")
    if hi is None:
        hi = CAPACITY_CEILING
        if fits(hi):
            lo = hi
    while hi - lo > 8:
        mid = (lo + hi) // 2 // 8 * 8
        if mid <= lo:
            break
        if fits(mid):
            lo = mid
        else:
            hi = mid
    total = torch.cuda.get_device_properties(0).total_memory
    params = probes[lo][1]
    res = {"deepest_layers": lo, "params": params, "first_out_of_memory": hi,
           "probes": {str(k): v[0] for k, v in sorted(probes.items())},
           "probe_peak_gb": probes[lo][2] / 1e9, "device_total_gb": total / 1e9,
           "host_state_gb_at_12_B": 12 * params / 1e9,
           "host_gb_at_16_B": 16 * params / 1e9,
           "device_engine_reckoned_max_params": total / 16,
           "parent_reserved_gb_before_clearing": reserved_held / 1e9,
           "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9,
           "device_free_gb_before_probes": free_before / 1e9,
           "seconds": sum(v[3] for v in probes.values())}
    log(f"[offload-capacity] {json.dumps(res)}")
    return res


# ------------------------------------------------------- long-sequence training
# tests/perf/long_seq_model_perf.py:6-8,25,37-56: GPT-2 at n_embd 1024, 16
# heads, 12 layers, T = 8192, batch 1, remat "dots", loss_chunk 512, bf16,
# ZeRO-2, Adam at lr 1e-4. Under "dots" the backward replays each block's
# attention forward: two forward launches a layer a step
LONG_MODEL = dict(vocab_size=50304, n_positions=8192, n_embd=1024, n_layer=12, n_head=16,
                  remat=True, remat_policy="dots", loss_chunk=512)
LONG_CONFIG = {"train_batch_size": 1, "steps_per_print": 1000, "bf16": {"enabled": True},
               "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
               "zero_optimization": {"stage": 2}}
LONG_STEPS, DENSE_STEPS = 10, 6
NO_REMAT_STEPS = 5              # block-sparse without remat: the forward once a layer
BS_SHAPE = (1, 16, 8192, 64)    # B, H, T, D of the long-sequence path


def long_sparsity():
    from deepspeed_tpu_torch.ops.sparse_attention import VariableSparsityConfig
    return VariableSparsityConfig(num_heads=16, block=256, num_random_blocks=0,
                                  local_window_blocks=[3], global_block_indices=[0],
                                  attention="unidirectional")


def _bs_cases():
    """(name, (B, H, T, D), dtype, layout, block, causal) of each check."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    empty = np.ones((2, 8, 8), np.int64)
    empty[:, 3, :] = 0     # a q-row with no active block: out 0, lse -inf
    empty[:, :, 5] = 0     # a k-column with none: dk = dv = 0
    return [
        ("variable-256 (main)", BS_SHAPE, torch.bfloat16,
         long_sparsity().make_layout(8192), 256, True),
        ("fixed-16", (2, 4, 512, 64), torch.float32,
         sa.FixedSparsityConfig(num_heads=4, block=16, attention="unidirectional")
         .make_layout(512), 16, True),
        # bidirectional: under causal its LUT holds blocks above the diagonal
        ("bigbird-64", (2, 4, 2048, 64), torch.bfloat16,
         sa.BigBirdSparsityConfig(num_heads=4, block=64, num_random_blocks=2,
                                  different_layout_per_head=True).make_layout(2048), 64, True),
        ("variable-128-d128", (1, 4, 2048, 128), torch.float16,
         sa.VariableSparsityConfig(num_heads=4, block=128, num_random_blocks=1,
                                   attention="unidirectional").make_layout(2048), 128, True),
        ("longformer-64-d256", (1, 2, 512, 256), torch.bfloat16,
         sa.BSLongformerSparsityConfig(num_heads=2, block=64).make_layout(512), 64, True),
        ("fixed-32-bidirectional", (2, 4, 1024, 64), torch.bfloat16,
         sa.FixedSparsityConfig(num_heads=4, block=32).make_layout(1024), 32, False),
        ("empty-row-col-64-d40", (2, 2, 512, 40), torch.float32, empty, 64, False),
        # the tensor-core design: rows with no allowed key (lse -inf) in bf16
        ("empty-row-col-64-bf16", (2, 2, 512, 64), torch.bfloat16, empty, 64, False),
        ("variable-128-d80", (1, 4, 2048, 80), torch.float16,
         sa.VariableSparsityConfig(num_heads=4, block=128, local_window_blocks=[3],
                                   global_block_indices=[0],
                                   attention="unidirectional").make_layout(2048), 128, True),
        # global rows without the causal mask: dq splits them across CTAs
        ("longformer-128-global-rows", (2, 4, 4096, 64), torch.bfloat16,
         sa.BSLongformerSparsityConfig(num_heads=4, block=128).make_layout(4096), 128, False),
    ]


def _scaled_err(a, b):
    """max |a - b| / max |b| over the finite entries; equal entries (-inf
    lse of rows with no allowed key in both) count as no error."""
    err = torch.where(a == b, 0.0, (a - b).abs())
    fin = torch.isfinite(b)
    return float(err.max()) / (float(b[fin].abs().max()) + 1e-6)


def _bs_case(shape, dtype, layout, block, causal, seed=0):
    """(kernel, plain) results of one case on the same seeded inputs: each a
    list [out, lse, dq, dk, dv] from the forward and the backward of
    sum(out * g)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    luts = bsa.device_luts(layout, q.device)

    def run(kernel):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        if kernel:
            _, lse = bsa.block_sparse_fwd(q, k, v, luts, block=block, causal=causal,
                                          sm_scale=scale)
            out = bsa._BlockSparseAttention.apply(qs, ks, vs, luts, block, causal, scale)
        else:
            out, lse = bsa.block_sparse_attention_reference(qs, ks, vs, layout, block,
                                                            causal, scale)
        (out.float() * g.float()).sum().backward()
        return [t.detach().float() for t in (out, lse, qs.grad, ks.grad, vs.grad)]

    return run(True), run(False)


def phase_block_sparse_kernels():
    """The three block-sparse kernels against their plain version at the
    long-sequence path's shape and at other layouts; then times."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    main = None
    for name, shape, dtype, layout, block, causal in _bs_cases():
        before = _bs_tensor_core_launches()
        got, want = _bs_case(shape, dtype, layout, block, causal)
        torch.cuda.synchronize()
        tc = bsa.tensor_core_path(dtype, shape[-1], block)
        ran = [a - b for a, b in zip(_bs_tensor_core_launches(), before)]
        if ran != [2 * tc, tc, tc]:     # _bs_case runs the forward twice
            raise AssertionError(f"block-sparse {name}: tensor-core launches (fwd, dq, dk/dv) "
                                 f"{ran}, but the shape rule names the "
                                 f"{'tensor-core' if tc else 'CUDA-core'} design")
        tol = FLASH_TOL[dtype]
        errs = {}
        for out, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if out != "lse" and not torch.isfinite(a).all():
                raise AssertionError(f"block-sparse {name}: non-finite {out}")
            errs[out] = _scaled_err(a, b)
        log(f"[block-sparse] {name} {shape} {dtype} block {block} causal {causal}, all three "
            f"on the {'tensor' if tc else 'CUDA'} cores: "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (scaled by max |ref|, tol {tol})")
        if name.startswith("empty"):
            row, col = slice(3 * block, 4 * block), slice(5 * block, 6 * block)
            if not (got[0][:, :, row].eq(0).all() and got[1][:, :, row].eq(-math.inf).all()
                    and got[3][:, :, col].eq(0).all() and got[4][:, :, col].eq(0).all()):
                raise AssertionError("block-sparse: the empty row or column is not zero")
        if max(errs.values()) > tol:
            raise AssertionError(f"block-sparse kernels vs plain, {name}: {errs} > {tol}")
        if main is None:
            main = {n: (float(torch.where(a == b, 0.0, (a - b).abs()).max()), errs[n])
                    for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want)}
        for kern, names in (("fwd", ("out", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            worst[kern] = max(worst[kern], *(errs[n] for n in names))
        del got, want
    torch.cuda.empty_cache()
    return time_block_sparse(main, worst)


def _bs_tensor_core_launches():
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    return [bsa.block_sparse_fwd.tensor_core_launches,
            bsa.block_sparse_bwd_dq.tensor_core_launches,
            bsa.block_sparse_bwd_dkv.tensor_core_launches]


def _bs_cuda_core_entries(block, causal, sm_scale):
    """The CUDA-core forward, dq and dk/dv entries called directly on bf16
    inputs that the shape rule sends to the tensor cores: the earlier design,
    timed beside its redesign on the same inputs (no launch counted)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    lib = bsa._lib()

    def fwd(q, k, v, luts):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        err = lib.bs_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), luts.counts.data_ptr(), luts.cols.data_ptr(),
                         luts.cols.shape[1], *bsa._tail(q, block, sm_scale, causal))
        if err:
            raise RuntimeError(f"bs_fwd: cudaError {err}")
        return out, lse

    def dq(q, k, v, do, lse, delta, luts):
        out = torch.empty_like(q)
        err = lib.bs_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), luts.counts.data_ptr(), luts.cols.data_ptr(),
                        luts.cols.shape[1], out.data_ptr(),
                        *bsa._tail(q, block, sm_scale, causal))
        if err:
            raise RuntimeError(f"bs_dq: cudaError {err}")
        return out

    def dkv(q, k, v, do, lse, delta, luts):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.bs_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(), luts.counts_t.data_ptr(),
                         luts.rows_t.data_ptr(), luts.rows_t.shape[1], dk.data_ptr(),
                         dv.data_ptr(), *bsa._tail(q, block, sm_scale, causal))
        if err:
            raise RuntimeError(f"bs_dkv: cudaError {err}")
        return dk, dv

    return fwd, dq, dkv


def _bs_forward_designs(q, k, v, luts, kw):
    """The two forward designs on the same inputs: (errors of the tensor-core
    out and lse against the CUDA-core ones, scaled by max |value|; whether a
    second tensor-core launch is bit-identical to the first)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    fma_fwd = _bs_cuda_core_entries(kw["block"], kw["causal"], kw["sm_scale"])[0]
    tc = bsa.block_sparse_fwd(q, k, v, luts, **kw)
    fma = fma_fwd(q, k, v, luts)
    again = bsa.block_sparse_fwd(q, k, v, luts, **kw)
    errs = {n: _scaled_err(a.float(), b.float()) for n, a, b in zip(("out", "lse"), tc, fma)}
    return errs, all(torch.equal(a, b) for a, b in zip(tc, again))


def time_block_sparse(main_err, worst):
    """Device times at the main shape, inputs rotating over 3 sets (68 MB a
    set, beyond the 50 MB L2): the forward's tensor-core design and, on the
    same inputs in turns (new, old, old, new), its CUDA-core design, by
    CUDA-graph replays (the new design's eager loop beside them); the
    backward kernels' tensor-core design (the wrapper's) and, in turns, their
    CUDA-core design, both also on the layout without its global column;
    beside them the plain version and SDPA with the layout (causal included)
    as a boolean mask, forward and backward. First, each kernel's two
    designs' outputs against each other and two launches bit for bit (the
    forward also on the case whose rows split, Longformer's global rows
    without the causal mask)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    B, H, T, D = BS_SHAPE
    layout = long_sparsity().make_layout(T)
    block, kw = 256, dict(block=256, causal=True, sm_scale=D ** -0.5)
    luts = bsa.device_luts(layout, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sets = []
    for _ in range(3):
        q, k, v, do = (torch.randn(BS_SHAPE, generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        out, lse = bsa.block_sparse_fwd(q, k, v, luts, **kw)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        sets.append((q, k, v, do, lse, delta))
    no_global = layout.copy()
    no_global[:, 1:, 0] = 0
    luts_ng = bsa.device_luts(no_global, "cuda")
    fma_fwd, fma_dq, fma_dkv = _bs_cuda_core_entries(block, True, D ** -0.5)

    # the forward's two designs agree on the same inputs, and its split rows
    # merge the same way every launch
    fwd_checks = {}
    for name, shape, dtype, lay, blk, causal in _bs_cases():
        if name not in ("variable-256 (main)", "longformer-128-global-rows"):
            continue
        g = torch.Generator(device="cuda").manual_seed(2)
        qkv = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]
        lay_luts = bsa.device_luts(lay, "cuda")
        fkw = dict(block=blk, causal=causal, sm_scale=shape[-1] ** -0.5)
        errs, same = _bs_forward_designs(*qkv, lay_luts, fkw)
        splits = bsa.device_work(lay_luts, "cuda", T=shape[2], block=blk, causal=causal,
                                 transposed=False, batch=shape[0], D=shape[-1]).n_groups
        fwd_checks[name] = {"errs": errs, "bit_identical": same, "split_groups": splits}
        del qkv
    log(f"[block-sparse] tensor-core vs CUDA-core forward (out, lse scaled by max |value|) "
        f"and two launches bit-identical: {json.dumps(fwd_checks)}")
    if fwd_checks["longformer-128-global-rows"]["split_groups"] == 0:
        raise AssertionError("the Longformer case split no forward row")
    for name, c in fwd_checks.items():
        if max(c["errs"].values()) > FLASH_TOL[torch.bfloat16] or not c["bit_identical"]:
            raise AssertionError(f"block-sparse forward designs, {name}: {c}")

    # the two designs of each backward kernel agree on the same inputs, and
    # the tensor-core design's split column merges the same way every launch
    tc_outs = [bsa.block_sparse_bwd_dq(*sets[0], luts, **kw),
               *bsa.block_sparse_bwd_dkv(*sets[0], luts, **kw)]
    fma_outs = [fma_dq(*sets[0], luts), *fma_dkv(*sets[0], luts)]
    designs_err = {n: _scaled_err(a.float(), b.float()) for n, a, b in
                   zip(("dq", "dk", "dv"), tc_outs, fma_outs)}
    again = [bsa.block_sparse_bwd_dq(*sets[0], luts, **kw),
             *bsa.block_sparse_bwd_dkv(*sets[0], luts, **kw)]
    identical = [bool(torch.equal(a, b)) for a, b in zip(tc_outs, again)]
    del tc_outs, fma_outs, again
    log(f"[block-sparse] tensor-core vs CUDA-core backward outputs (scaled by max |value|): "
        + ", ".join(f"{n} {e:.2e}" for n, e in designs_err.items())
        + f"; two launches bit-identical (dq, dk, dv): {identical}")
    if max(designs_err.values()) > FLASH_TOL[torch.bfloat16]:
        raise AssertionError(f"tensor-core vs CUDA-core block-sparse backward: {designs_err}")
    if not all(identical):
        raise AssertionError(f"block-sparse backward launches differ bit-wise: {identical}")

    def timers(l):
        return {"dq": lambda i: bsa.block_sparse_bwd_dq(*sets[i % 3], l, **kw),
                "dkv": lambda i: bsa.block_sparse_bwd_dkv(*sets[i % 3], l, **kw),
                "dq_fma": lambda i: fma_dq(*sets[i % 3], l),
                "dkv_fma": lambda i: fma_dkv(*sets[i % 3], l)}

    eager_fwd = time_ms(lambda i: bsa.block_sparse_fwd(*sets[i % 3][:3], luts, **kw), 60)
    fwd_turns = {"fwd": [], "fwd_fma": []}
    for n in ("fwd", "fwd_fma", "fwd_fma", "fwd"):     # in turns: new, old, old, new
        fn = bsa.block_sparse_fwd if n == "fwd" else \
            (lambda q, k, v, l, **_: fma_fwd(q, k, v, l))
        fwd_turns[n].append(graph_ms(lambda i: fn(*sets[i % 3][:3], luts, **kw), 3))
    ms = {n: statistics.mean(t) for n, t in fwd_turns.items()}
    turns = {n: [] for n in ("dq", "dkv", "dq_fma", "dkv_fma")}
    for names in (("dq", "dkv"), ("dq_fma", "dkv_fma"), ("dq_fma", "dkv_fma"), ("dq", "dkv")):
        for n in names:     # in turns: new, old, old, new
            turns[n].append(time_ms(timers(luts)[n], 20 if n.endswith("fma") else 60))
    ms.update({n: statistics.mean(t) for n, t in turns.items()})
    ng = {n: time_ms(timers(luts_ng)[n], 20 if n.endswith("fma") else 60) for n in turns}
    work = {t: bsa.device_work(luts, "cuda", T=T, block=block, causal=True, transposed=t,
                               batch=B, D=D) for t in (False, True)}
    mask = bsa.layout_mask(layout, block, True, "cuda")
    pairs = int(mask.sum()) * B          # (q, k) pairs the layout and causal mask keep
    pairs_ng = int(bsa.layout_mask(no_global, block, True, "cuda").sum()) * B
    log(f"[block-sparse] forward turns (ms, graph replays): {json.dumps(fwd_turns)}, eager "
        f"{eager_fwd!r}; backward turns (ms): {json.dumps(turns)}; without the global column: "
        f"{json.dumps(ng)} for {pairs_ng / pairs!r} of the pairs; split groups dq "
        f"{work[False].n_groups}, dk/dv {work[True].n_groups}")

    def fwd_bwd(fn, iters):
        fwd = time_ms(lambda i: fn(*sets[i % 3][:3]), iters, warmup=1)
        graphs = []
        for q, k, v, do, _, _ in sets[:2]:
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            graphs.append((fn(*qkv), qkv, do))
        bwd = time_ms(lambda i: torch.autograd.grad(
            graphs[i % 2][0], graphs[i % 2][1], graphs[i % 2][2], retain_graph=True),
            iters, warmup=1)
        del graphs
        torch.cuda.empty_cache()
        return fwd, bwd

    plain_fwd, plain_bwd = fwd_bwd(lambda q, k, v: bsa.block_sparse_attention_reference(
        q, k, v, layout, block, True)[0], 2)
    sdpa_fwd, sdpa_bwd = fwd_bwd(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), 4)
    del sets, mask
    torch.cuda.empty_cache()

    tensor = B * H * T * D * 2      # one bf16 [B, H, T, D]
    row = B * H * T * 4             # one float32 [B, H, T]
    lut_bytes = sum(t.numel() * 4 for t in (luts.counts, luts.cols, luts.counts_t, luts.rows_t))
    mm = 2 * pairs * D              # flops of one product over the kept pairs
    work_of = {"fwd": (2 * mm, 3 * tensor + tensor + row + lut_bytes),
               "dq": (3 * mm, 4 * tensor + 2 * row + tensor + lut_bytes),
               "dkv": (4 * mm, 4 * tensor + 2 * row + 2 * tensor + lut_bytes)}
    entries = []
    for name, body, line, other, plain, lib, outs in (
            ("fwd", "_bs_fwd_kernel_res", 135, "285:_bs_fwd_kernel", plain_fwd, sdpa_fwd,
             ("out", "lse")),
            ("dq", "_bs_dq_kernel_res", 174, "372:_bs_dq_kernel", plain_bwd, sdpa_bwd, ("dq",)),
            ("dkv", "_bs_dkv_kernel_res", 210, "442:_bs_dkv_kernel", plain_bwd, sdpa_bwd,
             ("dk", "dv"))):
        flops, nbytes = work_of[name]
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        e = {"name": f"block_sparse_{name}", "route": "cuda", "entry": f"bs_{name}_tc",
             "design": "wgmma",
             "source": "deepspeed_tpu_torch/csrc/block_sparse_attention_tc.cu",
             "replaces": f"deepspeed_tpu/ops/pallas/block_sparse_attention.py:{line}:{body}",
             "also_replaces": f"deepspeed_tpu/ops/pallas/block_sparse_attention.py:{other}",
             "launches": None, "max_abs_err": max(main_err[n][0] for n in outs),
             "scaled_err": max(main_err[n][1] for n in outs),
             "worst_scaled_err": worst[name], "tol": FLASH_TOL[torch.bfloat16],
             "kernel_ms": ms[name], "ms": ms[name], "plain_ms": plain, "library_ms": lib,
             "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "pct_of_bound": 100 * bound / ms[name]}
        # the CUDA-core design on the same inputs
        e.update({"fma_ms": ms[f"{name}_fma"], "speedup_vs_fma": ms[f"{name}_fma"] / ms[name],
                  "fma_pct_of_bound": 100 * bound / ms[f"{name}_fma"],
                  "split_groups": work[name == "dkv"].n_groups,
                  "items": int(work[name == "dkv"].items.shape[0])})
        if name == "fwd":
            e.update({"timing": "CUDA-graph replays", "turns_ms": fwd_turns["fwd"],
                      "fma_turns_ms": fwd_turns["fwd_fma"], "eager_ms": eager_fwd,
                      "designs": fwd_checks})
        else:
            # both also on the layout without its global column: the split
            # balances the column if the time falls with the pairs, ms / ms_ng
            # <= 1.25 pairs / pairs_ng
            e.update({"timing": "eager loop", "turns_ms": turns[name],
                      "fma_turns_ms": turns[f"{name}_fma"],
                      "ms_without_global_column": ng[name],
                      "fma_ms_without_global_column": ng[f"{name}_fma"],
                      "ms_over_ms_without_global_column": ms[name] / ng[name],
                      "pairs_over_pairs_without_global_column": pairs / pairs_ng})
        log(f"[block-sparse] {json.dumps(e)}")
        entries.append(e)
    return entries


def _long_batch(vocab, T):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab, size=(1, T))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    return torch.from_numpy(tokens).cuda(), torch.from_numpy(labels).cuda()


def _long_model(**over):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    kw = dict(LONG_MODEL, sparse_attention=long_sparsity())
    kw.update(over)
    model = GPT2Model(GPT2Config(**kw))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model


def _train_steps(engine, *batch, steps):
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine(*batch)
        engine.backward(loss)
        engine.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(loss.detach()))
    return losses, step_s


def phase_long_training():
    """GPT-2 with block-sparse attention at T = 8192 through
    deepspeed_tpu_torch.initialize on the card; then dense flash."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa

    tokens, labels = _long_batch(LONG_MODEL["vocab_size"], LONG_MODEL["n_positions"])
    checks = {}
    for dtype, T, tol, remat in ((torch.float32, 2048, TRAIN_TOL_F32, True),
                                 (torch.bfloat16, 8192, TRAIN_TOL_BF16, True),
                                 (torch.bfloat16, 8192, TRAIN_TOL_BF16, False)):
        m = _long_model(n_layer=2, compute_dtype=dtype, remat=remat)
        before = (bsa.block_sparse_fwd.launches, bsa.block_sparse_fwd.tensor_core_launches)
        lk, lp, nrel = _kernel_vs_plain(m, tokens[:, :T], labels[:, :T])
        # bf16 through the tensor-core forward, float32 through the CUDA-core
        # one; twice a layer under remat "dots", once without
        fwd = 2 * (1 + remat)
        tc = fwd * (dtype == torch.bfloat16)
        if (bsa.block_sparse_fwd.launches - before[0],
                bsa.block_sparse_fwd.tensor_core_launches - before[1]) != (fwd, tc):
            raise AssertionError(f"the kernel path did not launch the forward {fwd // 2} "
                                 "time(s) per layer in the design the shape rule names, or "
                                 "the plain path launched it")
        checks[f"{dtype}{'' if remat else ' no remat'}"] = [lk, lp, nrel]
        log(f"[long] {dtype} 2 layers T {T}{'' if remat else ' no remat'}, kernel vs plain: "
            f"loss {lk!r} vs {lp!r}, per-layer grad norms max rel diff {nrel!r} (tol {tol})")
        bad = ((abs(lk - lp) > tol * abs(lp) or nrel > tol) if dtype == torch.float32
               else (abs(lk - lp) > tol[0] or nrel > tol[1]))
        if bad:
            raise AssertionError(f"{dtype} block-sparse kernel path disagrees with the plain path")
        del m
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = _long_model()
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=LONG_CONFIG)
    launchers = (bsa.block_sparse_fwd, bsa.block_sparse_bwd_dq, bsa.block_sparse_bwd_dkv)
    for f in launchers:
        f.launches = f.tensor_core_launches = 0
    losses, step_s = _train_steps(engine, tokens, labels, steps=LONG_STEPS)
    launches = [f.launches for f in launchers]
    tc_launches = _bs_tensor_core_launches()
    log(f"[long] step losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"long-sequence losses not finite and decreasing: {losses}")
    n_layer = LONG_MODEL["n_layer"]
    want = [2 * n_layer * LONG_STEPS, n_layer * LONG_STEPS, n_layer * LONG_STEPS]
    if launches != want:
        raise AssertionError(f"block-sparse launches {launches} != {want} (fwd twice a "
                             f"layer under remat 'dots', dq and dk/dv once)")
    if tc_launches != want:
        raise AssertionError(f"block-sparse launches on the tensor cores (fwd, dq, dk/dv) "
                             f"{tc_launches}: not all of {want}")
    steady = step_s[2:]
    step = statistics.median(steady)
    tok_s = LONG_MODEL["n_positions"] / step
    res = {"steps": LONG_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_median": step * 1e3, "step_ms_min": min(steady) * 1e3,
           "step_ms_max": max(steady) * 1e3, "step_ms_all": [s * 1e3 for s in step_s],
           "tokens_per_s": tok_s, "params": n_params,
           "mfu": tok_s * 6 * n_params / BF16_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "block_sparse_launches": launches,
           "block_sparse_tensor_core_launches (fwd, dq, dkv)": tc_launches,
           "kernel_vs_plain": checks}
    log(f"[long] {json.dumps(res)}")
    LONG.update(res)
    profile_step("profile-long", engine, tokens, labels)
    del engine, model
    gc.collect()        # the engine and its optimizer refer to each other
    torch.cuda.empty_cache()

    # the same model without remat: the forward once a layer a step
    torch.cuda.reset_peak_memory_stats()
    plain = _long_model(remat=False)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=plain, config_params=LONG_CONFIG)
    before = [f.launches for f in launchers]
    n_losses, n_step_s = _train_steps(engine, tokens, labels, steps=NO_REMAT_STEPS)
    n_launches = [f.launches - b for f, b in zip(launchers, before)]
    if n_launches != [n_layer * NO_REMAT_STEPS] * 3:
        raise AssertionError(f"block-sparse launches without remat {n_launches} != "
                             f"{n_layer} x {NO_REMAT_STEPS} each")
    if not all(np.isfinite(n_losses)) or not n_losses[-1] < n_losses[0]:
        raise AssertionError(f"no-remat long-sequence losses not finite and decreasing: "
                             f"{n_losses}")
    n_step = statistics.median(n_step_s[2:])
    n_res = {"steps": NO_REMAT_STEPS, "losses": n_losses, "step_ms_median": n_step * 1e3,
             "step_ms_all": [s * 1e3 for s in n_step_s],
             "tokens_per_s": LONG_MODEL["n_positions"] / n_step,
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "block_sparse_launches": n_launches, "remat_over_no_remat_step": step / n_step}
    log(f"[long-no-remat] {json.dumps(n_res)}")
    del engine, plain
    gc.collect()
    torch.cuda.empty_cache()

    # the same model with dense flash attention
    log(f"[long-dense] allocated before the dense model: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats()
    dense = _long_model(sparse_attention=None, use_flash_attention=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=dense, config_params=LONG_CONFIG)
    before = fa.flash_attention_fwd.launches
    d_losses, d_step_s = _train_steps(engine, tokens, labels, steps=DENSE_STEPS)
    if fa.flash_attention_fwd.launches - before != 2 * n_layer * DENSE_STEPS:
        raise AssertionError("the dense comparison did not run the flash forward twice "
                             "a layer a step")
    if not all(np.isfinite(d_losses)):
        raise AssertionError(f"dense long-sequence losses not finite: {d_losses}")
    d_step = statistics.median(d_step_s[2:])
    d_res = {"steps": DENSE_STEPS, "losses": d_losses, "step_ms_median": d_step * 1e3,
             "step_ms_all": [s * 1e3 for s in d_step_s],
             "tokens_per_s": LONG_MODEL["n_positions"] / d_step,
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "sparse_over_dense_step": step / d_step,
             "dense_over_sparse_tokens_per_s": d_step / step}
    log(f"[long-dense] {json.dumps(d_res)}")
    del engine, dense
    torch.cuda.empty_cache()
    return launches


# [onebit-long]: the long-sequence model at its full size (12 layers, T 8192,
# remat "dots", bf16) with 1-bit Adam at ZeRO 0, through the warmup into the
# frozen phase; at one card the collectives are the identity and the
# compression runs all the same
LONG = {}                       # [long]'s Adam ZeRO-2 result, for the comparison
ONEBIT_CONFIG = dict(LONG_CONFIG, optimizer={"type": "OneBitAdam",
                                             "params": {"lr": 1e-4, "freeze_step": 3}},
                     zero_optimization={"stage": 0})
ONEBIT_STEPS = 8
ONEBIT_FREEZE = 3
ONEBIT_EF_TOL = 4e-6            # m + we + se = out + we' + se', x max |m + we + se|
ONEBIT_CPU_TOL = 1e-5           # the card's exchange against the CPU's, x max |m + we|


def _onebit_warmup_check(opt, grads, state, master, step, hyper, apply):
    """One warmup step through ``apply`` and against the no-bias-correction
    formula written out here on the same card tensors: (max |m err|, max |v
    err|, max |master err| / max |master|)."""
    n_pad = state.exp_avg.numel()
    g, p0 = opt._flat(grads, n_pad), opt._flat(master, n_pad)
    m0, v0 = state.exp_avg.clone(), state.exp_avg_sq.clone()
    apply(grads, state, master, step, hyper)
    h = hyper[0]
    b1, b2 = np.float32(h["beta1"]), np.float32(h["beta2"])
    m1 = m0 * float(b1) + g * float(np.float32(1) - b1)
    v1 = v0 * float(b2) + g * g * float(np.float32(1) - b2)
    p1 = p0 - float(np.float32(h["lr"])) * (m1 / (torch.sqrt(v1) + float(np.float32(h["eps"])))
                                            + float(np.float32(h["weight_decay"])) * p0)
    p = opt._flat(master, n_pad)
    return (float((state.exp_avg - m1).abs().max()), float((state.exp_avg_sq - v1).abs().max()),
            float((p - p1).abs().max() / p1.abs().max()))


def phase_onebit_long():
    """``[long]``'s model at full size with 1-bit Adam (``freeze_step`` 3) at
    ZeRO 0 through ``initialize`` for ONEBIT_STEPS steps. Checks: the
    block-sparse kernels' launches as in ``[long]``, all on the tensor
    cores; finite losses, the last below the first; each warmup step's
    state and master against the no-bias-correction formula on the card's
    own grads; at the first frozen step ``exp_avg_sq`` unchanged bit for bit
    and the worker error non-zero; that step's exchange keeping the error
    feedback identity, and equal to the same function on the CPU from
    copies of its inputs. Returns the kernels' launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    tokens, labels = _long_batch(LONG_MODEL["vocab_size"], LONG_MODEL["n_positions"])
    torch.cuda.reset_peak_memory_stats()
    model = _long_model()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=ONEBIT_CONFIG)
    opt = engine._onebit
    if opt is None or opt.freeze_step != ONEBIT_FREEZE:
        raise AssertionError("[onebit-long] the engine did not configure 1-bit Adam")
    checks = {"warmup": []}
    apply, exchange = engine._opt_apply, opt.exchange
    rec = {}

    def checked_apply(grads, state, master, step, hyper, groups=None):
        if step <= ONEBIT_FREEZE:
            checks["warmup"].append(_onebit_warmup_check(opt, grads, state, master, step,
                                                         hyper, apply))
            return master, state
        v0 = state.exp_avg_sq.clone() if step == ONEBIT_FREEZE + 1 else None
        out = apply(grads, state, master, step, hyper)
        if v0 is not None:
            checks["v_unchanged_bitwise"] = bool(torch.equal(v0, state.exp_avg_sq))
            checks["worker_error_max"] = float(state.worker_error.abs().max())
        return out

    def recorded_exchange(m_local, we, se, segs):
        out = exchange(m_local, we, se, segs)
        if not rec:
            rec.update(inputs=(m_local.clone(), we.clone(), se.clone()),
                       outputs=tuple(t.clone() for t in out), segs=segs)
        return out

    engine._opt_apply, opt.exchange = checked_apply, recorded_exchange
    launchers = (bsa.block_sparse_fwd, bsa.block_sparse_bwd_dq, bsa.block_sparse_bwd_dkv)
    for f in launchers:
        f.launches = f.tensor_core_launches = 0
    losses, step_s = _train_steps(engine, tokens, labels, steps=ONEBIT_STEPS)
    launches = [f.launches for f in launchers]
    tc_launches = _bs_tensor_core_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_layer = LONG_MODEL["n_layer"]
    want = [2 * n_layer * ONEBIT_STEPS, n_layer * ONEBIT_STEPS, n_layer * ONEBIT_STEPS]
    if launches != want or tc_launches != want:
        raise AssertionError(f"[onebit-long] block-sparse launches {launches}, on the tensor "
                             f"cores {tc_launches}: not all of {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[onebit-long] losses not finite and falling: {losses}")
    worst = [max(c[i] for c in checks["warmup"]) for i in range(3)]
    if len(checks["warmup"]) != ONEBIT_FREEZE or worst[0] or worst[1] or worst[2] > 1e-6:
        raise AssertionError(f"[onebit-long] warmup steps against the formula: {checks}")
    if not checks.get("v_unchanged_bitwise") or not checks.get("worker_error_max", 0) > 0:
        raise AssertionError(f"[onebit-long] first frozen step: {checks}")
    m, we, se = rec["inputs"]
    out, we1, se1 = rec["outputs"]
    lhs = m + we + se
    ident = float((lhs - (out + we1 + se1)).abs().max() / lhs.abs().max())
    t0 = time.perf_counter()
    cpu_out = exchange(*(t.cpu() for t in (m, we, se)), rec["segs"])
    cpu_s = time.perf_counter() - t0
    scale = float((m + we).abs().max())
    cpu_err = [float((a.cpu() - b).abs().max()) / scale for a, b in zip(rec["outputs"], cpu_out)]
    if ident > ONEBIT_EF_TOL or max(cpu_err) > ONEBIT_CPU_TOL:
        raise AssertionError(f"[onebit-long] error feedback identity {ident!r} (tol "
                             f"{ONEBIT_EF_TOL}), card vs CPU {cpu_err} (tol {ONEBIT_CPU_TOL})")
    steady = step_s[2:]
    step = statistics.median(steady)
    res = {"steps": ONEBIT_STEPS, "freeze_step": ONEBIT_FREEZE, "losses": losses,
           "step_ms_median": step * 1e3, "step_ms_all": [s * 1e3 for s in step_s],
           "warmup_step_ms": [s * 1e3 for s in step_s[:ONEBIT_FREEZE]],
           "frozen_step_ms": [s * 1e3 for s in step_s[ONEBIT_FREEZE:]],
           "max_memory_allocated_gb": peak, "padded_elements": int(m.numel()),
           "segments": rec["segs"].n_segs,
           "block_sparse_launches": launches, "tensor_core_launches": tc_launches,
           "warmup_max_err (m, v, master rel)": worst,
           "v_unchanged_bitwise": checks["v_unchanged_bitwise"],
           "worker_error_max": checks["worker_error_max"],
           "ef_identity_rel_err": ident, "card_vs_cpu_rel_err (out, we, se)": cpu_err,
           "cpu_exchange_s": cpu_s,
           "long_adam_zero2_step_ms_median": LONG.get("step_ms_median"),
           "long_adam_zero2_max_memory_gb": LONG.get("max_memory_allocated_gb")}
    log(f"[onebit-long] {json.dumps(res)}")
    del engine, model, rec, m, we, se, out, we1, se1, lhs, cpu_out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# [resnet]: the CIFAR ResNet (models/resnet.py's default: width 32, stages
# (2, 2, 2), GroupNorm 8) on seeded synthetic CIFAR-shaped batches (NHWC
# 32x32x3, 10 classes; no CIFAR-10 data is in the repository)
RESNET_BATCH = 256
RESNET_STEPS = 4


def _cifar_batch(batch, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, (batch,)).astype(np.int64)
    images = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32) * 0.3
    images += (labels[:, None, None, None] / classes - 0.5) * 2.0
    return images, labels


def _resnet_config(stage):
    # docs/cifar.md: Adam and OneCycle; ZeRO 2 keeps bf16 parameters (the
    # config's rule) while the model computes in float32
    return {"train_batch_size": RESNET_BATCH, "steps_per_print": 1000,
            "bf16": {"enabled": stage > 0},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "scheduler": {"type": "OneCycle", "params": {
                "cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 2}},
            "zero_optimization": {"stage": stage}}


def _resnet(device):
    from deepspeed_tpu_torch.models.resnet import ResNet
    model = ResNet(device="cpu")
    model.init(torch.Generator().manual_seed(0))     # the same weights on both devices
    return model.to(device)


def phase_resnet():
    """The default CIFAR ResNet through ``initialize`` at batch 256, ZeRO 0
    (float32) then ZeRO 2 (bf16 parameters): losses falling over
    RESNET_STEPS steps; the first step's loss and grad norm, and the grads
    of one float32 backward (their whole vector's relative error), equal the
    CPU's within TRAIN_TOL_F32."""
    import deepspeed_tpu_torch
    images, labels = _cifar_batch(RESNET_BATCH)
    out = {}
    for stage in (0, 2):
        first = {}
        for device in ("cuda", "cpu"):
            engine, _, _, _ = deepspeed_tpu_torch.initialize(
                model=_resnet(device), config_params=_resnet_config(stage), device=device)
            losses, norms, step_s = [], [], []
            for _ in range(RESNET_STEPS if device == "cuda" else 1):
                if device == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                loss = engine(images, labels)
                engine.backward(loss)
                engine.step()
                losses.append(float(loss.detach()))
                norms.append(float(engine._last_grad_norm))
                step_s.append(time.perf_counter() - t)
            first[device] = (losses[0], norms[0])
            if device == "cuda":
                if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                    raise AssertionError(f"[resnet] ZeRO {stage} losses not finite and "
                                         f"falling: {losses}")
                out[f"zero{stage}"] = {"losses": losses, "step_ms": [s * 1e3 for s in step_s],
                                       "images_per_s": RESNET_BATCH / statistics.median(
                                           step_s[1:])}
            del engine
        rel = [abs(a - b) / abs(b) for a, b in zip(first["cuda"], first["cpu"])]
        out[f"zero{stage}"].update(first_step_cuda=first["cuda"], first_step_cpu=first["cpu"],
                                   first_step_rel_diff=rel)
        if max(rel) > TRAIN_TOL_F32:
            raise AssertionError(f"[resnet] ZeRO {stage} first step (loss, grad norm) "
                                 f"{first} differ by {rel} (tol {TRAIN_TOL_F32})")
    grads = {}
    for device in ("cuda", "cpu"):
        model = _resnet(device)
        loss = model(torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device))
        loss.backward()
        grads[device] = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    cpu = grads["cpu"]
    # the whole gradient's relative error; a leaf's own (a GroupNorm scale's
    # grad sums 262,144 products with cancellation) is logged beside it
    diff = math.sqrt(sum(float(((grads["cuda"][n] - g) ** 2).sum()) for n, g in cpu.items()))
    whole = math.sqrt(sum(float((g ** 2).sum()) for g in cpu.values()))
    out["grad_rel_err"] = diff / whole
    out["per_leaf_grad_norm_max_rel_diff"] = max(
        abs(float(grads["cuda"][n].norm()) - float(g.norm())) / max(float(g.norm()), 1e-30)
        for n, g in cpu.items())
    out["params"] = sum(g.numel() for g in cpu.values())
    if out["grad_rel_err"] > TRAIN_TOL_F32:
        raise AssertionError(f"[resnet] the card's grads differ from the CPU's by "
                             f"{out['grad_rel_err']} (tol {TRAIN_TOL_F32})")
    log(f"[resnet] {json.dumps(out)}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_crash_sim():
    """``ds-tpu-torch crash-sim`` and ``crash-sim --goodput`` on the card and
    on the CPU: every scenario recovers (bit-equal retrain, warm restart
    token-identical with fewer prefill chunks) and the card's transcripts
    equal the CPU's byte for byte. The recovery run on the CPU overlaps the
    card's; the goodput runs bill wall-clock against injected stalls within
    10%, so each runs with no other process of this script busy."""
    from deepspeed_tpu_torch import cli
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = {"crash": [], "goodput": ["--goodput"]}

    def cpu_run(name):
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.cli", "crash-sim", *runs[name],
               "--device", "cpu", "--json", os.path.join(out_dir, f"{name}_cpu.json")]
        with open(os.path.join(out_dir, f"{name}_cpu.log"), "wb") as out:
            return subprocess.Popen(cmd, cwd=str(root), env=env, stdout=out,
                                    stderr=subprocess.STDOUT)

    def card_run(name):
        t0 = time.perf_counter()
        rc = cli.main(["crash-sim", *runs[name], "--device", "cuda", "--json",
                       os.path.join(out_dir, f"{name}_cuda.json")])
        times[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[crash-sim] {name} on the card exited {rc}")

    def wait(name, child):
        if child.wait(timeout=300) != 0:
            out = Path(out_dir, f"{name}_cpu.log").read_text(errors="replace")
            raise AssertionError(f"[crash-sim] {name} on the CPU exited "
                                 f"{child.returncode}: {out[-3000:]}")

    times, child = {}, cpu_run("crash")
    try:
        card_run("crash")
        wait("crash", child)
        card_run("goodput")
        child = cpu_run("goodput")
        wait("goodput", child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    texts = {}
    for name in runs:
        for device in ("cuda", "cpu"):
            with open(os.path.join(out_dir, f"{name}_{device}.json")) as f:
                texts[name, device] = f.read()
        if texts[name, "cuda"] != texts[name, "cpu"]:
            raise AssertionError(f"[crash-sim] {name} transcripts differ between the card "
                                 f"and the CPU")
    crash = json.loads(texts["crash", "cuda"])
    serve = {k: (v["warm_prefill_chunks"], v["cold_prefill_chunks"])
             for k, v in crash["scenarios"].items() if k.startswith("serve_")}
    if not crash["ok"] or any(w >= c for w, c in serve.values()):
        raise AssertionError(f"[crash-sim] recovery failed: {crash}")
    log(f"[crash-sim] {json.dumps({'card_s': times, 'transcripts_equal_cpu': True, 'scenarios': sorted(crash['scenarios']), 'warm_vs_cold_prefill_chunks': serve, 'goodput_ok': json.loads(texts['goodput', 'cuda'])['ok']})}")
    shutil.rmtree(out_dir, ignore_errors=True)


def profile_step(tag, engine, *batch, top=15):
    """One optimizer step of one micro-batch under torch.profiler:
    device-busy share and top kernels."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.backward(engine(*batch))
        engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[{tag}] window {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / wall_us:.3f} of the window)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[{tag}] {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
            f"{e.key[:90]}")
    return busy_us / wall_us


# ------------------------------------------------------------ the fused block
# GPT-2 124M: GPT2Config's own width and depth, vocab padded as bench.py pads it
FUSED_MODEL = dict(vocab_size=50304, n_positions=1024, n_embd=768, n_layer=12, n_head=12,
                   fused_block=True, remat=False, loss_chunk=128)
FUSED_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 8,
                "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-4, "betas": [0.9, 0.95],
                                         "weight_decay": 0.1}},
                "steps_per_print": 1000}
FUSED_STEPS, UNFUSED_STEPS = 10, 6
FUSED_SHAPE = (8, 1024, 768, 12)   # B, T, E, heads of the fused path


def _fused_operands(B, T, E, dtype, seed=0):
    """x and the six parameters as the wrapper hands them to the kernels:
    weights in x's dtype, LayerNorm parameters and biases float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def mk(shape, scale=0.05):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return [mk((B, T, E), 1.0).to(dtype), 1.0 + mk((E,)), mk((E,)), mk((E, 3 * E)).to(dtype),
            mk((3 * E,)), mk((E, E)).to(dtype), mk((E,))]


def _fused_bounds(B, T, E, H, itemsize, causal):
    """(flops, bytes) of the tensor-core design's two entries and of the
    whole op: each input read once, each output written once (the first
    entry writes q, k and v; the second reads them)."""
    tile, vec = B * T * E * itemsize, 4 * E
    attn = 4 * B * H * T * T * (E // H) // (2 if causal else 1)
    qkv = (2 * B * T * E * 3 * E, tile + 3 * E * E * itemsize + 5 * vec + 3 * tile)
    out = (2 * B * T * E * E + attn, 3 * tile + tile + E * E * itemsize + vec + tile)
    whole = (qkv[0] + out[0], 2 * tile + 4 * E * E * itemsize + 6 * vec)
    return qkv, out, whole


def _bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _fused_counts():
    from deepspeed_tpu_torch.ops import fused_block as fb
    return (fb.fused_transformer_block.launches, fb.fused_transformer_block.tc_launches,
            fb.fused_block_kv.launches, fb.fused_block_q.launches,
            fb.fused_block_qkv_tc.launches, fb.fused_block_attn_tc.launches)


def _fused_entries(tc):
    """The two entries of a design, each (kernel, plain version), over x, the
    operands and a workspace of the design's layout; the second entry takes
    the workspace ``ws``."""
    from deepspeed_tpu_torch.ops import fused_block as fb
    if tc:
        return ((lambda ops, H: fb.fused_block_qkv_tc(*ops[:5], n_head=H),
                 lambda ops, H: fb.fused_block_qkv_plain(*ops[:5], H)),
                (lambda ops, ws, H, c: fb.fused_block_attn_tc(ops[0], ws, *ops[5:], n_head=H,
                                                              causal=c),
                 lambda ops, ws, H, c: fb.fused_block_attn_plain(ops[0], ws, *ops[5:], H, c)))
    return ((lambda ops, H: fb.fused_block_kv(*ops[:5]),
             lambda ops, H: fb.fused_block_kv_plain(*ops[:5])),
            (lambda ops, ws, H, c: fb.fused_block_q(ops[0], ws, *ops[1:], n_head=H, causal=c),
             lambda ops, ws, H, c: fb.fused_block_q_plain(ops[0], ws, *ops[1:], H, c)))


def phase_fused_block_kernels():
    """The fused-block entries and their wrapper against the plain versions
    at the fused path's shape and at other shapes, each case on the design
    the shape rule names (checked by the launch counts); gradients; times."""
    from deepspeed_tpu_torch.ops import fused_block as fb
    cases = [  # (B, T, E, heads, dtype, causal)
        (*FUSED_SHAPE, torch.bfloat16, True),         # the main path
        (2, 64, 32, 4, torch.float32, True),          # the JAX tests' shape
        (2, 64, 32, 4, torch.float32, False),
        (2, 1000, 768, 12, torch.bfloat16, True),     # ragged tail
        (2, 512, 768, 12, torch.float16, False),
        (2, 512, 1024, 16, torch.bfloat16, True),     # E = 1024
        (1, 4096, 768, 12, torch.bfloat16, True),     # one long row
        (2, 1024, 1600, 25, torch.bfloat16, True),    # GPT-2 1.5B's width (fault C3)
        (2, 512, 768, 6, torch.bfloat16, True),       # head dim 128 (fault C3)
        (2, 512, 1024, 16, torch.float32, True),      # float32 E 1024: 16 rows (fault C3)
        (2, 512, 1600, 20, torch.bfloat16, True),     # heads of 80 on the CUDA cores (C3)
    ]
    main, worst = None, {"qkv": 0.0, "attn": 0.0}
    for case in cases:
        B, T, E, H, dtype, causal = case
        ops = _fused_operands(B, T, E, dtype)
        tc = fb.tensor_core_design(dtype, E, H)
        (first, first_p), (second, second_p) = _fused_entries(tc)
        ws = first(ops, H)
        ws_p = first_p(ops, H)
        out = second(ops, ws_p, H, causal)
        out_p = second_p(ops, ws_p, H, causal)
        before = _fused_counts()
        full = fb.fused_transformer_block(*ops, H, causal=causal)
        ran = [a - b for a, b in zip(_fused_counts(), before)]
        full_p = fb.fused_block_plain(*ops, H, causal)
        torch.cuda.synchronize()
        design = "tensor cores" if tc else "CUDA cores"
        if ran != ([1, 1, 0, 0, 1, 1] if tc else [1, 0, 1, 1, 0, 0]):
            raise AssertionError(f"fused block {case}: launches {ran} are not the {design} "
                                 "design's that the shape rule names")
        tol = FLASH_TOL[dtype]
        errs = {"qkv": _scaled_err(ws.float(), ws_p.float()),
                "attn": _scaled_err(out.float(), out_p.float()),
                "wrapper": _scaled_err(full.float(), full_p.float())}
        log(f"[fused] {case} {design}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (scaled by max |ref|, tol {tol})")
        if not all(torch.isfinite(t).all() for t in (ws, out, full)):
            raise AssertionError(f"fused block {case}: non-finite output")
        if max(errs.values()) > tol:
            raise AssertionError(f"fused-block kernels vs plain, case {case}: {errs} > {tol}")
        if main is None:
            main = {"qkv": (float((ws.float() - ws_p.float()).abs().max()), errs["qkv"]),
                    "attn": (float((out.float() - out_p.float()).abs().max()), errs["attn"])}
        if tc:
            for k in worst:
                worst[k] = max(worst[k], errs[k])
        del ws, ws_p, out, out_p, full, full_p, ops
    torch.cuda.empty_cache()

    # gradients of sum(out * g) through the wrapper (kernel forward, reference
    # backward) against autograd of the plain version
    for B, T, E, H, dtype in ((*FUSED_SHAPE, torch.bfloat16), (2, 64, 32, 4, torch.float32)):
        ops = _fused_operands(B, T, E, dtype, seed=1)
        g = torch.randn((B, T, E), generator=torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
        grads = []
        for fn in (fb.fused_transformer_block, fb.fused_block_plain):
            leaves = [t.clone().requires_grad_() for t in ops]
            (fn(*leaves, H).float() * g).sum().backward()
            grads.append([t.grad.float() for t in leaves])
        torch.cuda.synchronize()
        gerr = max(_scaled_err(a, b) for a, b in zip(*grads))
        log(f"[fused] gradients {(B, T, E, H, dtype)}: worst of 7, {gerr:.2e} "
            f"(scaled by max |ref|, tol {FLASH_TOL[dtype]})")
        if gerr > FLASH_TOL[dtype]:
            raise AssertionError(f"fused-block gradients vs the plain version: {gerr}")
        del grads, ops
    torch.cuda.empty_cache()
    return time_fused(main, worst)


def time_fused(main_err, worst):
    """Device times at the main shape, x rotating over 4 sets (x, workspace
    and output 63 MB a set), each by CUDA-graph replays of the 4 calls
    (``graph_ms``: the unfused composition is some 20 small kernels, and an
    eager loop of it times the host's enqueue): the tensor-core design's
    entries, the CUDA-core design's on the same inputs and the unfused
    composition (LayerNorm, bf16 GEMMs and the flash forward kernel), in
    turns (new, old, unfused, unfused, old, new; the mean of the two); then
    eager loops of the wrapper and the unfused composition, and the plain
    versions, once."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_block as fb
    B, T, E, H = FUSED_SHAPE
    sets = []
    for i in range(4):
        ops = _fused_operands(B, T, E, torch.bfloat16, seed=10 + i)
        sets.append((ops, fb.fused_block_qkv_tc(*ops[:5], n_head=H), fb.fused_block_kv(*ops[:5])))

    def unfused(x, scale, bias, wq, bq, wp, bp):
        h = fb._layer_norm_f32(x, scale, bias, 1e-5).to(x.dtype)
        qkv = torch.matmul(h, wq) + bq.to(x.dtype)
        q, k, v = (t.reshape(B, T, H, E // H).transpose(1, 2) for t in qkv.split(E, dim=-1))
        y = fa.flash_attention(q, k, v, True).transpose(1, 2).reshape(B, T, E)
        return x + (torch.matmul(y, wp) + bp.to(x.dtype))

    (new_qkv, new_qkv_p), (new_attn, new_attn_p) = _fused_entries(True)
    (old_kv, old_kv_p), (old_q, old_q_p) = _fused_entries(False)
    timers = {
        "new": lambda: (graph_ms(lambda i: new_qkv(sets[i][0], H), 4),
                        graph_ms(lambda i: new_attn(sets[i][0], sets[i][1], H, True), 4)),
        "old": lambda: (graph_ms(lambda i: old_kv(sets[i][0], H), 4, replays=5),
                        graph_ms(lambda i: old_q(sets[i][0], sets[i][2], H, True), 4, replays=5)),
        "unfused": lambda: graph_ms(lambda i: unfused(*sets[i][0]), 4),
    }
    turns = {k: [] for k in timers}
    with torch.no_grad():
        for name in ("new", "old", "unfused", "unfused", "old", "new"):
            turns[name].append(timers[name]())
        ms = {name: [statistics.mean(t[j] for t in turns[name]) for j in range(2)]
              for name in ("new", "old")}
        unfused_ms = statistics.mean(turns["unfused"])
        wrapper_ms = time_ms(lambda i: fb.fused_transformer_block(*sets[i % 4][0], H), 20)
        unfused_eager_ms = time_ms(lambda i: unfused(*sets[i % 4][0]), 20)
        # the first entry at half the CTAs: if its time holds, each CTA's own
        # chain bounds it, not the card's shared L2 or memory bandwidth
        qkv_half_batch_ms = graph_ms(lambda i: new_qkv([sets[i][0][0][:B // 2],
                                                        *sets[i][0][1:]], H), 4)
        plain = [time_ms(lambda i: new_qkv_p(sets[i % 4][0], H), 8),
                 time_ms(lambda i: new_attn_p(sets[i % 4][0], sets[i % 4][1], H, True), 8)]
    del sets
    torch.cuda.empty_cache()

    qkv_w, attn_w, whole_w = _fused_bounds(B, T, E, H, 2, True)
    whole_ms, whole_by = _bound_ms(*whole_w, BF16_FLOPS)
    log("[fused] " + json.dumps({
        "name": "fused_transformer_block", "shape": FUSED_SHAPE, "design": "tensor cores",
        "ms": sum(ms["new"]), "old_ms": sum(ms["old"]), "turns_ms": turns,
        "plain_ms": sum(plain), "unfused_composition_ms": unfused_ms,
        "eager_loop_ms": {"wrapper": wrapper_ms, "unfused_composition": unfused_eager_ms},
        "qkv_ms_at_half_batch": qkv_half_batch_ms,
        "gflop": whole_w[0] / 1e9,
        "mbytes": whole_w[1] / 1e6, "bound_ms": whole_ms, "bound_by": whole_by}))
    entries = []
    for j, (name, work) in enumerate((("fused_block_qkv_tc", qkv_w),
                                      ("fused_block_attn_tc", attn_w))):
        key = ("qkv", "attn")[j]
        b_ms, b_by = _bound_ms(*work, BF16_FLOPS)
        e = {"name": name, "route": "cuda", "design": "tensor cores",
             "source": "deepspeed_tpu_torch/csrc/fused_block_tc.cu",
             "replaces": "deepspeed_tpu/ops/pallas/fused_block.py:86:_fused_block_kernel",
             "launches": None, "max_abs_err": main_err[key][0],
             "scaled_err": main_err[key][1], "worst_scaled_err": worst[key],
             "tol": FLASH_TOL[torch.bfloat16], "kernel_ms": ms["new"][j], "ms": ms["new"][j],
             "old_ms": ms["old"][j], "plain_ms": plain[j], "library_ms": None,
             "unfused_composition_ms": unfused_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"[fused] {json.dumps(e)}")
        entries.append(e)
    return entries


def _fused_model(**over):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(**dict(FUSED_MODEL, **over)))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model


def _step_stats(step_s, tokens_per_step, n_params):
    steady = step_s[2:]
    step = statistics.median(steady)
    tok_s = tokens_per_step / step
    return {"step_ms_median": step * 1e3, "step_ms_min": min(steady) * 1e3,
            "step_ms_max": max(steady) * 1e3, "step_ms_all": [s * 1e3 for s in step_s],
            "tokens_per_s": tok_s, "params": n_params,
            "mfu": tok_s * 6 * n_params / BF16_FLOPS,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_fused_training():
    """GPT-2 124M with the fused block through deepspeed_tpu_torch.initialize
    on the card; then the same model with flash attention."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_block as fb

    tokens, labels = _train_batch(FUSED_MODEL["vocab_size"])
    m32 = _fused_model(n_layer=2, compute_dtype=torch.float32)
    before = fb.fused_transformer_block.launches
    l32k, l32p, n32 = _kernel_vs_plain(m32, tokens, labels)
    if fb.fused_transformer_block.launches - before != 2:
        raise AssertionError("the kernel path did not launch the fused block once per layer, "
                             "or the plain path launched it")
    log(f"[fused-train] float32 2 layers, kernel vs plain: loss {l32k!r} vs {l32p!r}, "
        f"per-layer grad norms max rel diff {n32!r} (tol {TRAIN_TOL_F32})")
    if abs(l32k - l32p) > TRAIN_TOL_F32 * abs(l32p) or n32 > TRAIN_TOL_F32:
        raise AssertionError("float32 fused path disagrees with the plain path")
    del m32
    torch.cuda.empty_cache()

    model = _fused_model()
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=FUSED_CONFIG)
    lk, lp, nrel = _kernel_vs_plain(engine.module, tokens, labels)
    log(f"[fused-train] bf16 12 layers, first micro-batch kernel vs plain: loss {lk!r} vs "
        f"{lp!r}, per-layer grad norms max rel diff {nrel!r} (tol {TRAIN_TOL_BF16})")
    if abs(lk - lp) > TRAIN_TOL_BF16[0] or nrel > TRAIN_TOL_BF16[1]:
        raise AssertionError("bf16 fused path disagrees with the plain path")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()      # the training steps' peak, not the check's
    for f in (fb.fused_block_kv, fb.fused_block_q, fb.fused_block_qkv_tc,
              fb.fused_block_attn_tc, fb.fused_transformer_block):
        f.launches = 0
    fb.fused_transformer_block.tc_launches = 0
    losses, step_s = _train_steps(engine, tokens, labels, steps=FUSED_STEPS)
    launches = [fb.fused_block_qkv_tc.launches, fb.fused_block_attn_tc.launches,
                fb.fused_transformer_block.launches, fb.fused_transformer_block.tc_launches]
    log(f"[fused-train] step losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fused training losses not finite and decreasing: {losses}")
    n_layer = FUSED_MODEL["n_layer"]
    if (launches != [n_layer * FUSED_STEPS] * 4
            or fb.fused_block_kv.launches or fb.fused_block_q.launches):
        raise AssertionError(f"fused-block launches {launches} (entries, wrapper, tensor-core "
                             f"design) != {n_layer} x {FUSED_STEPS} micro-steps each, all on "
                             "the tensor-core design")
    res = {"steps": FUSED_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
           **_step_stats(step_s, tokens.numel(), n_params),
           "fused_block_launches": launches, "first_micro_loss_kernel": lk,
           "first_micro_loss_plain": lp, "grad_norm_max_rel_diff": nrel,
           "f32_2_layer": [l32k, l32p, n32]}
    log(f"[fused-train] {json.dumps(res)}")
    profile_step("profile-fused", engine, tokens, labels)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    # the same model, unfused, with the flash kernels
    torch.cuda.reset_peak_memory_stats()
    unfused = _fused_model(fused_block=False, use_flash_attention=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=unfused, config_params=FUSED_CONFIG)
    before = (fa.flash_attention_fwd.launches, fb.fused_transformer_block.launches)
    u_losses, u_step_s = _train_steps(engine, tokens, labels, steps=UNFUSED_STEPS)
    if (fa.flash_attention_fwd.launches - before[0] != n_layer * UNFUSED_STEPS
            or fb.fused_transformer_block.launches != before[1]):
        raise AssertionError("the unfused comparison did not run the flash kernels alone")
    if not all(np.isfinite(u_losses)):
        raise AssertionError(f"unfused losses not finite: {u_losses}")
    u_res = {"steps": UNFUSED_STEPS, "losses": u_losses,
             **_step_stats(u_step_s, tokens.numel(), n_params)}
    u_res["fused_over_unfused_step"] = res["step_ms_median"] / u_res["step_ms_median"]
    log(f"[fused-train-unfused] {json.dumps(u_res)}")
    log(f"[fused-train] GPT-2 124M step: fused {res['step_ms_median']:.1f} ms, unfused "
        f"{u_res['step_ms_median']:.1f} ms, fused/unfused {u_res['fused_over_unfused_step']:.3f}")
    del engine, unfused
    gc.collect()
    torch.cuda.empty_cache()
    return launches[:2]


# ------------------------------------------------------------------------- BERT
# BERT-large (docs/bert.md:25-26) at tests/perf/transformer_layer_perf.py's
# second shape, LAMB as examples/train_bert_mlm.py:38
BERT_MODEL = dict(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096, max_position_embeddings=512,
                  use_flash_attention=True)
BERT_BATCH, BERT_SEQ, BERT_STEPS = 16, 512, 10
BERT_CONFIG = {"train_batch_size": BERT_BATCH, "steps_per_print": 1000,
               "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
               "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}}}
LAYER_SHAPES = ((128, 64), (512, 16))    # (seq, batch) of the one-layer check


def _padding_mask(batch, seq, rng):
    """[B, T] 1/0 mask: rows keep between half and all of their positions."""
    lengths = rng.randint(seq // 2, seq + 1, size=batch)
    lengths[0] = seq
    return (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32)


def _bert_batch():
    """(input_ids, labels, token_type_ids, attention_mask): 15% of the kept
    positions masked ([MASK] = 103) with their labels, -100 elsewhere."""
    rng = np.random.RandomState(0)
    ids = rng.randint(1000, BERT_MODEL["vocab_size"], size=(BERT_BATCH, BERT_SEQ))
    mask = _padding_mask(BERT_BATCH, BERT_SEQ, rng)
    chosen = (rng.rand(BERT_BATCH, BERT_SEQ) < 0.15) & (mask > 0)
    labels = np.where(chosen, ids, -100)
    inputs = np.where(chosen, 103, ids)
    return (torch.from_numpy(inputs).cuda(), torch.from_numpy(labels).cuda(), None,
            torch.from_numpy(mask).cuda())


def _bert_model(**over):
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    model = BertForMaskedLM(BertConfig(**dict(BERT_MODEL, **over)))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model


def _bert_grad_norms(model):
    """float32 grad norm of each layer, then of the embeddings (the
    token-type table has no grad when the batch has no token types)."""
    groups = [list(l.parameters()) for l in model.layers] + [list(model.embeddings.parameters())]
    return torch.stack([torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                                       for p in g if p.grad is not None))
                        for g in groups]).cpu()


def _bert_kernel_vs_plain(model, batch):
    """(loss, loss, max relative grad-norm difference) of the flash path and
    the dense attention path of one micro-batch; grads cleared."""
    out = []
    for flash in (True, False):
        for layer in model.layers:
            layer.config.use_flash_attention = flash
        loss = model(*batch)
        loss.backward()
        out.append((loss.item(), _bert_grad_norms(model)))
        model.zero_grad(set_to_none=True)
        del loss
    for layer in model.layers:
        layer.config.use_flash_attention = True
    torch.cuda.synchronize()
    (lk, nk), (lp, npl) = out
    return lk, lp, float(((nk - npl).abs() / npl).max())


def phase_bert_training():
    """BERT-large masked-LM through deepspeed_tpu_torch.initialize on the
    card, then the one-layer check with the mask and train-mode dropout."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import flash_attention as fa

    batch = _bert_batch()
    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    m32 = _bert_model(num_hidden_layers=2, compute_dtype=torch.float32)
    before = fa.flash_attention_fwd.launches
    l32k, l32p, n32 = _bert_kernel_vs_plain(m32, batch)
    if fa.flash_attention_fwd.launches - before != 2:
        raise AssertionError("the flash path did not launch once per layer, or the dense "
                             "path launched the kernel")
    log(f"[bert] float32 2 layers, kernel vs plain: loss {l32k!r} vs {l32p!r}, "
        f"per-layer grad norms max rel diff {n32!r} (tol {TRAIN_TOL_F32})")
    if abs(l32k - l32p) > TRAIN_TOL_F32 * abs(l32p) or n32 > TRAIN_TOL_F32:
        raise AssertionError("float32 BERT flash path disagrees with the dense path")
    del m32
    torch.cuda.empty_cache()

    model = _bert_model()
    n_params = model.param_count()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=BERT_CONFIG)
    lk, lp, nrel = _bert_kernel_vs_plain(engine.module, batch)
    log(f"[bert] bf16 24 layers, first micro-batch kernel vs plain: loss {lk!r} vs {lp!r}, "
        f"per-layer grad norms max rel diff {nrel!r} (tol {TRAIN_TOL_BF16})")
    if abs(lk - lp) > TRAIN_TOL_BF16[0] or nrel > TRAIN_TOL_BF16[1]:
        raise AssertionError("bf16 BERT flash path disagrees with the dense path")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()      # the training steps' peak, not the check's
    for f in launchers:
        f.launches = f.tensor_core_launches = 0
    losses, step_s = _train_steps(engine, *batch, steps=BERT_STEPS)
    launches = [f.launches for f in launchers]
    log(f"[bert] step losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"BERT losses not finite and decreasing: {losses}")
    n_layer = BERT_MODEL["num_hidden_layers"]
    if launches != [n_layer * BERT_STEPS] * 3:
        raise AssertionError(f"flash launches {launches} != {n_layer} x {BERT_STEPS} "
                             "micro-steps each")
    if _tensor_core_launches() != launches:
        raise AssertionError(f"tensor-core launches (fwd, dq, dk/dv) {_tensor_core_launches()}: "
                             f"not every launch of {launches} ran the tensor cores")
    res = {"steps": BERT_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
           **_step_stats(step_s, BERT_BATCH * BERT_SEQ, n_params),
           "masked_positions": int((batch[1] >= 0).sum()),
           "kept_positions": int(batch[3].sum()), "flash_launches": launches,
           "tensor_core_launches": _tensor_core_launches(),
           "first_micro_loss_kernel": lk, "first_micro_loss_plain": lp,
           "grad_norm_max_rel_diff": nrel, "f32_2_layer": [l32k, l32p, n32]}
    log(f"[bert] {json.dumps(res)}")
    profile_step("profile-bert", engine, *batch, top=20)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    bert_layer_check()
    return launches


def bert_layer_check():
    """One BERT-large layer (pre-LN, bf16), forward + backward of
    sum(out ** 2) with a padding mask and train-mode dropout 0.1: the flash
    path against the dense path under the same generator seed (both draw
    one attention seed; the dense path's keep mask is
    ``dropout_keep_reference`` of it); then the flash path's time."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                     DeepSpeedTransformerLayer)
    for seq, batch in LAYER_SHAPES:
        cfg = DeepSpeedTransformerConfig(
            batch_size=batch, max_seq_length=seq, hidden_size=1024, intermediate_size=4096,
            heads=16, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1, num_hidden_layers=24,
            fp16=False, pre_layer_norm=True)
        layer = DeepSpeedTransformerLayer(cfg)
        layer.init(torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.RandomState(1)
        x = torch.from_numpy(rng.randn(batch, seq, 1024).astype(np.float32)).cuda().bfloat16()
        keep = torch.from_numpy(_padding_mask(batch, seq, rng)).cuda()
        mask = ((1.0 - keep) * -1e9)[:, None, None, :]

        def fwd_bwd(seed=1):
            xs = x.clone().requires_grad_()
            out = layer(xs, mask, generator=torch.Generator(device="cuda").manual_seed(seed),
                        deterministic=False)
            out.float().square().sum().backward()
            grads = [xs.grad] + [p.grad for p in layer.parameters()]
            layer.zero_grad(set_to_none=True)
            return [out.detach().float()] + [g.float() for g in grads]

        before = [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                       fa.flash_attention_bwd_dkv)]
        got = fwd_bwd()
        after = [f.launches for f in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                      fa.flash_attention_bwd_dkv)]
        other_seed = fwd_bwd(seed=2)[0]
        cfg.use_flash_attention = False
        want = fwd_bwd()
        cfg.use_flash_attention = True
        torch.cuda.synchronize()
        if [a - b for a, b in zip(after, before)] != [1, 1, 1]:
            raise AssertionError("the layer did not launch each flash kernel once")
        if torch.equal(got[0], other_seed):
            raise AssertionError("train-mode dropout did not depend on the generator seed")
        names = ["out", "dx"] + list(layer.NAMES)
        errs = {n: _scaled_err(a, b) for n, a, b in zip(names, got, want)}
        tol = FLASH_TOL[torch.bfloat16]
        worst = max(errs, key=errs.get)
        log(f"[bert-layer] seq {seq} batch {batch}, mask + dropout 0.1, flash vs dense under "
            f"one seed: out {errs['out']:.2e}, dx {errs['dx']:.2e}, worst {worst} "
            f"{errs[worst]:.2e} (scaled by max |ref|, tol {tol})")
        if not all(torch.isfinite(t).all() for t in got) or errs[worst] > tol:
            raise AssertionError(f"BERT layer flash vs dense, seq {seq}: {errs}")
        del got, want, other_seed
        ms = time_ms(lambda i: fwd_bwd(), 10)
        mm = 2 * batch * seq * 1024 * (4 * 1024 + 2 * 4096)
        attn = 4 * batch * 16 * seq * seq * 64
        log(f"[bert-layer] seq {seq} batch {batch}: forward + backward {ms!r} ms, "
            f"{3 * (mm + attn) / ms / 1e9:.1f} TFLOP/s (3 x forward flops)")
        del layer, x
        torch.cuda.empty_cache()


# -------------------------------------------------- single-card paths, first runs
# tests/perf/long_seq_model_perf.py's Variable layout at T = 8192, 16 heads,
# block 256 (long_sparsity), D 64, bf16 operands; the masked path's padding:
# keys from SINGLE_VALID on are masked by an additive key-padding mask
SINGLE_VALID = 6144
BERT_HEAD_STEPS = 3


def _bs_counts():
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    return [f.launches for f in (bsa.block_sparse_fwd, bsa.block_sparse_bwd_dq,
                                 bsa.block_sparse_bwd_dkv)]


def sparse_matmul_softmax_checks():
    """MatMul in modes sdd, dsd and dds and Softmax at the Variable layout
    on card tensors, against float32 dense masked products of the same
    operands."""
    from deepspeed_tpu_torch.ops.sparse_attention import MatMul, Softmax
    from deepspeed_tpu_torch.ops.sparse_attention.matmul import dense_to_sparse, sparse_to_dense
    B, H, T, D = BS_SHAPE
    blk = 256
    layout = long_sparsity().make_layout(T)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    tol = FLASH_TOL[torch.bfloat16]
    errs = {}
    scores = MatMul(layout, blk, "sdd", trans_b=True)(q, k)
    want = dense_to_sparse(q.float() @ k.float().transpose(-1, -2), layout, blk)
    errs["sdd"] = _scaled_err(scores.float(), want)
    scale = 1.0 / math.sqrt(D)
    probs = Softmax(layout, blk)(scores, scale=scale)
    dense = sparse_to_dense(scores.float(), layout, blk, fill=-math.inf) * scale
    errs["softmax"] = _scaled_err(probs.float(),
                                  dense_to_sparse(torch.softmax(dense, -1), layout, blk))
    del dense, want
    dense_p = sparse_to_dense(probs.float(), layout, blk)
    out = MatMul(layout, blk, "dsd")(probs, v)
    errs["dsd"] = _scaled_err(out.float(), dense_p @ v.float())
    vt = v.transpose(-1, -2).contiguous()
    out = MatMul(layout, blk, "dds")(vt, probs)
    errs["dds"] = _scaled_err(out.float(), vt.float() @ dense_p)
    log(f"[single-card] sparse MatMul / Softmax at {BS_SHAPE}, Variable layout, block {blk}, "
        f"bf16, {int(layout.sum())} blocks, against float32 dense masked products: "
        f"{json.dumps(errs)} (scaled by max |ref|, tol {tol})")
    if not all(e <= tol for e in errs.values()):
        raise AssertionError(f"sparse MatMul / Softmax disagree: {errs}")
    del q, k, v, scores, probs, dense_p, out, vt
    torch.cuda.empty_cache()
    return errs


def sparse_masked_path_check():
    """SparseSelfAttention with a key-padding mask ("add") and a causal
    attention mask ("mul"): the dense masked path against the kernel path.
    The padded keys lie beyond SINGLE_VALID and the layout is causal, so
    rows before it see none of them; the output's gradient is zero on the
    other rows, so out, dq, dk and dv of the two paths are the same
    function there and everywhere."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
    B, H, T, D = BS_SHAPE
    attn = SparseSelfAttention(long_sparsity(), key_padding_mask_mode="add",
                               attn_mask_mode="mul", max_seq_length=T)
    g = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(B, H, T, D, generator=g, device="cuda").bfloat16() for _ in range(3)]
    dout = torch.randn(B, H, T, D, generator=g, device="cuda").bfloat16()
    dout[:, :, SINGLE_VALID:] = 0
    kpm = torch.zeros(B, T, device="cuda")
    kpm[:, SINGLE_VALID:] = -10000.0
    causal = torch.tril(torch.ones(T, T, device="cuda"))

    def run(masked):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = (attn(q, k, v, key_padding_mask=kpm, attn_mask=causal) if masked
               else attn(q, k, v))
        out.backward(dout)
        return [out.detach()[:, :, :SINGLE_VALID].float(), q.grad.float(), k.grad.float(),
                v.grad.float()]

    before = _bs_counts()
    kernel = run(False)
    launches = [a - b for a, b in zip(_bs_counts(), before)]
    masked = run(True)
    if _bs_counts() != [a + b for a, b in zip(before, launches)] or launches != [1, 1, 1]:
        raise AssertionError(f"the kernel path launched {launches}, or the masked path "
                             "launched a kernel")
    errs = {n: _scaled_err(a, b) for n, a, b in zip(("out", "dq", "dk", "dv"), masked, kernel)}
    tol = FLASH_TOL[torch.bfloat16]
    log(f"[single-card] SparseSelfAttention masked path (key padding from {SINGLE_VALID}, "
        f"causal attn_mask) against the kernel path on rows 0..{SINGLE_VALID - 1}: "
        f"{json.dumps(errs)} (tol {tol}); kernel launches {launches}")
    if not all(torch.isfinite(t).all() for t in masked) or max(errs.values()) > tol:
        raise AssertionError(f"the masked sparse path disagrees: {errs}")
    del kernel, masked, base
    torch.cuda.empty_cache()
    return errs


def _bert_head_model(kind):
    """BertModel (its hidden states' mean square as the loss) or
    BertForQuestionAnswering at BERT-large, seeded."""
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForQuestionAnswering, BertModel

    class BertHiddenLoss(BertModel):
        def forward(self, input_ids, token_type_ids=None, attention_mask=None):
            return super().forward(input_ids, token_type_ids,
                                   attention_mask).float().square().mean()

    cls = BertForQuestionAnswering if kind == "qa" else BertHiddenLoss
    model = cls(BertConfig(**BERT_MODEL))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    return model


def bert_heads_check():
    """BertModel and BertForQuestionAnswering through initialize at
    BERT-large, seq 512, micro-batch 16, BERT_CONFIG (the QA engine with
    fused_step and LAMB): the first micro-batch's loss and per-layer
    grad norms against the dense attention path, then 3 engine steps."""
    import deepspeed_tpu_torch
    ids, _, _, mask = _bert_batch()
    rng = np.random.RandomState(2)
    kept = mask.sum(1).long().cpu().numpy()
    start = torch.from_numpy(rng.randint(0, kept)).cuda()
    end = torch.from_numpy(np.minimum(start.cpu().numpy() + rng.randint(0, 30, len(kept)),
                                      kept - 1)).cuda()
    out = {}
    n_layer = BERT_MODEL["num_hidden_layers"]
    for kind, batch, fused in (("bert", (ids, None, mask), False),
                               ("qa", (ids, start, end, None, mask), True)):
        model = _bert_head_model(kind)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config_params=dict(BERT_CONFIG, fused_step=fused))
        if engine._fused != fused:
            raise AssertionError(f"{kind}: fused_step={fused} took fused={engine._fused}")
        lk, lp, nrel = _bert_kernel_vs_plain(engine.module, batch)
        counts0, tc0 = _flash_counts(), _tensor_core_launches()
        losses, step_s = _train_steps(engine, *batch, steps=BERT_HEAD_STEPS)
        launches = [a - b for a, b in zip(_flash_counts(), counts0)]
        tc = [a - b for a, b in zip(_tensor_core_launches(), tc0)]
        out[kind] = {"loss_kernel": lk, "loss_plain": lp, "grad_norm_max_rel_diff": nrel,
                     "losses": losses, "step_ms": [s * 1e3 for s in step_s],
                     "fused_step": fused, "flash_launches": launches}
        log(f"[single-card] {type(model).__mro__[1 if kind == 'bert' else 0].__name__} "
            f"BERT-large seq {BERT_SEQ} batch {BERT_BATCH}: {json.dumps(out[kind])} "
            f"(tol {TRAIN_TOL_BF16})")
        if abs(lk - lp) > TRAIN_TOL_BF16[0] or nrel > TRAIN_TOL_BF16[1]:
            raise AssertionError(f"{kind}: the flash path disagrees with the dense path")
        want = [n_layer * BERT_HEAD_STEPS] * 3
        if not all(np.isfinite(losses)) or launches != want or tc != want:
            raise AssertionError(f"{kind}: losses {losses}, flash launches {launches} "
                                 f"(tensor cores {tc}) != {want}")
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def transformer_layer_checks():
    """One BERT-large layer, seq 512, batch 16, bf16, with the padding mask,
    forward and backward of a fixed cotangent: post-LN with attention and
    hidden dropout 0.1, flash against dense under one generator; the flash forward's dropout keep mask against
    ``dropout_keep_reference`` bit for bit; the memory knobs against the
    same layer without them, with both peaks."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                     DeepSpeedTransformerLayer)
    seq, batch, H = BERT_SEQ, BERT_BATCH, BERT_MODEL["hidden_size"]
    heads = BERT_MODEL["num_attention_heads"]
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(batch, seq, H).astype(np.float32)).cuda().bfloat16()
    keep = torch.from_numpy(_padding_mask(batch, seq, rng)).cuda()
    mask = ((1.0 - keep) * -1e9)[:, None, None, :]
    # a fixed cotangent: sum(out ** 2) of a post-LN layer is nearly constant
    # (unit LayerNorm), so its gradient would be rounding noise
    dy = torch.from_numpy(rng.randn(batch, seq, H).astype(np.float32)).cuda()
    out = {}

    def layer_of(pre_ln):
        cfg = DeepSpeedTransformerConfig(
            batch_size=batch, max_seq_length=seq, hidden_size=H,
            intermediate_size=BERT_MODEL["intermediate_size"], heads=heads,
            attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1,
            num_hidden_layers=BERT_MODEL["num_hidden_layers"], fp16=False,
            pre_layer_norm=pre_ln)
        layer = DeepSpeedTransformerLayer(cfg)
        layer.init(torch.Generator(device="cuda").manual_seed(0))
        return layer

    def fwd_bwd(layer, seed=1):
        xs = x.clone().requires_grad_()
        y = layer(xs, mask, generator=torch.Generator(device="cuda").manual_seed(seed),
                  deterministic=False)
        y.float().backward(dy)
        grads = [xs.grad] + [p.grad for p in layer.parameters()]
        layer.zero_grad(set_to_none=True)
        return [y.detach().float()] + [g_.float() for g_ in grads]

    # post-LN with dropout: flash against dense
    layer = layer_of(False)
    got = fwd_bwd(layer)
    other = fwd_bwd(layer, seed=2)[0]
    layer.config.use_flash_attention = False
    want = fwd_bwd(layer)
    layer.config.use_flash_attention = True
    names = ["out", "dx"] + list(layer.NAMES)
    errs = {n: _scaled_err(a, b) for n, a, b in zip(names, got, want)}
    worst = max(errs, key=errs.get)
    tol = FLASH_TOL[torch.bfloat16]
    out["post_ln_dropout"] = {"out": errs["out"], "dx": errs["dx"], "worst": worst,
                              "worst_err": errs[worst], "tol": tol}
    log(f"[single-card] layer post-LN, dropout 0.1: {json.dumps(out['post_ln_dropout'])}")
    if torch.equal(got[0], other) or errs[worst] > tol:
        raise AssertionError(f"post-LN layer flash vs dense: {errs}")
    del got, want, other, layer

    # the kernel's dropout hash: uniform probabilities (q = k = 0) and v an
    # identity on one 64-key chunk read that chunk's keep mask from the output
    rate, D = 0.1, H // heads
    zeros = torch.zeros(batch, heads, seq, D, device="cuda", dtype=torch.bfloat16)
    seed = 12345
    got = torch.empty(batch, heads, seq, seq, dtype=torch.bool, device="cuda")
    for c in range(seq // D):
        v = torch.zeros_like(zeros)
        v[:, :, c * D:(c + 1) * D] = torch.eye(D, device="cuda", dtype=torch.bfloat16)
        y = fa.flash_attention(zeros, zeros, v, False, dropout_rate=rate, dropout_seed=seed)
        got[..., c * D:(c + 1) * D] = y > 0
    ref = fa.dropout_keep_reference(seed, batch, heads, seq, seq, rate, device="cuda") > 0
    same = bool(torch.equal(got, ref))
    out["dropout_hash"] = {"bit_for_bit": same, "keep_share": float(got.float().mean()),
                           "elements": got.numel()}
    log(f"[single-card] flash forward dropout keep mask against dropout_keep_reference, "
        f"[{batch}, {heads}, {seq}, {seq}] at rate {rate}: {json.dumps(out['dropout_hash'])}")
    if not same:
        raise AssertionError("the kernel's dropout hash differs from dropout_keep_reference")
    del got, ref, zeros, v, y

    # the memory knobs against the same layer without them
    layer = layer_of(True)
    runs = {}
    knobs = ("normalize_invertible", "gelu_checkpoint", "attn_dropout_checkpoint")
    for on in (False, True):
        for kn in knobs:
            setattr(layer.config, kn, on)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs[on] = fwd_bwd(layer)
        torch.cuda.synchronize()
        runs[on].append((torch.cuda.max_memory_allocated() - base) / 1e9)
    for kn in knobs:
        setattr(layer.config, kn, False)
    errs = {n: _scaled_err(a, b) for n, a, b in zip(names, runs[True][:-1], runs[False][:-1])}
    worst = max(errs, key=errs.get)
    out["memory_knobs"] = {"worst": worst, "worst_err": errs[worst], "tol": REMAT_TOL,
                           "peak_gb_without": runs[False][-1], "peak_gb_with": runs[True][-1]}
    log(f"[single-card] memory knobs {knobs}: {json.dumps(out['memory_knobs'])}")
    if errs[worst] > REMAT_TOL:
        raise AssertionError(f"the memory knobs changed the layer: {errs}")
    del runs, layer, x
    torch.cuda.empty_cache()
    return out


def remat_more_policies(tokens, labels):
    """At 4 layers of the 1.5B: "attn", "flash" and "dots+attn-lean" keep the
    flash op's (out, lse), so the forward kernel runs once a layer; loss and
    grads against the same model without remat."""
    out = {}
    for policy in ("attn", "flash", "dots+attn-lean"):
        model = _cut_model(4, remat_policy=policy)
        counts0 = _flash_counts()
        loss_r, norms_r = _loss_and_norms(model, tokens, labels)
        counts = [a - b for a, b in zip(_flash_counts(), counts0)]
        model.config = dataclasses.replace(model.config, remat=False)
        loss_n, norms_n = _loss_and_norms(model, tokens, labels)
        rel = float(((norms_r - norms_n).abs() / norms_n).max())
        out[policy] = {"flash_launches": counts, "loss": [loss_r.item(), loss_n.item()],
                       "grad_norm_max_rel_diff": rel}
        log(f"[single-card] 4 layers, remat {policy!r}: {json.dumps(out[policy])} "
            f"(tol {REMAT_TOL})")
        if counts != [4, 4, 4]:
            raise AssertionError(f"remat {policy!r}: flash launches {counts} != [4, 4, 4]")
        if abs(loss_r.item() - loss_n.item()) > REMAT_TOL or rel > REMAT_TOL:
            raise AssertionError(f"remat {policy!r} changed the loss or the grads")
        del model
        torch.cuda.empty_cache()
    return out


def phase_single_card():
    """The ported paths that fit one card and had run only on the CPU: the
    sparse MatMul / Softmax, the masked sparse path, the BERT classes beside
    the MLM one, post-LN with dropout and the dropout hash, the memory
    knobs, three remat policies. (fp16 loss scaling and SGD run in
    [train-fused].) Returns the flash and block-sparse launches of the
    phase."""
    _zero_flash_counts()
    bs0 = _bs_counts()
    res = {"sparse_matmul_softmax": sparse_matmul_softmax_checks(),
           "sparse_masked_path": sparse_masked_path_check(),
           "bert_heads": bert_heads_check(),
           "transformer_layer": transformer_layer_checks()}
    tokens, labels = _published_batch(MODEL["vocab_size"])
    res["remat_policies"] = remat_more_policies(tokens, labels)
    flash = _flash_counts()
    sparse = [a - b for a, b in zip(_bs_counts(), bs0)]
    log(f"[single-card] every check held; flash launches {flash}, block-sparse {sparse}")
    return flash, sparse


T0 = time.perf_counter()


# [lint]: the lint suite over the registry's engines on the card; the
# serving entry's decode step runs the paged-decode kernel once a layer
LINT_DECODE_PROGRAM = "serving:serve_decode_step"
LINT_N_LAYER = 2                # the registry's tiny GPT-2


def phase_lint():
    """``ds-tpu-torch lint`` in this process over every ported registry entry
    on the card, then the same on the CPU: exit 0 on both (no violation the
    shipped allowlist does not cover, no stale entry), the same vids, and
    each program's recorded kernel ops, the paged-decode op once a layer in
    the decode step and as many times in all as the wrapper counted. Returns
    the kernel's launches."""
    from deepspeed_tpu_torch.lint import cli
    from deepspeed_tpu_torch.ops.paged_attention import paged_decode_attention as pda
    from deepspeed_tpu_torch.utils import op_record

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_lint_")
    reports, times = {}, {}
    for device in ("cuda", "cpu"):
        artifacts = []
        path = os.path.join(out_dir, f"lint_{device}.json")
        pda.launches = pda.cluster_launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--device", device, "--out", path], artifacts=artifacts)
        times[device] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"[lint] ds-tpu-torch lint --device {device} exited {rc}")
        with open(path) as f:
            reports[device] = (f.read(), artifacts, pda.launches, pda.cluster_launches)
    text, artifacts, launches, cluster = reports["cuda"]
    rep = json.loads(text)
    if rep["unused_allowlist_entries"]:
        raise AssertionError(f"[lint] stale entries {rep['unused_allowlist_entries']}")

    def vids(t):
        r = json.loads(t)
        return sorted(v["id"] for v in r["violations"] + r["allowlisted"])

    if vids(text) != vids(reports["cpu"][0]):
        raise AssertionError(f"[lint] vids differ: cuda {vids(text)} cpu "
                             f"{vids(reports['cpu'][0])}")
    recorded = 0
    for a in artifacts:
        kernels = op_record.kernel_counts(a.program)
        recorded += kernels.get("paged_decode", 0)
        log(f"[lint] {a.name}: {len(a.ops)} ops, kernel ops {kernels}")
    decode = next(a for a in artifacts if a.name == LINT_DECODE_PROGRAM)
    if op_record.kernel_counts(decode.program) != {"paged_decode": LINT_N_LAYER}:
        raise AssertionError(f"[lint] {LINT_DECODE_PROGRAM} recorded "
                             f"{op_record.kernel_counts(decode.program)}")
    if recorded != launches or cluster != launches or launches != LINT_N_LAYER:
        raise AssertionError(f"[lint] {recorded} paged_decode ops recorded, the wrapper "
                             f"counted {launches} launches ({cluster} cluster design)")
    log(f"[lint] {json.dumps({'cuda_s': round(times['cuda'], 2), 'cpu_s': round(times['cpu'], 2), 'programs': len(rep['programs']), 'violations': len(rep['violations']), 'allowlisted': vids(text), 'report_bytes_equal_cpu': text == reports['cpu'][0], 'paged_decode_launches': launches})}")
    return launches


# [launcher]: the published config's widths at 4 of 48 layers, no remat (one
# forward launch a layer), launched as a child through the runner
LAUNCHER_LAYERS = 4
LAUNCHER_STEPS = 4


def _launcher_run():
    """(losses, per-step flash launches, sha256 of the optimizer state after
    the last step) of the launcher phase's training: bench.py:406-420's
    widths and engine config at LAUNCHER_LAYERS layers, without remat. The
    external-master pair never moves the parameters (the loss repeats), so
    its state, which every step moves, is compared too."""
    import hashlib
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer

    tokens, labels = _published_batch(MODEL["vocab_size"])
    model = GPT2Model(GPT2Config(**dict(PUBLISHED_MODEL, n_layer=LAUNCHER_LAYERS,
                                        remat=False, remat_policy=None)))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, optimizer=shard_optimizer(32),
                                                     config_params=PUBLISHED_CONFIG)
    losses, launches = [], []
    for _ in range(LAUNCHER_STEPS):
        before = _flash_counts()
        loss = engine(tokens, labels)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.float()))
        launches.append([a - b for a, b in zip(_flash_counts(), before)])
    state = torch.cat([engine.opt_state[k].reshape(-1) for k in sorted(engine.opt_state)])
    return losses, launches, hashlib.sha256(state.cpu().numpy().tobytes()).hexdigest()


def launched_child():
    """``chip_smoke.py --launched``: the launcher phase's child. Prints its
    env identity, losses and flash launches as one ``LAUNCHED`` line."""
    import deepspeed_tpu_torch  # noqa: F401
    ident = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                            "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                                            "CUDA_VISIBLE_DEVICES")}
    ident["device"] = torch.cuda.current_device()
    losses, launches, state = _launcher_run()
    log("LAUNCHED " + json.dumps({"env": ident, "losses": losses, "launches": launches,
                                  "state_sha256": state}))


def phase_launcher():
    """``python -m deepspeed_tpu_torch.launcher.runner --num_gpus 1
    chip_smoke.py --launched``: the child's env identity, its losses and
    optimizer state bit for bit those of the same run in this process, and
    LAUNCHER_LAYERS x (1, 1, 1) flash launches a step. Returns the child's
    flash launches."""
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
                          "--num_gpus", "1", "chip_smoke.py", "--launched"],
                         cwd=str(root), env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("LAUNCHED ")]
    if res.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"[launcher] the launched child failed (exit {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-4000:]}")
    if any(ln.startswith("{\"ok\"") for ln in res.stdout.splitlines()):
        raise AssertionError("[launcher] the child printed a result line")
    child = json.loads(lines[0][len("LAUNCHED "):])
    want_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500",
                "CUDA_VISIBLE_DEVICES": child["env"]["CUDA_VISIBLE_DEVICES"], "device": 0}
    if child["env"] != want_env or child["env"]["CUDA_VISIBLE_DEVICES"] is None:
        raise AssertionError(f"[launcher] child identity {child['env']}")
    t0 = time.perf_counter()
    losses, launches, state = _launcher_run()
    here_s = time.perf_counter() - t0
    if child["losses"] != losses or child["state_sha256"] != state:
        raise AssertionError(f"[launcher] differ: child {child['losses']} "
                             f"{child['state_sha256']}, here {losses} {state}")
    want = [[LAUNCHER_LAYERS] * 3] * LAUNCHER_STEPS
    if child["launches"] != want or launches != want:
        raise AssertionError(f"[launcher] flash launches: child {child['launches']} here "
                             f"{launches}, want {want}")
    log(f"[launcher] {json.dumps({'child_env': child['env'], 'losses': losses, 'state_sha256': state, 'bitwise_equal': True, 'flash_launches_a_step': want[0], 'child_s': round(child_s, 2), 'in_process_s': round(here_s, 2)})}")
    gc.collect()
    torch.cuda.empty_cache()
    return [sum(step[i] for step in child["launches"]) for i in range(3)]


def _device_memory():
    """The device memory the driver reports free, and this process's caching
    allocator's reserve, in bytes."""
    return {"free": torch.cuda.mem_get_info()[0], "reserved": torch.cuda.memory_reserved()}


def _timed_phase(fn, *args):
    """``fn(*args)``, its wall time logged as ``[time] <name> <s> s``."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"[time] {fn.__name__} {time.perf_counter() - t:.1f} s")
    return out


def main():
    args = sys.argv[1:]
    probe = args[1] if len(args) == 2 and args[0] == "--probe" else None
    # the launcher phase's child, as the runner starts it (--local_rank=N first)
    launched = [a for a in args if not a.startswith("--local_rank=")] == ["--launched"]
    if args and probe is None and not launched:
        print("usage: chip_smoke.py [--probe N_LAYER | --launched]", file=sys.stderr)
        sys.exit(2)
    card = phase_device(quiet=probe is not None or launched)
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as err:     # the script alone, outside a checkout of the repo
        print(f"chip_smoke: run it from the root of the repository ({err})", file=sys.stderr)
        sys.exit(1)
    if probe is not None:
        probe_offload_footprint(int(probe))
        return
    if launched:
        launched_child()
        return
    host = host_info()
    log(f"[host] {json.dumps(host)}")
    _timed_phase(phase_build)
    entry = _timed_phase(phase_kernels)
    memory = {"before": _device_memory()}
    srv = _timed_phase(phase_serving)
    entry.update(launches=srv["launches"], captures=srv["captures"], replays=srv["replays"])
    _timed_phase(phase_serving_graphs, srv)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    memory["after"] = _device_memory()
    # what the serving phases leave once every engine is gone: the cuBLAS
    # workspaces (their capture stream's among them), cleared here to show it
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    memory["after_clearing_cublas_workspaces"] = _device_memory()
    log(f"[serving-memory] {json.dumps(memory)}")
    flash = _timed_phase(phase_flash_kernels)
    for e, n in zip(flash, _timed_phase(phase_training)):
        e["launches"] = n
    for e, n in zip(flash, _timed_phase(phase_train_published)):
        e["launches_published"] = n
    for e, n in zip(flash, _timed_phase(phase_train_telemetry)):
        e["launches_telemetry"] = n
    for e, n in zip(flash, _timed_phase(phase_train_observatories)):
        e["launches_observatories"] = n
    for e, n in zip(flash, _timed_phase(phase_train_fused)):
        e["launches_fused"] = n
    for e, n in zip(flash, _timed_phase(phase_fp16_optimizer)):
        e["launches_fp16_optimizer"] = n
    offload_launches, clip_rounding = _timed_phase(phase_train_offload)
    for e, n in zip(flash, offload_launches):
        e["launches_offload"] = n
    _timed_phase(phase_checkpoint, clip_rounding)
    _timed_phase(phase_offload_large)
    _timed_phase(phase_offload_capacity)
    sparse = _timed_phase(phase_block_sparse_kernels)
    for e, n in zip(sparse, _timed_phase(phase_long_training)):
        e["launches"] = n
    for e, n in zip(sparse, _timed_phase(phase_onebit_long)):
        e["launches_onebit"] = n
    fused = _timed_phase(phase_fused_block_kernels)
    for e, n in zip(fused, _timed_phase(phase_fused_training)):
        e["launches"] = n
    # the flash kernels' non-causal path with a key bias, inside BERT
    for e, n in zip(flash, _timed_phase(phase_bert_training)):
        e["launches_bert"] = n
    single_flash, single_sparse = _timed_phase(phase_single_card)
    for e, n in zip(flash, single_flash):
        e["launches_single_card"] = n
    for e, n in zip(sparse, single_sparse):
        e["launches_single_card"] = n
    # the rest of serving runs last, so that the offload-capacity probes
    # above see this process as the training phases leave it
    model32, outs32 = _timed_phase(phase_serving_spec)
    _timed_phase(phase_serving_mirror)
    _timed_phase(phase_serving_restart, model32, outs32)
    del model32, outs32
    gc.collect()
    torch.cuda.empty_cache()
    entry["launches_fleet"] = _timed_phase(phase_serving_fleet)
    _timed_phase(phase_resnet)
    _timed_phase(phase_crash_sim)
    entry["launches_lint"] = _timed_phase(phase_lint)
    for e, n in zip(flash, _timed_phase(phase_launcher)):
        e["launches_launcher"] = n
    log(f"[time] chip_smoke.py phases {time.perf_counter() - T0:.1f} s")
    log(card)
    log(f"host: {host['cpu']}, nproc {host['nproc']}, MemTotal {host['mem_total_gb']:.1f} GB")
    log(json.dumps({"kernels": [entry, *flash, *sparse, *fused]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
