"""InferenceEngine: continuous-batching serving over the paged KV cache
(PyTorch port of ``deepspeed_tpu/serve/engine.py``).

The engine owns the device state (the compute-dtype parameters and one paged
KV pool, updated in place by every program) and executes the scheduler's
host decisions in a fixed per-iteration order:

    admit -> ensure write blocks (CoW page copies) -> one prefill chunk
          -> one decode step for every live lane -> sampling heads

Sampling is host-side for the single-lane path — exact greedy (np.argmax
over the fetched float32 logits row, first-max tie-break) when
``temperature <= 0``, else temperature/top-k/top-p sampling with a
counter-based RNG keyed on ``(request seed, token position)`` so replays and
preempt-restarts regenerate identical tokens — and a small device head per
beam step. The schedule log each ``step`` returns is the JAX engine's, byte
for byte (``json.dumps``), for the same trace.

Not in this slice of the port (each raises, naming the ROADMAP.md item that
brings it): speculative decoding, head-sharded serving, the dense mirror,
the request tracer, telemetry, warm-restart ``state_dict``, and the lint and
memory manifests.
"""

import time

import numpy as np
import torch

from .block_allocator import NULL_BLOCK
from .paged import build_paged_programs, serving_params
from .scheduler import RequestOutput, Scheduler

_NEXT_SERVING = "ROADMAP.md queue A10 (rest of serving)"


def _later(what, where=_NEXT_SERVING):
    return NotImplementedError(f"{what} is not in the PyTorch port yet: {where}")


class InferenceEngine:
    def __init__(self, model, params=None, *, num_slots=8, block_size=16,
                 num_blocks=257, max_model_len=256, prefill_chunk=32,
                 use_pallas=False, telemetry=None, mirror=False,
                 request_trace=None, prefix_cache=False, sharding=None,
                 speculation=None):
        c = model.config
        if (speculation or {}).get("enabled"):
            raise _later("serving.speculation")
        tp = int(sharding.get("model", 1)) if isinstance(sharding, dict) \
            else int(sharding or 1)
        if tp < 1:
            raise ValueError(f"serving.sharding.model must be >= 1, got {tp}")
        if tp > 1:
            raise _later(f"serving.sharding.model = {tp}")
        if mirror:
            raise _later("mirror=True (serve/oracle.py)")
        if (request_trace or {}).get("enabled"):
            raise _later("serving.request_trace")
        if telemetry is not None:
            raise _later("telemetry", "ROADMAP.md queue A21-A22 (observatories)")
        if max_model_len % block_size != 0:
            raise ValueError(f"max_model_len {max_model_len} not a multiple "
                             f"of block_size {block_size}")
        if max_model_len > c.n_positions:
            raise ValueError(f"max_model_len {max_model_len} exceeds the "
                             f"model's n_positions {c.n_positions}")
        if getattr(c, "sparse_attention", None):
            raise ValueError("serving supports dense attention only")
        if params is not None:
            model.load_parameters(params)
        self.model = model
        self.device = model.device
        self.params = serving_params(model)
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_model_len = int(max_model_len)
        self.max_blocks = self.max_model_len // self.block_size
        self.prefill_chunk = int(prefill_chunk)

        self._raw = build_paged_programs(
            model, num_slots=self.num_slots, block_size=self.block_size,
            max_blocks=self.max_blocks, prefill_chunk=self.prefill_chunk,
            use_pallas=use_pallas)
        self._decode = self._raw["decode_step"]
        self._prefill = self._raw["prefill_chunk"]
        self._copy = self._raw["copy_blocks"]
        self._beam_heads = {}
        self.copy_width = self._raw["copy_width"]

        pool_shape = (c.n_layer, self.num_blocks, self.block_size,
                      c.n_head, c.head_dim)
        self.k_pool = torch.zeros(pool_shape, dtype=c.compute_dtype,
                                  device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=c.compute_dtype,
                                  device=self.device)

        self.scheduler = Scheduler(
            num_slots=self.num_slots, num_blocks=self.num_blocks,
            block_size=self.block_size, max_model_len=self.max_model_len,
            prefill_chunk=self.prefill_chunk, prefix_cache=prefix_cache)
        self.prefix_cache = self.scheduler.prefix_cache

        self._it = 0
        self._order = []                    # req_id submission order
        self.outputs = {}                   # req_id -> RequestOutput
        self._submit_ms = {}
        self._target_steps = 0              # prefill chunks + decode steps

    # ------------------------------------------------------------- plumbing
    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _beam_head(self, kind, g):
        key = (kind, g.lanes, g.req.eos_token_id)
        if key not in self._beam_heads:
            self._beam_heads[key] = self._raw[f"beam_{kind}"](key[1], key[2])
        return self._beam_heads[key]

    # ----------------------------------------------------------- submission
    def submit(self, req):
        """Queue a request; infeasible ones are refused (a RequestOutput with
        status "refused"), never crash the engine."""
        self._order.append(req.req_id)
        self._submit_ms[req.req_id] = time.perf_counter()
        reason = self.scheduler.submit(req)
        if reason is not None:
            out = RequestOutput(req.req_id, "refused", refusal=reason)
            self.outputs[req.req_id] = out
            return out
        return None

    # ---------------------------------------------------------- the big loop
    def step(self):
        """One serving iteration. Returns the schedule-log dict — pure host
        decisions only, so a trace replay is byte-identical (json.dumps)."""
        sched, it = self.scheduler, self._it
        log = {"it": it}
        admitted = sched.admit(it)
        preempted, copies = sched.ensure_decode_room()
        log["admitted"] = [g.req.req_id for g in admitted]
        log["preempted"] = [g.req.req_id for g in preempted]
        log["copies"] = [list(c) for c in copies]
        self._run_copies(copies)

        log["prefill"] = self._prefill_one(it)
        log["decode"], log["finished"] = self._decode_all(it)
        self._it += 1
        return log

    def run(self, requests):
        """Submit everything, drive steps until drained. Returns (outputs in
        submission order, per-iteration schedule log)."""
        for r in requests:
            self.submit(r)
        logs = []
        guard = 0
        while not self.scheduler.idle:
            if not self.scheduler.running:
                na = self.scheduler.next_arrival()
                if na is not None and na > self._it:
                    self._it = na           # fast-forward idle iterations
            logs.append(self.step())
            guard += 1
            if guard > 200000:
                raise RuntimeError("serving loop failed to drain (bug)")
        return [self.outputs[rid] for rid in self._order], logs

    # -------------------------------------------------------------- internals
    def _run_copies(self, copies):
        P = self.copy_width
        for i in range(0, len(copies), P):
            batch = copies[i:i + P]
            src = np.zeros(P, np.int32)     # pads: null 0 -> 0 self-copy
            dst = np.zeros(P, np.int32)
            for j, (s, d) in enumerate(batch):
                src[j], dst[j] = s, d
            self._copy(self.k_pool, self.v_pool, self._tensor(src, torch.int32),
                       self._tensor(dst, torch.int32))

    def _pad_table(self, table):
        out = np.full(self.max_blocks, NULL_BLOCK, np.int32)
        out[:len(table)] = table
        return out

    def _prefill_one(self, it):
        pf = self.scheduler.next_prefill(it)
        if pf is None:
            return None
        g, pos, n, chunk = pf
        logits = self._prefill(
            self.params, self._tensor([chunk], torch.int32), pos, n,
            self._tensor(self._pad_table(g.tables[0]), torch.int32),
            self.k_pool, self.v_pool)
        self._target_steps += 1
        done = self.scheduler.finish_prefill_chunk(g, n, it)
        if done:
            self._first_tokens(g, logits, it)
        return [g.req.req_id, pos, n, bool(done)]

    def _first_tokens(self, g, logits, it):
        if g.lanes == 1:
            tok = self._sample_token(g, logits[0].cpu().numpy(), 0)
            self.scheduler.begin_decode(g, [tok], it)
        else:
            scores, tok0, live = self._beam_head("init", g)(logits)
            self.scheduler.begin_decode(
                g, [int(t) for t in tok0.cpu().numpy()], it,
                scores=scores.cpu().numpy(), live=live.cpu().numpy())
        g.first_token_ms = (time.perf_counter()
                            - self._submit_ms[g.req.req_id]) * 1000.0

    def _decode_all(self, it):
        # a group that completed prefill THIS iteration sits out one decode:
        # its first write block is ensured at the NEXT iteration's start
        lanes = [(g, lane, slot) for g, lane, slot in
                 self.scheduler.decode_lanes() if g.entered_decode_it != it]
        decode_log = [[g.req.req_id, lane, slot] for g, lane, slot in lanes]
        if not lanes:
            return decode_log, []
        S = self.num_slots
        toks = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        tables = np.full((S, self.max_blocks), NULL_BLOCK, np.int32)
        active = np.zeros(S, bool)
        for g, lane, slot in lanes:
            toks[slot] = g.generated[lane][-1]
            pos[slot] = g.next_pos(lane)
            tables[slot] = self._pad_table(g.tables[lane])
            active[slot] = True
        logits = self._decode(
            self.params, self._tensor(toks, torch.int32),
            self._tensor(pos, torch.int32), self._tensor(tables, torch.int32),
            self._tensor(active, torch.bool), self.k_pool, self.v_pool)
        self._target_steps += 1
        logits_np = logits.cpu().numpy()

        finished = []
        for g in list(self.scheduler.running):
            if g.phase != "decode" or g.entered_decode_it == it:
                continue                    # groups that just prefilled wait
            if g.lanes == 1:
                self._sample_greedy(g, logits_np, finished, it)
            else:
                self._sample_beam(g, logits, finished, it)
        return decode_log, finished

    def _sample_token(self, g, logits_row, position):
        """Next token for a single-lane group from its f32 logits row.

        ``temperature <= 0`` is the exact historical greedy path. Otherwise:
        scale by temperature, apply top-k then nucleus truncation, softmax in
        f64 (host math — bit-stable across platforms), and invert the CDF at a
        uniform drawn from ``default_rng([seed, position])``. The counter-based
        keying makes every draw a pure function of (request, position): replays
        and preempt-restarts (bit-identical logits) resample identical tokens,
        and no RNG state needs checkpointing or preemption care."""
        req = g.req
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        logits = np.asarray(logits_row, np.float64) / req.temperature
        if 0 < req.top_k < logits.size:
            kth = np.partition(logits, -req.top_k)[-req.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        probs = np.exp(logits - np.max(logits))
        probs /= probs.sum()
        if req.top_p < 1.0:
            order = np.argsort(-logits, kind="stable")
            csum = np.cumsum(probs[order])
            # smallest prefix reaching top_p, always keeping the crossing token
            cut = int(np.searchsorted(csum, req.top_p, side="left")) + 1
            mask = np.zeros(probs.size, bool)
            mask[order[:cut]] = True
            probs = np.where(mask, probs, 0.0)
            probs /= probs.sum()
        u = np.random.default_rng([req.seed, position]).random()
        tok = int(np.searchsorted(np.cumsum(probs), u, side="right"))
        tok = min(tok, probs.size - 1)
        while tok > 0 and probs[tok] == 0.0:   # float-edge guard: never emit a
            tok -= 1                           # truncated (zero-mass) token
        return tok

    def _sample_greedy(self, g, logits_np, finished, it):
        tok = self._sample_token(g, logits_np[g.slots[0]], len(g.generated[0]))
        g.generated[0].append(tok)
        eos = g.req.eos_token_id
        if (len(g.generated[0]) >= g.req.max_new_tokens
                or (eos >= 0 and tok == eos)):
            self._finish(g, g.generated[0], None, finished, it)

    def _sample_beam(self, g, logits, finished, it):
        scores, parents, toks, live = self._beam_head("select", g)(
            logits, self._tensor(g.slots, torch.int32),
            self._tensor(np.asarray(g.scores, np.float32), torch.float32),
            self._tensor(np.asarray(g.live, bool), torch.bool))
        parents = [int(p) for p in parents.cpu().numpy()]
        self.scheduler.reorder_beams(g, parents)
        for k, t in enumerate(toks.cpu().numpy()):
            g.generated[k].append(int(t))
        g.scores = scores.cpu().numpy()
        g.live = live.cpu().numpy()
        if len(g.generated[0]) >= g.req.max_new_tokens:
            best, score = self._rank_beams(g)
            self._finish(g, best, score, finished, it)

    def _rank_beams(self, g):
        """Host replay of beam_search's GNMT final ranking: finished beams
        count tokens through EOS (clamped to L), unfinished count exactly L."""
        L = float(g.req.max_new_tokens)
        eos = g.req.eos_token_id
        scores = np.asarray(g.scores, np.float32)
        if eos >= 0:
            lengths = []
            for toks in g.generated:
                n = 0
                for t in toks:
                    if t == eos:
                        break
                    n += 1
                lengths.append(min(n + 1.0, L))
        else:
            lengths = [L] * g.lanes
        lengths = np.asarray(lengths, np.float32)
        final = scores / np.power(lengths, np.float32(g.req.length_penalty))
        best = int(np.argmax(final))
        return g.generated[best], float(final[best])

    def _finish(self, g, tokens, score, finished, it):
        self.scheduler.finish_group(g)
        self.outputs[g.req.req_id] = RequestOutput(
            g.req.req_id, "finished", tokens=list(tokens), score=score,
            ttft_iters=(g.first_token_it - g.req.arrival),
            ttft_ms=g.first_token_ms, finished_it=it,
            preemptions=getattr(g.req, "_preemptions_carry", g.preemptions))
        finished.append(g.req.req_id)

    # ------------------------------------------------------------- metrics
    @property
    def target_steps(self):
        """Target-model program executions so far (prefill chunks + decode
        steps)."""
        return self._target_steps

    # ---------------------------------------------------- later slices
    def state_dict(self):
        raise _later("InferenceEngine.state_dict (warm restart)")

    def load_state_dict(self, state):
        raise _later("InferenceEngine.load_state_dict (warm restart)")

    def lint_programs(self, sample_batch=None):
        raise _later("InferenceEngine.lint_programs", "ROADMAP.md queue A23 (lint)")

    def memory_manifest(self):
        raise _later("InferenceEngine.memory_manifest",
                     "ROADMAP.md queue A22 (device observatories: utils/hbm.py)")
