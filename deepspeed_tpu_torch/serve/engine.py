"""InferenceEngine: continuous-batching serving over the paged KV cache
(PyTorch port of ``deepspeed_tpu/serve/engine.py``).

The engine owns the device state (the compute-dtype parameters and one paged
KV pool, updated in place by every program) and executes the scheduler's
host decisions in a fixed per-iteration order:

    admit -> ensure write blocks (CoW page copies) -> one prefill chunk
          -> one decode step for every live lane -> sampling heads

On the card ``decode_step``, ``prefill_chunk`` and ``spec_verify`` (and the
draft's decode and prefill) are CUDA graphs, captured once when the engine is
built into one graph memory pool (``paged.GraphedProgram``): the JAX
engine's compile-once contract. Each step's inputs go to the graphs' static
buffers through pinned memory, and the logits come back in one copy a step.
``copy_blocks``, the beam heads and the dense mirror stay eager: the first
two are a few kernels each, and the mirror is the check. On the CPU every
program runs eagerly.

Sampling is host-side for the single-lane path — exact greedy (np.argmax
over the fetched float32 logits row, first-max tie-break) when
``temperature <= 0``, else temperature/top-k/top-p sampling with a
counter-based RNG keyed on ``(request seed, token position)`` so replays and
preempt-restarts regenerate identical tokens — and a small device head per
beam step. The schedule log each ``step`` returns is the JAX engine's, byte
for byte (``json.dumps``), for the same trace.

``mirror=True`` runs the dense-cache oracle (serve/oracle.py) in lockstep and
asserts the paged logits are **bitwise identical** to the dense ones every
prefill chunk and every decode step (on the gather path: the paged-decode
kernel reduces in another order). ``speculation`` drafts with a second model
(serve/speculative.py) and verifies K + 1 positions in one target program,
token-identical to plain greedy decode. ``request_trace`` keeps the request
ledger (serve/request_trace.py). ``state_dict`` / ``load_state_dict`` are the
warm restart (resilience/serve_restart.py).

``telemetry`` (a ``utils/telemetry.py`` ``TelemetrySession``; JAX
``deepspeed_tpu/serve/engine.py:106,217-231,283-312``): each program's
watchdog record is its CUDA-graph capture on the card (wall time, the graph
pool's bytes as temp bytes) and its first call on the CPU, under the JAX
names (``serve:decode_step``, ``serve:prefill_chunk``, ``serve:spec_verify``,
``serve:copy_blocks``, ``serve:beam_<kind>_k<K>_e<eos>``, the draft's
``serve:spec_draft_*``); every iteration emits the ``Serving/*`` scalars and,
with the request tracer, closes the session's step with its latency summary.

Not in this slice of the port (each raises, naming the ROADMAP.md item that
brings it): head-sharded serving, and the lint and memory manifests.
"""

import time

import numpy as np
import torch

from .block_allocator import NULL_BLOCK
from .paged import (EagerProgram, GraphedProgram, build_paged_programs, serving_params,
                    stage)
from .request_trace import RequestTracer
from .scheduler import RequestOutput, Scheduler


def _later(what, where):
    return NotImplementedError(f"{what} is not in the PyTorch port yet: {where}")


class InferenceEngine:
    def __init__(self, model, params=None, *, num_slots=8, block_size=16,
                 num_blocks=257, max_model_len=256, prefill_chunk=32,
                 use_pallas=False, telemetry=None, mirror=False,
                 request_trace=None, prefix_cache=False, sharding=None,
                 speculation=None):
        c = model.config
        spec_cfg = speculation if (speculation or {}).get("enabled") else None
        tp = int(sharding.get("model", 1)) if isinstance(sharding, dict) \
            else int(sharding or 1)
        if tp < 1:
            raise ValueError(f"serving.sharding.model must be >= 1, got {tp}")
        if tp > 1 and mirror:
            raise ValueError(
                "mirror asserts bitwise identity against the dense "
                "oracle; the sharded proj psum reorders each reduction "
                "(token-identical, not bitwise) — run the mirror on an "
                "unsharded engine")
        if tp > 1 and spec_cfg is not None:
            raise ValueError(
                "speculation + serving.sharding.model > 1 is not supported: "
                "the spec_verify program is single-chip only (shard the "
                "target OR speculate, not both)")
        if tp > 1:
            raise _later(f"serving.sharding.model = {tp}",
                         "ROADMAP.md item 10.6 (head-sharded serving)")
        if max_model_len % block_size != 0:
            raise ValueError(f"max_model_len {max_model_len} not a multiple "
                             f"of block_size {block_size}")
        if max_model_len > c.n_positions:
            raise ValueError(f"max_model_len {max_model_len} exceeds the "
                             f"model's n_positions {c.n_positions}")
        if getattr(c, "sparse_attention", None):
            raise ValueError("serving supports dense attention only")
        if mirror and prefix_cache:
            raise ValueError(
                "mirror cannot run with prefix_cache: a warm start skips "
                "prefill chunks whose KV the dense per-slot oracle no longer "
                "holds (its cache is overwritten on slot reuse) — prove "
                "bitwise identity on a cache-off engine instead")
        if spec_cfg is not None and mirror:
            raise ValueError(
                "mirror asserts bitwise identity against the dense oracle; "
                "the K+1-wide spec_verify program runs other kernels than "
                "the 1-wide decode_step (token-identical, not bitwise) and "
                "commits multiple tokens per step the per-step oracle cannot "
                "follow — run the mirror on a speculation-off engine")
        if params is not None:
            model.load_parameters(params)
        self.tp = tp
        self.telemetry = telemetry
        self.model = model
        self.device = model.device
        self.params = serving_params(model)
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_model_len = int(max_model_len)
        self.max_blocks = self.max_model_len // self.block_size
        self.prefill_chunk = int(prefill_chunk)
        # with serving.request_trace disabled the tracer is None, and every
        # hook below is an `is not None` host branch
        rt = request_trace or {}
        self.tracer = None
        if rt.get("enabled"):
            self.tracer = RequestTracer(
                capacity=rt.get("capacity", 256),
                iteration_capacity=rt.get("iteration_capacity", 4096),
                dump_dir=rt.get("dump_dir") or None,
                slo=rt.get("slo"),
                host_id=rt.get("host_id", 0))

        # one graph memory pool for every program of this engine, the
        # draft's included (their outputs are consumed before the next replay)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        pool_shape = (c.n_layer, self.num_blocks, self.block_size,
                      c.n_head, c.head_dim)
        self.k_pool = torch.zeros(pool_shape, dtype=c.compute_dtype,
                                  device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=c.compute_dtype,
                                  device=self.device)

        self._spec = None
        self._verify = None
        self.spec_k = 0
        if spec_cfg is not None:
            from .speculative import SpeculativeDecoder
            draft_model = spec_cfg.get("draft_model")
            if draft_model is None:
                raise ValueError(
                    "serving.speculation.enabled needs a live draft model: "
                    "pass draft_model= (and optionally draft_parameters=) to "
                    "deepspeed_tpu_torch.init_inference (the config's "
                    "draft_model key is a label, not a loader)")
            draft_params = spec_cfg.get("draft_params")
            if draft_model is model:
                if draft_params is not None:
                    raise ValueError(
                        "draft_parameters for the target model itself would "
                        "overwrite the target's weights: pass the draft as a "
                        "GPT2Model of its own")
                dparams = self.params       # a self-draft shares the weights
            else:
                if draft_params is not None:
                    draft_model.load_parameters(draft_params)
                dparams = serving_params(draft_model)
            self.spec_k = int(spec_cfg.get("max_draft_tokens", 4))
            self._spec = SpeculativeDecoder(
                draft_model, dparams, num_slots=self.num_slots,
                block_size=self.block_size, max_blocks=self.max_blocks,
                prefill_chunk=self.prefill_chunk,
                draft_pool_blocks=(int(spec_cfg.get("draft_pool_blocks") or 0)
                                   or self.num_blocks),
                max_draft_tokens=self.spec_k, target_config=c,
                wrap=self._program)
        self._raw = build_paged_programs(
            model, num_slots=self.num_slots, block_size=self.block_size,
            max_blocks=self.max_blocks, prefill_chunk=self.prefill_chunk,
            use_pallas=use_pallas,
            verify_width=self.spec_k + 1 if self._spec is not None else 0)
        ins = self._raw["inputs"]
        self._decode = self._program("decode_step", self._raw["decode_step"],
                                     ins["decode_step"], self.params,
                                     self.k_pool, self.v_pool)
        self._prefill = self._program("prefill_chunk", self._raw["prefill_chunk"],
                                      ins["prefill_chunk"], self.params,
                                      self.k_pool, self.v_pool)
        if self._spec is not None:
            self._verify = self._program("spec_verify", self._raw["spec_verify"],
                                         ins["spec_verify"], self.params,
                                         self.k_pool, self.v_pool)
        self._copy = self._watch("serve:copy_blocks", self._raw["copy_blocks"])
        self._beam_heads = {}
        self.copy_width = self._raw["copy_width"]

        self.scheduler = Scheduler(
            num_slots=self.num_slots, num_blocks=self.num_blocks,
            block_size=self.block_size, max_model_len=self.max_model_len,
            prefill_chunk=self.prefill_chunk, prefix_cache=prefix_cache)
        self.prefix_cache = self.scheduler.prefix_cache

        self._mirror = None
        self.mirror_checks = 0
        if mirror:
            from .oracle import build_oracle_programs
            self._mirror = build_oracle_programs(
                model, num_slots=self.num_slots, max_len=self.max_model_len,
                prefill_chunk=self.prefill_chunk)
            self._okcs, self._ovcs = self._mirror["fresh_caches"]()

        self._it = 0
        self._order = []                    # req_id submission order
        self.outputs = {}                   # req_id -> RequestOutput
        self._submit_ms = {}
        self._start_wall = None
        self._tokens_sampled = 0            # every appended token
        self._tokens_finished = 0           # tokens of finished requests only
        # target-model step accounting (speculation's headline number):
        # _target_steps counts target program executions (prefill chunks,
        # decode steps, spec verifies); _advance_steps counts per-GROUP
        # participations in a token-advancing step, so advance/token reads
        # ~1.0 for plain greedy and ~1/(1+E[accepted]) with speculation
        self._target_steps = 0
        self._advance_steps = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_rounds = 0

    # ------------------------------------------------------------- plumbing
    def _program(self, name, fn, inputs, params, k_pool, v_pool):
        """A serving program as the engine runs it, taking its per-step
        inputs as host arrays: a CUDA graph on the card (captured here, the
        capture recorded by the compile watchdog), op by op on the CPU (its
        first call recorded)."""
        if self._graph_pool is None:
            return self._watch(f"serve:{name}",
                               EagerProgram(fn, name, inputs, params, k_pool, v_pool))
        t0 = time.perf_counter()
        prog = GraphedProgram(fn, name, inputs, params, k_pool, v_pool,
                              self._graph_pool)
        if self.telemetry is not None:
            sig = tuple((tuple(shape), np.dtype(dtype), str(self.device))
                        for shape, dtype in inputs)
            self.telemetry.record_capture(f"serve:{name}", sig,
                                          time.perf_counter() - t0, prog.pool_bytes)
        return prog

    def _watch(self, name, fn):
        return self.telemetry.watch(name, fn) if self.telemetry is not None else fn

    def _scalar(self, name, value):
        if self.telemetry is not None:
            self.telemetry.monitor.add_scalar(f"Serving/{name}", float(value), self._it)

    def graphs(self):
        """name -> GraphedProgram of this engine (empty on the CPU)."""
        progs = {"decode_step": self._decode, "prefill_chunk": self._prefill,
                 "spec_verify": self._verify}
        if self._spec is not None:
            progs.update(spec_draft_decode=self._spec._decode,
                         spec_draft_prefill=self._spec._prefill)
        return {k: v for k, v in progs.items() if isinstance(v, GraphedProgram)}

    def _tensor(self, a, dtype):
        return stage(a, dtype, self.device)

    def _beam_head(self, kind, g):
        key = (kind, g.lanes, g.req.eos_token_id)
        if key not in self._beam_heads:
            self._beam_heads[key] = self._watch(
                f"serve:beam_{kind}_k{key[1]}_e{key[2]}",
                self._raw[f"beam_{kind}"](key[1], key[2]))
        return self._beam_heads[key]

    # ----------------------------------------------------------- submission
    def submit(self, req):
        """Queue a request; infeasible ones are refused (a RequestOutput with
        status "refused"), never crash the engine."""
        self._order.append(req.req_id)
        self._submit_ms[req.req_id] = time.perf_counter()
        if self.tracer is not None:
            self.tracer.on_submit(req)
        reason = self.scheduler.submit(req)
        if reason is not None:
            if self.tracer is not None:
                self.tracer.on_refused(req, reason)
            out = RequestOutput(req.req_id, "refused", refusal=reason)
            self.outputs[req.req_id] = out
            return out
        return None

    # ---------------------------------------------------------- the big loop
    def step(self):
        """One serving iteration. Returns the schedule-log dict — pure host
        decisions only, so a trace replay is byte-identical (json.dumps)."""
        if self._start_wall is None:
            self._start_wall = time.perf_counter()
        sched, it, tr = self.scheduler, self._it, self.tracer
        log = {"it": it}
        if tr is not None:
            tr.begin_iteration(it)

        admitted = sched.admit(it)
        preempted, copies = sched.ensure_decode_room()
        log["admitted"] = [g.req.req_id for g in admitted]
        log["preempted"] = [g.req.req_id for g in preempted]
        log["copies"] = [list(c) for c in copies]
        if tr is not None:
            for g in admitted:
                tr.on_admit(g, it)
            for g in preempted:
                tr.on_preempt(g, it, g.evicted_blocks)
        self._run_copies(copies)

        log["prefill"] = self._prefill_one(it)
        spec_res = self._speculate_all(it) if self._spec is not None else None
        if spec_res is not None:
            log["spec"], log["decode"], log["finished"] = spec_res
        else:
            if self._spec is not None:
                log["spec"] = []
            log["decode"], log["finished"] = self._decode_all(it)

        self._scalar("occupancy", sched.occupancy())
        self._scalar("waiting", len(sched.waiting))
        self._scalar("free_blocks", sched.allocator.num_free)
        if self.prefix_cache is not None and self.telemetry is not None:
            pc = self.prefix_cache.stats()
            self._scalar("PrefixCache/hit_rate", pc["hit_rate"])
            self._scalar("PrefixCache/hit_tokens", pc["hit_tokens"])
            self._scalar("PrefixCache/parked_blocks", pc["parked_blocks"])
            self._scalar("PrefixCache/evictions", pc["evictions"])
        if self._spec is not None and self.telemetry is not None:
            s = self.spec_summary()
            self._scalar("Spec/acceptance_rate", s["spec_acceptance_rate"])
            self._scalar("Spec/drafted_tokens", s["drafted_tokens"])
            self._scalar("Spec/accepted_tokens", s["accepted_tokens"])
            self._scalar("Spec/wasted_draft_tokens", s["wasted_draft_tokens"])
            self._scalar("Spec/target_steps_per_token", s["target_steps_per_token"])
        elapsed = max(time.perf_counter() - self._start_wall, 1e-9)
        self._scalar("tok_s", self._tokens_sampled / elapsed)
        self._scalar("goodput_tok_s", self._tokens_finished / elapsed)
        if tr is not None:
            itrec = tr.end_iteration(len(sched.waiting), len(sched.running),
                                     sched.pool_stats())
            if self.telemetry is not None:
                ws = tr.waste_summary()
                self._scalar("Waste/replayed_tokens", ws["replayed_tokens"])
                self._scalar("Waste/fraction", ws["waste_fraction"])
                self._scalar("Pool/fragmentation", itrec["pool"]["frag"])
                self.telemetry.end_step(it, 1, serving=tr.latency_summary())
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
            self._copy(self.k_pool, self.v_pool, self._tensor(src, np.int32),
                       self._tensor(dst, np.int32))

    def _pad_table(self, table):
        out = np.full(self.max_blocks, NULL_BLOCK, np.int32)
        out[:len(table)] = table
        return out

    def _prefill_one(self, it):
        pf = self.scheduler.next_prefill(it)
        if pf is None:
            return None
        g, pos, n, chunk = pf
        logits = self._prefill(self.params, [chunk], pos, n,
                               self._pad_table(g.tables[0]), self.k_pool, self.v_pool)
        self._target_steps += 1
        if self._mirror is not None:
            ol = self._mirror["prefill_chunk"](
                self.params, *(self._tensor(a, np.int32)
                               for a in ([chunk], pos, n, g.slots[0])),
                self._okcs, self._ovcs)
            self._assert_bitwise(logits, ol, f"prefill it={it} "
                                 f"req={g.req.req_id} pos={pos}")
        if self.tracer is not None:
            self.tracer.on_prefill(g, it, pos, n, g.prefill_replay_tokens(pos, n))
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
            if self._mirror is not None:
                perm = np.arange(self.num_slots, dtype=np.int32)
                perm[np.asarray(g.slots[1:], np.int32)] = g.slots[0]
                self._mirror["reorder"](self._okcs, self._ovcs,
                                        self._tensor(perm, np.int32))
        self._tokens_sampled += g.lanes
        if self.tracer is not None:
            # single-source TTFT: the ledger record feeds the Group field
            # AND the RequestOutput fields (they read the same numbers, so
            # they cannot drift)
            self.tracer.on_fork(g, it)
            ttft_ms, ttft_iters = self.tracer.on_first_token(g, it)
        else:
            ttft_ms = (time.perf_counter()
                       - self._submit_ms[g.req.req_id]) * 1000.0
            ttft_iters = it - g.req.arrival
        g.first_token_ms = ttft_ms
        self._scalar("ttft_ms", ttft_ms)
        self._scalar("ttft_iters", ttft_iters)

    # -------------------------------------------------------- speculation
    def _extend_target_table(self, g, m, copies):
        """Cover write positions ``next_pos .. next_pos+m`` in the group's
        target block table before a verify step: fresh pages past the end,
        ``ensure_exclusive`` (CoW) for existing shared ones — the same
        discipline as Scheduler._ensure_group_blocks, widened to the verify
        window. On pool exhaustion the appended pages go back and the table
        shrinks to its original length (the group plain-decodes this
        iteration); CoW swaps that already happened keep their device copy,
        the pages are genuinely exclusive now (the scheduler precedent)."""
        from .block_allocator import AllocationError
        alloc = self.scheduler.allocator
        BS = self.block_size
        table = g.tables[0]
        orig_len = len(table)
        p0 = g.next_pos(0)
        try:
            for bi in range(p0 // BS, (p0 + m) // BS + 1):
                if bi == len(table):
                    table.append(alloc.allocate(1)[0])
                else:
                    blk, copy = alloc.ensure_exclusive(table[bi])
                    if copy is not None:
                        table[bi] = blk
                        copies.append(copy)
        except AllocationError:
            if len(table) > orig_len:
                alloc.free(table[orig_len:])
                del table[orig_len:]
            return False
        return True

    def _speculate_all(self, it):
        """One speculative decode round, replacing ``_decode_all`` for the
        whole iteration: eligible single-lane greedy groups get up to K draft
        proposals verified at K+1 positions, and EVERY other decode lane
        (beam lanes, sampled lanes, groups that lost a draft-page race) rides
        the same ``spec_verify`` execution as a plain ``n_valid=1`` row — so
        a speculative iteration still executes exactly ONE target
        decode-domain program, and "strictly fewer target steps" holds at
        the program-execution level, not just per token.

        Accepted prefixes (plus the target's own next token) commit; the
        first rejection truncates the block table to the accepted frontier
        and refcount-releases the tail (free rollback — the kept partial
        page's garbage tail is never attended and is overwritten next
        round). Returns ``(spec_log, decode_log, finished)``, or None when
        no group can draft this iteration (the caller falls back to the
        cheaper 1-wide ``decode_step``)."""
        spec, sched, alloc = self._spec, self.scheduler, self.scheduler.allocator
        spec.sync(sched.running)
        lanes = [(g, lane, slot) for g, lane, slot in
                 sched.decode_lanes() if g.entered_decode_it != it]
        plan, copies = [], []
        for g, lane, slot in lanes:
            if lane != 0 or g.lanes != 1 or g.req.temperature > 0.0:
                continue
            # never draft past the request budget: m proposals commit at most
            # m+1 tokens, and the final token must come from a verify row so
            # the emitted stream matches plain decode's finish check exactly
            m = min(self.spec_k,
                    g.req.max_new_tokens - len(g.generated[0]) - 1)
            if m < 1:
                continue
            if not spec.prepare(g, m):
                continue
            if not self._extend_target_table(g, m, copies):
                continue
            plan.append((g, m))
        self._run_copies(copies)
        if not plan:
            return None

        drafts = spec.propose(plan)
        plan_groups = {id(g) for g, _ in plan}
        plain = [(g, lane, slot) for g, lane, slot in lanes
                 if id(g) not in plan_groups]
        decode_log = [[g.req.req_id, lane, slot] for g, lane, slot in plain]
        if self.tracer is not None:
            traced = set()
            for g, _, _ in plain:
                if id(g) in traced:
                    continue
                traced.add(id(g))
                self.tracer.on_decode(
                    g, it, g.lanes, g.lanes if g.decode_is_replay() else 0)

        S, D = self.num_slots, self.spec_k + 1
        toks = np.zeros((S, D), np.int32)
        pos0 = np.zeros(S, np.int32)
        n_valid = np.zeros(S, np.int32)
        tables = np.full((S, self.max_blocks), NULL_BLOCK, np.int32)
        active = np.zeros(S, bool)
        for g, m in plan:
            slot = g.slots[0]
            toks[slot, 0] = g.generated[0][-1]
            toks[slot, 1:1 + m] = drafts[spec._key(g)]
            pos0[slot] = g.next_pos(0)
            n_valid[slot] = m + 1
            tables[slot] = self._pad_table(g.tables[0])
            active[slot] = True
        for g, lane, slot in plain:
            toks[slot, 0] = g.generated[lane][-1]
            pos0[slot] = g.next_pos(lane)
            n_valid[slot] = 1
            tables[slot] = self._pad_table(g.tables[lane])
            active[slot] = True
        logits = self._verify(self.params, toks, pos0, n_valid, tables, active,
                              self.k_pool, self.v_pool)
        self._target_steps += 1
        self._advance_steps += len(plan) + len({id(g) for g, _, _ in plain})
        self._spec_rounds += 1
        logits_np = logits.cpu().numpy()

        spec_log, finished = [], []
        for g, m in plan:
            slot = g.slots[0]
            p0 = g.next_pos(0)
            ds = drafts[spec._key(g)]
            len_before = len(g.generated[0])
            eos, L = g.req.eos_token_id, g.req.max_new_tokens
            committed, a, fin = [], 0, False
            for i in range(m + 1):
                t = int(np.argmax(logits_np[slot, i]))
                committed.append(t)
                matched = i < m and ds[i] == t
                if matched:
                    a += 1
                # the exact _sample_greedy finish check, applied per token
                if (len_before + len(committed) >= L
                        or (eos >= 0 and t == eos)):
                    fin = True
                    break
                if not matched:
                    break
            g.generated[0].extend(committed)
            self._tokens_sampled += len(committed)
            self._spec_drafted += m
            self._spec_accepted += a
            r = min(max(g.replay_decode_hwm - len_before, 0), len(committed))
            if self.tracer is not None:
                self.tracer.on_spec(g, it, drafted=m, accepted=a,
                                    committed=len(committed), replayed=r)
            spec_log.append([g.req.req_id, m, a, len(committed)])
            if fin:
                self._finish(g, g.generated[0], None, finished, it)
                continue
            # rollback: the table only needs to cover the committed frontier
            # (positions <= p0 + a hold valid KV)
            keep = alloc.blocks_for_tokens(p0 + a + 1)
            table = g.tables[0]
            if keep < len(table):
                alloc.free(table[keep:])
                del table[keep:]
            spec.observe(g, p0, a, m)

        # the ride-along lanes sample from verify row 0 — greedy argmax is
        # token-identical to decode_step's row; beam heads consume the
        # device row (the verify's output, before any other replay)
        logits0_np = logits_np[:, 0]
        logits0 = None
        for g in list(sched.running):
            if (g.phase != "decode" or g.entered_decode_it == it
                    or id(g) in plan_groups):
                continue
            if g.lanes == 1:
                self._sample_greedy(g, logits0_np, finished, it)
            else:
                if logits0 is None:
                    logits0 = logits[:, 0]
                self._sample_beam(g, logits0, finished, it)
        return spec_log, decode_log, finished

    def _decode_all(self, it):
        # a group that completed prefill THIS iteration sits out one decode:
        # its first write block is ensured at the NEXT iteration's start
        lanes = [(g, lane, slot) for g, lane, slot in
                 self.scheduler.decode_lanes() if g.entered_decode_it != it]
        decode_log = [[g.req.req_id, lane, slot] for g, lane, slot in lanes]
        if not lanes:
            return decode_log, []
        if self.tracer is not None:
            # classify BEFORE sampling appends: a step whose pre-append token
            # count sits below the group's replay high-water mark regenerates
            # work a preempted attempt already did (all K lanes of it)
            traced = set()
            for g, _, _ in lanes:
                if id(g) in traced:
                    continue
                traced.add(id(g))
                self.tracer.on_decode(
                    g, it, g.lanes, g.lanes if g.decode_is_replay() else 0)
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
        logits = self._decode(self.params, toks, pos, tables, active,
                              self.k_pool, self.v_pool)
        self._target_steps += 1
        self._advance_steps += len({id(g) for g, _, _ in lanes})
        if self._mirror is not None:
            ol = self._mirror["decode_step"](
                self.params, self._tensor(toks, np.int32), self._tensor(pos, np.int32),
                self._tensor(active, bool), self._okcs, self._ovcs)
            self._assert_bitwise(logits, ol, f"decode it={it}", rows=active)
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
        self._tokens_sampled += 1
        eos = g.req.eos_token_id
        if (len(g.generated[0]) >= g.req.max_new_tokens
                or (eos >= 0 and tok == eos)):
            self._finish(g, g.generated[0], None, finished, it)

    def _sample_beam(self, g, logits, finished, it):
        scores, parents, toks, live = self._beam_head("select", g)(
            logits, self._tensor(g.slots, np.int32),
            self._tensor(np.asarray(g.scores, np.float32), np.float32),
            self._tensor(np.asarray(g.live, bool), bool))
        parents = [int(p) for p in parents.cpu().numpy()]
        old_slot_of = [g.slots[p] for p in parents]
        self.scheduler.reorder_beams(g, parents)
        if self._mirror is not None:
            perm = np.arange(self.num_slots, dtype=np.int32)
            perm[np.asarray(g.slots, np.int32)] = old_slot_of
            self._mirror["reorder"](self._okcs, self._ovcs,
                                    self._tensor(perm, np.int32))
        for k, t in enumerate(toks.cpu().numpy()):
            g.generated[k].append(int(t))
        self._tokens_sampled += g.lanes
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
        if self._spec is not None:
            self._spec.release(g)   # draft pages die with the request
        self.scheduler.finish_group(g)
        n = len(tokens)
        self._tokens_finished += n
        rec = (self.tracer.on_finish(g, it, n)
               if self.tracer is not None else None)
        if rec is not None:
            # ledger-derived bookkeeping (same record the timeline exports)
            out = RequestOutput(
                g.req.req_id, "finished", tokens=list(tokens), score=score,
                ttft_iters=rec.get("ttft_iters"), ttft_ms=rec.get("ttft_ms"),
                finished_it=rec["finished_it"],
                preemptions=rec["preemptions"])
        else:
            out = RequestOutput(
                g.req.req_id, "finished", tokens=list(tokens), score=score,
                ttft_iters=(g.first_token_it - g.req.arrival),
                ttft_ms=g.first_token_ms, finished_it=it,
                preemptions=getattr(g.req, "_preemptions_carry",
                                    g.preemptions))
        self.outputs[g.req.req_id] = out
        finished.append(g.req.req_id)

    def _assert_bitwise(self, paged, dense, what, rows=None):
        a, b = paged.cpu().numpy(), dense.cpu().numpy()
        if rows is not None:
            a, b = a[rows], b[rows]
        if not np.array_equal(a, b):
            bad = int(np.sum(a != b))
            raise AssertionError(
                f"paged/dense logits diverged ({what}): {bad} of {a.size} "
                f"entries differ; max abs diff "
                f"{float(np.max(np.abs(a - b)))!r}")
        self.mirror_checks += 1

    # ------------------------------------------------------------- metrics
    @property
    def target_steps(self):
        """Target-model program executions so far (prefill chunks + decode
        steps + spec verifies) — speculation's strict-improvement number."""
        return self._target_steps

    def spec_summary(self):
        """Speculation efficiency counters: ``target_steps_per_token``
        divides per-group participations in token-advancing steps by tokens
        sampled, so plain greedy reads ~1.0 and speculation
        ~1/(1 + E[accepted])."""
        drafted, accepted = self._spec_drafted, self._spec_accepted
        return {
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "wasted_draft_tokens": drafted - accepted,
            "spec_rounds": self._spec_rounds,
            "spec_acceptance_rate": accepted / max(drafted, 1),
            "target_steps": self._target_steps,
            "advance_steps": self._advance_steps,
            "target_steps_per_token":
                self._advance_steps / max(self._tokens_sampled, 1),
        }

    # ------------------------------------------------------- fleet hooks
    def prefix_peek(self, prompt):
        """Read-only fleet-router probe: ``(hit_blocks, hit_tokens)`` this
        replica's prefix cache would serve for ``prompt`` — no stats are
        touched, no blocks are revived. ``(0, 0)`` when the cache is
        disabled."""
        if self.prefix_cache is None:
            return (0, 0)
        blocks, hit_tokens = self.prefix_cache.peek(prompt)
        return (len(blocks), hit_tokens)

    def load_view(self) -> dict:
        """Host-side load snapshot for fleet admission/balance decisions:
        queue depth, lane usage, and pool headroom, all exact counters the
        scheduler already maintains (no device sync)."""
        return {"waiting": len(self.scheduler.waiting),
                "running": len(self.scheduler.running),
                "free_slots": len(self.scheduler.free_slots),
                "free_blocks": self.scheduler.allocator.num_free,
                "num_blocks": self.num_blocks,
                "it": self._it}

    def fast_forward(self, it: int):
        """Advance the iteration clock without stepping — a cold replacement
        joining a fleet at iteration ``it`` must not restart from 0."""
        self._it = max(self._it, int(it))

    # ------------------------------------------------------- warm restart
    _OUT_FIELDS = ("req_id", "status", "tokens", "score", "refusal",
                   "ttft_iters", "ttft_ms", "finished_it", "preemptions")

    def geometry(self) -> dict:
        """Everything the paged programs' shapes (and therefore the KV pool
        bytes) depend on — a warm restart into a different geometry would
        read pages laid out for another engine, so restore validates this.
        ``compute_dtype`` is the dtype's name as the JAX package writes it
        ("bfloat16", "float32"), so snapshots cross between the packages."""
        c = self.model.config
        return {"num_slots": self.num_slots, "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "max_model_len": self.max_model_len,
                "prefill_chunk": self.prefill_chunk, "tp": self.tp,
                "n_layer": int(c.n_layer), "n_head": int(c.n_head),
                "head_dim": int(c.head_dim),
                "compute_dtype": str(c.compute_dtype).replace("torch.", "")}

    def state_dict(self) -> dict:
        """Warm-restart snapshot: quiesces the scheduler (preempting every
        running group so its prefill frontier parks in the prefix cache),
        then captures the KV pools (CPU tensors in the compute dtype), the
        allocator/cache/scheduler ledgers, and the request bookkeeping as
        host data. The restored replica remaps parked prompt pages through
        the prefix machinery instead of re-prefilling."""
        self.scheduler.quiesce()
        if self._spec is not None:
            # draft state is best-effort: the restored replica re-drafts from
            # each request's committed context (token-identity is unaffected)
            self._spec.drop_all()
        return {
            "geometry": self.geometry(),
            "scheduler": self.scheduler.state_dict(),
            "it": self._it,
            "order": list(self._order),
            "outputs": [{k: getattr(o, k) for k in self._OUT_FIELDS}
                        for o in self.outputs.values()],
            "tokens_sampled": self._tokens_sampled,
            "tokens_finished": self._tokens_finished,
            "k_pool": self.k_pool.cpu(),
            "v_pool": self.v_pool.cpu(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Rejoin warm from a ``state_dict`` snapshot (this package's or the
        JAX package's; pools as tensors or numpy arrays, in any float dtype
        that holds the compute dtype's values). Refuses (ValueError) a
        snapshot whose geometry does not match this engine — page indices and
        pool bytes are only meaningful under the exact same layout. The pools
        are copied into the live ones, whose addresses the captured graphs
        hold."""
        mine, theirs = self.geometry(), state["geometry"]
        if mine != theirs:
            diff = {k: (theirs.get(k), mine.get(k))
                    for k in sorted(set(mine) | set(theirs))
                    if theirs.get(k) != mine.get(k)}
            raise ValueError(f"serving warm restart refused: checkpoint "
                             f"geometry does not match this engine "
                             f"(checkpoint vs live): {diff}")
        self.scheduler.load_state_dict(state["scheduler"])
        self._it = int(state["it"])
        self._order = list(state["order"])
        self.outputs = {d["req_id"]: RequestOutput(**d)
                        for d in state["outputs"]}
        self._tokens_sampled = int(state["tokens_sampled"])
        self._tokens_finished = int(state["tokens_finished"])
        with torch.no_grad():
            for live, saved in ((self.k_pool, state["k_pool"]),
                                (self.v_pool, state["v_pool"])):
                live.copy_(torch.as_tensor(saved))
        # wall-clock bookkeeping restarts: TTFT-ms of still-pending requests
        # is measured from the rejoin (iteration-time TTFT is exact)
        now = time.perf_counter()
        self._submit_ms = {r.req_id: now
                           for r, _ in self.scheduler.waiting}
        if self.tracer is not None:
            # requeued requests re-enter this replica's ledger fresh — their
            # pre-kill history died with the old process, and TTFT after a
            # warm restart is TTFT as experienced from the rejoin
            for r, _ in self.scheduler.waiting:
                self.tracer.on_submit(r)
        self._start_wall = None

    # ---------------------------------------------------- later slices
    def lint_programs(self, sample_batch=None):
        raise _later("InferenceEngine.lint_programs", "ROADMAP.md item 23 (lint)")

    def memory_manifest(self):
        raise _later("InferenceEngine.memory_manifest",
                     "ROADMAP.md item 22b (device observatories: utils/hbm.py)")
