"""Speculative decoding over the paged KV pool (Leviathan et al., greedy;
PyTorch port of ``deepspeed_tpu/serve/speculative.py``).

The draft model autoregressively proposes up to K tokens per scheduler
iteration against its OWN small paged pool (its programs are the same
fixed-shape ``decode_step`` / ``prefill_chunk`` builds from serve/paged.py,
on the gather path, as in the JAX package, and CUDA graphs on the card like
the target's), then the target verifies all K+1 positions in ONE
``spec_verify`` execution over the main pool — a batched, chunked-prefill-
shaped step with per-position logits out. Greedy acceptance: walking the
verify rows in order, row i's argmax g_i commits unconditionally (it is what
plain decode would have sampled there); if it equals draft token d_{i+1} the
walk continues, else it stops — so every round commits between 1 and K+1
tokens and the emitted stream is token-identical to the target's own greedy
decode. The first rejection truncates the request's block table back to the
accepted frontier and refcount-releases the tail pages; garbage KV past the
frontier in the kept partial page is never attended (the causal mask stops at
the query position) and the next round's writes cover the same extent, so
rollback is free — no device work, exactly the CoW allocator's fork/release
machinery beam search already exercises.

Identity contract: the D-wide verify rows are argmax-identical to the 1-wide
``decode_step`` but NOT bitwise (the wider batch runs other kernels, and on
the card the decode step may run the paged-decode kernel), so the engine
refuses speculation + mirror-oracle.

This module owns only the DRAFT side (pools, allocator, catch-up prefill,
proposal loop) plus the pure acceptance rule; the engine owns the target
``spec_verify`` program and the commit/rollback of the target block table.
Draft state is best-effort by construction: a preempted or finished group's
draft pages are dropped (``sync``) and rebuilt from the request's committed
context on its next speculative turn, so preemption, warm restart and the
latest-admitted-first victim policy are untouched.
"""

import numpy as np
import torch

from ..utils.op_record import dtype_name
from .block_allocator import AllocationError, BlockAllocator, NULL_BLOCK
from .paged import build_paged_programs


def accept_greedy(row_argmax, draft_tokens):
    """The speculative acceptance rule on host ints. ``row_argmax[i]`` is the
    target's greedy token after consuming the last committed token plus
    ``draft_tokens[:i]``; returns ``(committed, accepted)`` where ``committed``
    is the token run plain greedy decode would have emitted (always at least
    one: row 0 IS the plain decode step) and ``accepted`` counts the draft
    tokens that matched. The caller cuts ``committed`` early on EOS /
    max_new_tokens — this rule knows nothing about stop conditions."""
    committed, accepted = [], 0
    m = len(draft_tokens)
    for i, t in enumerate(row_argmax):
        committed.append(int(t))
        if i < m and int(draft_tokens[i]) == int(t):
            accepted += 1
        else:
            break
    return committed, accepted


class SpeculativeDecoder:
    """Draft-side state machine for one engine: a private paged KV pool for
    the draft model, per-group draft block tables, and the propose loop.

    ``draft_params`` is the draft's serving parameter tree
    (``paged.serving_params``). The draft pool mirrors the target pool's
    geometry knobs (block size, table width, chunk length) at the DRAFT
    model's layer/head shapes, and is sized by ``draft_pool_blocks``. Draft
    pages are never shared (no beam lanes, no prefix cache), so there is no
    CoW here — truncation after a rejection is a plain refcount release.
    Draft allocation failure is never fatal: the group simply decodes plainly
    this iteration (deterministic — a pure function of pool state, itself a
    pure function of the trace). ``wrap(name, fn, inputs, params, k_pool,
    v_pool)`` turns a program into what the engine runs (a CUDA graph on the
    card, op by op on the CPU; either takes host inputs)."""

    def __init__(self, draft_model, draft_params, *, num_slots, block_size,
                 max_blocks, prefill_chunk, draft_pool_blocks,
                 max_draft_tokens, target_config, wrap):
        dc = draft_model.config
        if dc.vocab_size != target_config.vocab_size:
            raise ValueError(
                f"draft vocab_size {dc.vocab_size} != target vocab_size "
                f"{target_config.vocab_size}: speculative acceptance compares "
                "token ids, the vocabularies must be the same")
        max_model_len = int(max_blocks) * int(block_size)
        if dc.n_positions < max_model_len:
            raise ValueError(
                f"draft n_positions {dc.n_positions} < max_model_len "
                f"{max_model_len}: the draft must reach every position the "
                "target serves")
        if getattr(dc, "moe_experts", 0) or getattr(dc, "sparse_attention",
                                                    None):
            raise ValueError("speculative drafting supports dense draft "
                             "models only (same rule as the serving engine)")
        if max_draft_tokens < 1:
            raise ValueError(f"max_draft_tokens must be >= 1, "
                             f"got {max_draft_tokens}")
        self.model = draft_model
        self.params = draft_params
        self.device = draft_model.device
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_blocks = int(max_blocks)
        self.prefill_chunk = int(prefill_chunk)
        self.max_draft_tokens = int(max_draft_tokens)
        self.allocator = BlockAllocator(int(draft_pool_blocks),
                                        int(block_size))
        raw = build_paged_programs(
            draft_model, num_slots=self.num_slots,
            block_size=self.block_size, max_blocks=self.max_blocks,
            prefill_chunk=self.prefill_chunk)
        self._raw = raw
        pool_shape = (dc.n_layer, int(draft_pool_blocks), self.block_size,
                      dc.n_head, dc.head_dim)
        self.k_pool = torch.zeros(pool_shape, dtype=dc.compute_dtype,
                                  device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=dc.compute_dtype,
                                  device=self.device)
        self._decode = wrap("spec_draft_decode", raw["decode_step"],
                            raw["inputs"]["decode_step"], self.params,
                            self.k_pool, self.v_pool)
        self._prefill = wrap("spec_draft_prefill", raw["prefill_chunk"],
                             raw["inputs"]["prefill_chunk"], self.params,
                             self.k_pool, self.v_pool)
        # (req_id, admission_idx) -> {"table": [...], "done": int}: ``done``
        # counts positions with valid draft KV; the key is unique per Group
        # instance (a preempt-restart re-admits under a new admission_idx),
        # so stale state can never alias a restarted request
        self._state = {}

    def lint_programs(self):
        """The draft's programs for the lint registry, on fresh zero pools,
        with the serving manifest (deepspeed_tpu/serve/speculative.py:251)."""
        from .engine import _lint_manifest
        dc = self.model.config
        S, MB, C = self.num_slots, self.max_blocks, self.prefill_chunk
        kp, vp = torch.zeros_like(self.k_pool), torch.zeros_like(self.v_pool)
        manifest = _lint_manifest(dtype_name(dc.compute_dtype), kp, vp)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return [
            ("serve_spec_draft_decode", self._raw["decode_step"],
             (self.params, zeros(S), zeros(S), zeros(S, MB), zeros(S, dtype=torch.bool),
              kp, vp), manifest),
            ("serve_spec_draft_prefill", self._raw["prefill_chunk"],
             (self.params, zeros(1, C), zeros(),
              torch.ones((), dtype=torch.int32, device=self.device), zeros(MB), kp, vp),
             manifest),
        ]

    # ----------------------------------------------------------- group state
    @staticmethod
    def _key(g):
        return (g.req.req_id, g.admission_idx)

    def sync(self, running):
        """Drop draft state for groups no longer running (finished, preempted
        or quiesced) — their pages go back to the draft pool. Called at the
        top of every speculative turn, so no removal path needs a hook."""
        alive = {self._key(g) for g in running}
        for key in [k for k in self._state if k not in alive]:
            self.allocator.free(self._state.pop(key)["table"])

    def release(self, g):
        st = self._state.pop(self._key(g), None)
        if st is not None:
            self.allocator.free(st["table"])

    def drop_all(self):
        for key in list(self._state):
            self.allocator.free(self._state.pop(key)["table"])

    def prepare(self, g, m):
        """Host-only reservation for one speculative round: make the group's
        draft table cover every position the catch-up + proposal pass will
        write (up to ``next_pos + m - 1``). Returns False — group plain-
        decodes this iteration — when the draft pool cannot cover it; any
        state it already has stays valid (``done`` just lags further)."""
        st = self._state.setdefault(self._key(g), {"table": [], "done": 0})
        need = self.allocator.blocks_for_tokens(g.next_pos(0) + m)
        ext = need - len(st["table"])
        if ext <= 0:
            return True
        try:
            st["table"].extend(self.allocator.allocate(ext))
        except AllocationError:
            return False
        return True

    # -------------------------------------------------------------- proposal
    def _pad_table(self, table):
        out = np.full(self.max_blocks, NULL_BLOCK, np.int32)
        out[:len(table)] = table
        return out

    def _catch_up(self, g, st):
        """Feed the draft every committed token it has not consumed yet —
        ``ctx[done:]`` — through the fixed-shape prefill program, one chunk
        at a time. The chunk that reaches the context frontier returns the
        draft's next-token logits, i.e. the first proposal. Returns that
        logits row ([V] float32 numpy)."""
        ctx = g.req.prompt + g.generated[0]
        C = self.prefill_chunk
        table = self._pad_table(st["table"])
        logits = None
        for pos in range(st["done"], len(ctx), C):
            chunk = ctx[pos:pos + C]
            n = len(chunk)
            chunk = chunk + [0] * (C - n)
            logits = self._prefill(self.params, [chunk], pos, n, table,
                                   self.k_pool, self.v_pool)
        st["done"] = len(ctx)
        return logits[0].cpu().numpy()

    def propose(self, plan):
        """Run one drafting turn for every (group, m) in ``plan``: per-group
        catch-up prefill (first proposal falls out of the chunk that completes
        the context), then batched greedy draft-decode steps for the rest —
        groups that want fewer proposals go inactive in later steps. Returns
        ``{key(g): [d_1..d_m]}``. Every program call has the one fixed shape,
        so a drafting turn replays the captured graphs only."""
        drafts, alive = {}, []
        for g, m in plan:
            st = self._state[self._key(g)]
            row = self._catch_up(g, st)
            drafts[self._key(g)] = [int(np.argmax(row))]
            if m > 1:
                alive.append((g, m, st))
        steps = max((m - 1 for _, m, _ in alive), default=0)
        S = self.num_slots
        for j in range(steps):
            toks = np.zeros(S, np.int32)
            pos = np.zeros(S, np.int32)
            tables = np.full((S, self.max_blocks), NULL_BLOCK, np.int32)
            active = np.zeros(S, bool)
            stepping = []
            for g, m, st in alive:
                if j >= m - 1:
                    continue
                slot = g.slots[0]
                ds = drafts[self._key(g)]
                toks[slot] = ds[-1]
                pos[slot] = st["done"]
                tables[slot] = self._pad_table(st["table"])
                active[slot] = True
                stepping.append((g, st))
            logits = self._decode(self.params, toks, pos, tables, active,
                                  self.k_pool, self.v_pool)
            logits_np = logits.cpu().numpy()
            for g, st in stepping:
                drafts[self._key(g)].append(
                    int(np.argmax(logits_np[g.slots[0]])))
                st["done"] += 1
        return drafts

    def observe(self, g, p0, accepted, drafted):
        """Reconcile draft state with a verify outcome: positions past the
        accepted frontier hold rejected-token KV, so ``done`` falls back to
        ``min(p0 + accepted + 1, p0 + drafted)`` and the table truncates to
        match — the draft-side twin of the target-table rollback (plain
        refcount release; draft pages are never shared)."""
        st = self._state.get(self._key(g))
        if st is None:
            return
        st["done"] = min(p0 + accepted + 1, p0 + drafted)
        keep = self.allocator.blocks_for_tokens(st["done"])
        if keep < len(st["table"]):
            self.allocator.free(st["table"][keep:])
            del st["table"][keep:]

    # ------------------------------------------------------------------ misc
    def pool_stats(self):
        st = self.allocator.stats()
        return {"free": st["free"], "used": st["used"]}
