"""Paged KV-cache programs over models/gpt2.py (PyTorch port).

Counterpart of ``deepspeed_tpu/serve/paged.py`` for one device:
``decode_step``, ``prefill_chunk``, ``spec_verify`` (with ``verify_width``),
``copy_blocks`` and the ``beam_init(K, eos)`` / ``beam_select(K, eos)``
heads. Shapes are fixed at build time (slot count, chunk length, verify
width, table width, pool geometry), and what changes per iteration rides in
as tensor values, as in the JAX package: ``prefill_chunk``'s ``pos`` and
``n_valid`` are int32 tensors (JAX's traced ``jnp.int32``), and the last
valid row is picked on the device, so no program reads a value back.

The pool is ``[n_layer, num_blocks, block_size, n_head, head_dim]`` per k/v in
the compute dtype; block 0 is the reserved null page (block_allocator). The
gather path rebuilds each slot's pages into the dense
``[slots, n_head, max_blocks * block_size, head_dim]`` view and runs the
JAX package's score / mask / softmax / value math; with ``use_pallas`` the
decode step calls the paged-decode kernel instead (ops/paged_attention.py).
``spec_verify`` always takes the gather path, as in the JAX package.

Two differences from the JAX programs, both deliberate:

- **The pools are updated in place.** The JAX programs donate the pools and
  return new ones (one buffer aliased through every program); here each
  program writes into the ``k_pool``/``v_pool`` tensors it is given and
  returns only what is not a pool.
- **Indices are kept in range explicitly.** JAX clamps an out-of-range
  gather index without a word; torch raises. Every index the JAX programs
  clamp (``wpe_cap``, ``tp // BS`` against ``MB - 1``, the last valid row of
  a chunk) is clamped here too.

Head-sharded serving (a ``mesh`` whose model axis has ``size`` ranks; JAX
``deepspeed_tpu/serve/paged.py:362-470``): the weights stay replicated, the
pools hold this rank's ``n_head / size`` heads, and each rank computes its
heads' q, k and v from its columns of ``c_attn_w`` (``_qkv_local``), attends
(decode through the paged-decode kernel at the local head count, prefill
through the gather path) and multiplies by its rows of ``c_proj_w``
(``_proj_local``); the float32 partial sums are all-reduced over the group —
the one collective of a layer — and the bias is added once after. The MLP and
the logits are computed whole on every rank. ``spec_verify`` stays
single-rank (the engine refuses speculation with sharding).

On the card the engine runs ``decode_step``, ``prefill_chunk`` and
``spec_verify`` as CUDA graphs (``GraphedProgram``), the port's counterpart of
the JAX package's ``jax.jit``: each is captured once, at fixed addresses, and
replayed every iteration.

The parameters arrive in the layout ``serving_params`` builds: the JAX
package's tree with the weights and biases already in the compute dtype
(JAX casts the same values at every use, so the numbers are the same),
LayerNorm in float32, and ``lm_head``, the compute-dtype ``wte`` widened to
float32 for the float32 logits.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..models.gpt2 import DecodeMath
from ..parallel.mesh import MODEL_AXIS
from .block_allocator import NULL_BLOCK


@torch.no_grad()
def serving_params(model, dtype=None):
    """The programs' parameter tree from a ``GPT2Model``, cast once to
    ``dtype`` (default: the model's compute dtype)."""
    cd = dtype or model.config.compute_dtype

    def ln(m):
        return {"scale": m.scale.detach().float(), "bias": m.bias.detach().float()}

    def cast(t):
        return t.detach().to(cd)

    wte = cast(model.wte)
    return {
        "wte": wte,
        "wpe": cast(model.wpe),
        "lm_head": wte.float(),
        "ln_f": ln(model.ln_f),
        "blocks": [{
            "ln_1": ln(b.ln_1),
            "attn": {k: cast(getattr(b.attn, k)) for k in
                     ("c_attn_w", "c_attn_b", "c_proj_w", "c_proj_b")},
            "ln_2": ln(b.ln_2),
            "mlp": {k: cast(getattr(b.mlp, k)) for k in
                    ("c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b")},
        } for b in model.blocks],
    }


def _host(a, dtype):
    return torch.from_numpy(np.array(a, dtype=dtype))


def stage(a, dtype, device):
    """A host array as a tensor on ``device``: on the card through pinned
    memory (torch's caching host allocator keeps a block until its copy has
    run) and a copy that does not wait; on the CPU the array itself."""
    t = _host(a, dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def graph_captured(fn):
    """Mark ``fn`` as a program a CUDA graph may capture. ``GraphedProgram``
    captures nothing else, so the marked functions are exactly the roots
    the lint's captured-code passes scan (lint/ast_passes.py)."""
    fn.graph_captured = True
    return fn


def build_paged_programs(model, *, num_slots, block_size, max_blocks,
                         prefill_chunk, use_pallas=False, verify_width=0, mesh=None):
    """Program dict for one engine: ``decode_step``, ``prefill_chunk``,
    ``copy_blocks``, the ``beam_init(K, eos)`` / ``beam_select(K, eos)``
    factories, ``copy_width``, ``inputs`` (each graphable program's per-step
    input shapes and numpy dtypes) and, with ``verify_width`` D > 0,
    ``spec_verify``. A ``mesh`` (``parallel.mesh.Mesh``) whose model axis
    is above 1 builds the head-sharded decode and prefill over pools of this
    rank's heads."""
    c = model.config
    nh, hd = c.n_head, c.head_dim
    tp = mesh.shape[MODEL_AXIS] if mesh is not None else 1
    if tp > 1:
        if verify_width:
            raise ValueError("spec_verify is single-rank: no speculation with sharding")
        if nh % tp:
            raise ValueError(f"n_head {nh} not divisible by model-axis size {tp}")
        nh = nh // tp                   # this rank's heads: the pools' and the kernel's
    S, BS, MB, C = int(num_slots), int(block_size), int(max_blocks), int(prefill_chunk)
    D = int(verify_width)
    ML = MB * BS                      # the dense view length the gather rebuilds
    P = S                             # CoW copies per batched copy_blocks call
    V = c.vocab_size
    m = DecodeMath(model)
    qkv_fn, proj_fn = m.qkv, m.proj
    if tp > 1:
        H, h0, width = c.n_head * hd, mesh.axis_index(MODEL_AXIS) * nh * hd, nh * hd
        group = mesh.group(MODEL_AXIS)

        def qkv_fn(x, bp):
            """This rank's heads of the attn projection: the column block
            ``[part * H + h0, + nh_l * hd)`` of ``c_attn_w`` for part in (q,
            k, v), the same product / bias / reshape as ``DecodeMath.qkv``
            (JAX ``_qkv_local``)."""
            B_, Tn, _ = x.shape

            def part(i):
                lo = i * H + h0
                out = (torch.matmul(x, bp["c_attn_w"][:, lo:lo + width].to(x.dtype))
                       + bp["c_attn_b"][lo:lo + width].to(x.dtype))
                return out.reshape(B_, Tn, nh, hd).transpose(1, 2)

            return part(0), part(1), part(2)

        def proj_fn(y, bp, x_dtype):
            """This rank's rows of ``c_proj_w``; the float32 partial sums
            all-reduced over the model group (the layer's one collective),
            the bias added once after (JAX ``_proj_local``)."""
            w = bp["c_proj_w"][h0:h0 + width].to(x_dtype)
            part = torch.matmul(y.float(), w.float())
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
            return part.to(x_dtype) + bp["c_proj_b"].to(x_dtype)

    if use_pallas:
        from ..ops.paged_attention import paged_decode_attention
    else:
        paged_decode_attention = None

    def _gather(pool, li, tables):
        """[S_, heads, ML, hd] dense view of one layer's pages by table."""
        g = pool[li][tables]                       # [S_, MB, BS, heads, hd]
        return g.reshape(tables.shape[0], ML, nh, hd).transpose(1, 2)

    def _null(dev):
        return torch.full((), NULL_BLOCK, device=dev, dtype=torch.long)

    # ---------------------------------------------------------------- decode
    @graph_captured
    @torch.no_grad()
    def decode_step(p, toks, pos, tables, active, k_pool, v_pool):
        """One token for every slot: toks/pos/active are [S] (int32, int32,
        bool) and tables [S, MB] int32. Writes each slot's k/v at ``pos`` into
        the pools in place; inactive lanes compute garbage and write to the
        null page (several lanes may write the same null-page row: harmless,
        no slot ever reads it unmasked). Returns logits [S, V] float32."""
        dev = k_pool.device
        rows = torch.arange(S, device=dev)
        x = p["wte"][toks[:, None].long()] + p["wpe"][pos[:, None].long()]  # [S, 1, H]
        tables_l = tables.long()
        wblk = torch.where(active, tables_l[rows, (pos // BS).long()], _null(dev))
        off = (pos % BS).long()
        lengths = pos + 1

        def attn(xin, bp, li):
            q, k, v = qkv_fn(xin, bp)
            k_pool[li, wblk, off] = k[:, :, 0, :].to(k_pool.dtype)
            v_pool[li, wblk, off] = v[:, :, 0, :].to(v_pool.dtype)
            if paged_decode_attention is not None:
                y = paged_decode_attention(q.contiguous(), k_pool, v_pool, li,
                                           tables, lengths, block_size=BS)
                return proj_fn(y.transpose(1, 2).reshape(S, 1, nh * hd),
                              bp, xin.dtype)
            kg = _gather(k_pool, li, tables_l)
            vg = _gather(v_pool, li, tables_l)
            mask = (torch.arange(ML, device=dev)[None, :]
                    <= pos[:, None])[:, None, None, :]
            return proj_fn(m.attend(q, kg, vg, mask, xin.dtype), bp, xin.dtype)

        x = m.blocks_forward(p, x, attn)
        return m.logits(x[:, -1], p)

    # --------------------------------------------------------------- prefill
    @graph_captured
    @torch.no_grad()
    def prefill_chunk_fn(p, toks, pos, n_valid, table, k_pool, v_pool):
        """One chunk of ONE sequence's prompt: toks [1, C] padded past
        ``n_valid`` (``pos`` and ``n_valid`` int32 scalars, tensors or
        ints; table [MB] int32). Writes positions [pos, pos + n_valid)
        through ``table`` into the pools in place (pads go to the null page;
        their duplicate writes there are harmless for the same reason as in
        decode_step) and returns the logits [1, V] of the last valid row —
        only meaningful on the chunk that completes the prompt. The row is
        picked on the device, its index clamped into the chunk as JAX's
        ``dynamic_slice`` clamps it."""
        dev = k_pool.device
        pos = torch.as_tensor(pos, device=dev).long()
        n_valid = torch.as_tensor(n_valid, device=dev).long()
        wpe_cap = p["wpe"].shape[0] - 1
        ar = torch.arange(C, device=dev)
        tp = pos + ar                                         # [C] positions
        positions = tp.clamp(max=wpe_cap)  # pads only; valid rows untouched
        x = p["wte"][toks.long()] + p["wpe"][positions][None]  # [1, C, H]
        valid = ar < n_valid
        table_l = table.long()
        wblk = torch.where(valid, table_l[(tp // BS).clamp(max=MB - 1)], _null(dev))
        off = tp % BS
        tbl1 = table_l[None]                                  # [1, MB]

        def attn(xin, bp, li):
            q, k, v = qkv_fn(xin, bp)                          # [1, nh, C, hd]
            k_pool[li, wblk, off] = k[0].transpose(0, 1).to(k_pool.dtype)
            v_pool[li, wblk, off] = v[0].transpose(0, 1).to(v_pool.dtype)
            kg = _gather(k_pool, li, tbl1)
            vg = _gather(v_pool, li, tbl1)
            # the same [C, ML] causal frontier the cached forward masks with
            mask = torch.arange(ML, device=dev)[None, :] <= tp[:, None]
            return proj_fn(m.attend(q, kg, vg, mask, xin.dtype), bp, xin.dtype)

        x = m.blocks_forward(p, x, attn)
        last = (n_valid - 1).clamp(0, C - 1).reshape(1)
        return m.logits(x.index_select(1, last)[:, 0], p)

    # ---------------------------------------------------- speculative verify
    @graph_captured
    @torch.no_grad()
    def spec_verify(p, toks, pos0, n_valid, tables, active, k_pool, v_pool):
        """Score a drafted continuation for every slot in one step: ``toks``
        is [S, D] int32 — row 0 each slot's last committed token, rows 1..
        the draft's proposals — at positions ``pos0 + [0, D)``; pos0 and
        n_valid [S] int32, tables [S, MB] int32, active [S] bool. Rows past
        ``n_valid[s]`` (and all rows of inactive slots) write to the null
        page and produce garbage logits the host ignores. Returns logits
        [S, D, V] float32: row i is the target's next-token distribution
        AFTER consuming toks[:, :i+1], what ``decode_step`` would give i
        steps later, so greedy acceptance against these rows is
        token-identical to plain decode. Rejected rows leave garbage KV past
        the accepted frontier; the causal mask (keys <= query position)
        never attends it, and the next round's writes cover the same
        extent — rollback is a host-side table truncation."""
        dev = k_pool.device
        wpe_cap = p["wpe"].shape[0] - 1
        ar = torch.arange(D, device=dev)
        tp = pos0.long()[:, None] + ar[None, :]               # [S, D] positions
        positions = tp.clamp(max=wpe_cap)  # pads only; valid rows untouched
        x = p["wte"][toks.long()] + p["wpe"][positions]        # [S, D, H]
        valid = (ar[None, :] < n_valid[:, None]) & active[:, None]
        tables_l = tables.long()
        wblk = torch.where(valid, tables_l.gather(1, (tp // BS).clamp(max=MB - 1)),
                           _null(dev))
        off = tp % BS

        def attn(xin, bp, li):
            q, k, v = m.qkv(xin, bp)                          # [S, nh, D, hd]
            k_pool[li, wblk, off] = k.transpose(1, 2).to(k_pool.dtype)
            v_pool[li, wblk, off] = v.transpose(1, 2).to(v_pool.dtype)
            kg = _gather(k_pool, li, tables_l)
            vg = _gather(v_pool, li, tables_l)
            # per-row causal frontier: row i attends keys <= pos0 + i — the
            # same mask decode_step applies one position at a time
            mask = (torch.arange(ML, device=dev)[None, None, :]
                    <= tp[:, :, None])[:, None, :, :]
            return m.proj(m.attend(q, kg, vg, mask, xin.dtype), bp, xin.dtype)

        x = m.blocks_forward(p, x, attn)
        return m.logits(x.reshape(S * D, -1), p).reshape(S, D, V)

    # ------------------------------------------------------------ block copy
    @torch.no_grad()
    def copy_blocks(k_pool, v_pool, src, dst):
        """Copy-on-write page copies in place, batched to a fixed width ``P``
        (pads are 0 -> 0 null self-copies). The source pages are gathered
        before the scatter, so overlapping pairs are safe."""
        src, dst = src.long(), dst.long()
        k_pool[:, dst] = k_pool[:, src]
        v_pool[:, dst] = v_pool[:, src]

    # ----------------------------------------------------------- beam heads
    NEG = -1e9

    def _top_k(x, K):
        # jax.lax.top_k breaks ties toward the lower index; torch.topk does not
        # promise an order, and frozen beams produce exact -1e9 ties, so take a
        # stable descending sort and slice it
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :K], idx[..., :K]

    def beam_init(K, eos):
        """(prefill logits [1, V]) -> (scores, tok0, live) [K each] — the
        top-K first-token expansion from the chunk that completed the prompt."""
        @torch.no_grad()
        def f(logits):
            logp0 = torch.log_softmax(logits, dim=-1)
            scores, tok0 = _top_k(logp0, K)                  # [1, K]
            live = (tok0 != eos) if eos >= 0 else torch.ones_like(tok0, dtype=torch.bool)
            return scores[0], tok0[0].to(torch.int32), live[0]
        return f

    def beam_select(K, eos):
        """(logits [S, V], slot_idx [K], scores [K], live [K]) ->
        (scores, parent, tok, live) [K each] — one beam step, the JAX
        package's beam_search step_scores + top-K reorder at B=1."""
        @torch.no_grad()
        def f(logits, slot_idx, scores, live):
            logp = torch.log_softmax(logits[slot_idx.long()].reshape(1, K, V), dim=-1)
            cand = scores[None, :, None] + logp
            if eos >= 0:
                frozen = torch.full((1, K, V), NEG, device=logits.device)
                frozen[:, :, eos] = scores[None]
                cand = torch.where(live[None, :, None], cand, frozen)
            new_scores, idx = _top_k(cand.reshape(1, K * V), K)   # [1, K]
            parent = idx // V
            tok = (idx % V).to(torch.int32)
            new_live = torch.gather(live[None], 1, parent)
            if eos >= 0:
                new_live = new_live & (tok != eos)
            return (new_scores[0], parent[0].to(torch.int32), tok[0],
                    new_live[0])
        return f

    i32, b = np.int32, np.bool_
    out = {
        "decode_step": decode_step,
        "prefill_chunk": prefill_chunk_fn,
        "copy_blocks": copy_blocks,
        "beam_init": beam_init,
        "beam_select": beam_select,
        "copy_width": P,
        "inputs": {
            "decode_step": [((S,), i32), ((S,), i32), ((S, MB), i32), ((S,), b)],
            "prefill_chunk": [((1, C), i32), ((), i32), ((), i32), ((MB,), i32)],
            "spec_verify": [((S, D), i32), ((S,), i32), ((S,), i32), ((S, MB), i32),
                            ((S,), b)],
        },
    }
    if D > 0:
        out["spec_verify"] = spec_verify
    return out


_STREAMS = {}       # device index -> the one stream every program warms up and is captured on


def _capture_stream(dev):
    """One side stream a device for every warm-up and capture: cuBLAS keeps a
    workspace for each stream it has run on until the process ends, so a
    stream per program would hold one more workspace each."""
    if dev.index not in _STREAMS:
        _STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _STREAMS[dev.index]


def _kernel_counters():
    """The launch counters of the kernels a serving program may run."""
    from ..ops.paged_attention import paged_decode_attention
    return [(paged_decode_attention, ("launches", "cluster_launches"))]


class EagerProgram:
    """A serving program run op by op, with ``GraphedProgram``'s signature:
    ``prog(params, *inputs, k_pool, v_pool)`` with the per-step inputs as
    host arrays, staged to the pools' device (``stage``). What the engine
    runs on the CPU, and the eager side of a comparison on the card."""

    def __init__(self, fn, name, inputs, params, k_pool, v_pool):
        self.fn, self.name = fn, name
        self._dtypes = [dtype for _, dtype in inputs]
        self._device = k_pool.device

    def __call__(self, params, *args):
        *inputs, k_pool, v_pool = args
        return self.fn(params, *(stage(a, dt, self._device)
                                 for a, dt in zip(inputs, self._dtypes)),
                       k_pool, v_pool)


class GraphedProgram:
    """One serving program (``decode_step``, ``prefill_chunk`` or
    ``spec_verify``) captured once as a CUDA graph and replayed: the port's
    counterpart of the JAX package's ``jax.jit``, which compiles each
    program once at its fixed shapes.

    ``GraphedProgram(fn, name, inputs, params, k_pool, v_pool, pool)``
    captures at construction. The per-step inputs (``inputs``: their shapes
    and numpy dtypes) become static buffers, zero at capture: all lanes
    inactive (or ``n_valid`` 0), so the warm-up and the capture write the
    null page only and may run on a live pool. The program is first run
    twice on the device's one capture stream (cuBLAS's workspace for it, the
    paged-decode kernel's one-time shared-memory attribute, the pools' TMA
    maps), then captured on it into ``pool``, the engine's one graph memory
    pool. A failed capture raises; nothing falls back to eager.

    ``prog(params, *inputs, k_pool, v_pool)`` takes the inputs as host
    arrays, as ``EagerProgram`` does. ``params`` and the pools must be the
    captured ones (a graph replays the addresses it captured; load a
    snapshot with ``copy_`` into the live pools); each input is copied from
    pinned host memory straight into its static buffer, the graph is
    replayed, and the static output is returned. **That output is
    overwritten by the next replay of any program sharing the pool**:
    consume it first. The kernels' launch counters moved at capture, when no
    kernel ran; they are restored then, and each replay adds the launches
    the capture recorded, so they keep counting kernel executions.
    ``captures`` and ``replays`` count this program's; ``pool_bytes`` is
    what its capture added to the graph pool (``memory_reserved``)."""

    def __init__(self, fn, name, inputs, params, k_pool, v_pool, pool):
        if not getattr(fn, "graph_captured", False):
            raise ValueError(f"{name}: only a function marked @graph_captured is "
                             "captured (the lint scans exactly those)")
        self.name = name
        self._fixed = (params, k_pool, v_pool)
        dev = k_pool.device
        self._dtypes = [dtype for _, dtype in inputs]
        self._static = [_host(np.zeros(shape), dtype).to(dev) for shape, dtype in inputs]
        self.captures = self.replays = 0
        counters = _kernel_counters()
        before = [[getattr(obj, a) for a in attrs] for obj, attrs in counters]
        args = (params, *self._static, k_pool, v_pool)
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = [[getattr(obj, a) for a in attrs] for obj, attrs in counters]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self._out = fn(*args)
        self.captures += 1
        # what the capture added to the shared graph pool (reserved segments)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._delta = []
        for (obj, attrs), b, w in zip(counters, before, warm):
            for a, b_a, w_a in zip(attrs, b, w):
                self._delta.append((obj, a, getattr(obj, a) - w_a))
                setattr(obj, a, b_a)

    def __call__(self, params, *args):
        *inputs, k_pool, v_pool = args
        p0, k0, v0 = self._fixed
        if params is not p0 or k_pool.data_ptr() != k0.data_ptr() \
                or v_pool.data_ptr() != v0.data_ptr():
            raise ValueError(f"{self.name}: the CUDA graph was captured on other "
                             "parameters or pools (copy a snapshot into the live "
                             "pools instead)")
        if len(inputs) != len(self._static):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, captured "
                             f"{len(self._static)}")
        for s, a, dt in zip(self._static, inputs, self._dtypes):
            s.copy_(_host(a, dt).pin_memory(), non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for obj, a, d in self._delta:
            setattr(obj, a, getattr(obj, a) + d)
        return self._out
