"""GPT-2 family model for the PyTorch port.

Counterpart of ``deepspeed_tpu/models/gpt2.py`` with the same parameter tree,
names and layouts, so the JAX package's parameters carry over one to one
(``params_from_jax``):

    wte [V, E], wpe [P, E], ln_f.{scale, bias},
    blocks.{i}.ln_1.{scale, bias},
    blocks.{i}.attn.{c_attn_w [E, 3E], c_attn_b, c_proj_w [E, E], c_proj_b},
    blocks.{i}.ln_2.{scale, bias},
    blocks.{i}.mlp.{c_fc_w [E, 4E], c_fc_b, c_proj_w [4E, E], c_proj_b}

Weights stay ``[in, out]`` (``x @ w``), as in the JAX package. The module
carries the serving path (serve/paged.py calls ``_layer_norm`` and ``_mlp``)
and the training forward: ``forward(tokens, labels=None, generator=None)``
is the JAX ``apply`` over the module's own parameters, with dense or flash
attention (ops/flash_attention.py), block-sparse attention over a
``SparsityConfig`` layout (ops/block_sparse_attention.py; it takes precedence
over flash, as in the JAX model), the fused attention half of a block
(``fused_block``, ops/fused_block.py; it takes precedence over flash, and
the serving programs ignore it, as the JAX ones do) and the chunked
cross-entropy; ``generate`` and ``beam_search`` decode over per-layer KV
caches as the JAX model's do. Its layers
take the JAX package's per-layer parameter dicts (``params_tree``) and round
where the JAX model rounds. ``remat`` recomputes each block in the backward
under ``remat_policy`` (``runtime/activation_checkpointing/checkpointing.py``;
the serving programs ignore both, as the JAX serving path does); the
attention tags its products and output for the policies where the JAX model
does. Dropout draws from an explicit ``torch.Generator``: the block seeds
are drawn before the blocks and each block draws from generators of its
seeds, so a recompute draws the same masks (JAX splits a key per block
outside the checkpoint in the same way). It cannot match ``jax.random`` bit
for bit, except the flash kernels' attention dropout, which hashes
coordinates. MoE comes with a later slice and raises
``NotImplementedError`` when asked for.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.block_sparse_attention import block_sparse_attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_block import fused_transformer_block
from ..runtime.activation_checkpointing.checkpointing import checkpoint_name, checkpoint_wrapper


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_flash_attention: bool = False
    fused_block: bool = False
    remat: bool = False
    remat_policy: Any = None
    loss_chunk: int = 128
    compute_dtype: Any = torch.bfloat16
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    sparse_attention: Any = None

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


# options of the JAX model that later slices of the port bring, by the
# ROADMAP.md queue item that ports them
_LATER = {
    "moe_experts": "queue A19 (MoE)",
}


class _LayerNorm(nn.Module):
    def __init__(self, n, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))


class _Attention(nn.Module):
    def __init__(self, e, device):
        super().__init__()
        self.c_attn_w = nn.Parameter(torch.empty(e, 3 * e, device=device))
        self.c_attn_b = nn.Parameter(torch.zeros(3 * e, device=device))
        self.c_proj_w = nn.Parameter(torch.empty(e, e, device=device))
        self.c_proj_b = nn.Parameter(torch.zeros(e, device=device))


class _MLP(nn.Module):
    def __init__(self, e, device):
        super().__init__()
        self.c_fc_w = nn.Parameter(torch.empty(e, 4 * e, device=device))
        self.c_fc_b = nn.Parameter(torch.zeros(4 * e, device=device))
        self.c_proj_w = nn.Parameter(torch.empty(4 * e, e, device=device))
        self.c_proj_b = nn.Parameter(torch.zeros(e, device=device))


class _Block(nn.Module):
    def __init__(self, e, device):
        super().__init__()
        self.ln_1 = _LayerNorm(e, device)
        self.attn = _Attention(e, device)
        self.ln_2 = _LayerNorm(e, device)
        self.mlp = _MLP(e, device)


def nucleus_keep(logits, top_p):
    """The top-p keep mask of ``generate``'s sampler, the JAX model's rule
    (deepspeed_tpu/models/gpt2.py:804-815): tokens ordered by a stable
    ascending argsort, reversed, so of tied logits the higher index comes
    first; a token stays while the probability mass ahead of it is under
    ``top_p`` (the first always stays), and the mask goes back by sort
    position, so ties at the cutoff do not widen the nucleus."""
    order = torch.flip(torch.argsort(logits, dim=-1, stable=True), dims=(-1,))
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    kept_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
    return torch.zeros_like(kept_sorted).scatter(-1, order, kept_sorted)


class GPT2Model(nn.Module):
    """GPT-2 with float32 parameters on ``device`` (the card unless the caller
    asks for ``"cpu"``). ``init(generator)`` fills them with the JAX package's
    scheme; ``load_parameters`` takes a name -> tensor dict such as
    ``params_from_jax`` returns."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        if config.sparse_attention is not None:
            if config.dropout != 0.0:
                raise ValueError("sparse_attention has no in-kernel dropout; set dropout=0")
        if config.fused_block:
            if config.dropout != 0.0:
                raise ValueError("fused_block has no in-kernel dropout; set dropout=0")
            if config.sparse_attention is not None:
                raise ValueError("fused_block and sparse_attention are mutually exclusive")
        for field, where in _LATER.items():
            if getattr(config, field):
                raise NotImplementedError(
                    f"GPT2Config.{field} is not in the PyTorch port yet: "
                    f"ROADMAP.md {where}")
        self.config = config
        self._sparse_layouts = {}  # seq_len -> block layout (host numpy), built once
        dev = resolve_device(device)
        c = config
        self.wte = nn.Parameter(torch.empty(c.vocab_size, c.n_embd, device=dev))
        self.wpe = nn.Parameter(torch.empty(c.n_positions, c.n_embd, device=dev))
        self.ln_f = _LayerNorm(c.n_embd, dev)
        self.blocks = nn.ModuleList(_Block(c.n_embd, dev) for _ in range(c.n_layer))

    @property
    def device(self):
        return self.wte.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """normal(initializer_range) for the embeddings and input projections,
        ``initializer_range / sqrt(2 n_layer)`` for the output projections
        (GPT-2 paper), ones/zeros for LayerNorm, zeros for biases — the JAX
        package's scheme. The numbers differ from ``jax.random``'s; tests that
        need equal weights carry the JAX ones over with ``params_from_jax``."""
        c = self.config
        std = c.initializer_range
        proj_std = std / math.sqrt(2 * c.n_layer)
        self.wte.normal_(0.0, std, generator=generator)
        self.wpe.normal_(0.0, std, generator=generator)
        for blk in self.blocks:
            blk.attn.c_attn_w.normal_(0.0, std, generator=generator)
            blk.attn.c_proj_w.normal_(0.0, proj_std, generator=generator)
            blk.mlp.c_fc_w.normal_(0.0, std, generator=generator)
            blk.mlp.c_proj_w.normal_(0.0, proj_std, generator=generator)
            for ln in (blk.ln_1, blk.ln_2):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
            for b in (blk.attn.c_attn_b, blk.attn.c_proj_b,
                      blk.mlp.c_fc_b, blk.mlp.c_proj_b):
                b.zero_()
        self.ln_f.scale.fill_(1.0)
        self.ln_f.bias.zero_()
        return dict(self.named_parameters())

    def load_parameters(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a full name -> tensor dict into the parameters (strict: every
        name once, shapes equal)."""
        load_parameters(self, params)

    # ------------------------------------------------------------- layers
    # Both take the JAX package's per-layer parameter dicts and round at the
    # same points: LayerNorm in float32 with the result cast back; each dot
    # accumulates in float32 and is rounded once to x's dtype before the bias
    # (cast to x's dtype) is added.
    def _layer_norm(self, x, p, eps):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mean) * torch.rsqrt(var + eps)
        return (out * p["scale"] + p["bias"]).to(x.dtype)

    def _mlp(self, x, p):
        h = torch.matmul(x, p["c_fc_w"].to(x.dtype)) + p["c_fc_b"].to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        # announce the block's last product to the remat policies: only the
        # residual sum leaving the block reads it, so none keeps it (JAX
        # saves no such residual)
        h = checkpoint_name(h, "ds_dot:mlp_proj")
        return torch.matmul(h, p["c_proj_w"].to(x.dtype)) + p["c_proj_b"].to(x.dtype)

    # ------------------------------------------------------------- training
    def params_tree(self) -> Dict[str, Any]:
        """The JAX package's nested parameter dict over this module's own
        parameters (the same tensors, so autograd reaches them)."""
        def ln(m):
            return {"scale": m.scale, "bias": m.bias}

        return {
            "wte": self.wte, "wpe": self.wpe, "ln_f": ln(self.ln_f),
            "blocks": [{
                "ln_1": ln(b.ln_1),
                "attn": {k: getattr(b.attn, k) for k in
                         ("c_attn_w", "c_attn_b", "c_proj_w", "c_proj_b")},
                "ln_2": ln(b.ln_2),
                "mlp": {k: getattr(b.mlp, k) for k in
                        ("c_fc_w", "c_fc_b", "c_proj_w", "c_proj_b")},
            } for b in self.blocks],
        }

    def param_count(self, params=None) -> int:
        """Element count of ``params`` (a name -> tensor dict or tree), or of
        the module's own parameters."""
        from ..runtime.utils import param_count
        return param_count(params if params is not None else dict(self.named_parameters()))

    def _dropout(self, x, rng):
        """Inverted dropout at ``config.dropout``, the mask drawn from ``rng``:
        a ``torch.Generator`` on x's device, or an int seed of a fresh one."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=x.device).manual_seed(rng)
        keep = 1.0 - self.config.dropout
        mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def _attention(self, x, p, seed=None):
        """``seed``: the attention dropout's (an int), None without dropout."""
        c = self.config
        B, T, E = x.shape
        nh, hd = c.n_head, c.head_dim
        # announce the fused-qkv product to the remat policies (gpt2.py:320-326)
        x = checkpoint_name(x, "ds_dot:qkv")
        qkv = torch.matmul(x, p["c_attn_w"].to(x.dtype)) + p["c_attn_b"].to(x.dtype)
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2) for t in qkv.split(E, dim=-1))
        if c.sparse_attention is not None:
            y = block_sparse_attention(q, k, v, self.sparse_layout(T),
                                       c.sparse_attention.block, causal=True)
        elif c.use_flash_attention:
            # the kernels hash (seed, b*H + h, q, k); the flash op's own
            # outputs are the policies' attn_out / attn_lse
            y = flash_attention(q, k, v, True, dropout_rate=c.dropout if seed is not None else 0.0,
                                dropout_seed=seed)
        else:
            # scores, mask and softmax in float32, probabilities rounded to the
            # compute dtype before the value product (gpt2.py:372-386)
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
            mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            s = torch.where(mask, s, torch.full((), -1e9, device=x.device))
            probs = torch.softmax(s, dim=-1).to(x.dtype)
            if seed is not None:
                probs = self._dropout(probs, seed)
            y = torch.matmul(probs.float(), v.float()).to(x.dtype)
        if c.sparse_attention is not None or not c.use_flash_attention:
            # the "attn" policies keep this output (gpt2.py:387-389)
            y = checkpoint_name(y, "attn_out")
        y = y.transpose(1, 2).reshape(B, T, E)
        # announce the square output projection (gpt2.py:390-392)
        y = checkpoint_name(y, "ds_dot:proj")
        return torch.matmul(y, p["c_proj_w"].to(x.dtype)) + p["c_proj_b"].to(x.dtype)

    def sparse_layout(self, T):
        """The ``sparse_attention`` layout at sequence length T, built once
        per T; its head count must be the model's."""
        if T not in self._sparse_layouts:
            layout = self.config.sparse_attention.make_layout(T)
            if layout.shape[0] != self.config.n_head:
                raise ValueError(
                    f"sparse_attention config built for {layout.shape[0]} heads; model "
                    f"runs {self.config.n_head} — construct it with "
                    f"num_heads={self.config.n_head}")
            self._sparse_layouts[T] = layout
        return self._sparse_layouts[T]

    def _embed(self, p, tokens, generator=None):
        c = self.config
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = (p["wte"][tokens.long()].to(c.compute_dtype)
             + p["wpe"][pos].to(c.compute_dtype))
        if generator is not None and c.dropout > 0:
            x = self._dropout(x, generator)
        return x

    def _block(self, x, bp, seeds=None):
        """One block; ``seeds``: the (attention, residual 1, residual 2)
        dropout seeds, ints drawn before the block, None without dropout."""
        c = self.config
        eps = c.layer_norm_epsilon
        if c.fused_block and seeds is None:
            # the whole attention half (LayerNorm + qkv + attention + proj +
            # residual) in the fused-block kernels
            ap = bp["attn"]
            x = fused_transformer_block(
                x, bp["ln_1"]["scale"], bp["ln_1"]["bias"], ap["c_attn_w"], ap["c_attn_b"],
                ap["c_proj_w"], ap["c_proj_b"], c.n_head, causal=True, eps=eps)
        else:
            a = self._attention(self._layer_norm(x, bp["ln_1"], eps), bp["attn"],
                                None if seeds is None else seeds[0])
            if seeds is not None:
                a = self._dropout(a, seeds[1])
            x = x + a
        m = self._mlp(self._layer_norm(x, bp["ln_2"], eps), bp["mlp"])
        if seeds is not None:
            m = self._dropout(m, seeds[2])
        return x + m

    def _backbone(self, p, tokens, generator=None):
        """Embeddings -> blocks -> final LayerNorm: ``[B, T, E]`` hidden states.
        With ``remat`` each block runs under ``checkpoint_wrapper`` with
        ``remat_policy`` (gpt2.py:467-478)."""
        c = self.config
        dropout = generator is not None and c.dropout > 0
        x = self._embed(p, tokens, generator if dropout else None)
        seeds = [None] * len(p["blocks"])
        if dropout:
            # every block's three seeds in one draw (one wait for the card)
            seeds = torch.randint(0, 2**31 - 1, (len(p["blocks"]), 3), generator=generator,
                                  device=generator.device).tolist()
        block = checkpoint_wrapper(self._block, policy=c.remat_policy) if c.remat else self._block
        for bp, s in zip(p["blocks"], seeds):
            x = block(x, bp, s)
        return self._layer_norm(x, p["ln_f"], c.layer_norm_epsilon)

    @staticmethod
    def _head(x, wte):
        # the tied LM head in float32 from compute-dtype operands: a product of
        # two bf16 numbers is exact in float32, so this is JAX's bf16-in /
        # f32-accumulate dot up to summation order (TF32 must stay off)
        return torch.matmul(x.float(), wte.to(x.dtype).float().t())

    def logits(self, p, tokens, generator=None):
        """float32 logits ``[B, T, vocab]``."""
        return self._head(self._backbone(p, tokens, generator), p["wte"])

    def _chunked_ce(self, x, wte, labels, chunk):
        """Cross-entropy over sequence chunks; each chunk's float32 logits are
        recomputed in the backward (non-reentrant checkpoint), so the
        ``[B, T, vocab]`` logits never exist at once."""
        w = wte.to(x.dtype).float()
        total = n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, x.shape[1], chunk):
            t, n = checkpoint(_ce_sums, x[:, s:s + chunk], w, labels[:, s:s + chunk],
                              use_reentrant=False, preserve_rng_state=False)
            total, n_valid = total + t, n_valid + n
        return total / n_valid.clamp(min=1.0)

    def apply_parts(self, p, tokens, labels, generator=None):
        """``(ce_mean, aux)``: the mean cross-entropy over labels >= 0 (the
        -100 convention ignores the rest) and the MoE auxiliary term (zero:
        MoE is not ported)."""
        x = self._backbone(p, tokens, generator)
        labels = labels.long()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        T = x.shape[1]
        if self.config.loss_chunk:
            # largest divisor of T not above loss_chunk (gpt2.py:532)
            chunk = next(cc for cc in range(min(self.config.loss_chunk, T), 0, -1)
                         if T % cc == 0)
            if chunk < T:
                return self._chunked_ce(x, p["wte"], labels, chunk), aux
        total, n_valid = _ce_sums(x, p["wte"].to(x.dtype).float(), labels)
        return total / n_valid.clamp(min=1.0), aux

    def forward(self, tokens, labels=None, generator=None):
        """With labels: the mean token cross-entropy (the training loss).
        Without: float32 logits. ``generator`` (on the module's device)
        turns dropout on when ``config.dropout > 0``."""
        p = self.params_tree()
        if labels is None:
            return self.logits(p, tokens, generator)
        ce, aux = self.apply_parts(p, tokens, labels, generator)
        return ce + aux

    # ------------------------------------------------------------- decoding
    def _cached_forward(self, p, toks, pos, kcs, vcs):
        """Incremental forward over per-layer KV caches, shared by
        ``generate`` and ``beam_search``: ``toks [B, Tn]`` at positions
        ``pos ..`` (``pos`` counts the tokens already cached) against caches
        ``[n_layer, B, n_head, max_len, head_dim]`` in the compute dtype,
        written in place; returns the last position's float32 logits
        ``[B, vocab]``. The JAX package's ``_build_cached_forward``: dense
        causal attention (a sparse model decodes densely, as there) through
        ``DecodeMath``, the serving programs' math."""
        m = DecodeMath(self)
        cd = self.config.compute_dtype
        Tn = toks.shape[1]
        dev = toks.device
        tp = pos + torch.arange(Tn, device=dev)
        x = p["wte"][toks.long()].to(cd) + p["wpe"][tp].to(cd)
        allowed = torch.arange(kcs.shape[3], device=dev)[None, :] <= tp[:, None]

        def attn(h, ap, li):
            q, k, v = m.qkv(h, ap)
            kcs[li, :, :, pos:pos + Tn] = k.to(kcs.dtype)
            vcs[li, :, :, pos:pos + Tn] = v.to(vcs.dtype)
            return m.proj(m.attend(q, kcs[li], vcs[li], allowed, h.dtype), ap, h.dtype)

        x = m.blocks_forward(p, x, attn)
        return self._head(x[:, -1], p["wte"])

    def _decode_caches(self, B, max_len, dev):
        c = self.config
        shape = (c.n_layer, B, c.n_head, max_len, c.head_dim)
        return (torch.zeros(shape, dtype=c.compute_dtype, device=dev),
                torch.zeros(shape, dtype=c.compute_dtype, device=dev))

    def _decode_checks(self, T0, max_new_tokens):
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1 (got {max_new_tokens})")
        if T0 + max_new_tokens > self.config.n_positions:
            raise ValueError(f"prompt {T0} + {max_new_tokens} new tokens exceeds "
                             f"n_positions {self.config.n_positions}")

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int, temperature: float = 0.0,
                 generator=None, *, top_k: int = 0, top_p: float = 1.0):
        """Autoregressive decode with per-layer KV caches: one forward over the
        prompt, then single-token steps that append to static-length caches.
        ``temperature == 0`` is greedy (the first maximum); otherwise
        categorical sampling drawn from ``generator`` (a ``torch.Generator``
        on the module's device, required), optionally truncated to the
        ``top_k`` highest-probability tokens and/or the nucleus of
        smallest-count tokens whose cumulative probability reaches ``top_p``
        (both filters compose; at least the argmax token always survives).
        Returns ``[B, T0 + max_new_tokens]`` int64. The JAX package's
        ``generate`` over the module's own parameters; raises ValueError
        where it asserts. A sampled run cannot match ``jax.random`` bit for
        bit."""
        c = self.config
        B, T0 = tokens.shape
        self._decode_checks(T0, max_new_tokens)
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 requires a torch.Generator")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (got {top_k})")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {top_p})")

        def sample(logits):
            if temperature == 0:
                return torch.argmax(logits, dim=-1)
            # float32, as JAX's logits / jnp.float32(temperature) promotes
            logits = logits.float() / temperature
            if 0 < top_k < c.vocab_size:
                kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
                logits = torch.where(logits < kth, torch.full((), -math.inf,
                                                              device=logits.device), logits)
            if top_p < 1.0:
                logits = torch.where(nucleus_keep(logits, top_p), logits,
                                     torch.full((), -math.inf, device=logits.device))
            return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=generator)[:, 0]

        p = self.params_tree()
        kcs, vcs = self._decode_caches(B, T0 + max_new_tokens, tokens.device)
        logits = self._cached_forward(p, tokens, 0, kcs, vcs)
        out = [tokens.long()]
        tok = sample(logits)
        for i in range(1, max_new_tokens):
            out.append(tok[:, None])
            tok = sample(self._cached_forward(p, tok[:, None], T0 + i - 1, kcs, vcs))
        out.append(tok[:, None])
        return torch.cat(out, dim=1)

    @torch.no_grad()
    def beam_search(self, tokens, max_new_tokens: int, num_beams: int = 4, *,
                    eos_token_id=None, length_penalty: float = 1.0):
        """KV-cached beam search: prefill once, expand to ``num_beams`` beams
        per batch row, then single-token steps that keep the K
        highest-scoring hypotheses (summed token log-probs; ties go to the
        lower index, as ``jax.lax.top_k``). With ``eos_token_id`` a finished
        beam is frozen (only the EOS continuation at zero cost survives) and
        padded with EOS; scores are length-normalized by
        ``len**length_penalty`` (GNMT convention) for the final ranking.
        Returns ``(sequences [B, T0 + max_new_tokens], scores [B])`` — the
        best beam per row. The JAX package's ``beam_search``; raises
        ValueError where it asserts."""
        c = self.config
        B, T0 = tokens.shape
        K, L, V = int(num_beams), int(max_new_tokens), c.vocab_size
        self._decode_checks(T0, L)
        if not 1 <= K <= V:
            raise ValueError(f"num_beams {K} must be in [1, vocab_size {V}]")
        if eos_token_id is not None and not 0 <= eos_token_id < V:
            raise ValueError(f"eos_token_id {eos_token_id} outside vocab [0, {V})")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        dev = tokens.device

        def top_k(x):
            vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return vals[..., :K], idx[..., :K]

        p = self.params_tree()
        kcs, vcs = self._decode_caches(B, T0 + L, dev)
        first = self._cached_forward(p, tokens, 0, kcs, vcs)
        kcs, vcs = kcs.repeat_interleave(K, dim=1), vcs.repeat_interleave(K, dim=1)
        scores, tok0 = top_k(torch.log_softmax(first, dim=-1))          # [B, K]
        live = tok0 != eos if eos >= 0 else torch.ones_like(tok0, dtype=torch.bool)
        seqs = torch.full((B, K, L), eos if eos >= 0 else 0, dtype=torch.long, device=dev)
        seqs[:, :, 0] = tok0
        for t in range(L - 1):
            logits = self._cached_forward(p, seqs[:, :, t].reshape(B * K, 1), T0 + t,
                                          kcs, vcs)
            cand = scores[:, :, None] + torch.log_softmax(logits.reshape(B, K, V), dim=-1)
            if eos >= 0:
                # a finished beam admits only the EOS continuation, at no cost
                frozen = torch.full((B, K, V), -1e9, device=dev)
                frozen[:, :, eos] = scores
                cand = torch.where(live[:, :, None], cand, frozen)
            scores, idx = top_k(cand.reshape(B, K * V))
            parent, tok = idx // V, idx % V
            seqs = torch.gather(seqs, 1, parent[:, :, None].expand(B, K, L)).clone()
            seqs[:, :, t + 1] = tok
            flatp = (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1)
            kcs, vcs = kcs[:, flatp], vcs[:, flatp]
            live = torch.gather(live, 1, parent)
            if eos >= 0:
                live = live & (tok != eos)
        # GNMT length normalization: finished beams count tokens up to and
        # including EOS; an unfinished beam counts exactly L
        if eos >= 0:
            lengths = torch.clamp(torch.cumprod((seqs != eos).float(), dim=2).sum(2) + 1.0,
                                  max=float(L))
        else:
            lengths = torch.full((B, K), float(L), device=dev)
        final = scores / lengths ** float(length_penalty)
        best = torch.argmax(final, dim=1)
        rows = torch.arange(B, device=dev)
        return torch.cat([tokens.long(), seqs[rows, best]], dim=1), final[rows, best]


class DecodeMath:
    """The per-layer math of decoding over a KV cache, in one place for
    ``GPT2Model.generate`` / ``beam_search``, the paged serving programs
    (serve/paged.py) and the dense oracle (serve/oracle.py): qkv, attention
    with scores and softmax in float32 and the probabilities rounded to the
    compute dtype before the value product (the JAX package's
    ``attn_cached``), the projection, and the LayerNorm / MLP block loop.
    ``attend`` takes the history as ``[B, heads, T, hd]`` views; the paged
    gather and the oracle give it views of a token-major ``[B, T, heads,
    hd]`` tensor, so that both issue the same ops on operands of the same
    layout."""

    def __init__(self, model):
        c = model.config
        self.model = model
        self.nh, self.hd = c.n_head, c.head_dim
        self.eps = c.layer_norm_epsilon

    def qkv(self, x, bp):
        B_, Tn, _ = x.shape
        nh, hd = self.nh, self.hd
        qkv = torch.matmul(x, bp["c_attn_w"].to(x.dtype)) + bp["c_attn_b"].to(x.dtype)
        q, k, v = qkv.split(nh * hd, dim=-1)
        q = q.reshape(B_, Tn, nh, hd).transpose(1, 2)
        k = k.reshape(B_, Tn, nh, hd).transpose(1, 2)
        v = v.reshape(B_, Tn, nh, hd).transpose(1, 2)
        return q, k, v

    @staticmethod
    def proj(y, bp, x_dtype):
        return (torch.matmul(y, bp["c_proj_w"].to(x_dtype))
                + bp["c_proj_b"].to(x_dtype))

    def attend(self, q, kg, vg, mask, x_dtype):
        s = torch.matmul(q.float(), kg.float().transpose(-1, -2)) / math.sqrt(self.hd)
        s = torch.where(mask, s, torch.full((), -1e9, device=s.device))
        p = torch.softmax(s, dim=-1).to(x_dtype)
        y = torch.matmul(p, vg)
        B_, heads, Tn, _ = y.shape
        return y.transpose(1, 2).reshape(B_, Tn, heads * self.hd)

    def blocks_forward(self, p, x, attn_fn):
        m = self.model
        for li, bp in enumerate(p["blocks"]):
            a = attn_fn(m._layer_norm(x, bp["ln_1"], self.eps), bp["attn"], li)
            x = x + a
            h = m._layer_norm(x, bp["ln_2"], self.eps)
            x = x + m._mlp(h, bp["mlp"])
        return m._layer_norm(x, p["ln_f"], self.eps)

    @staticmethod
    def logits(row, p):
        # row [B_, H] against serving_params' lm_head (the compute-dtype wte
        # widened to float32), accumulated in float32
        return torch.matmul(row.float(), p["lm_head"].t())


@torch.no_grad()
def load_parameters(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy a full name -> tensor dict into ``module``'s parameters (strict:
    every name once, shapes equal)."""
    own = dict(module.named_parameters())
    if set(params) != set(own):
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        raise ValueError(f"parameter names differ: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    for name, t in params.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(own[name].shape)}")
        own[name].copy_(t)


def _ce_sums(x, w, labels):
    """(sum of token cross-entropies over labels >= 0, their count) of
    hidden states ``x`` against the float32 head ``w`` [vocab, E]."""
    logits = torch.matmul(x.float(), w.t())
    lse = torch.logsumexp(logits, dim=-1)
    valid = (labels >= 0).float()
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - gold) * valid).sum(), valid.sum()


def params_from_jax(tree, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's GPT-2 parameter pytree (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> a name -> float32 tensor dict in
    ``GPT2Model``'s naming, on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = {}

    def put(name, leaf):
        out[name] = torch.from_numpy(np.array(leaf, np.float32)).to(dev)

    put("wte", tree["wte"])
    put("wpe", tree["wpe"])
    for k in ("scale", "bias"):
        put(f"ln_f.{k}", tree["ln_f"][k])
    for i, bp in enumerate(tree["blocks"]):
        if "mlp" not in bp:
            raise NotImplementedError(
                f"block {i} has no dense MLP (MoE): ROADMAP.md {_LATER['moe_experts']}")
        for sub in ("ln_1", "ln_2", "attn", "mlp"):
            for k, leaf in bp[sub].items():
                put(f"blocks.{i}.{sub}.{k}", leaf)
    return out
