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
cross-entropy. Its layers
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
