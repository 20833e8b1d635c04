"""Transformer (BERT encoder) layer.

Counterpart of ``deepspeed_tpu/ops/transformer/transformer.py`` with the same
config surface (``DeepSpeedTransformerConfig``) and the same parameter names
and ``[in, out]`` layouts, so the JAX package's per-layer parameter dict
carries over one to one:

    attn_qkvw [H, 3H], attn_qkvb, attn_ow [H, H], attn_ob, attn_nw, attn_nb,
    inter_w [H, I], inter_b, output_w [I, H], output_b, norm_w, norm_b

The products, LayerNorm (eps 1e-12, float32, cast back), the exact GELU and
the residuals are PyTorch ops that round where the JAX layer rounds; only
attention has hand-written kernels (``ops/flash_attention.py``: non-causal,
the padding mask as a float32 key bias, train-mode attention dropout inside
the kernel). A full ``[B, ., Tq, Tk]`` mask takes the dense path.

The memory knobs (``normalize_invertible``, ``gelu_checkpoint``,
``attn_dropout_checkpoint``) recompute their segment in the backward
(non-reentrant ``torch.utils.checkpoint``). Dropout draws from an explicit
``torch.Generator``, which a recompute does not rewind: the attention
dropout's seed is drawn before the checkpointed segment and handed in, and
hidden dropout sits outside both segments, so a recompute sees the same
masks. Attention dropout is the flash kernels' coordinate hash of that one
seed on both paths (the dense path takes its keep mask from
``dropout_keep_reference``), so a generator gives the same layer output
whichever path runs.

Layer contract: ``init(generator)`` fills the parameters;
``forward(hidden, attention_mask=None, generator=None, deterministic=True)
-> hidden`` with shapes ``[B, T, H]``.
"""

import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ..flash_attention import dropout_keep_reference, flash_attention


class TransformerConfig:

    def __init__(self, batch_size=-1, max_seq_length=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1):
        self.layer_id = -1
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.max_seq_length = max_seq_length
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range


class DeepSpeedTransformerConfig(TransformerConfig):
    """Config mirror of the JAX package's. The reference's CUDA-only knobs
    are accepted; the memory knobs become recompute segments; ``fp16``
    selects the compute dtype (bf16 by default)."""

    def __init__(self,
                 batch_size=-1,
                 max_seq_length=-1,
                 hidden_size=-1,
                 intermediate_size=-1,
                 heads=-1,
                 attn_dropout_ratio=-1,
                 hidden_dropout_ratio=-1,
                 num_hidden_layers=-1,
                 initializer_range=-1,
                 local_rank=-1,
                 seed=-1,
                 fp16=False,
                 bf16=True,
                 pre_layer_norm=True,
                 normalize_invertible=False,
                 gelu_checkpoint=False,
                 adjust_init_range=True,
                 attn_dropout_checkpoint=False,
                 stochastic_mode=False,
                 use_flash_attention=True):
        super().__init__(batch_size, max_seq_length, hidden_size,
                         (intermediate_size if intermediate_size > 0 else 4 * hidden_size),
                         heads, attn_dropout_ratio, hidden_dropout_ratio,
                         num_hidden_layers, initializer_range)
        self.fp16 = fp16
        self.bf16 = bf16
        self.pre_layer_norm = pre_layer_norm
        self.local_rank = local_rank
        self.seed = seed
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.test_gemm = False
        self.training = True
        self.is_grad_enabled = True
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.use_flash_attention = use_flash_attention

    @property
    def compute_dtype(self):
        if self.fp16:
            return torch.float16
        if self.bf16:
            return torch.bfloat16
        return torch.float32

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            config.__dict__[key] = value
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def layer_norm(x, scale, bias, eps=1e-12):
    """LayerNorm in float32 with the result cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return (((xf - mean) * torch.rsqrt(var + eps)) * scale + bias).to(x.dtype)


def _keep_mask(shape, rate, generator, device):
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def _apply_keep(x, keep, rate):
    """Inverted dropout of x by a boolean keep mask."""
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def _linear(x, w, b):
    # accumulates in float32, rounds once to x's dtype, then adds the bias in
    # x's dtype
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def _f32(leaf):
    return torch.from_numpy(np.array(leaf, np.float32))


class DeepSpeedTransformerLayer(nn.Module):
    """One BERT encoder layer: fused qkv, attention output, attention
    LayerNorm, intermediate, output, output LayerNorm. float32 parameters on
    ``device`` (the card unless the caller asks for ``"cpu"``).

    ``initial_weights`` / ``initial_biases``: the reference's 8-entry lists
    (q, k, v, attention output, attention LayerNorm, intermediate, output,
    output LayerNorm) with weights in ``[out, in]`` layout; ``init`` applies
    them transposed over its random fill."""

    layer_id = 0
    NAMES = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw", "attn_nb",
             "inter_w", "inter_b", "output_w", "output_b", "norm_w", "norm_b")

    def __init__(self, config: DeepSpeedTransformerConfig, initial_weights=None,
                 initial_biases=None, device=None):
        super().__init__()
        self.config = config
        self.config.layer_id = DeepSpeedTransformerLayer.layer_id
        DeepSpeedTransformerLayer.layer_id += 1
        self._initial_weights = initial_weights
        self._initial_biases = initial_biases
        dev = resolve_device(device)
        for name, shape in zip(self.NAMES, self.param_shapes()):
            fill = torch.ones if name in ("attn_nw", "norm_w") else torch.zeros
            setattr(self, name, nn.Parameter(fill(shape, device=dev)))

    # ---------------- parameters ----------------
    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """normal(initializer_range) weights (the output projections at
        ``/ sqrt(2 num_hidden_layers)`` when ``adjust_init_range``), zero
        biases, unit LayerNorm — the JAX package's scheme; its numbers differ
        from ``jax.random``'s. Returns the name -> parameter dict."""
        c = self.config
        std = c.initializer_range if c.initializer_range > 0 else 0.02
        out_std = (std / math.sqrt(2.0 * max(c.num_hidden_layers, 1))
                   if c.adjust_init_range else std)
        for name, s in (("attn_qkvw", std), ("attn_ow", out_std), ("inter_w", std),
                        ("output_w", out_std)):
            getattr(self, name).normal_(0.0, s, generator=generator)
        for name in ("attn_qkvb", "attn_ob", "attn_nb", "inter_b", "output_b", "norm_b"):
            getattr(self, name).zero_()
        for name in ("attn_nw", "norm_w"):
            getattr(self, name).fill_(1.0)
        w, b = self._initial_weights, self._initial_biases
        if w is not None:
            self.attn_qkvw.copy_(torch.cat([_f32(x).t() for x in w[:3]], dim=1))
            self.attn_ow.copy_(_f32(w[3]).t())
            self.attn_nw.copy_(_f32(w[4]))
            self.inter_w.copy_(_f32(w[5]).t())
            self.output_w.copy_(_f32(w[6]).t())
            self.norm_w.copy_(_f32(w[7]))
        if b is not None:
            self.attn_qkvb.copy_(torch.cat([_f32(x) for x in b[:3]]))
            for name, x in zip(("attn_ob", "attn_nb", "inter_b", "output_b", "norm_b"), b[3:]):
                getattr(self, name).copy_(_f32(x))
        return dict(self.named_parameters())

    def param_shapes(self):
        H, I = self.config.hidden_size, self.config.intermediate_size
        return [(H, 3 * H), (3 * H,), (H, H), (H,), (H,), (H,), (H, I), (I,), (I, H), (H,),
                (H,), (H,)]

    # ---------------- forward ----------------
    def _flash_ok(self, attention_mask, B, T):
        """flash takes no mask, a ``[B, T]`` or a ``[B, 1, 1, T]`` additive key
        mask; a full ``[B, ., Tq, Tk]`` mask takes the dense path."""
        if not self.config.use_flash_attention:
            return False
        return attention_mask is None or tuple(attention_mask.shape) in ((B, T), (B, 1, 1, T))

    def _attention(self, x, attention_mask, flash, seed):
        """``seed``: the attention dropout's seed, or None for no dropout."""
        c = self.config
        B, T, H = x.shape
        heads = c.heads
        d = H // heads
        dt = x.dtype
        qkv = _linear(x, self.attn_qkvw, self.attn_qkvb)
        q, k, v = (t.reshape(B, T, heads, d).transpose(1, 2) for t in qkv.split(H, dim=-1))
        if flash:
            bias = None
            if attention_mask is not None:
                bias = attention_mask.float().reshape(B, 1, T)
            ctx = flash_attention(q, k, v, False, bias=bias,
                                  dropout_rate=float(c.attn_dropout_ratio) if seed is not None
                                  else 0.0, dropout_seed=seed)
        else:
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
            if attention_mask is not None:
                scores = scores + attention_mask.float()
            probs = torch.softmax(scores, dim=-1).to(dt)
            if seed is not None:
                keep = dropout_keep_reference(seed, B, heads, T, T, c.attn_dropout_ratio,
                                              device=x.device) > 0
                probs = _apply_keep(probs, keep, c.attn_dropout_ratio)
            ctx = torch.matmul(probs.float(), v.float()).to(dt)
        ctx = ctx.transpose(1, 2).reshape(B, T, H)
        return _linear(ctx, self.attn_ow, self.attn_ob)

    def _ffn(self, x):
        h = F.gelu(_linear(x, self.inter_w, self.inter_b))   # exact (erf) GELU
        return _linear(h, self.output_w, self.output_b)

    def _hidden_dropout(self, x, generator, active):
        rate = self.config.hidden_dropout_ratio
        if not active or rate <= 0:
            return x
        return _apply_keep(x, _keep_mask(x.shape, rate, generator, x.device), rate)

    def forward(self, hidden_states, attention_mask=None, generator=None, deterministic=True):
        c = self.config
        x = hidden_states.to(c.compute_dtype)
        B, T, _ = x.shape
        active = not deterministic and generator is not None
        flash = self._flash_ok(attention_mask, B, T)
        seed = None
        if active and c.attn_dropout_ratio > 0:
            # one seed per layer call; the keep mask hashes (seed, b*H + h, q, k)
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                     device=generator.device))

        def attn_segment(x):
            if c.pre_layer_norm:
                x = layer_norm(x, self.attn_nw, self.attn_nb)
            return self._attention(x, attention_mask, flash, seed)

        def ffn_segment(x):
            if c.pre_layer_norm:
                x = layer_norm(x, self.norm_w, self.norm_b)
            return self._ffn(x)

        def run(segment, recompute, x):
            if recompute and torch.is_grad_enabled():
                return checkpoint(segment, x, use_reentrant=False, preserve_rng_state=False)
            return segment(x)

        attn_out = run(attn_segment, c.attn_dropout_checkpoint or c.normalize_invertible, x)
        x = x + self._hidden_dropout(attn_out, generator, active)
        if not c.pre_layer_norm:
            x = layer_norm(x, self.attn_nw, self.attn_nb)
        ffn_out = run(ffn_segment, c.gelu_checkpoint, x)
        x = x + self._hidden_dropout(ffn_out, generator, active)
        if not c.pre_layer_norm:
            x = layer_norm(x, self.norm_w, self.norm_b)
        return x
