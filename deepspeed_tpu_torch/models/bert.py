"""BERT model family over the transformer layer.

Counterpart of ``deepspeed_tpu/models/bert.py``: BERT embeddings + N
``DeepSpeedTransformerLayer`` modules + a head, with the JAX package's
parameter tree as the modules' parameter names, so its parameters carry over
one to one (``params_from_jax``):

    embeddings.{word [V, H], position [P, H], token_type [2, H], ln_scale, ln_bias},
    layers.{i}.{the layer's 12 names}, qa_outputs.{w [H, 2], b}

The heads are subclasses of ``BertModel`` (the JAX ones hold one in
``.bert`` and share its parameter tree), so the names carry no prefix.
``forward(*batch)`` returns the loss, which is what the training engine
calls; dropout needs an explicit ``torch.Generator`` and ``deterministic=False``,
so a run through the engine has none, as in the JAX package.
"""

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.transformer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer
from ..ops.transformer.transformer import layer_norm
from .gpt2 import load_parameters


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pre_layer_norm: bool = False     # classic BERT is post-LN
    compute_dtype: Any = torch.bfloat16
    use_flash_attention: bool = True


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        h = c.hidden_size
        self.word = nn.Parameter(torch.empty(c.vocab_size, h, device=device))
        self.position = nn.Parameter(torch.empty(c.max_position_embeddings, h, device=device))
        self.token_type = nn.Parameter(torch.empty(c.type_vocab_size, h, device=device))
        self.ln_scale = nn.Parameter(torch.ones(h, device=device))
        self.ln_bias = nn.Parameter(torch.zeros(h, device=device))


class BertModel(nn.Module):
    """``init(generator)`` fills the float32 parameters on ``device`` (the card
    unless the caller asks for ``"cpu"``); ``forward(input_ids,
    token_type_ids=None, attention_mask=None, generator=None,
    deterministic=True) -> [B, T, H]``."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.embeddings = _Embeddings(config, dev)
        self.layers = nn.ModuleList(
            DeepSpeedTransformerLayer(self._layer_config(), device=dev)
            for _ in range(config.num_hidden_layers))

    def _layer_config(self):
        c = self.config
        return DeepSpeedTransformerConfig(
            hidden_size=c.hidden_size,
            intermediate_size=c.intermediate_size,
            heads=c.num_attention_heads,
            attn_dropout_ratio=c.attention_probs_dropout_prob,
            hidden_dropout_ratio=c.hidden_dropout_prob,
            num_hidden_layers=c.num_hidden_layers,
            initializer_range=c.initializer_range,
            pre_layer_norm=c.pre_layer_norm,
            bf16=c.compute_dtype == torch.bfloat16,
            fp16=c.compute_dtype == torch.float16,
            use_flash_attention=c.use_flash_attention,
        )

    @property
    def device(self):
        return self.embeddings.word.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """normal(initializer_range) embeddings, unit LayerNorm, and each
        layer's own scheme. The numbers differ from ``jax.random``'s; tests
        that need equal weights carry the JAX ones over with
        ``params_from_jax``."""
        e, std = self.embeddings, self.config.initializer_range
        for t in (e.word, e.position, e.token_type):
            t.normal_(0.0, std, generator=generator)
        e.ln_scale.fill_(1.0)
        e.ln_bias.zero_()
        for layer in self.layers:
            layer.init(generator)
        return dict(self.named_parameters())

    def load_parameters(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a full name -> tensor dict (``params_from_jax``) into the
        parameters (strict: every name once, shapes equal)."""
        load_parameters(self, params)

    def param_count(self, params=None) -> int:
        from ..runtime.utils import param_count
        return param_count(params if params is not None else dict(self.named_parameters()))

    def _embed(self, input_ids, token_type_ids):
        e = self.embeddings
        T = input_ids.shape[1]
        x = e.word[input_ids.long()] + e.position[:T][None]
        if token_type_ids is not None:
            x = x + e.token_type[token_type_ids.long()]
        return layer_norm(x.float(), e.ln_scale, e.ln_bias).to(self.config.compute_dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, generator=None,
                deterministic=True):
        x = self._embed(input_ids, token_type_ids)
        ext_mask = None
        if attention_mask is not None:
            # [B, T] 1/0 mask -> additive [B, 1, 1, T]
            ext_mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.layers:
            x = layer(x, attention_mask=ext_mask, generator=generator,
                      deterministic=deterministic)
        return x


class BertForMaskedLM(BertModel):
    """BERT + tied-embedding MLM head; ``forward`` returns the masked-LM loss."""

    def logits(self, input_ids, token_type_ids=None, attention_mask=None, generator=None,
               deterministic=True):
        """float32 logits ``[B, T, vocab]`` from compute-dtype operands: a
        product of two bf16 numbers is exact in float32, so this is the JAX
        bf16-in / f32-accumulate einsum up to summation order (TF32 must stay
        off)."""
        x = super().forward(input_ids, token_type_ids, attention_mask, generator, deterministic)
        return torch.matmul(x.float(), self.embeddings.word.to(x.dtype).float().t())

    def forward(self, input_ids, labels, token_type_ids=None, attention_mask=None,
                generator=None, deterministic=True):
        """labels: [B, T] with -100 for unmasked positions (ignored)."""
        logits = self.logits(input_ids, token_type_ids, attention_mask, generator,
                             deterministic)
        logp = F.log_softmax(logits, dim=-1)
        labels = labels.long()
        ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


class _QAOutputs(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(h, 2, device=device))
        self.b = nn.Parameter(torch.zeros(2, device=device))


class BertForQuestionAnswering(BertModel):
    """BERT + span-extraction head (the SQuAD fine-tuning workload);
    ``forward`` returns the mean of the start- and end-position
    cross-entropies."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__(config, device)
        self.qa_outputs = _QAOutputs(config.hidden_size, self.device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        super().init(generator)
        self.qa_outputs.w.normal_(0.0, self.config.initializer_range, generator=generator)
        self.qa_outputs.b.zero_()
        return dict(self.named_parameters())

    def logits(self, input_ids, token_type_ids=None, attention_mask=None, generator=None,
               deterministic=True):
        """-> (start_logits, end_logits), each [B, T] float32."""
        x = super().forward(input_ids, token_type_ids, attention_mask, generator, deterministic)
        qa = self.qa_outputs
        out = torch.matmul(x.float(), qa.w.to(x.dtype).float()) + qa.b.float()
        return out[..., 0], out[..., 1]

    def forward(self, input_ids, start_positions, end_positions, token_type_ids=None,
                attention_mask=None, generator=None, deterministic=True):
        start_logits, end_logits = self.logits(input_ids, token_type_ids, attention_mask,
                                               generator, deterministic)

        def ce(logits, pos):
            logp = F.log_softmax(logits, dim=-1)
            return -logp.gather(-1, pos.long()[:, None])[:, 0].mean()

        return (ce(start_logits, start_positions) + ce(end_logits, end_positions)) / 2.0


def params_from_jax(tree, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's BERT parameter pytree (leaves as numpy arrays or
    anything ``np.asarray`` takes; with or without ``qa_outputs``) -> a name
    -> float32 tensor dict in these modules' naming, on ``device`` (the card
    unless ``"cpu"``)."""
    dev = resolve_device(device)
    out = {}

    def put(name, leaf):
        out[name] = torch.from_numpy(np.array(leaf, np.float32)).to(dev)

    for k, leaf in tree["embeddings"].items():
        put(f"embeddings.{k}", leaf)
    for i, lp in enumerate(tree["layers"]):
        for k, leaf in lp.items():
            put(f"layers.{i}.{k}", leaf)
    for k, leaf in tree.get("qa_outputs", {}).items():
        put(f"qa_outputs.{k}", leaf)
    return out
