"""Helpers for using sparse attention with transformer models, on tensors.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
pad inputs to the block size, unpad outputs, extend position embeddings.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


class SparseAttentionUtils:

    @staticmethod
    def extend_position_embedding(position_embedding, max_position: int):
        """Tile an existing [P, H] position embedding out to max_position rows."""
        P = position_embedding.shape[0]
        if max_position <= P:
            return position_embedding[:max_position]
        reps = -(-max_position // P)
        return torch.cat([position_embedding] * reps, dim=0)[:max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def pad_to_block_size(block_size: int,
                          input_ids,
                          attention_mask=None,
                          token_type_ids=None,
                          position_ids=None,
                          inputs_embeds=None,
                          pad_token_id: int = 0,
                          model_embeddings=None) -> Tuple:
        """Pad the sequence dim up to a multiple of block_size.

        Returns (pad_len, input_ids, attention_mask, token_type_ids, position_ids,
        inputs_embeds).
        """
        ref = input_ids if input_ids is not None else inputs_embeds
        seq_len = ref.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds)

        def pad2d(x, value=0):
            return None if x is None else F.pad(x, (0, pad_len), value=value)

        input_ids = pad2d(input_ids, pad_token_id)
        attention_mask = pad2d(attention_mask, 0)
        token_type_ids = pad2d(token_type_ids, 0)
        position_ids = pad2d(position_ids, 0)
        if inputs_embeds is not None:
            B, _, E = inputs_embeds.shape
            pad_block = torch.zeros((B, pad_len, E), dtype=inputs_embeds.dtype,
                                    device=inputs_embeds.device)
            if model_embeddings is not None and input_ids is None:
                pad_ids = torch.full((B, pad_len), pad_token_id, dtype=torch.long,
                                     device=inputs_embeds.device)
                pad_block = model_embeddings[pad_ids].to(inputs_embeds.dtype)
            inputs_embeds = torch.cat([inputs_embeds, pad_block], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids, position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Drop padded positions from the model output."""
        if pad_len > 0:
            return sequence_output[:, :-pad_len]
        return sequence_output
