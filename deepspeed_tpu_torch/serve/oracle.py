"""Dense-cache mirror of the paged serving programs — the bit-exactness
oracle (PyTorch port of ``deepspeed_tpu/serve/oracle.py``).

The paged programs (serve/paged.py) claim to be the dense cached-forward math
with only the *memory layout* changed. This module is the referee: the same
slot-shaped programs over plain contiguous per-slot caches, with no block
tables, no pools, no paging. The engine's ``mirror=True`` runs it in
lockstep and asserts the logits are **bitwise identical** every prefill
chunk and every decode step; any divergence means the paging machinery
(allocator, tables, scatter/gather, copy-on-write) changed the numbers.

The programs issue their ops at the SAME shapes as the engine's ([num_slots,
1, H] decode rows, [1, chunk, H] prefill rows) through the same code
(``models.gpt2.DecodeMath``). One layout differs from the JAX oracle on purpose:
the caches are token-major, ``[n_layer, num_slots + 1, max_len, n_head,
head_dim]`` (the pool pages' layout; the +1 row is the null slot padded lanes
write to, the dense analog of the null page), so the attention operands have
the paged gather's strides and the same library kernels run on them. XLA
canonicalises layouts before it picks a kernel; cuBLAS and the CPU BLAS do
not.

The oracle holds only on the gather path: the paged-decode kernel reduces in
another order. The programs stay eager on the card: they are the check.
"""

import torch

from ..models.gpt2 import DecodeMath


def build_oracle_programs(model, *, num_slots, max_len, prefill_chunk):
    """``decode_step(p, toks, pos, active, kcs, vcs)`` and
    ``prefill_chunk(p, toks, pos, n_valid, slot, kcs, vcs)`` over dense
    per-slot caches, updated in place, each returning its logits; plus
    ``reorder(kcs, vcs, perm)`` (the beam-search cache shuffle the paged path
    does with table forks) and ``fresh_caches()``."""
    c = model.config
    nh, hd = c.n_head, c.head_dim
    S, ML, C = int(num_slots), int(max_len), int(prefill_chunk)
    m = DecodeMath(model)

    @torch.no_grad()
    def decode_step(p, toks, pos, active, kcs, vcs):
        dev = kcs.device
        x = p["wte"][toks[:, None].long()] + p["wpe"][pos[:, None].long()]
        wslot = torch.where(active, torch.arange(S, device=dev),
                            torch.full((), S, device=dev))  # pads -> null slot
        pc = pos.long().clamp(max=ML - 1)

        def attn(xin, bp, li):
            q, k, v = m.qkv(xin, bp)                      # [S, nh, 1, hd]
            kcs[li, wslot, pc] = k[:, :, 0, :].to(kcs.dtype)
            vcs[li, wslot, pc] = v[:, :, 0, :].to(vcs.dtype)
            kg = kcs[li, :S].transpose(1, 2)              # [S, nh, ML, hd]
            vg = vcs[li, :S].transpose(1, 2)
            mask = (torch.arange(ML, device=dev)[None, :]
                    <= pos[:, None])[:, None, None, :]
            return m.proj(m.attend(q, kg, vg, mask, xin.dtype), bp, xin.dtype)

        x = m.blocks_forward(p, x, attn)
        return m.logits(x[:, -1], p)

    @torch.no_grad()
    def prefill_chunk_fn(p, toks, pos, n_valid, slot, kcs, vcs):
        dev = kcs.device
        pos = torch.as_tensor(pos, device=dev).long()
        n_valid = torch.as_tensor(n_valid, device=dev).long()
        slot = torch.as_tensor(slot, device=dev).long().reshape(1)
        wpe_cap = p["wpe"].shape[0] - 1
        ar = torch.arange(C, device=dev)
        tp = pos + ar
        positions = tp.clamp(max=wpe_cap)
        x = p["wte"][toks.long()] + p["wpe"][positions][None]
        valid = ar < n_valid
        wslot = torch.where(valid, slot, torch.full((), S, device=dev))
        pc = tp.clamp(max=ML - 1)

        def attn(xin, bp, li):
            q, k, v = m.qkv(xin, bp)                      # [1, nh, C, hd]
            kcs[li, wslot, pc] = k[0].transpose(0, 1).to(kcs.dtype)
            vcs[li, wslot, pc] = v[0].transpose(0, 1).to(vcs.dtype)
            kg = kcs[li].index_select(0, slot).transpose(1, 2)
            vg = vcs[li].index_select(0, slot).transpose(1, 2)
            mask = torch.arange(ML, device=dev)[None, :] <= tp[:, None]
            return m.proj(m.attend(q, kg, vg, mask, xin.dtype), bp, xin.dtype)

        x = m.blocks_forward(p, x, attn)
        last = (n_valid - 1).clamp(0, C - 1).reshape(1)
        return m.logits(x.index_select(1, last)[:, 0], p)

    @torch.no_grad()
    def reorder(kcs, vcs, perm):
        """Slot permutation/duplication [S] — the dense analog of beam-search
        block-table forking: new slot s takes old slot perm[s]'s cache.
        Identity entries keep non-beam slots untouched."""
        perm = perm.long()
        kcs[:, :S] = kcs[:, perm]
        vcs[:, :S] = vcs[:, perm]

    def fresh_caches():
        shape = (c.n_layer, S + 1, ML, nh, hd)
        dev = model.device
        return (torch.zeros(shape, dtype=c.compute_dtype, device=dev),
                torch.zeros(shape, dtype=c.compute_dtype, device=dev))

    return {
        "decode_step": decode_step,
        "prefill_chunk": prefill_chunk_fn,
        "reorder": reorder,
        "fresh_caches": fresh_caches,
    }
