"""The dispatcher recorder and its readers (``deepspeed_tpu_torch/utils/
op_record.py``), the port's counterpart of ``deepspeed_tpu/utils/hlo.py``,
against hand-built programs of known counts and bytes (the counterpart of
``tests/unit/test_hlo_parsers.py``) and, where both packages can express the
same program, against the JAX readers over its HLO.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils import op_record as R


class _FakeWorld:
    def __init__(self, world_size):
        self.world_size = world_size

    def __enter__(self):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), world_size=self.world_size, rank=0)

    def __exit__(self, *exc):
        dist.destroy_process_group()


def test_collective_kinds_results_and_bytes():
    """Each c10d op under JAX's kind, with what one participant receives."""
    def prog(t, h):
        dist.all_reduce(t)                                   # 512 f32
        out = torch.empty(128)
        dist.reduce_scatter_tensor(out, t)                   # 128 f32
        parts = [torch.empty(512, dtype=torch.bfloat16) for _ in range(4)]
        dist.all_gather(parts, h)                            # 4 x 512 bf16, one result
        full = torch.empty(2048, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(full, h)                 # 2048 bf16
        rs = torch.empty(512)
        dist.reduce_scatter(rs, [t, t, t, t])                # 512 f32
        dist.broadcast(t, 0)
        return out, full

    with _FakeWorld(4):
        p = R.record(prog, torch.ones(512), torch.ones(512, dtype=torch.bfloat16))
    assert R.collective_counts(p) == {"all-reduce": 1, "reduce-scatter": 2,
                                      "all-gather": 2, "broadcast": 1}
    assert R.collective_results(p, "all-gather") == [("all-gather", "bf16", 2048)] * 2
    assert R.collective_results(p, "reduce-scatter") == [("reduce-scatter", "f32", 128),
                                                          ("reduce-scatter", "f32", 512)]
    assert R.collective_bytes(p) == 512 * 4 + 128 * 4 + 2 * 2048 * 2 + 512 * 4 + 512 * 4


def test_no_collective_outside_a_group():
    p = R.record(lambda x: (x @ x).sum(), torch.ones(4, 4))
    assert R.collective_counts(p) == {} and R.collective_bytes(p) == 0
    assert [r.name for r in p.ops] == ["aten::mm", "aten::sum"]


def _jax_hlo(fn, *shapes):
    import jax
    import jax.numpy as jnp
    args = [jnp.ones(s, dt) for s, dt in shapes]
    return jax.jit(fn).lower(*args).as_text(dialect="hlo")


def _leak_programs():
    import jax.numpy as jnp
    bf, f32 = jnp.bfloat16, jnp.float32
    return {
        # one float32 product of two converted operands
        "leak": (lambda w, x: (x.astype(f32) @ w.astype(f32)).astype(bf),
                 lambda w, x: (x.float() @ w.float()).to(torch.bfloat16)),
        # a bf16 product widened after: no float32 product at all
        "clean": (lambda w, x: (x @ w).astype(f32),
                  lambda w, x: (x @ w).float()),
    }


@pytest.mark.parametrize("case", ["leak", "clean"])
def test_f32_dots_with_lowp_operands_count_as_jax(case):
    from deepspeed_tpu.utils import hlo
    jfn, tfn = _leak_programs()[case]
    import jax.numpy as jnp
    text = _jax_hlo(jfn, ((32, 32), jnp.bfloat16), ((8, 32), jnp.bfloat16))
    w = torch.ones(32, 32, dtype=torch.bfloat16)
    x = torch.ones(8, 32, dtype=torch.bfloat16)
    hits = R.f32_dots_with_lowp_operands(R.record(tfn, w, x))
    assert len(hits) == len(hlo.f32_dots_with_lowp_operands(text))
    if hits:
        (dot, fed), = hits
        assert dot.startswith("mm@") and len(fed) == 2


def test_f32_dot_through_views_and_linear():
    """A conversion reaches the product through transposes, reshapes and
    ``F.linear``'s decomposition; f16 counts only when asked for."""
    w = torch.ones(16, 32, dtype=torch.float16)
    x = torch.ones(2, 4, 32, dtype=torch.float16)
    p = R.record(lambda w, x: torch.nn.functional.linear(x.float(), w.float()), w, x)
    assert len(R.f32_dots_with_lowp_operands(p, lowp=("f16",))) == 1
    assert R.f32_dots_with_lowp_operands(p, lowp=("bf16",)) == []


@pytest.mark.parametrize("chain,lossy", [
    (("float32", "bfloat16", "float32"), True),
    (("float32", "float16", "float32"), True),
    (("bfloat16", "float32", "bfloat16"), False),
    (("float32", "float32", "float32"), False),
])
def test_lossy_convert_roundtrips_as_jax(chain, lossy):
    import jax.numpy as jnp
    from deepspeed_tpu.utils import hlo
    d0, d1, d2 = chain
    text = _jax_hlo(lambda x: x.astype(getattr(jnp, d1)).astype(getattr(jnp, d2)),
                    ((4, 4), getattr(jnp, d0)))
    p = R.record(lambda x: x.to(getattr(torch, d1)).to(getattr(torch, d2)),
                 torch.ones(4, 4, dtype=getattr(torch, d0)))
    hits = R.lossy_convert_roundtrips(p)
    assert len(hits) == len(hlo.lossy_convert_roundtrips(text)) == int(lossy)
    if lossy:
        names = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
        assert hits == [("_to_copy@0", (names[d0], names[d1], names[d0]))]


def test_aliases_mutations_and_fresh_outputs():
    def prog(a, b):
        a.add_(b)              # writes a, returns it
        c = b * 2              # fresh
        return a, c, b.view(4)

    a, b = torch.ones(2, 2), torch.ones(2, 2)
    p = R.record(prog, a, b)
    add = p.ops[0]
    assert add.name == "aten::add_" and add.mutates == [0] and add.aliases == {0: 0}
    assert R.input_output_aliases(p) == {0: [0], 1: [2]}
    assert R.fresh_outputs(p) == [1]
    assert R.written_storages(p) == {p.args[0].storage}
    assert [(t.dtype, t.shape, t.nbytes) for t in p.outs] == [
        ("f32", (2, 2), 16), ("f32", (2, 2), 16), ("f32", (4,), 16)]


def test_kernel_ops_are_recorded_as_one_op():
    """The port's kernel entries are dispatcher ops: the recorder sees each
    as one op (here through their fake kernels, on meta tensors), and their
    launch counters move only where a kernel launches."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    before = (pa.paged_decode_attention.launches, pa.paged_decode_attention.cluster_launches)
    q = torch.empty(4, 2, 1, 8, device="meta")
    pool = torch.empty(2, 5, 4, 2, 8, device="meta")
    tables = torch.empty(4, 2, dtype=torch.int32, device="meta")
    lengths = torch.empty(4, dtype=torch.int32, device="meta")
    op = torch.ops.deepspeed_tpu_torch.paged_decode
    p = R.record(lambda *a: [op(*a) for _ in range(3)], q, pool, pool, 1, tables, lengths, 4)
    assert R.kernel_counts(p) == {"paged_decode": 3}
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.cluster_launches) == before


def test_dtype_names_and_bytes():
    assert [R.dtype_name(d) for d in (torch.float32, torch.bfloat16, torch.int32, torch.bool)] \
        == ["f32", "bf16", "s32", "pred"]
    assert R.dtype_bytes("bf16") == 2 and R.dtype_bytes(torch.float64) == 8
    assert R.dtype_bytes("unknown") is None
    assert np.prod((2, 3)) == R._elements((2, 3))
