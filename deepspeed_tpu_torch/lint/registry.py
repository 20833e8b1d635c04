"""Registry of representative test-scale engine programs for
``ds-tpu-torch lint`` (the port's counterpart of
``deepspeed_tpu/lint/registry.py``, at its scale: a 32-wide MLP on a batch
of 8, and a GPT-2 of width 16, 2 layers, vocab 64).

Each entry builds a real engine on ``cuda`` (unless ``device="cpu"``) and
captures every program on its active step path through
``engine.lint_programs``, whose manifests the engines declare themselves:
standard two-step ZeRO-2, the external-master fused step (the published
1.5B structure), the external-master accumulation window, ZeRO-Offload's
host tier, the GPT-2 decode programs, paged serving and its speculative
programs, and the pipeline's instruction executor at 4 stages (each
stage's forward and backward, local programs). Capturing runs each program
once (lint/program_passes.py), so every builder makes an engine of its own.

The serving entries run the paged-decode kernel (``use_pallas=True``, where
the JAX entry takes the gather path): on the card each decode step shows
``deepspeed_tpu_torch::paged_decode`` once a layer; on the CPU the wrapper
takes the plain version. The GPT-2 decode programs attend over dense caches,
as the JAX package's do.

The communication entries (``comm_hierarchical``, ``comm_compressed``,
``comm_overlap``, ``comm_overlap_compressed``) and ``standard``, the flat
exchange they are compared with, train at 8 ranks factorized 2 x 4, as the
JAX entries do on the 8-device mesh: they are built and
captured inside torch's fake process group of 8 ranks, this process rank 0
(``entry_world``; ``utils/op_record.py`` ``fake_world``), so each
collective is recorded with its group and moves no data.

``serving_sharded`` records the head-sharded decode and prefill at
``serving.sharding.model`` 2 in the fake process group of 2 ranks, the
model axis (``ENTRY_AXIS``): its manifest admits one float32 all-reduce a
layer and no other collective, the JAX budget
(deepspeed_tpu/serve/engine.py:912-915).

Entries the port cannot build yet would raise ``NotImplementedError``
naming their ROADMAP.md item (``_unported``; none is left).
``capture_registry()`` with no names takes the ported entries (``PORTED``);
the CLI names the others as skipped, and logs the axis of each entry
captured at several ranks.

The lint model computes in the engine's compute dtype, with only the loss
in float32, so a clean low-precision program has no float32 product.
"""

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from .program_passes import ProgramArtifact

HIDDEN = 32
BATCH = 8


class LintModel(nn.Module):
    """Two-layer MLP that computes in its parameters' dtype (the engine's
    compute dtype), with only the loss in float32."""

    def __init__(self, hidden_dim=HIDDEN, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        h = hidden_dim
        self.w1 = nn.Parameter(torch.randn(h, h, generator=g) * 0.1)
        self.b1 = nn.Parameter(torch.zeros(h))
        self.w2 = nn.Parameter(torch.randn(h, h, generator=g) * 0.1)
        self.b2 = nn.Parameter(torch.zeros(h))

    def forward(self, x, y):
        dt = self.w1.dtype
        h = torch.tanh(x.to(dt) @ self.w1 + self.b1)
        out = h @ self.w2 + self.b2
        return torch.mean(torch.square(out.float() - y))


def external_master_pair(n):
    """Flat-shard external-master ``(init, apply)`` client pair — the 1.5B
    published optimizer's structure at test scale — updating its state in
    place."""
    def init(params):
        flat = torch.cat([p.reshape(-1).float() for p in pytree.tree_leaves(params)])
        shard = flat[: flat.shape[0] // n].clone()
        return {"master": shard, "m1": torch.zeros_like(shard),
                "m2": torch.zeros_like(shard)}

    def apply(grads, opt_state, master, step, hyper):
        g = torch.cat([x.reshape(-1).float() for x in pytree.tree_leaves(grads)])
        gs = g[: opt_state["master"].shape[0]]
        opt_state["m1"].mul_(0.9).add_(0.1 * gs)
        opt_state["m2"].mul_(0.999).add_(0.001 * gs * gs)
        opt_state["master"].sub_(hyper["lr"] * opt_state["m1"]
                                 / (torch.sqrt(opt_state["m2"]) + 1e-8))
        return None, opt_state

    apply.external_master = True
    return init, apply


def _config(batch=BATCH, **overrides):
    cfg = {"train_batch_size": batch, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(overrides)
    return cfg


def _sample_batch(rng_seed=0, batch=BATCH, hidden=HIDDEN):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(batch, hidden)).astype(np.float32)
    return x, np.tanh(x)


def _engine(device, optimizer=None, **config):
    import deepspeed_tpu_torch
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LintModel(), optimizer=optimizer, config_params=_config(**config),
        device=device)
    return eng


def _build_standard(device):
    return _engine(device, zero_optimization={"stage": 2}), _sample_batch()


def _build_external_master_fused(device):
    eng = _engine(device, optimizer=external_master_pair(4),
                  zero_optimization={"stage": 2}, zero_allow_untested_optimizer=True)
    return eng, _sample_batch()


def _build_external_master_accum(device):
    eng = _engine(device, optimizer=external_master_pair(4), batch=BATCH * 2,
                  gradient_accumulation_steps=2, zero_optimization={"stage": 2},
                  zero_allow_untested_optimizer=True)
    return eng, _sample_batch()


def _build_comm_hierarchical(device):
    # the two-level exchange (uncompressed): reduce-scatter and all-gather
    # inside the 2 x 4 slices, one float32 all-reduce across them
    eng = _engine(device, zero_optimization={"stage": 2},
                  comm={"mode": "hierarchical", "dcn_slices": 2})
    return eng, _sample_batch()


def _build_comm_compressed(device):
    # the error-feedback 1-bit cross-slice exchange: packed u8 signs over the
    # all-to-all and all-gather, float32 per-segment scales
    eng = _engine(device, zero_optimization={"stage": 2},
                  comm={"mode": "hierarchical_compressed", "dcn_slices": 2})
    return eng, _sample_batch()


def _build_comm_overlap(device):
    # the bucketed exchange over the two-level topology: 0.004 MB buckets cut
    # the model into three equal padded buckets ((b1, b2) / (w1) / (w2),
    # 1024 elements each)
    eng = _engine(device, zero_optimization={"stage": 2},
                  comm={"mode": "hierarchical", "dcn_slices": 2,
                        "overlap": {"mode": "bucketed", "bucket_mb": 0.004}})
    if len(eng._overlap_plan) != 3:
        raise RuntimeError("lint registry: comm_overlap entry expects the equal "
                           f"3-bucket plan, got {eng._overlap_plan}")
    return eng, _sample_batch()


def _build_comm_overlap_compressed(device):
    # the bucketed compressed exchange: per-bucket 1-bit cross-slice phases
    # with the bucketed error-feedback layout
    eng = _engine(device, zero_optimization={"stage": 2},
                  comm={"mode": "hierarchical_compressed", "dcn_slices": 2,
                        "overlap": {"mode": "bucketed", "bucket_mb": 0.004}})
    return eng, _sample_batch()


def _build_zero_offload(device):
    eng = _engine(device, zero_optimization={"stage": 2, "cpu_offload": True})
    return eng, _sample_batch()


def _tiny_gpt2(device):
    from ..models.gpt2 import GPT2Config, GPT2Model
    cfg = GPT2Config(vocab_size=64, n_positions=64, n_embd=16, n_layer=2, n_head=2,
                     compute_dtype=torch.float32, loss_chunk=0)
    model = GPT2Model(cfg, device=device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    return model


class _DecodeLintAdapter:
    """Engine-shaped wrapper so the GPT-2 decode programs
    (``GPT2Model.decode_lint_programs``) ride the same capture path."""

    def __init__(self, model):
        self.model = model

    def lint_programs(self, sample_batch=None):
        return self.model.decode_lint_programs()

    def memory_manifest(self):
        # the parameters are the only persistent residents of dense decode
        # (the caches are per-call)
        params = list(self.model.parameters())
        return {"classes": {"params": params},
                "geometry": {"kind": "decode", "psi": sum(p.numel() for p in params),
                             "param_itemsize": params[0].element_size()}}


def _build_gpt2_decode(device):
    return _DecodeLintAdapter(_tiny_gpt2(device)), None


def _serving_engine(model, **kw):
    from ..serve.engine import InferenceEngine
    return InferenceEngine(model, num_slots=4, block_size=4, num_blocks=17,
                           max_model_len=32, prefill_chunk=8, use_pallas=True, **kw)


def _build_serving(device):
    return _serving_engine(_tiny_gpt2(device)), None


class _SpecPrograms:
    """The speculative engine's spec programs only: its decode, prefill and
    copy programs are the ``serving`` entry's."""

    def __init__(self, eng):
        self.eng = eng

    def lint_programs(self, sample_batch=None):
        return [e for e in self.eng.lint_programs(sample_batch) if "spec" in e[0]]

    def memory_manifest(self):
        return self.eng.memory_manifest()


def _build_serving_speculative(device):
    # a self-draft (the target model and weights) keeps the builder cheap;
    # the programs have a real small draft's shapes
    model = _tiny_gpt2(device)
    eng = _serving_engine(model, speculation={"enabled": True, "draft_model": model,
                                              "max_draft_tokens": 2})
    return _SpecPrograms(eng), None


def _build_serving_sharded(device):
    # the head-sharded programs at sharding.model = 2, recorded in the fake
    # process group of 2 ranks (entry_world): one float32 all-reduce a layer
    return _serving_engine(_tiny_gpt2(device), sharding={"model": 2}), None


class PipeDense(nn.Module):
    """One layer of the pipeline entry: ``tanh(x @ w)`` in w's dtype."""

    def __init__(self, dim, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(torch.randn(dim, dim, generator=g) * 0.3)

    def forward(self, x):
        return torch.tanh(x.to(self.w.dtype) @ self.w)


def _pipe_mse(out, tgt):
    return torch.mean(torch.square(out.float() - tgt.float()))


def _build_pipeline(device):
    # the instruction executor at 4 stages of one layer each (the JAX entry):
    # each stage's forward and backward are local programs
    import deepspeed_tpu_torch
    from ..parallel.pipe import LayerSpec, PipelineModule
    module = PipelineModule(layers=[LayerSpec(PipeDense, HIDDEN, seed=i) for i in range(4)],
                            num_stages=4, loss_fn=_pipe_mse)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=module, device=device,
        config_params=_config(batch=BATCH, gradient_accumulation_steps=2,
                              pipeline={"spmd": False}))
    if eng._spmd:
        raise RuntimeError("lint registry: the pipeline entry must stay on the "
                           "instruction executor")
    x, y = _sample_batch(batch=BATCH // 2)     # one micro-batch
    return eng, (x, y)


def _unported(item):
    def build(device):
        raise NotImplementedError(f"this lint-registry entry is not in the PyTorch port "
                                  f"yet: ROADMAP.md {item}")
    build.item = item
    return build


BUILDERS = {
    "standard": _build_standard,
    "external_master_fused": _build_external_master_fused,
    "external_master_accum": _build_external_master_accum,
    "comm_hierarchical": _build_comm_hierarchical,
    "comm_compressed": _build_comm_compressed,
    "comm_overlap": _build_comm_overlap,
    "comm_overlap_compressed": _build_comm_overlap_compressed,
    "zero_offload": _build_zero_offload,
    "pipeline": _build_pipeline,
    "gpt2_decode": _build_gpt2_decode,
    "serving": _build_serving,
    "serving_speculative": _build_serving_speculative,
    "serving_sharded": _build_serving_sharded,
}
PORTED = sorted(k for k, b in BUILDERS.items() if not hasattr(b, "item"))
UNPORTED = {k: b.item for k, b in sorted(BUILDERS.items()) if hasattr(b, "item")}


# the entries built and captured at several ranks (a fake process group):
# the exchanges, and ``standard``, the flat exchange they are compared with,
# at 8 ranks of the data axis; the head-sharded serving programs at 2 ranks
# of the model axis
ENTRY_WORLD = {"standard": 8, "comm_hierarchical": 8, "comm_compressed": 8,
               "comm_overlap": 8, "comm_overlap_compressed": 8, "serving_sharded": 2}
ENTRY_AXIS = {"serving_sharded": "model"}


def entry_axis(entry):
    """The mesh axis an entry's ranks lie on ("data" unless named)."""
    return ENTRY_AXIS.get(entry, "data")


def entry_world(entry):
    """The context an entry is built and captured in: the fake process
    group of its ranks, or nothing (one rank)."""
    import contextlib
    from ..utils.op_record import fake_world
    n = ENTRY_WORLD.get(entry)
    return fake_world(n) if n else contextlib.nullcontext()


def build_entry(entry, device="cuda"):
    """(engine, sample batch) of one entry (call it inside
    ``entry_world(entry)`` for an entry of several ranks)."""
    return BUILDERS[entry](device)


def capture_entry(entry, device="cuda"):
    """[ProgramArtifact] for one registry entry, program names prefixed
    ``entry:program``."""
    with entry_world(entry):
        engine, batch = build_entry(entry, device)
        return [ProgramArtifact.capture(f"{entry}:{name}", fn, args, manifest)
                for name, fn, args, manifest in engine.lint_programs(batch)]


def capture_registry(entries=None, device="cuda"):
    """Artifacts for the requested entries (default: the ported ones, in
    name order)."""
    out = []
    for entry in (PORTED if not entries else list(entries)):
        out.extend(capture_entry(entry, device))
    return out
