"""Program lint of the port (``deepspeed_tpu_torch/lint/``), on the CPU.

The three seeded fixtures of ``tests/unit/test_lint_programs.py:32-80`` in
torch — a step that replaces the state it declares in place, an injected
all-gather of a sharded tensor, a bf16 region with one float32 product —
each trip only their own pass, with the vid the JAX fixture yields (the JAX
fixtures run here beside them). The seeded report is byte-identical across
two runs. The shipped registry lints clean through the CLI with the shipped
allowlist, ``--json`` byte-identical across two runs, and a stale allowlist
entry fails the run. The engines' manifests hold at dp = 2 under torch's
fake process group (the collectives dispatch, no second process), and a
bf16 GPT-2 engine's float32 LM head shows as the ``f32-dot-in-lowp-region``
its widened product is.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.lint import cli, registry
from deepspeed_tpu_torch.lint.model import LintReport
from deepspeed_tpu_torch.lint.program_passes import ProgramArtifact, run_program_passes


# ------------------------------------------------------------- JAX fixtures
def _jax_fixtures():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from deepspeed_tpu.lint.program_passes import ProgramArtifact as JArtifact
    from deepspeed_tpu.parallel.mesh import DATA_AXIS, build_mesh

    f = jax.jit(lambda x: (x * 2).astype(jnp.bfloat16), donate_argnums=(0,))
    donation = JArtifact.capture("seeded_broken_donation", f,
                                 (jnp.ones((64, 64), jnp.float32),),
                                 {"donation": {"check_unusable": True}, "strict": True})
    mesh = build_mesh(data=8)
    sharded, replicated = NamedSharding(mesh, P(DATA_AXIS)), NamedSharding(mesh, P())

    @lambda fn: jax.jit(fn, out_shardings=(replicated, replicated))
    def step(w, g):
        gsum = jax.lax.with_sharding_constraint(g, replicated)
        return w - 0.1 * gsum, gsum

    gather = JArtifact.capture(
        "seeded_full_gather", step,
        (jax.device_put(np.ones((4096,), np.float32), sharded),
         jax.device_put(np.ones((4096,), np.float32), replicated)),
        {"collectives": {}, "strict": True, "donation": {"check_unusable": False}})

    @jax.jit
    def leak(w1, w2, x):
        h = jnp.tanh(x @ w1)
        return (h.astype(jnp.float32) @ w2.astype(jnp.float32)).astype(jnp.bfloat16)

    w = jnp.ones((32, 32), jnp.bfloat16)
    fp32 = JArtifact.capture("seeded_fp32_leak", leak, (w, w, jnp.ones((8, 32), jnp.bfloat16)),
                             {"compute_dtype": "bf16", "strict": True,
                              "donation": {"check_unusable": False}})
    return {"seeded_broken_donation": donation, "seeded_full_gather": gather,
            "seeded_fp32_leak": fp32}


# ----------------------------------------------------------- torch fixtures
class _FakeWorld:
    """torch's fake process group: collectives dispatch (and are recorded)
    without a second process."""

    def __init__(self, world_size):
        self.world_size = world_size

    def __enter__(self):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), world_size=self.world_size, rank=0)
        return self

    def __exit__(self, *exc):
        dist.destroy_process_group()


def seeded_broken_donation():
    """Declares its state in place but returns a new bf16 buffer instead."""
    x = torch.ones(64, 64)
    return ProgramArtifact.capture(
        "seeded_broken_donation", lambda x: (x * 2).to(torch.bfloat16), (x,),
        {"donation": {"check_unusable": True, "inplace_args": [x]}, "strict": True})


def seeded_full_gather():
    """A ZeRO-style update that re-gathers its sharded parameter: the strict
    manifest, which budgets no collective, must call the gather out."""
    def step(w, g):
        full = torch.empty(w.numel() * dist.get_world_size())
        dist.all_gather_into_tensor(full, w)
        return full - 0.1 * g, g

    with _FakeWorld(8):
        return ProgramArtifact.capture(
            "seeded_full_gather", step, (torch.ones(512), torch.ones(4096)),
            {"collectives": {}, "strict": True, "donation": {"check_unusable": False}})


def seeded_fp32_leak():
    """A bf16 MLP with one mid-chain float32 product."""
    def leak(w1, w2, x):
        h = torch.tanh(x @ w1)
        return (h.float() @ w2.float()).to(torch.bfloat16)

    w = torch.ones(32, 32, dtype=torch.bfloat16)
    return ProgramArtifact.capture(
        "seeded_fp32_leak", leak, (w, w, torch.ones(8, 32, dtype=torch.bfloat16)),
        {"compute_dtype": "bf16", "strict": True, "donation": {"check_unusable": False}})


FIXTURES = {"seeded_broken_donation": (seeded_broken_donation, "program-donation"),
            "seeded_full_gather": (seeded_full_gather, "program-collectives"),
            "seeded_fp32_leak": (seeded_fp32_leak, "program-dtype")}


@pytest.fixture(scope="module")
def jax_vids():
    from deepspeed_tpu.lint.program_passes import run_program_passes as jrun
    return {name: {v.vid for v in jrun([a])} for name, a in _jax_fixtures().items()}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_seeded_fixture_trips_its_own_pass_with_jax_vid(name, jax_vids):
    build, pass_id = FIXTURES[name]
    vs = run_program_passes([build()])
    assert {v.vid for v in vs} == jax_vids[name]
    assert len(jax_vids[name]) == 1 and all(v.pass_id == pass_id for v in vs)


def _seeded_report():
    artifacts = [build() for build, _ in FIXTURES.values()]
    report = LintReport()
    report.programs += [a.name for a in artifacts]
    report.extend(run_program_passes(artifacts))
    report.finish()
    return report.to_json()


def test_seeded_report_is_deterministic_across_runs():
    text = _seeded_report()
    assert text == _seeded_report()
    assert json.loads(text)["summary"] == {"violations": 3, "allowlisted": 0, "failed": True}


# ------------------------------------------------------- the shipped registry
def test_cli_registry_is_clean_and_byte_stable(tmp_path, capsys):
    """``ds-tpu-torch lint --json --device cpu``: exit 0 with the shipped
    allowlist (no violation uncovered, no stale entry), every ported entry's
    programs captured, the unported ones named as skipped, and the same
    bytes on a second run."""
    out = [tmp_path / "a.json", tmp_path / "b.json"]
    for p in out:
        assert cli.main(["--json", "--device", "cpu", "--out", str(p)]) == 0
    captured = capsys.readouterr()
    text = out[0].read_text()
    assert text == out[1].read_text()
    rep = json.loads(text)
    assert rep["violations"] == [] and rep["unused_allowlist_entries"] == []
    assert {p.split(":")[0] for p in rep["programs"]} == set(registry.PORTED)
    assert len(rep["programs"]) == 38
    for entry, item in registry.UNPORTED.items():
        assert f"skipped {entry}: not in the PyTorch port yet (ROADMAP.md {item})" \
            in captured.err
    for entry in registry.UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
            registry.build_entry(entry, "cpu")


def test_stale_or_missing_allowlist_entry_fails_the_run(tmp_path):
    shipped = json.loads(open(cli._DEFAULT_ALLOWLIST).read())["allow"]
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"allow": shipped + [
        {"id": "ast-host-sync:item-call:deepspeed_tpu_torch/utils/nothing.py::f",
         "reason": "matches nothing"}]}))
    assert cli.main(["--ast-only", "--allowlist", str(stale)]) == 1
    missing = tmp_path / "missing.json"
    missing.write_text(json.dumps({"allow": shipped[1:]}))
    assert cli.main(["--ast-only", "--allowlist", str(missing)]) == 1
    # a program entry is judged only when the program surface ran in full
    prog = tmp_path / "prog.json"
    prog.write_text(json.dumps({"allow": shipped + [
        {"id": "program-dtype:*", "reason": "judged with the program surface"}]}))
    assert cli.main(["--ast-only", "--allowlist", str(prog)]) == 0


def test_serving_programs_write_their_pools():
    """A serving program that copied a pool instead of writing it would trip
    the in-place check; the real ones write both pools (and the paged
    decode runs the kernel wrapper, the plain version on the CPU)."""
    arts = registry.capture_entry("serving", "cpu")
    assert [a.name for a in arts] == ["serving:serve_decode_step",
                                      "serving:serve_prefill_chunk",
                                      "serving:serve_copy_blocks"]
    assert all(len(a.inplace_args) == 2 for a in arts)
    assert run_program_passes(arts) == []
    eng, _ = registry.build_entry("serving", "cpu")
    name, fn, args, man = eng.lint_programs()[2]

    def copying(k_pool, v_pool, src, dst):
        k_pool = k_pool.clone()
        k_pool[:, dst.long()] = k_pool[:, src.long()]
        return k_pool

    vs = run_program_passes([ProgramArtifact.capture(name, copying, args, man)])
    assert {(v.rule, v.subject) for v in vs} == {
        ("unusable-donation", f"{name}#arg0"), ("unusable-donation", f"{name}#arg1")}
    # undeclared, the copy is a second pool-sized buffer at the peak; as in
    # JAX, every undeclared input of the fresh output's shape and dtype counts
    undeclared = dict(man, donation=dict(man["donation"], inplace_args=[]))
    vs = run_program_passes([ProgramArtifact.capture(name, copying, args, undeclared)])
    assert [(v.rule, v.subject) for v in vs] == [
        ("undonated-aliasable", f"{name}#arg0"), ("undonated-aliasable", f"{name}#arg1")]
    assert vs[0].details["hbm_waste_bytes"] == args[0].numel() * 4


def test_engine_state_replaced_instead_of_updated():
    """A client pair that returns new state (a functional update) holds two
    copies of it at the peak: the fused step's in-place check names each
    leaf it replaced."""
    import deepspeed_tpu_torch
    init, apply = registry.external_master_pair(4)

    def functional(grads, state, master, step, hyper):
        return None, {k: v.clone() for k, v in state.items()}

    functional.external_master = True
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=registry.LintModel(), optimizer=(init, functional), device="cpu",
        config_params=registry._config(zero_optimization={"stage": 2},
                                       zero_allow_untested_optimizer=True))
    (prog,) = eng.lint_programs(registry._sample_batch())
    vs = run_program_passes([ProgramArtifact.capture(*prog)])
    assert sorted(v.subject for v in vs) == [f"fused_step#optimizer[{i}]" for i in range(3)]
    assert {v.rule for v in vs} == {"unusable-donation"}


def test_engine_manifests_hold_at_dp2():
    """ZeRO-2 at dp = 2: the backward reduces in bf16 (reduce-scatter for the
    sharded leaves, all-reduce for the rest), the update re-gathers the
    parameters in bf16, and both programs are clean against the engine's
    manifests; the dp = 1 budget would refuse the reductions."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import op_record
    with _FakeWorld(2):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=registry.LintModel(), device="cpu",
            config_params=registry._config(batch=16, zero_optimization={"stage": 2}))
        arts = [ProgramArtifact.capture(*p) for p in eng.lint_programs(registry._sample_batch())]
    lg, upd = arts
    assert op_record.collective_counts(lg.program) == {"reduce-scatter": 2, "all-reduce": 2}
    assert {dt for _, dt, _ in op_record.collective_results(lg.program)} == {"bf16"}
    assert op_record.collective_counts(upd.program)["all-gather"] == 2
    assert run_program_passes(arts) == []
    lg.manifest = dict(lg.manifest, any_reduction={"max": 0})
    assert [v.rule for v in run_program_passes([lg])] == ["count-exceeded"]


def test_bf16_gpt2_head_is_a_widened_product():
    """The port's float32 LM head (``models/gpt2.py`` ``_head``) widens the
    bf16 activations and embedding: in a bf16 engine it is exactly what
    ``f32-dot-in-lowp-region`` names. The shipped registry's GPT-2 entries
    compute in float32, as the JAX registry's do, so the shipped allowlist
    carries no entry for it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(vocab_size=64, n_positions=16, n_embd=16, n_layer=1,
                                 n_head=2, loss_chunk=0), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config_params={
            "train_batch_size": 2, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 2}})
    tokens = np.arange(32).reshape(2, 16) % 64
    lg = ProgramArtifact.capture(*eng.lint_programs((tokens, np.roll(tokens, -1, 1)))[0])
    dots = [v for v in run_program_passes([lg]) if v.rule == "f32-dot-in-lowp-region"]
    assert dots and all(v.subject.startswith("loss_and_grad#dot") for v in dots)


# ------------------------------------------------ what waited for the registry
def test_hbm_and_anatomy_sweep_the_registry(capsys):
    """``ds-tpu-torch hbm`` and ``anatomy`` without a saved report sweep the
    ported registry entries: every entry's live classes reconcile with the
    ZeRO model (a float32 serving engine's head is its embedding's storage,
    counted once), each program names the classes it touched, and each
    program gets a roofline floor; the unported entries are listed as
    skipped."""
    from deepspeed_tpu_torch.utils import anatomy, hbm
    rep = hbm.sweep_registry(device="cpu")
    assert rep["ok"] and rep["errors"] == [] and set(rep["entries"]) == set(registry.PORTED)
    assert rep["skipped"] == registry.UNPORTED
    std = rep["entries"]["standard"]
    assert set(std["programs"]) == {"loss_and_grad", "apply_update"}
    upd = std["programs"]["apply_update"]["by_class"]
    assert upd["params"] == std["classes"]["params"]["parsed_bytes"] > 0
    assert upd["master"] == std["classes"]["master"]["parsed_bytes"] > 0
    dec = rep["entries"]["serving"]["programs"]["serve_decode_step"]
    assert dec["by_class"]["kv_pool"] == rep["entries"]["serving"]["classes"]["kv_pool"][
        "parsed_bytes"]
    assert hbm.hbm_main(["--device", "cpu", "--entry", "gpt2_decode"]) == 0
    capsys.readouterr()
    assert anatomy.anatomy_main(["--device", "cpu", "--entry", "serving", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert [p["name"] for p in out["programs"]] == [
        "serving:serve_copy_blocks", "serving:serve_decode_step", "serving:serve_prefill_chunk"]
    assert all(p["roofline"]["predicted_floor_us"] > 0 for p in out["programs"])
