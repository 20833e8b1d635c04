"""``ds-tpu-torch comm-sim`` (``deepspeed_tpu_torch/comm/sim.py``), the lint
registry's communication entries and the anatomy's ``comm_compare`` against
the JAX package's.

The simulator records the flat, hierarchical and compressed exchanges at 8
ranks (2 slices x 4) in torch's fake process group; its manifest passes and
its report is byte-stable. Against the JAX report (the same model, config
and factorization, from the compiled HLO): the same programs, collectives
and intra-slice bytes; two differences, both in how the programs are cut:

- the JAX programs all-reduce the loss over the data axis (one 4-byte
  cross-slice all-reduce each), the port's loss stays on its rank;
- XLA fuses the flat exchange's four per-leaf all-reduces into one; the
  port issues one per leaf (the same 8448 bytes).
"""

import json

import numpy as np
import pytest

from deepspeed_tpu.comm import sim as jsim
from deepspeed_tpu.utils import anatomy as janatomy
from deepspeed_tpu_torch.comm import sim
from deepspeed_tpu_torch.lint import registry
from deepspeed_tpu_torch.utils import anatomy

LOSS_PMEAN_BYTES = 4


@pytest.fixture(scope="module")
def reports():
    return sim.build_report(), jsim.build_report()


def test_report_passes_its_manifest_and_is_byte_stable(reports):
    ours, _ = reports
    assert ours["ok"] and ours["violations"] == []
    assert ours["dcn_reduction_vs_flat"] >= sim.MIN_DCN_REDUCTION
    assert sim.render(ours) == sim.render(sim.build_report())
    # a broken schedule is caught: the compressed program's all-to-all gone
    bad = json.loads(sim.render(ours))
    del bad["programs"]["compressed:loss_and_grad_comm"]["collectives"]["all-to-all"]
    assert any("all-to-all[dcn]" in v for v in sim._check(bad))


def test_report_equals_jax_but_for_the_loss_all_reduce(reports):
    ours, theirs = reports
    assert ours["mesh"] == theirs["mesh"]
    assert set(ours["programs"]) == set(theirs["programs"]) == set(sim.MANIFEST)
    assert theirs["ok"]
    for name, prog in ours["programs"].items():
        jprog = theirs["programs"][name]
        assert prog["ici_bytes"] == jprog["ici_bytes"], name
        assert prog["dcn_bytes"] == jprog["dcn_bytes"] - LOSS_PMEAN_BYTES, name

        def levels(p):
            return {(op, lvl) for op, lv in p["collectives"].items()
                    for lvl, v in lv.items() if v["count"]}
        extra = levels(jprog) - levels(prog)
        assert levels(prog) <= levels(jprog)
        assert extra <= {("all-reduce", "dcn")}, (name, extra)
        for op, lvl in levels(prog):
            if op != "all-reduce":
                assert prog["collectives"][op][lvl] == jprog["collectives"][op][lvl], \
                    (name, op, lvl)


def test_cli_writes_the_report(tmp_path, capsys):
    from deepspeed_tpu_torch import cli
    path = tmp_path / "comm.json"
    assert cli.main(["comm-sim", "--out", str(path)]) == 0
    assert "OK" in capsys.readouterr().out
    assert json.loads(path.read_text())["ok"]


@pytest.mark.parametrize("entry", ["comm_hierarchical", "comm_compressed", "comm_overlap",
                                   "comm_overlap_compressed"])
def test_registry_comm_entries_build_at_eight_ranks(entry):
    from deepspeed_tpu_torch.lint.program_passes import run_program_passes
    arts = registry.capture_entry(entry, "cpu")
    names = [a.name.split(":")[1] for a in arts]
    assert names[0] == "loss_and_grad" and names[-1] == "apply_update"
    assert ("loss_and_grad_comm" in names) == ("compressed" in entry)
    assert run_program_passes(arts) == []
    assert entry in registry.PORTED and entry not in registry.UNPORTED


def _synthetic(seed):
    rng = np.random.default_rng(seed)

    def rep(name, bucket=None):
        rows = [{"level": lvl, "bucket": bucket if lvl == "ici" else None,
                 "exposed_s": float(rng.random()) * 1e-4}
                for lvl in ("ici", "dcn", "dcn")]
        return {"name": name, "collectives": rows,
                "exposed_s": {"ici": float(rng.random()) * 1e-4,
                              "dcn": float(rng.random()) * 1e-4},
                "wire_bytes": {"ici": int(rng.integers(0, 1 << 20)),
                               "dcn": int(rng.integers(0, 1 << 20))}}
    return {"standard": [rep("standard:a"), rep("standard:b")],
            "comm_hierarchical": [rep("h:a")],
            "comm_compressed": [rep("c:a"), rep("c:b")],
            "comm_overlap": [rep("o:a", bucket=0), rep("o:b", bucket=1)]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comm_compare_equals_jax(seed):
    reports = _synthetic(seed)
    assert anatomy.comm_compare(reports) == janatomy.comm_compare(reports)
    partial = dict(reports)
    del partial["comm_overlap"]
    assert anatomy.comm_compare(partial) is None is janatomy.comm_compare(partial)
    # the overlap clause: bucket-tagged intra-slice rows must expose nothing
    for r in reports["comm_overlap"]:
        for c in r["collectives"]:
            c["exposed_s"] = 0.0 if c["bucket"] is not None else c["exposed_s"]
    assert anatomy.comm_compare(reports) == janatomy.comm_compare(reports)


def test_registry_slice_sets_equal_jax():
    assert sorted(map(sorted, anatomy._registry_slice_sets())) == \
        sorted(map(sorted, janatomy._registry_slice_sets()))
