"""The PyTorch port's run goodput ledger (``deepspeed_tpu_torch/utils/
goodput.py``) against the JAX package's, on the CPU.

Seeded random event streams (spans, clamped and over-large carve-outs,
hang, replay and eval events) drive one ``RunLedger`` of each package on the
same synthetic clock: the persisted ledger files, the summaries, the
``Run/Goodput/*`` scalar items, the Perfetto timeline and the fleet merge of
several hosts are byte for byte the JAX package's; ``goodput_main``'s render
and diff print the same text and return the same exit codes. Then the
engine's carve of the ``AsyncCheckpointer`` snapshot fence as
``checkpoint_stall``.
"""

import json
import random

import pytest

from deepspeed_tpu.utils import goodput as jg
from deepspeed_tpu_torch.utils import goodput as pg


def _stream(mod, seed, **kw):
    """A ledger of ``mod`` over a seeded event stream on a synthetic clock."""
    rng = random.Random(seed)
    cell = [100.0]
    led = mod.RunLedger(clock=lambda: cell[0], wall=lambda: 1000.0, **kw)
    cell[0] += rng.uniform(0.0, 3.0)
    led.close("init", {"compile": rng.uniform(0.0, 5.0)})
    led.set_replay_until(rng.randint(-1, 3))
    step = 0
    for _ in range(rng.randint(5, 40)):
        ev = rng.random()
        cell[0] += rng.uniform(0.0, 1.0)
        if ev < 0.7:
            step += 1
            carve = {}
            if rng.random() < 0.5:
                carve["checkpoint_stall"] = rng.uniform(0.0, 2.0)
            if rng.random() < 0.3:
                carve["compile"] = rng.uniform(0.0, 2.0)
            if rng.random() < 0.2:
                carve["straggler_skew"] = rng.uniform(0.0, 2.0)
            led.close_step(step, carve or None, hang=rng.random() < 0.1)
        elif ev < 0.85:
            led.close("host_gap")
            cell[0] += rng.uniform(0.0, 0.5)
            led.close_eval()
        else:
            led.close("host_gap")
    cell[0] += rng.uniform(0.0, 1.0)
    return led


@pytest.mark.parametrize("seed", range(6))
def test_ledger_bundle_bytes_match_jax(seed, tmp_path):
    p = _stream(pg, seed, run_id=f"r{seed}", host=seed % 3, ledger_dir=str(tmp_path / "p"))
    j = _stream(jg, seed, run_id=f"r{seed}", host=seed % 3, ledger_dir=str(tmp_path / "j"))
    assert p.scalar_items() == j.scalar_items()
    assert json.dumps(p.finalize(), sort_keys=True) == json.dumps(j.finalize(), sort_keys=True)
    with open(p.ledger_path()) as fp, open(j.ledger_path()) as fj:
        assert fp.read() == fj.read()
    pg.goodput_timeline(p.to_dict(), str(tmp_path / "p.trace.json"))
    jg.goodput_timeline(j.to_dict(), str(tmp_path / "j.trace.json"))
    assert (tmp_path / "p.trace.json").read_text() == (tmp_path / "j.trace.json").read_text()


def test_fleet_goodput_matches_jax():
    p = {h: _stream(pg, 20 + h, run_id="f", host=h).finalize(persist=False) for h in range(4)}
    j = {h: _stream(jg, 20 + h, run_id="f", host=h).finalize(persist=False) for h in range(4)}
    assert json.dumps(pg.fleet_goodput(p), sort_keys=True) == \
        json.dumps(jg.fleet_goodput(j), sort_keys=True)


def test_unknown_class_is_refused_as_in_jax():
    led = pg.RunLedger(clock=lambda: 0.0, wall=lambda: 0.0)
    with pytest.raises(ValueError):
        led.close("lunch")
    jled = jg.RunLedger(clock=lambda: 0.0, wall=lambda: 0.0)
    with pytest.raises(ValueError):
        jled.close("lunch")


def _pair(mod, root):
    """Two runs: r1 of two hosts (fraction 0.75), r2 of one (0.25)."""
    for h, hang in ((0, False), (1, True)):
        cell = [0.0]
        led = mod.RunLedger(run_id="r1", host=h, ledger_dir=str(root / "good"),
                            clock=lambda c=cell: c[0], wall=lambda: 1000.0)
        for s in range(1, 3):
            cell[0] += 1.0
            led.close_step(s, hang=hang and s == 2)
        led.finalize()
    cell = [0.0]
    led = mod.RunLedger(run_id="r2", host=0, ledger_dir=str(root / "worse"),
                        clock=lambda: cell[0], wall=lambda: 1000.0)
    cell[0] += 1.0
    led.close_step(1)
    cell[0] += 3.0
    led.close_step(2, hang=True)
    led.finalize()
    return str(root / "good"), str(root / "worse"), led.ledger_path()


@pytest.mark.parametrize("case", ["render_dir", "render_file", "diff", "diff_tolerant",
                                  "missing", "fleet_timeline"])
def test_goodput_cli_matches_jax(case, tmp_path, capsys):
    outs = {}
    for name, mod in (("p", pg), ("j", jg)):
        good, worse, one = _pair(mod, tmp_path / name)
        argv = {"render_dir": [good], "render_file": [one],
                "diff": ["--diff", good, worse],
                "diff_tolerant": ["--diff", good, worse, "--tolerance", "0.9"],
                "missing": [str(tmp_path / name / "empty")],
                "fleet_timeline": [good, "--timeline", str(tmp_path / name / "t.json")]}[case]
        rc = mod.goodput_main(argv)
        outs[name] = (rc, capsys.readouterr().out.replace(str(tmp_path / name), "<root>"))
    assert outs["p"] == outs["j"]
