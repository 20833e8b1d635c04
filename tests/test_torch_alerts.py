"""The PyTorch port's alert plane (``deepspeed_tpu_torch/utils/alerts.py``)
against the JAX package's, on the CPU: rule validation (the same
normalized rules, the same refusals in the same words), the attribution
harness ``run_alert_attribution(seed)`` (four injected regressions against
the default rules, each firing only its own rule, and the two-host fleet
merge) equal to JAX's report, each rule kind's firings over a seeded
metric stream, the fleet merge, the ``alerts`` and ``alert-sim`` CLIs, and
the config's ``telemetry.alerts.rules``, which the port now accepts."""

import json

import numpy as np
import pytest

from deepspeed_tpu.utils import alerts as ja
from deepspeed_tpu.utils import metrics as jm
from deepspeed_tpu_torch.utils import alerts as pa
from deepspeed_tpu_torch.utils import metrics as pm

BAD_RULES = [
    ("not-a-list", "must be a list"),
    ([{"name": "x", "kind": "gradient", "metric": "Telemetry/Samples/mfu"}],
     "kind must be one of"),
    ([{"name": "x", "kind": "threshold", "metric": "Telemetry/Samples/mfu", "above": 1},
      {"name": "x", "kind": "threshold", "metric": "Telemetry/Samples/mfu", "above": 2}],
     "duplicate rule name"),
    ([{"name": "x", "kind": "threshold", "metric": "Telemetry/Samples/mfu", "above": 1,
       "window": 4}], "unknown key"),
    ([{"name": "x", "kind": "threshold", "metric": "Telemetry/Samples/mfu"}],
     "needs 'above' and/or 'below'"),
    ([{"name": "x", "kind": "slo_burn", "metric": "Serving/Fleet/shed", "mode": "counter"}],
     "budget"),
    ([{"name": "x", "kind": "threshold", "metric": "Bogus/metric", "above": 1}], "not declared"),
    ([{"name": "x", "kind": "delta", "metric": "Train/Samples/lr"}], "neutral"),
]

RULES = [
    {"name": "hot", "kind": "threshold", "metric": "Cluster/step_skew", "above": 1.5,
     "for_steps": 2},
    {"name": "slow", "kind": "delta", "metric": "Telemetry/Samples/mfu", "window": 4,
     "baseline": 8, "drop_pct": 10.0},
    {"name": "flat", "kind": "stuck", "metric": "Train/Samples/loss_scale", "steps": 5},
    {"name": "burn", "kind": "slo_burn", "metric": "Run/Goodput/goodput_fraction",
     "good": True, "budget": 0.2},
]


def _messages(mod, cat_mod):
    out = []
    for rules, _ in BAD_RULES:
        try:
            mod.validate_rules(rules, cat_mod.default_catalog())
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_rule_refusals_match_jax():
    got, want = _messages(pa, pm), _messages(ja, jm)
    assert got == want
    for msg, (_, words) in zip(got, BAD_RULES):
        assert msg is not None and words in msg


def test_normalized_rules_match_jax():
    assert (pa.validate_rules(RULES, pm.default_catalog())
            == ja.validate_rules(RULES, jm.default_catalog()))
    assert pa.default_rules() == ja.default_rules()


def _evaluate(mod, cat_mod, seed, rules):
    store = cat_mod.MetricStore(catalog=cat_mod.default_catalog(), ring_len=64)
    eng = mod.AlertEngine(rules=rules, store=store)
    rng = np.random.RandomState(seed)
    scale = 256.0
    for step in range(48):
        store.observe("Cluster/step_skew", 1.0 + (2.0 if 20 <= step < 24 else 0.0)
                      + 0.1 * rng.rand(), step)
        store.observe("Telemetry/Samples/mfu", 0.4 - (0.2 if step > 30 else 0.0)
                      + 0.01 * rng.rand(), step)
        if step < 10 or rng.rand() < 0.3:
            scale = max(scale / 2, 1.0) if rng.rand() < 0.5 else scale * 2
        store.observe("Train/Samples/loss_scale", scale, step)
        store.observe("Run/Goodput/goodput_fraction", 0.9 if step < 25 else 0.5, step)
        eng.evaluate(step)
    return eng.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rules", ["custom", "default"])
def test_alert_engine_firings_match_jax(seed, rules):
    r = RULES if rules == "custom" else None
    got = _evaluate(pa, pm, seed, r)
    want = _evaluate(ja, jm, seed, r)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if rules == "custom":
        assert got["fired"]


@pytest.mark.parametrize("seed", [20, 7])
def test_attribution_harness_report_matches_jax(seed, tmp_path):
    got = pa.run_alert_attribution(seed=seed, dump_dir=str(tmp_path / "p"))
    want = ja.run_alert_attribution(seed=seed, dump_dir=str(tmp_path / "j"))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"] if seed == 20 else True


def test_merge_fleet_alerts_matches_jax():
    def snaps(mod, cat_mod):
        return {h: {"alerts": _evaluate(mod, cat_mod, h, RULES)} for h in range(3)}
    assert (json.dumps(pa.merge_fleet_alerts(snaps(pa, pm)), sort_keys=True)
            == json.dumps(ja.merge_fleet_alerts(snaps(ja, jm)), sort_keys=True))


def test_alert_sim_cli_transcript_matches_jax(tmp_path, capsys):
    assert pa.alert_sim_main(["--json", str(tmp_path / "p.json")]) == 0
    p_out = capsys.readouterr().out
    assert ja.alert_sim_main(["--json", str(tmp_path / "j.json")]) == 0
    j_out = capsys.readouterr().out
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert p_out.replace("p.json", "j.json") == j_out


def test_config_accepts_rules_and_refuses_bad_ones_in_jax_words():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    base = {"train_batch_size": 1, "train_micro_batch_size_per_gpu": 1}
    good = dict(base, telemetry={"enabled": True, "alerts": {"enabled": True, "rules": RULES}})
    assert (DeepSpeedConfig(good, world_size=1).telemetry_alerts_rules
            == JaxConfig(good, world_size=1).telemetry_alerts_rules)
    bad = dict(base, telemetry={"enabled": True, "alerts": {
        "enabled": True, "rules": [{"name": "x", "kind": "gradient"}]}})
    msgs = []
    for cls in (DeepSpeedConfig, JaxConfig):
        with pytest.raises(ValueError, match="telemetry.alerts.rules") as e:
            cls(bad, world_size=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
