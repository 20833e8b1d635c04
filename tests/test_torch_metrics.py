"""The PyTorch port's metric catalog and ring (``deepspeed_tpu_torch/utils/
metrics.py``) against the JAX package's, on the CPU: the catalog's JSON, the
resolution of every declared and family name, the ring snapshot of a seeded
observation stream, the exact host merge, and the OpenMetrics text and the
``metrics`` CLI's listing and export, byte for byte; the monitor's routing
of every scalar into the ring."""

import json

import numpy as np
import pytest

from deepspeed_tpu.utils import metrics as jm
from deepspeed_tpu_torch.utils import metrics as pm

NAMES = ["Telemetry/Samples/mfu", "Telemetry/Samples/step_time_ms", "Train/Samples/train_loss",
         "Train/Samples/loss_scale", "Serving/Fleet/shed", "Serving/Latency/ttft_ms_p99",
         "Cluster/step_skew", "Run/Goodput/goodput_fraction", "Alerts/mfu_drop",
         "Pipeline/Goodput/bubble_fraction", "Serving/ttft_ms", "Not/Declared"]


def _feed(mod, seed, ring_len=16, host=0):
    store = mod.MetricStore(catalog=mod.default_catalog(), ring_len=ring_len, host=host)
    rng = np.random.RandomState(seed)
    for step in range(40):
        for name in NAMES[:-1]:
            if rng.rand() < 0.7:
                store.observe(name, float(rng.randn()), step)
    return store


def test_catalog_json_matches_jax():
    assert (json.dumps(pm.default_catalog().to_dict(), sort_keys=True)
            == json.dumps(jm.default_catalog().to_dict(), sort_keys=True))


@pytest.mark.parametrize("name", NAMES)
def test_resolution_and_direction_match_jax(name):
    pc, jc = pm.default_catalog(), jm.default_catalog()
    ps, js = pc.resolve(name), jc.resolve(name)
    assert (ps is None) == (js is None)
    if ps is not None:
        assert ps.to_dict() == js.to_dict()
        assert pc.direction(name) == jc.direction(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_and_openmetrics_bytes_match_jax(seed):
    p, j = _feed(pm, seed), _feed(jm, seed)
    assert json.dumps(p.to_dict(), sort_keys=True) == json.dumps(j.to_dict(), sort_keys=True)
    assert pm.openmetrics_text(p.to_dict()) == jm.openmetrics_text(j.to_dict())


def test_merge_host_rings_matches_jax():
    rings_p = {h: _feed(pm, 10 + h, host=h).to_dict() for h in range(3)}
    rings_j = {h: _feed(jm, 10 + h, host=h).to_dict() for h in range(3)}
    assert (json.dumps(pm.merge_host_rings(rings_p), sort_keys=True)
            == json.dumps(jm.merge_host_rings(rings_j), sort_keys=True))
    bad = {**rings_p, 9: _feed(pm, 3, ring_len=8, host=9).to_dict()}
    with pytest.raises(ValueError, match="geometry"):
        pm.merge_host_rings(bad)


def test_strict_store_raises_and_unknown_warns_once():
    with pytest.raises(pm.UnknownMetricError):
        pm.MetricStore(strict=True).observe("Not/Declared", 1.0, 0)
    store = pm.MetricStore()
    store.observe("Not/Declared", 1.0, 0)
    store.observe("Not/Declared", 2.0, 1)
    assert [tuple(o) for o in store.series("Not/Declared")] == [(0, 1.0), (1, 2.0)]


@pytest.mark.parametrize("argv", [[], ["--json"]])
def test_metrics_cli_listing_matches_jax(argv, tmp_path):
    assert pm.metrics_main(argv + ["--out", str(tmp_path / "p")]) == 0
    assert jm.metrics_main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert (tmp_path / "p").read_text() == (tmp_path / "j").read_text()


def test_monitor_routes_scalars_and_cli_export_matches_jax(tmp_path):
    from deepspeed_tpu_torch.utils.monitor import SummaryMonitor
    mon = SummaryMonitor(str(tmp_path), "job")
    mon.metrics = pm.MetricStore()
    for step in range(5):
        mon.add_scalar("Train/Samples/train_loss", 3.0 - step * 0.1, step)
        mon.add_scalar("Telemetry/Samples/mfu", 0.25 + step * 0.01, step)
    mon.event("loss_scale", {"kind": "ramp"}, 3)
    mon.close()
    ledger = tmp_path / "job" / "scalars.jsonl"
    rows = [json.loads(line) for line in ledger.read_text().splitlines()]
    assert [r["tag"] for r in rows][:2] == ["Train/Samples/train_loss", "Telemetry/Samples/mfu"]
    assert mon.metrics.last("Telemetry/Samples/mfu") is not None
    assert (tmp_path / "job" / "events.jsonl").exists()
    assert pm.metrics_main(["--export", str(ledger), "--out", str(tmp_path / "p.om")]) == 0
    assert jm.metrics_main(["--export", str(ledger), "--out", str(tmp_path / "j.om")]) == 0
    assert (tmp_path / "p.om").read_text() == (tmp_path / "j.om").read_text()
