"""The PyTorch port's cluster observatory (``deepspeed_tpu_torch/utils/
cluster.py``) against the JAX package's, on the CPU: the heartbeat algebra
(``derive_cluster_stats``, ``find_straggler_host``, ``estimate_clock_offsets``)
over seeded matrices, a ``ClusterMonitor``'s stats, scalars and bundle over the
same heartbeats, the fleet latency and serving rollups, the merged cluster
timeline, ``assemble_cluster_report`` over flight-recorder dumps each
package wrote, and the two-host ``hang-sim`` transcript; then the port's own
seams: ``host_allgather`` over 2 gloo ranks (and a heartbeat through it), the
``HangWatchdog`` firing on an injected stall with a dump naming the scope,
and ``named_scope`` as a profiler range. JAX is imported inside the tests,
so the spawned workers import only torch."""

import json
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deepspeed_tpu_torch.utils import cluster as pc


def _jc():
    from deepspeed_tpu.utils import cluster
    return cluster


def _matrix(rng, hosts, step, slow=None):
    rows = []
    for h in range(hosts):
        step_ms = 100.0 + rng.rand() * 5
        dispatch = 90.0 + rng.rand() * 5
        if h == slow:
            dispatch *= 5.0
            step_ms *= 4.0
        rows.append([float(step), 1000.0 + step + 0.001 * h + 1e-4 * rng.rand(), step_ms,
                     dispatch, 1024.0 * h, 2048.0, float(1 << 30)])
    return rows


@pytest.mark.parametrize("hosts", [1, 2, 3, 8])
@pytest.mark.parametrize("slow", [None, 1])
def test_heartbeat_algebra_matches_jax(hosts, slow):
    jc = _jc()
    rng = np.random.RandomState(hosts)
    beats = [_matrix(rng, hosts, s, slow if hosts > 1 else None) for s in range(6)]
    for m in beats:
        for thr in (1.5, 3.0):
            assert pc.derive_cluster_stats(m, thr) == jc.derive_cluster_stats(m, thr)
        col = [r[3] for r in m]
        assert pc.find_straggler_host(col) == jc.find_straggler_host(col)
    assert pc.estimate_clock_offsets(beats) == jc.estimate_clock_offsets(beats)


class _Monitor:
    def __init__(self):
        self.rows = []

    def add_scalar(self, name, value, step):
        self.rows.append((name, float(value), step))

    def event(self, name, payload, step=None):
        self.rows.append((name, json.dumps(payload, sort_keys=True), step))


def test_cluster_monitor_ingest_matches_jax():
    jc = _jc()
    out = {}
    for name, mod in (("p", pc), ("j", jc)):
        mon = _Monitor()
        cm = mod.ClusterMonitor(monitor=mon, host_id=0, n_hosts=3, warmup_steps=1,
                                straggler_threshold=2.0, allgather=lambda row: [row])
        rng = np.random.RandomState(5)
        stats = [cm.ingest(_matrix(rng, 3, s, slow=2 if s > 2 else None), s) for s in range(6)]
        out[name] = (stats, mon.rows, cm.bundle(), cm.summary(), cm.skew_integral_s)
    assert out["p"] == out["j"]


def _sketch_bundles(mod, seed):
    from deepspeed_tpu_torch.serve.request_trace import HistogramSketch as PS
    from deepspeed_tpu.serve.request_trace import HistogramSketch as JS
    S = PS if mod is pc else JS
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        sk = {m: S() for m in ("ttft_ms", "tpot_ms", "e2e_ms")}
        for _ in range(40):
            for m in sk:
                sk[m].add(float(rng.lognormal(3, 1)))
        out.append({"latency_sketches": {m: s.to_dict() for m, s in sk.items()},
                    "totals": {"drafted_tokens": int(rng.randint(9)),
                               "accepted_draft_tokens": 2},
                    "counts": {"finished": 40}})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_rollups_match_jax(seed):
    jc = _jc()
    p, j = _sketch_bundles(pc, seed), _sketch_bundles(jc, seed)
    assert pc.fleet_latency_summary(p) == jc.fleet_latency_summary(j)
    assert pc.fleet_serving_totals(p) == jc.fleet_serving_totals(j)


def test_merged_cluster_trace_bytes_match_jax():
    jc = _jc()
    from deepspeed_tpu_torch.utils.pipeline_trace import simulated_bundle
    from deepspeed_tpu_torch.utils.trace_event import serialize_trace
    pipe = {h: dict(simulated_bundle(4, 2, step=1), host=h) for h in range(2)}
    offs = {0: 0.0, 1: 0.0015}
    assert (serialize_trace(pc.merged_cluster_trace(pipe, offs))
            == serialize_trace(jc.merged_cluster_trace(pipe, offs)))


def _dumps(cluster_mod, numerics, goodput, root):
    """Two hosts' flight-recorder dumps: host 1 hangs in a grad bucket at step
    3 (deadline), host 0 dumps on the peer signal; heartbeats and goodput
    ledgers ride in the cluster bundles."""
    for h in (0, 1):
        tracker = cluster_mod.ScopeTracker()
        cm = cluster_mod.ClusterMonitor(host_id=h, n_hosts=2, tracker=tracker,
                                        allgather=lambda row: [row])
        rec = numerics.FlightRecorder(capacity=8, dump_dir=root, host_id=h, run_id="rep",
                                      cluster=cm)
        for s in range(4):
            cm.ingest([[float(s), 1000.0 + s, 12.0, 9.0, 1.0, 2.0, 0.0],
                       [float(s), 1000.0 + s - 0.0015, 13.5, 10.0, 1.0, 2.0, 0.0]], s)
        cell = [0.0]
        led = goodput.RunLedger(run_id="rep", host=h, clock=lambda c=cell: c[0],
                           wall=lambda: 1000.0)
        for s in range(4):
            cell[0] += 1.0
            led.close_step(s, hang=h == 1 and s == 3)
        led.finalize(persist=False)
        cm.goodput = led
        rec.record_event("hang", {"origin": "deadline" if h == 1 else "peer_signal",
                                  "epoch": 3, "step": 3,
                                  "last_scope": "ds_grad_bucket1" if h else "ds_fwd_bwd"}, 3)
        rec.trigger("hang", {"host": h})
    return numerics.load_run_bundles(root, run="rep")


def test_assemble_cluster_report_matches_jax(tmp_path):
    jc = _jc()
    from deepspeed_tpu.utils import goodput as jg
    from deepspeed_tpu.utils import numerics as jn
    from deepspeed_tpu_torch.utils import goodput as pg
    from deepspeed_tpu_torch.utils import numerics as pn
    run_p, by_p = _dumps(pc, pn, pg, str(tmp_path / "p"))
    run_j, by_j = _dumps(jc, jn, jg, str(tmp_path / "j"))
    assert sorted(by_p) == sorted(by_j) == [0, 1]
    got = pc.assemble_cluster_report(by_p, run_key=run_p)
    # the JAX assembler over the port's dumps, and over dumps the JAX recorder wrote
    assert got == jc.assemble_cluster_report(by_p, run_key=run_p)
    assert got == jc.assemble_cluster_report(by_j, run_key=run_j)
    assert got["first_stall"] == {"host": 1, "step": 3, "scope": "ds_grad_bucket1",
                                  "origin": "deadline"}
    assert got["goodput"]["n_hosts"] == 2


def test_hang_sim_transcript_matches_jax(tmp_path):
    jc = _jc()
    assert pc.hang_sim_main(["--json", str(tmp_path / "p.json"),
                             "--dump-dir", str(tmp_path / "pd")]) == 0
    assert jc.hang_sim_main(["--json", str(tmp_path / "j.json"),
                             "--dump-dir", str(tmp_path / "jd")]) == 0
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))


def test_hang_watchdog_fires_on_an_injected_stall(tmp_path):
    from deepspeed_tpu_torch.utils.numerics import FlightRecorder, load_run_bundles
    tracker = pc.ScopeTracker()
    rec = FlightRecorder(capacity=8, dump_dir=str(tmp_path), host_id=0, run_id="stall")
    wd = pc.HangWatchdog(recorder=rec, deadline_s=0.1, host_id=0, run_id="stall",
                         tracker=tracker, poll_s=0.02)
    with pc.named_scope("ds_apply_update", tracker=tracker):
        wd.arm(7)
        deadline = time.monotonic() + 10.0
        while not wd.fired and time.monotonic() < deadline:   # the "stalled" step
            time.sleep(0.02)
    wd.disarm()
    wd.stop()
    assert len(wd.fired) == 1
    fire = wd.fired[0]
    assert (fire["origin"], fire["step"], fire["last_scope"]) == ("deadline", 7,
                                                                  "ds_apply_update")
    assert fire["waited_s"] > 0.1 and rec.dump_count == 1
    _, by_host = load_run_bundles(str(tmp_path), run="stall")
    assert by_host[0]["events"][0]["event"] == "hang"
    # the peer marker for the other hosts' watchdogs
    assert any(n.startswith("cluster_hang_stall_e7_host0") for n in os.listdir(tmp_path))


def test_named_scope_is_a_profiler_range():
    tracker = pc.ScopeTracker()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pc.named_scope("ds_fwd_bwd", tracker=tracker):
            torch.ones(4).sum()
    assert tracker.last_scope()["name"] == "ds_fwd_bwd"
    assert any(e.key == "ds_fwd_bwd" for e in prof.key_averages())


def _gloo_worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        mat = pc.host_allgather([rank, 10.0 + rank, 3.5])
        cm = pc.ClusterMonitor(straggler_threshold=1.5)
        assert (cm.host_id, cm.n_hosts) == (rank, 2)
        stats = cm.ingest(pc.host_allgather(
            [3.0, 1000.0 + rank, 100.0, 90.0 if rank == 0 else 900.0, 0.0, 0.0, 0.0]), 3)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump({"mat": mat, "stats": stats}, f)
    finally:
        dist.destroy_process_group()


def test_host_allgather_over_two_gloo_ranks():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_gloo_worker, args=(port, out_dir), nprocs=2,
                           start_method="spawn", join=True)
        res = [json.load(open(os.path.join(out_dir, f"{r}.json"))) for r in (0, 1)]
    for r in res:
        assert r["mat"] == [[0.0, 10.0, 3.5], [1.0, 11.0, 3.5]]
        assert r["stats"]["hosts"] == 2
        assert r["stats"]["straggler"] == {"host": 1, "ratio": 10.0}
    assert pc.host_allgather([1, 2]) == [[1.0, 2.0]]     # world 1: no group, the row
