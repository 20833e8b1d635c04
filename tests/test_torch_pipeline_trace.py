"""The PyTorch port's pipeline observatory (``deepspeed_tpu_torch/utils/
pipeline_trace.py``, with its copy of ``runtime/pipe/schedule.py``) against
the JAX package's, on the CPU, over a grid of (micro-batches, stages): the
instruction streams of every stage, ``lint_schedule``'s statistics,
``simulate_schedule`` at uniform and uneven costs, ``simulated_bundle`` and
its Perfetto export ``to_trace_events`` (bytes), and the goodput
decomposition of a recorded step, equal; a tracer fed the same spans
gives the same bundle; the ``timeline`` CLI writes the same file."""

import json

import pytest

from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.utils import pipeline_trace as jp
from deepspeed_tpu_torch.runtime.pipe import schedule as psched
from deepspeed_tpu_torch.utils import pipeline_trace as pp
from deepspeed_tpu_torch.utils.trace_event import serialize_trace

GRID = [(1, 1), (1, 2), (2, 2), (4, 2), (3, 3), (8, 4), (5, 4), (16, 8)]


@pytest.mark.parametrize("m,s", GRID)
@pytest.mark.parametrize("kind", ["train", "inference"])
def test_instruction_streams_match_jax(m, s, kind):
    cls = {"train": "TrainSchedule", "inference": "InferenceSchedule"}[kind]
    for stage in range(s):
        got = getattr(psched, cls)(micro_batches=m, stages=s, stage_id=stage)
        want = getattr(jsched, cls)(micro_batches=m, stages=s, stage_id=stage)
        assert ([[repr(c) for c in cmds] for cmds in got]
                == [[repr(c) for c in cmds] for cmds in want])
        assert got.num_pipe_buffers() == want.num_pipe_buffers()


@pytest.mark.parametrize("m,s", GRID)
@pytest.mark.parametrize("kind", ["train", "inference"])
def test_lint_and_simulate_match_jax(m, s, kind):
    assert pp.lint_schedule(m, s, kind) == jp.lint_schedule(m, s, kind)
    for costs in ((1.0, None), (1.0, 2.0), (0.5, 1.25)):
        assert (pp.simulate_schedule(m, s, kind, *costs)
                == jp.simulate_schedule(m, s, kind, *costs))


@pytest.mark.parametrize("m,s", GRID)
def test_simulated_bundle_and_trace_bytes_match_jax(m, s):
    got = pp.simulated_bundle(m, s, step=3)
    want = jp.simulated_bundle(m, s, step=3)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert (serialize_trace(pp.to_trace_events(got))
            == serialize_trace(jp.to_trace_events(want)))
    spans = got["steps"][0]["spans"]
    assert (pp.goodput_decomposition(spans, s) == jp.goodput_decomposition(spans, s))


def test_tracer_bundle_matches_jax():
    def feed(mod):
        tr = mod.PipelineTracer(stages=2, capacity=4)
        for step in range(3):
            tr.begin_step(step, "TrainSchedule", 4)
            t = 0
            for k, (name, mb) in enumerate([("ForwardPass", 0), ("ForwardPass", 1),
                                            ("BackwardPass", 0), ("BackwardPass", 1)]):
                for stage in range(2):
                    tr.record(stage, k, name, mb, mb % 2, t, t + 100 * (1 + stage + step))
                    t += 150
            tr.end_step()
        b = tr.bundle()
        # the step's host time base (perf_counter at begin_step) differs per run
        for rec in b["steps"]:
            rec.pop("wall_seconds")
            rec.pop("t0_us")
            rec["spans"] = [sp[:5] + sp[6:] for sp in rec["spans"]]
        return b
    assert json.dumps(feed(pp), sort_keys=True) == json.dumps(feed(jp), sort_keys=True)


def test_lint_refuses_what_jax_refuses():
    for mod in (pp, jp):
        with pytest.raises(mod.ScheduleLintError):
            streams, rings = mod._instruction_streams(4, 2)
            streams[1] = streams[1][1:]          # drop stage 1's first step
            mod._replay(streams, rings, 4)


def test_timeline_cli_matches_jax(tmp_path):
    bundle = pp.simulated_bundle(4, 2, step=1)
    (tmp_path / "b.json").write_text(json.dumps(bundle))
    assert pp.timeline_main([str(tmp_path / "b.json"), "-o", str(tmp_path / "p.json")]) == 0
    assert jp.timeline_main([str(tmp_path / "b.json"), "-o", str(tmp_path / "j.json")]) == 0
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
