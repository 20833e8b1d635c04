"""The PyTorch port's ``serve-sim`` (``deepspeed_tpu_torch/serve/sim.py``)
against the JAX package's, on the CPU, on equal weights: the JAX sim's
seeded GPT-2 (vocab 128, width 32, 2 layers) handed to the port through
``main(argv, model_params=...)`` with ``params_from_jax``. For each mode the
two sims exit alike and write the same ``deterministic`` report subtree
(requests, statuses, token counts, iteration-domain latencies, waste split,
prefix-cache and speculation counters, compare results), and a fleet run the
same routing transcript byte for byte: single engine with the bitwise mirror
and a byte-identical replay, the prefix cache against cache-off, speculation
against plain decode, and fleets with warm against cold failover and with
Poisson arrivals shedding at a queue bound (affinity against round-robin:
``tests/test_torch_fleet_router.py``). Then
the argument refusals, and the default device (the card, which raises
here)."""

import functools
import json

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.serve import sim as psim

BASE = ["--requests", "12", "--max-model-len", "64", "--num-blocks", "65",
        "--prefill-chunk", "16", "--block-size", "8", "--slots", "4"]

MODES = {
    "mirror_replay": ["--replay", "--include-infeasible"],
    "prefix_cache": ["--compare-prefix-cache", "--shared-prefix", "16"],
    "speculation": ["--compare-speculate", "--speculate", "3"],
    "fleet_failover": ["--fleet", "2", "--shared-prefix", "16", "--kill", "6:1",
                       "--compare-cold-failover"],
    "fleet_poisson_shed": ["--fleet", "2", "--arrival", "poisson:3.0",
                           "--max-queue-depth", "2", "--fleet-policy", "least_loaded"],
}


@functools.lru_cache(maxsize=None)
def _weights():
    import jax
    from deepspeed_tpu.serve import sim as jsim
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    args = jsim.argparse.Namespace(vocab_size=128, max_model_len=64, n_embd=32,
                                   n_layer=2, n_head=2, seed=0)
    _, jp = jsim._model_params(args)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _port_model():
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    model = GPT2Model(GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                                 n_head=2, compute_dtype=torch.float32, loss_chunk=0),
                      device="cpu")
    return model, _weights()


def _run(pkg, mode, tmp):
    from deepspeed_tpu.serve import sim as jsim
    argv = BASE + MODES[mode] + ["--json", str(tmp / f"{pkg}.json"),
                                 "--output", str(tmp / f"{pkg}_out"),
                                 "--snapshot-dir", str(tmp / f"{pkg}_snap")]
    if "--fleet" in argv:
        argv += ["--transcript", str(tmp / f"{pkg}.transcript")]
    if pkg == "jax":
        rc = jsim.main(argv)
    else:
        rc = psim.main(argv + ["--device", "cpu"], model_params=_port_model())
    report = json.loads((tmp / f"{pkg}.json").read_text())
    transcript = ((tmp / f"{pkg}.transcript").read_text()
                  if (tmp / f"{pkg}.transcript").exists() else None)
    return rc, report, transcript


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sim_report_matches_jax(mode, tmp_path, capsys):
    p_rc, p_rep, p_tr = _run("port", mode, tmp_path)
    j_rc, j_rep, j_tr = _run("jax", mode, tmp_path)
    assert (p_rc, p_rep["failures"]) == (j_rc, j_rep["failures"]) == (0, [])
    assert (json.dumps(p_rep["deterministic"], sort_keys=True)
            == json.dumps(j_rep["deterministic"], sort_keys=True))
    assert p_tr == j_tr
    if mode == "fleet_poisson_shed":
        assert p_rep["deterministic"]["n_shed"] > 0
    if mode == "fleet_failover":
        det = p_rep["deterministic"]
        assert det["failover_compare"]["prefill_chunks"]["warm"] < \
            det["failover_compare"]["prefill_chunks"]["cold"]


@pytest.mark.parametrize("argv,words", [
    (["--kill", "3:0"], "--kill needs --fleet N"),
    (["--fleet", "2", "--kill", "3:5"], "out of range"),
    (["--fleet", "2", "--replay"], "has its own compare modes"),
    (["--arrival", "uniform:2"], "--arrival must be"),
    (["--compare-affinity"], "fleet options need --fleet N"),
    (["--no-trace", "--slo-ttft-ms", "5"], "--no-trace is incompatible"),
])
def test_argument_refusals_match_jax(argv, words, capsys):
    from deepspeed_tpu.serve import sim as jsim
    errs = []
    for main in (psim.main, jsim.main):
        with pytest.raises(SystemExit) as info:
            main(argv)
        assert info.value.code == 2
        errs.append(capsys.readouterr().err.split("error: ", 1)[1])
    assert errs[0] == errs[1] and words in errs[0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card")
def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psim.main(["--requests", "1"])
