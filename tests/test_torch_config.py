"""``DeepSpeedConfig`` of the PyTorch port against the JAX package's: the same
config resolves to the same fields, and a bad one fails with the same error;
every probe of ``tests/unit/test_config_keys.py``'s sweep over
``TOP_LEVEL_CONFIG_KEYS`` gives both classes the same fields, log lines and
errors, but for the port's refusals, listed by name. Also the lazy version
fields and ``installed_ops`` (``git_version_info.py``) and the legacy ``pt``
alias."""

import pytest

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TorchConfig


def _view(cfg):
    """Every field, with nested config objects flattened to their fields."""
    out = {}
    for k, v in vars(cfg).items():
        out[k] = vars(v) if hasattr(v, "__dict__") else v
    return out


SERVING_OK = [
    {},
    {"enabled": True, "block_size": 16, "num_blocks": 513, "max_seqs": 8,
     "max_model_len": 1024, "prefill_chunk": 128, "use_pallas_decode": True},
    {"block_size": 4, "num_blocks": 13, "max_seqs": 4, "max_model_len": 32,
     "prefill_chunk": 8, "prefix_cache": {"enabled": True}},
    {"request_trace": {"enabled": True, "capacity": 8, "slo": {"ttft_ms": 50}},
     "sharding": {"model": 2}},
    {"speculation": {"enabled": True, "max_draft_tokens": 3, "draft_pool_blocks": 0},
     "fleet": {"replicas": 2, "policy": "least_loaded", "occupancy_cap": 0.5}},
]

SERVING_BAD = [
    {"block_size": 0},
    {"num_blocks": 1},
    {"max_seqs": True},
    {"max_model_len": 30, "block_size": 16},
    {"prefill_chunk": 2.5},
    {"request_trace": {"capacity": 0}},
    {"request_trace": {"slo": {"tpot_ms": -1}}},
    {"sharding": {"model": 0}},
    {"speculation": {"max_draft_tokens": 0}},
    {"speculation": {"draft_pool_blocks": 1}},
    {"fleet": {"replicas": 0}},
    {"fleet": {"policy": "random"}},
    {"fleet": {"occupancy_cap": 0.0}},
]


@pytest.mark.parametrize("serving", SERVING_OK)
def test_serving_block_resolves_the_same(serving):
    d = {"train_batch_size": 1, "serving": serving}
    assert _view(TorchConfig(dict(d), world_size=1)) == _view(JaxConfig(dict(d), world_size=1))


@pytest.mark.parametrize("serving", SERVING_BAD)
def test_serving_block_errors_the_same(serving):
    d = {"train_batch_size": 1, "serving": serving}
    with pytest.raises(ValueError) as jerr:
        JaxConfig(dict(d), world_size=1)
    with pytest.raises(ValueError) as terr:
        TorchConfig(dict(d), world_size=1)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("d", [
    {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 4,
     "zero_optimization": {"stage": 2, "cpu_offload": True},
     "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "max_grad_norm": 1.0}},
     "activation_checkpointing": {"partition_activations": True}},
    {"train_batch_size": 16, "fp16": {"enabled": True, "loss_scale": 0},
     "gradient_clipping": 1.0, "comm": {"overlap": {"mode": "bucketed"}}},
])
def test_training_blocks_resolve_the_same(d):
    import copy
    assert _view(TorchConfig(copy.deepcopy(d), world_size=2)) == \
        _view(JaxConfig(copy.deepcopy(d), world_size=2))


def test_world_size_without_a_process_group_is_one():
    cfg = TorchConfig({"train_batch_size": 4})
    assert (cfg.world_size, cfg.global_rank) == (1, 0)
    assert cfg.train_micro_batch_size_per_gpu == 4


def test_alert_rules_wait_for_the_observatories_slice():
    with pytest.raises(NotImplementedError, match="observatories"):
        TorchConfig({"train_batch_size": 1,
                     "telemetry": {"enabled": True, "alerts": {"rules": []}}})


# ------------------------------------------------- the key corpus of both classes
def _sweep():
    """``tests/unit/test_config_keys.py``'s probes: key -> [(value, expect)]."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit",
                        "test_config_keys.py")
    spec = importlib.util.spec_from_file_location("_jax_config_keys", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: [p] if not isinstance(p[0], tuple) else list(p) for k, p in mod.SWEEP.items()}


# the probes the port refuses (NotImplementedError naming its ROADMAP item)
# where the JAX package resolves them or rejects them with its own rule
# checks: telemetry.alerts.rules, the alert rules of the observatories
# (items 21-22), by (key, probe index) -> what the probe sets
REFUSED = {("telemetry", 53): "alerts.rules: one threshold rule",
           ("telemetry", 57): "alerts.rules: a rule of an unknown kind",
           ("telemetry", 58): "alerts.rules: a rule on an undeclared metric"}


def _resolve(cls, logger, d):
    """(fields or None, the exception's type and message or None, the log
    lines with the package's name taken out)."""
    import copy
    import logging

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.DEBUG)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage().replace("deepspeed_tpu_torch",
                                                          "deepspeed_tpu"))

    cap = Capture()
    logger.addHandler(cap)
    try:
        return _view(cls(copy.deepcopy(d), world_size=1)), None, cap.lines
    except (ValueError, TypeError, KeyError, AssertionError, NotImplementedError) as err:
        return None, (type(err), str(err)), cap.lines
    finally:
        logger.removeHandler(cap)


@pytest.mark.parametrize("key", sorted(__import__(
    "deepspeed_tpu_torch.runtime.constants", fromlist=["TOP_LEVEL_CONFIG_KEYS"]
).TOP_LEVEL_CONFIG_KEYS))
def test_every_key_resolves_the_same(key):
    """Each sweep probe of ``key`` gives both classes the same fields, the
    same log lines and the same error; the port's refusals are listed."""
    from deepspeed_tpu.runtime.constants import TOP_LEVEL_CONFIG_KEYS as JAX_KEYS
    from deepspeed_tpu.utils import logger as jax_logger
    from deepspeed_tpu_torch.utils import logger as port_logger
    assert key in JAX_KEYS
    for n, (value, _) in enumerate(_sweep()[key]):
        d = {"train_batch_size": 8, key: value}
        want = _resolve(JaxConfig, jax_logger, d)
        got = _resolve(TorchConfig, port_logger, d)
        if (key, n) in REFUSED:
            assert "rules" in value["alerts"], REFUSED[key, n]
            assert got[1][0] is NotImplementedError and "ROADMAP.md" in got[1][1]
            continue
        assert got == want, (key, n, value)


def test_the_refusals_are_what_the_port_refuses():
    sweep = _sweep()
    for key, n in REFUSED:
        value = sweep[key][n][0]
        with pytest.raises(NotImplementedError, match="observatories"):
            TorchConfig({"train_batch_size": 8, key: value}, world_size=1)


# ------------------------------------------------- provenance and the pt alias
def test_version_and_installed_ops():
    import re
    import shutil
    import torch
    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import git_version_info
    assert re.match(r"^\d+\.\d+\.\d+(\+[0-9a-f]{4,}|\+unknown)?$",
                    deepspeed_tpu_torch.__version__)
    assert deepspeed_tpu_torch.__version__ == deepspeed_tpu.__version__
    assert deepspeed_tpu_torch.__git_hash__ == git_version_info.git_hash
    assert deepspeed_tpu_torch.__git_branch__ == deepspeed_tpu.__git_branch__
    ops = deepspeed_tpu_torch.installed_ops
    assert set(ops) == {"cpu_adam", "paged_attention", "flash_attention",
                        "block_sparse_attention", "fused_block"}
    assert all(isinstance(v, bool) for v in ops.values())
    assert ops["cpu_adam"] == (shutil.which("g++") is not None)
    if not torch.cuda.is_available():
        assert not any(ops[k] for k in ops if k != "cpu_adam")


def test_import_runs_no_subprocess():
    """The fields are lazy: importing the package starts no process; reading
    ``__version__`` asks git."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import subprocess\n"
            "calls = []\n"
            "orig = subprocess.Popen.__init__\n"
            "def spy(self, *a, **k):\n"
            "    calls.append(a[0] if a else k.get('args'))\n"
            "    orig(self, *a, **k)\n"
            "subprocess.Popen.__init__ = spy\n"
            "import deepspeed_tpu_torch\n"
            "n = len(calls)\n"
            "deepspeed_tpu_torch.__version__\n"
            "print(n, len(calls) > n)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.split() == ["0", "True"]


def test_legacy_pt_alias():
    import deepspeed_tpu.pt as jax_pt
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.pt import deepspeed_config, deepspeed_utils
    from deepspeed_tpu_torch.runtime import config, utils
    assert deepspeed_config is config and deepspeed_utils is utils
    assert deepspeed_tpu_torch.pt.deepspeed_config.DeepSpeedConfig is TorchConfig
    assert sorted(n for n in vars(jax_pt) if not n.startswith("_")) == \
        sorted(n for n in vars(deepspeed_tpu_torch.pt) if not n.startswith("_"))
