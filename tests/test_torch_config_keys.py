"""The port's config-key reachability pass (``deepspeed_tpu_torch/lint/
config_pass.py``) against the JAX package's, on the CPU: the port declares
the same keys, its pass reports nothing the shipped allowlist does not
cover, and every key the JAX pass finds reachable is reachable in the port
(read where the port uses it, or where it refuses it by name)."""

import os

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.lint import config_pass as jcp
from deepspeed_tpu_torch.lint import config_pass as tcp
from deepspeed_tpu_torch.lint.cli import _DEFAULT_ALLOWLIST
from deepspeed_tpu_torch.lint.model import Allowlist

JPKG = os.path.dirname(os.path.abspath(deepspeed_tpu.__file__))
TPKG = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))


def _keys(pkg, mod):
    return mod.declared_key_constants(os.path.join(pkg, "runtime", "constants.py"))


def test_port_declares_the_jax_keys():
    keys = _keys(TPKG, tcp)
    assert keys == _keys(JPKG, jcp)
    assert keys["TRAIN_BATCH_SIZE"] == "train_batch_size" and "TELEMETRY" not in keys


def test_port_pass_reports_nothing_unallowlisted():
    allow = Allowlist.load(_DEFAULT_ALLOWLIST)
    vs = tcp.ConfigKeysPass(TPKG).run()
    assert [v.vid for v in vs if allow.match(v.vid) is None] == []


def test_every_key_jax_reaches_is_reached_in_the_port():
    def reached(pkg, mod):
        names = set()
        for rel in mod.CONSUMER_RELPATHS:
            path = os.path.join(pkg, rel)
            if os.path.exists(path):
                names |= mod._referenced_names(path)
        return {k for k in _keys(pkg, mod) if k in names}

    jax_reached = reached(JPKG, jcp)
    assert jax_reached and jax_reached <= reached(TPKG, tcp)
    assert set(tcp.CONSUMER_RELPATHS) == set(jcp.CONSUMER_RELPATHS)
