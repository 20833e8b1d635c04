"""Config-key reachability pass.

``runtime/constants.py`` declares config keys as ``NAME = "json_key"`` paired
with ``NAME_DEFAULT = ...``. A key constant whose name is never referenced
from a config-consuming module is a key users can set that nothing reads —
exactly the silent no-op the config test sweep exists to prevent, but caught
at the *declaration* instead of needing a hand-written probe per key.

A copy of ``deepspeed_tpu/lint/config_pass.py`` over the port's
``runtime/constants.py``, with JAX's list of consumers; a key the port
refuses is read where it refuses it, so it counts as reached.
The keys of the model axis (``serving.sharding.model``,
``activation_checkpointing.partition_activations``) are read by
``runtime/config.py`` and ``runtime/activation_checkpointing/config.py``
and act since tensor parallelism is in the port.
"""

import ast
import os

from .model import Violation

# modules that consume key constants (all use `from .constants import *` or
# explicit imports); a key referenced in any of them is reachable
CONSUMER_RELPATHS = (
    "runtime/config.py",
    "runtime/engine.py",
    "runtime/zero/config.py",
    "runtime/activation_checkpointing/config.py",
    "runtime/pipe/engine.py",
)


def declared_key_constants(constants_path):
    """{NAME: json_key} for every NAME = "str" with a NAME_DEFAULT sibling."""
    with open(constants_path) as f:
        tree = ast.parse(f.read(), filename=constants_path)
    assigns = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            assigns[node.targets[0].id] = node.value
    keys = {}
    for name, value in assigns.items():
        if name.endswith("_DEFAULT") or not isinstance(value, ast.Constant) \
                or not isinstance(value.value, str):
            continue
        if f"{name}_DEFAULT" in assigns:
            keys[name] = value.value
    return keys


def _referenced_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


class ConfigKeysPass:
    pass_id = "config-keys"

    def __init__(self, package_dir):
        self.package_dir = package_dir

    def run(self):
        constants_path = os.path.join(self.package_dir, "runtime", "constants.py")
        keys = declared_key_constants(constants_path)
        referenced = set()
        for rel in CONSUMER_RELPATHS:
            path = os.path.join(self.package_dir, rel)
            if os.path.exists(path):
                referenced |= _referenced_names(path)
        out = []
        for name in sorted(keys):
            if name in referenced:
                continue
            out.append(Violation(
                self.pass_id, "unreachable-key",
                f"runtime/constants.py::{name}",
                f"config key constant {name} (json key {keys[name]!r}) has a "
                "_DEFAULT but is never referenced from any config-consuming "
                "module — users can set a key nothing reads",
                details={"json_key": keys[name]}))
        return out
