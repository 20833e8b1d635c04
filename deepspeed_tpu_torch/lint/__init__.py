"""Static-analysis lint suite over the port's recorded programs and source
(the counterpart of ``deepspeed_tpu/lint/``).

Two analysis surfaces share one violation/report model (``model.py``):

- **Program passes** (``program_passes.py``) run over programs recorded at
  the dispatcher (``utils/op_record.py``: one executed call each) and check
  in-place state updates (the port's donation), per-program collective
  budgets, and dtype promotion (float32 products and lossy conversion
  round trips inside a declared low-precision region).
- **AST passes** (``ast_passes.py``) generalize the no-sync guard: forbidden
  host-sync calls, host casts reachable from code a CUDA graph captures or a
  dispatcher op runs, and clock reads there.

``config_pass.py`` adds the config-key reachability pass; ``registry.py``
builds the test-scale engines whose programs ``ds-tpu-torch lint`` checks;
``cli.py`` is the subcommand.
"""

from .model import Allowlist, LintReport, Violation  # noqa: F401
