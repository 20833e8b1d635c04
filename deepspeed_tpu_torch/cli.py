"""``ds-tpu-torch``: the port's command-line front end (``bin/ds-tpu``).

``ds-tpu-torch <sub-command> [args]`` runs one of the tools below;
anything else is a launch, ``ds-tpu-torch [launcher args] script.py
[script args]`` (``launcher/runner.py``). The sub-commands that read files
only (``inspect-dump``, ``timeline``, ``cluster-dump``, ``goodput``,
``alerts``, ``metrics``, ``serve-timeline``) need no card; ``lint``,
``anatomy``, ``hbm``, ``profile --reconcile``, ``serve-sim`` and
``crash-sim`` build engines on the card unless told ``--device cpu``;
``comm-sim`` records its engines on the CPU in a fake process group of 8
ranks.
"""

import sys

# sub-command -> (module, function)
COMMANDS = {
    "inspect-dump": ("deepspeed_tpu_torch.utils.numerics", "inspect_dump_main"),
    "timeline": ("deepspeed_tpu_torch.utils.pipeline_trace", "timeline_main"),
    "cluster-dump": ("deepspeed_tpu_torch.utils.cluster", "cluster_dump_main"),
    "hang-sim": ("deepspeed_tpu_torch.utils.cluster", "hang_sim_main"),
    "goodput": ("deepspeed_tpu_torch.utils.goodput", "goodput_main"),
    "alerts": ("deepspeed_tpu_torch.utils.alerts", "alerts_main"),
    "metrics": ("deepspeed_tpu_torch.utils.metrics", "metrics_main"),
    "alert-sim": ("deepspeed_tpu_torch.utils.alerts", "alert_sim_main"),
    "serve-timeline": ("deepspeed_tpu_torch.serve.request_trace", "serve_timeline_main"),
    "lint": ("deepspeed_tpu_torch.lint.cli", "main"),
    "anatomy": ("deepspeed_tpu_torch.utils.anatomy", "anatomy_main"),
    "hbm": ("deepspeed_tpu_torch.utils.hbm", "hbm_main"),
    "profile": ("deepspeed_tpu_torch.utils.profile_ingest", "profile_main"),
    "serve-sim": ("deepspeed_tpu_torch.serve.sim", "main"),
    "crash-sim": ("deepspeed_tpu_torch.resilience.crash_sim", "main"),
    "comm-sim": ("deepspeed_tpu_torch.comm.sim", "main"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in COMMANDS:
        import importlib
        module, fn = COMMANDS[argv[0]]
        return getattr(importlib.import_module(module), fn)(argv[1:])
    from .launcher.runner import main as run
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
