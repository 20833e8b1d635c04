"""``ds-tpu-torch lint`` — run the static-analysis suite and emit a report
(the port's ``deepspeed_tpu/lint/cli.py``).

Two surfaces, one report:

* **AST passes** walk every ``.py`` file of the ``deepspeed_tpu_torch``
  package — host-sync calls, host casts and clock reads inside captured
  code and dispatcher ops, and config-key reachability. Pure host work.
* **Program passes** build the registry's test-scale engines (on ``cuda``
  unless ``--device cpu``), record every program on each engine's active
  path via ``engine.lint_programs``, and check in-place updates, collective
  budgets and dtype promotion against the engines' own manifests. Entries
  the port has not yet are named as skipped (on stderr, and in the text
  listing), never silently missing.

Violations matching ``allowlist.json`` (shipped next to this module;
override with ``--allowlist``) are reported but do not fail the run. Exit
status is 1 on any violation the allowlist does not cover **or** any
allowlist entry that matched nothing (a stale entry is how an invariant
silently stops being checked). ``--json`` output is byte-for-byte the same
for a given tree and device type: violations sorted by id, no timestamps,
no absolute paths.
"""

import argparse
import os
import sys

from .model import Allowlist, LintReport

_DEFAULT_ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "allowlist.json")


def _package_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _package_files(package_dir):
    out = []
    for dirpath, _dirnames, filenames in os.walk(package_dir):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def host_sync_files(package_dir):
    """The host-sync (no-perturbation) surface: ``utils/`` plus the serving
    request ledger; the data path syncs on purpose (the loss fetch)."""
    return [f for f in _package_files(package_dir)
            if f.startswith(os.path.join(package_dir, "utils") + os.sep)
            or f == os.path.join(package_dir, "serve", "request_trace.py")]


def run_ast_surface(report, allowlist, package_dir=None):
    from .ast_passes import (HostSyncPass, RecompileHazardPass, TracerHostilePass,
                             run_ast_passes)
    from .config_pass import ConfigKeysPass
    pkg = package_dir or _package_dir()
    root = os.path.dirname(pkg)
    host_sync = HostSyncPass()
    report.passes.append(host_sync.pass_id)
    report.extend(run_ast_passes(host_sync_files(pkg), (host_sync,), root=root), allowlist)
    passes = (TracerHostilePass(), RecompileHazardPass())
    report.passes += [p.pass_id for p in passes]
    report.extend(run_ast_passes(_package_files(pkg), passes, root=root), allowlist)
    config_pass = ConfigKeysPass(pkg)
    report.passes.append(config_pass.pass_id)
    report.extend(config_pass.run(), allowlist)


def run_program_surface(report, allowlist, entries=None, device="cuda", artifacts=None):
    """Capture and check every requested entry (default: the ported ones);
    returns the unported entries skipped, ``{entry: ROADMAP item}``. The
    artifacts are appended to ``artifacts`` when a list is given."""
    from . import registry
    from .program_passes import PROGRAM_PASSES, run_program_passes
    report.passes += [p.pass_id for p in PROGRAM_PASSES]
    names = list(entries) if entries else sorted(registry.BUILDERS)
    skipped = {e: registry.UNPORTED[e] for e in names if e in registry.UNPORTED}
    for entry in names:
        if entry in skipped:
            continue
        captured = registry.capture_entry(entry, device)
        n = registry.ENTRY_WORLD.get(entry)
        if n:
            print(f"captured {entry} at {n} ranks of the {registry.entry_axis(entry)} axis",
                  file=sys.stderr)
        report.programs += [a.name for a in captured]
        report.extend(run_program_passes(captured), allowlist)
        if artifacts is not None:
            artifacts.extend(captured)
    return skipped


def main(argv=None, artifacts=None):
    parser = argparse.ArgumentParser(
        prog="ds-tpu-torch lint",
        description="in-place / collective / dtype / host-sync static analysis over "
                    "the package and its recorded programs")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON on stdout")
    parser.add_argument("--out", metavar="PATH",
                        help="also write the JSON report to PATH")
    parser.add_argument("--allowlist", metavar="PATH", default=_DEFAULT_ALLOWLIST,
                        help="violation allowlist (default: the shipped one)")
    parser.add_argument("--ast-only", action="store_true",
                        help="skip the program surface (no engine builds)")
    parser.add_argument("--programs-only", action="store_true",
                        help="skip the AST surface")
    parser.add_argument("--entry", action="append", metavar="NAME",
                        help="limit the program surface to a registry entry (repeatable)")
    parser.add_argument("--device", default="cuda",
                        help="device the registry's engines run on (default: cuda)")
    args = parser.parse_args(argv)

    from ..utils.logging import log_to_stderr
    log_to_stderr()      # stdout belongs to the report
    allowlist = Allowlist.load(args.allowlist)
    report = LintReport()
    skipped = {}
    if not args.programs_only:
        run_ast_surface(report, allowlist)
    if not args.ast_only:
        skipped = run_program_surface(report, allowlist, entries=args.entry,
                                      device=args.device, artifacts=artifacts)
    report.finish(allowlist)
    # a partial run matches only part of the allowlist: an entry is stale
    # when the surface it belongs to ran in full and it matched nothing
    ast_ran = not args.programs_only
    programs_ran = not args.ast_only and not args.entry
    stale = [g for g in report.unused_allow
             if (programs_ran if g.startswith("program-") else ast_ran)]
    for entry, item in skipped.items():
        print(f"skipped {entry}: not in the PyTorch port yet (ROADMAP.md {item})",
              file=sys.stderr)

    text = report.to_json()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.json:
        sys.stdout.write(text)
    else:
        for v in sorted(report.violations, key=lambda v: (v.vid, v.message)):
            print(f"FAIL {v.vid}\n     {v.message}")
        for v, reason in sorted(report.allowlisted,
                                key=lambda p: (p[0].vid, p[0].message)):
            print(f"allow {v.vid} ({reason})")
        for vid in report.unused_allow:
            print(f"stale-allowlist {vid}")
        for entry, item in skipped.items():
            print(f"skipped {entry} ({item})")
        print(f"{len(report.violations)} violation(s), {len(report.allowlisted)} "
              f"allowlisted, {len(report.programs)} program(s), "
              f"{len(report.passes)} pass(es), {len(skipped)} entry(ies) skipped")
    return 1 if report.failed or stale else 0


if __name__ == "__main__":
    sys.exit(main())
