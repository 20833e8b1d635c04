"""Two-level comm schedule simulator: ``ds-tpu-torch comm-sim``.

Counterpart of ``deepspeed_tpu/comm/sim.py``. Records the engine's
data-parallel gradient-exchange programs for the three comm modes at 8 ranks
factorized as 2 slices x 4 (torch's fake process group: this process is
rank 0, the collectives dispatch and are recorded at the dispatcher by
``utils/op_record.py``, and no data moves), classifies every collective by
its process group (intra-slice when its ranks lie in one slice, else
cross-slice: the JAX report's ``ici`` / ``dcn``), and emits a deterministic
JSON report of per-level collective counts and wire bytes (each op's result
bytes, what one rank receives). The report is a function of the recorded
op sequence alone, so two runs give the same bytes.

The embedded manifest pins the schedule's shape, as the JAX one:

- flat mode ships its full float32 exchange across the slices (the world
  group spans both);
- hierarchical mode moves the bulk inside the slices (reduce-scatter and
  all-gather) and leaves one all-reduce of a slice chunk across them;
- compressed mode replaces that all-reduce with the 1-bit exchange and must
  cut cross-slice bytes by at least ``MIN_DCN_REDUCTION`` against flat.

The counts and bytes differ from the JAX report where the programs do: XLA
fuses the flat mode's per-leaf all-reduces into one, the port issues one
per leaf. Any violation exits nonzero.
"""

import argparse
import json
import sys

MIN_DCN_REDUCTION = 8.0     # acceptance floor: compressed dcn bytes vs flat
WORLD = 8                   # ranks the simulator records at

# Expected per-level schedule shape, pinned per program. "ops" maps op ->
# level -> (min_count, max_count); "dcn_bytes_max_frac" bounds the program's
# cross-slice bytes as a fraction of the flat baseline's.
MANIFEST = {
    "flat:loss_and_grad": {
        "ops": {"all-reduce": {"dcn": (1, None)}},
        "ici_bytes_max": 0,      # flat mode may not touch the intra-slice level
    },
    "hierarchical:loss_and_grad": {
        "ops": {
            "reduce-scatter": {"ici": (1, None)},
            "all-reduce": {"dcn": (1, None)},
            "all-gather": {"ici": (1, None)},
        },
        "dcn_bytes_max_frac": 0.5,   # only 1/slice_size of the vector crosses
    },
    "compressed:loss_and_grad_comm": {
        "ops": {
            "reduce-scatter": {"ici": (1, None)},
            "all-to-all": {"dcn": (1, None)},    # 1-bit worker->server phase
            "all-gather": {"ici": (1, None), "dcn": (1, None)},
        },
        "dcn_bytes_max_frac": 1.0 / MIN_DCN_REDUCTION,
    },
}


def _build_engine(comm_cfg):
    import deepspeed_tpu_torch
    from ..lint.registry import LintModel, _config, _sample_batch

    overrides = {"zero_optimization": {"stage": 1}}
    if comm_cfg:
        overrides["comm"] = comm_cfg
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LintModel(), config_params=_config(**overrides), device="cpu")
    return eng, _sample_batch()


def collective_breakdown(program, slice_sets):
    """``{op: {"ici": {"count", "bytes"}, "dcn": {...}}}`` of a recorded
    program's collectives: an op is intra-slice when its group's ranks lie in
    one slice set (the JAX ``collective_axis_breakdown``)."""
    from ..utils.op_record import dtype_bytes
    sets = [frozenset(s) for s in slice_sets]
    out = {}
    for r in program.ops:
        if r.kind is None:
            continue
        nbytes = sum(n * (dtype_bytes(dt) or 0) for dt, n in r.results)
        group = set(r.group) if r.group is not None else None
        intra = (len(sets) <= 1) if group is None else any(group <= s for s in sets)
        lvl = out.setdefault(r.kind, {"ici": {"count": 0, "bytes": 0},
                                      "dcn": {"count": 0, "bytes": 0}})
        lvl["ici" if intra else "dcn"]["count"] += 1
        lvl["ici" if intra else "dcn"]["bytes"] += nbytes
    return out


def build_report(num_slices=2):
    """The comm-sim report dict, recorded in a fake world of ``WORLD`` ranks."""
    from ..utils.op_record import fake_world, record
    from .topology import CommTopology

    modes = [
        ("flat", None, "loss_and_grad"),
        ("hierarchical", {"mode": "hierarchical", "dcn_slices": num_slices},
         "loss_and_grad"),
        ("compressed", {"mode": "hierarchical_compressed", "dcn_slices": num_slices},
         "loss_and_grad_comm"),
    ]
    topo = CommTopology(WORLD, num_slices)
    slice_sets = [sorted(s) for s in topo.slice_rank_sets()]
    programs = {}
    with fake_world(WORLD):
        for mode, comm_cfg, prog_name in modes:
            eng, batch = _build_engine(comm_cfg)
            progs = {n: (fn, a) for n, fn, a, _m in eng.lint_programs(batch)}
            if prog_name not in progs:
                raise RuntimeError(f"{mode}: program {prog_name!r} not on the step path "
                                   f"({sorted(progs)})")
            fn, args = progs[prog_name]
            breakdown = collective_breakdown(record(fn, *args), slice_sets)
            totals = {lvl: sum(ops[lvl]["bytes"] for ops in breakdown.values())
                      for lvl in ("ici", "dcn")}
            programs[f"{mode}:{prog_name}"] = {
                "collectives": {op: breakdown[op] for op in sorted(breakdown)},
                "ici_bytes": totals["ici"],
                "dcn_bytes": totals["dcn"],
            }
    flat_dcn = programs["flat:loss_and_grad"]["dcn_bytes"]
    comp_dcn = programs["compressed:loss_and_grad_comm"]["dcn_bytes"]
    report = {
        "mesh": {"devices": topo.dp, "dp": topo.dp, "num_slices": topo.num_slices,
                 "slice_size": topo.slice_size, "slice_device_sets": slice_sets},
        "programs": programs,
        "dcn_reduction_vs_flat": round(flat_dcn / comp_dcn, 3) if comp_dcn else None,
        "min_dcn_reduction": MIN_DCN_REDUCTION,
    }
    report["violations"] = _check(report)
    report["ok"] = not report["violations"]
    return report


def _check(report):
    """Manifest violations of a report (empty: the schedule's shape holds)."""
    out = []
    flat_dcn = report["programs"]["flat:loss_and_grad"]["dcn_bytes"]
    for name, man in MANIFEST.items():
        prog = report["programs"].get(name)
        if prog is None:
            out.append(f"{name}: program missing from report")
            continue
        for op, levels in man.get("ops", {}).items():
            got = prog["collectives"].get(op, {})
            for lvl, (lo, hi) in levels.items():
                n = got.get(lvl, {}).get("count", 0)
                if lo is not None and n < lo:
                    out.append(f"{name}: {op}[{lvl}] count {n} < min {lo}")
                if hi is not None and n > hi:
                    out.append(f"{name}: {op}[{lvl}] count {n} > max {hi}")
        if "ici_bytes_max" in man and prog["ici_bytes"] > man["ici_bytes_max"]:
            out.append(f"{name}: ici bytes {prog['ici_bytes']} > {man['ici_bytes_max']}")
        frac = man.get("dcn_bytes_max_frac")
        if frac is not None and flat_dcn and prog["dcn_bytes"] > flat_dcn * frac:
            out.append(f"{name}: dcn bytes {prog['dcn_bytes']} > {frac} * flat {flat_dcn}")
    red = report["dcn_reduction_vs_flat"]
    if red is None or red < MIN_DCN_REDUCTION:
        out.append(f"compressed dcn reduction {red} < floor {MIN_DCN_REDUCTION}x vs flat")
    return out


def render(report):
    """Deterministic bytes: sorted keys, no floats beyond the rounded ratio."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ds-tpu-torch comm-sim",
        description="Record the two-level exchange at 8 ranks (a fake process group) "
                    "and check the per-level byte manifest.")
    ap.add_argument("--json", action="store_true",
                    help="print the full JSON report (default: summary line)")
    ap.add_argument("--out", default=None, help="also write the JSON report to this path")
    ap.add_argument("--num-slices", type=int, default=2,
                    help="slice factorization of the 8 ranks (default 2)")
    args = ap.parse_args(argv)

    from ..utils.logging import log_to_stderr
    log_to_stderr()          # stdout belongs to the report
    report = build_report(num_slices=args.num_slices)
    text = render(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.json:
        sys.stdout.write(text)
    else:
        red = report["dcn_reduction_vs_flat"]
        print(f"comm-sim: dcn_reduction_vs_flat={red}x (floor {MIN_DCN_REDUCTION}x), "
              f"{'OK' if report['ok'] else 'VIOLATIONS'}")
    for v in report["violations"]:
        print(f"comm-sim violation: {v}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
