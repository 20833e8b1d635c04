"""The flight recorder's dump reader (PyTorch port of the inspector part of
``deepspeed_tpu/utils/numerics.py:618-704``): host file I/O, copied, for
auto-resume (``resilience/auto_resume.py``). The recorder itself and the rest
of the numerics observatory are ROADMAP.md item 22.
"""

import json
import os
import re

# Both the legacy name (numerics_dump_host0_0.json) and the run-namespaced
# name (numerics_dump_<run>_host0_0.json) parse; legacy dumps group under the
# empty run key "". The run token never contains '_'.
DUMP_NAME_RE = re.compile(
    r"numerics_dump_(?:(?P<run>[^_]+)_)?host(?P<host>\d+)_(?P<idx>\d+)\.json$")


def scan_dump_dir_runs(dump_dir):
    """Group the flight-recorder dumps in ``dump_dir`` by run.

    Returns ``{run_key: [entry, ...]}`` where each entry is
    ``{"host", "index", "path", "mtime"}`` and each run's entries are sorted
    by (index, host). Legacy un-namespaced dumps land under run key ``""``.
    Pure host file I/O."""
    runs = {}
    if not dump_dir or not os.path.isdir(dump_dir):
        return runs
    for name in os.listdir(dump_dir):
        m = DUMP_NAME_RE.match(name)
        if not m:
            continue
        path = os.path.join(dump_dir, name)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        runs.setdefault(m.group("run") or "", []).append({
            "host": int(m.group("host")),
            "index": int(m.group("idx")),
            "path": path,
            "mtime": mtime,
        })
    for entries in runs.values():
        entries.sort(key=lambda e: (e["index"], e["host"]))
    return runs


def load_run_bundles(dump_dir, run=None):
    """Load the newest bundle per host for one run of a shared dump_dir.

    Picks the most recently written run when ``run`` is None. Returns
    ``(run_key, {host: bundle})``; torn dumps are skipped (an older intact
    dump from the same host wins, if any)."""
    runs = scan_dump_dir_runs(dump_dir)
    if not runs:
        return run, {}
    if run is None:
        run = max(runs, key=lambda k: max(e["mtime"] for e in runs[k]))
    elif run not in runs:
        return run, {}
    by_host = {}
    for entry in runs[run]:  # ascending (index, host): last intact one wins
        try:
            with open(entry["path"]) as f:
                by_host[entry["host"]] = json.load(f)
        except (OSError, ValueError):
            continue
    return run, by_host


def scan_dump_dir(dump_dir):
    """Newest flight-recorder bundle in ``dump_dir``, or None when the dir
    holds none. Dumps are grouped by run (see scan_dump_dir_runs); the most
    recently written run wins, then the highest (dump index, host) within it —
    the recorder numbers dumps monotonically per host. Pure host file I/O —
    the auto-resume path (resilience/auto_resume.py) calls this before any
    engine exists."""
    runs = scan_dump_dir_runs(dump_dir)
    if not runs:
        return None
    run = max(runs, key=lambda k: max(e["mtime"] for e in runs[k]))
    best = runs[run][-1]  # entries sorted by (index, host)
    try:
        with open(best["path"]) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # a torn dump must not block resume
