"""Shared violation / allowlist / report model for both lint surfaces
(a copy of ``deepspeed_tpu/lint/model.py``: the same violations and
allowlist give the same report bytes).

A violation's identity is its ``vid`` — ``pass_id:rule:subject`` — and every
subject is constructed deterministically (repo-relative paths, program-local
ordinals, flat argument indices) so the same tree state always produces the
same report bytes. The allowlist is a declarative JSON file of fnmatch globs
over vids, each with a mandatory human reason; ``ds-tpu-torch lint`` exits nonzero
on any violation no glob covers, and reports (but does not fail on) allowlist
entries that matched nothing — a stale entry is how an invariant silently
stops being checked.
"""

import fnmatch
import json


class Violation:
    """One finding. ``severity`` is "error" (fails the run) or "warning"."""

    def __init__(self, pass_id, rule, subject, message, severity="error", details=None):
        self.pass_id = pass_id
        self.rule = rule
        self.subject = subject
        self.message = message
        self.severity = severity
        self.details = dict(details or {})

    @property
    def vid(self):
        return f"{self.pass_id}:{self.rule}:{self.subject}"

    def to_dict(self):
        d = {"id": self.vid, "pass": self.pass_id, "rule": self.rule,
             "subject": self.subject, "severity": self.severity,
             "message": self.message}
        if self.details:
            d["details"] = self.details
        return d

    def __repr__(self):
        return f"Violation({self.vid!r})"


class Allowlist:
    """Declarative vid allowlist: ``{"allow": [{"id": glob, "reason": str}]}``."""

    def __init__(self, entries=()):
        self.entries = []
        for e in entries:
            if not isinstance(e, dict) or "id" not in e or not e.get("reason"):
                raise ValueError(
                    f"allowlist entry needs 'id' and a non-empty 'reason': {e!r}")
            self.entries.append({"id": e["id"], "reason": e["reason"]})
        self._hits = {e["id"]: 0 for e in self.entries}

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or not isinstance(data.get("allow", []), list):
            raise ValueError(
                f"{path}: allowlist must be {{\"allow\": [{{'id', 'reason'}}, ...]}}")
        return cls(data.get("allow", []))

    def match(self, vid):
        """First entry whose glob covers ``vid`` (entry order is priority)."""
        for e in self.entries:
            if fnmatch.fnmatchcase(vid, e["id"]):
                self._hits[e["id"]] += 1
                return e
        return None

    def unused(self):
        return sorted(g for g, n in self._hits.items() if n == 0)


class LintReport:
    """Deterministic aggregate of one lint run.

    ``to_json()`` is byte-stable for a given repo state: no timestamps, sorted
    keys, violations ordered by vid then message.
    """

    def __init__(self):
        self.violations = []       # non-allowlisted
        self.allowlisted = []      # (violation, reason)
        self.passes = []           # pass ids that ran
        self.programs = []         # program names analyzed
        self.unused_allow = []

    def add(self, violation, allowlist=None):
        entry = allowlist.match(violation.vid) if allowlist is not None else None
        if entry is not None:
            self.allowlisted.append((violation, entry["reason"]))
        else:
            self.violations.append(violation)

    def extend(self, violations, allowlist=None):
        for v in violations:
            self.add(v, allowlist)

    def finish(self, allowlist=None):
        if allowlist is not None:
            self.unused_allow = allowlist.unused()

    @property
    def failed(self):
        return any(v.severity == "error" for v in self.violations)

    def to_dict(self):
        def key(v):
            return (v.vid, v.message)

        return {
            "passes": sorted(self.passes),
            "programs": sorted(self.programs),
            "violations": [v.to_dict() for v in sorted(self.violations, key=key)],
            "allowlisted": [dict(v.to_dict(), allow_reason=reason)
                            for v, reason in sorted(self.allowlisted,
                                                    key=lambda p: key(p[0]))],
            "unused_allowlist_entries": list(self.unused_allow),
            "summary": {
                "violations": len(self.violations),
                "allowlisted": len(self.allowlisted),
                "failed": self.failed,
            },
        }

    def to_json(self):
        return json.dumps(self.to_dict(), sort_keys=True, indent=2,
                          separators=(",", ": ")) + "\n"
