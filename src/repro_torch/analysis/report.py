"""Findings, reports, and the suppression baseline — port of
``repro.analysis.report`` with its JSON schema and keys.

Every analysis pass registers :class:`Finding`s into one :class:`Report`.
A finding's ``key`` is its *suppression identity* — stable across runs and
machines (pass name + code + location, no counts/addresses), so a
checked-in baseline (``baseline.json``) can pin the set of known, triaged
findings while anything NEW fails the gate (``python -m repro_torch.analysis
--fail-on-new``; see README.md for the triage workflow).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``pass_name`` is the pass that produced it (graph | launch | sharding |
    trace); ``code`` the violation class (e.g. ``ww-race``, ``dtype-64``);
    ``location`` the program/kernel it anchors to. ``key`` defaults to
    ``pass:code:location`` — include disambiguators IN the location (dtype,
    operand name), never volatile data (counts, values, object ids).
    """

    pass_name: str
    code: str
    severity: str
    location: str
    message: str
    key: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")
        if not self.key:
            object.__setattr__(
                self, "key", f"{self.pass_name}:{self.code}:{self.location}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """Aggregated findings from every pass of one analysis run."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def new_findings(self, baseline: "Baseline") -> List[Finding]:
        """Findings whose key the baseline does not suppress — the gate
        fails on ANY of these, regardless of severity (an info-level
        regression is still a regression; triage it or baseline it)."""
        return [f for f in self.findings if f.key not in baseline.keys]

    def to_json(self) -> dict:
        order = {s: i for i, s in enumerate(SEVERITIES)}
        ranked = sorted(self.findings,
                        key=lambda f: (order[f.severity], f.key))
        return {
            "meta": self.meta,
            "counts": {s: len(self.by_severity(s)) for s in SEVERITIES},
            "findings": [f.to_json() for f in ranked],
        }

    def write(self, path: str, baseline: Optional["Baseline"] = None) -> dict:
        doc = self.to_json()
        if baseline is not None:
            doc["baseline"] = {
                "path": baseline.path,
                "entries": len(baseline.keys),
                "new_findings": [f.to_json()
                                 for f in self.new_findings(baseline)],
                # baselined keys nothing produced anymore — prune these
                "stale_entries": sorted(
                    baseline.keys - {f.key for f in self.findings}),
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return doc


@dataclasses.dataclass
class Baseline:
    """Checked-in suppression list: every entry is a triaged finding we
    deliberately keep, with a one-line justification."""

    keys: set = dataclasses.field(default_factory=set)
    entries: List[dict] = dataclasses.field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            doc = json.load(f)
        entries = doc.get("findings", [])
        bad = [e for e in entries
               if not e.get("key") or not e.get("justification")]
        if bad:
            raise ValueError(
                f"baseline {path}: every entry needs a key AND a "
                f"justification, got {bad}")
        return cls(keys={e["key"] for e in entries}, entries=entries,
                   path=path)

    @classmethod
    def from_findings(cls, findings, justification: str) -> "Baseline":
        """Build an in-memory baseline from live findings (test helper /
        ``--update-baseline``)."""
        entries = [{"key": f.key, "justification": justification}
                   for f in findings]
        return cls(keys={e["key"] for e in entries}, entries=entries)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"findings": sorted(self.entries,
                                          key=lambda e: e["key"])},
                      f, indent=2, sort_keys=True)
            f.write("\n")
