"""Trace-stability pass: the same spec must trace to the same graph — the
counterpart of ``repro.analysis.trace_check``.

The executor's one-build-per-spec cache (and on the card one CUDA graph
captured per spec) assumes that what a spec's program does is a pure
function of the spec. A closure that captures mutable Python state (a
counter, a per-call clock, a list being appended to) breaks that silently:
the cached program no longer matches what a fresh build would run. This
pass traces every program twice, each time through a fresh wrapper
(``graph_lint.trace``), and compares a fingerprint of the FX graph's code
and its constants' dtypes, shapes and bytes.

* ``unstable-trace`` — two traces of the same program differ (error).
"""
from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional

import torch

from repro_torch.analysis.graph_lint import trace
from repro_torch.analysis.report import Finding

PASS = "trace"


def graph_fingerprint(gm) -> str:
    """Digest of a traced program: its generated code, and every constant
    it holds (dtype, shape and bytes: two traces can share code yet bake
    different numbers)."""
    h = hashlib.sha256(gm.code.encode())
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        c = getattr(gm, node.target, None)
        if isinstance(c, torch.Tensor):
            c = c.detach().cpu().contiguous()
            h.update(str(c.dtype).encode())
            h.update(str(tuple(c.shape)).encode())
            h.update(c.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(c).encode())
    return h.hexdigest()


def _first_diff_line(a: str, b: str) -> str:
    for la, lb in zip(a.splitlines(), b.splitlines()):
        if la != lb:
            return f"{la.strip()!r} vs {lb.strip()!r}"
    return "(code identical; captured constants differ)"


def run(records: Iterable, first: Optional[list] = None) -> List[Finding]:
    """Trace every :class:`ProgramRecord` twice; flag any drift. ``first``
    may hold a first trace of each record, in order (``graph_lint.run``'s),
    which then counts as one of the two."""
    findings: List[Finding] = []
    for i, rec in enumerate(records):
        a = first[i] if first else trace(rec)[0]
        b = trace(rec)[0]
        if graph_fingerprint(a) != graph_fingerprint(b):
            findings.append(Finding(
                PASS, "unstable-trace", "error", rec.name,
                f"{rec.name}: two traces of the same spec differ — the "
                f"closure captures per-call Python state, so a cached "
                f"program is unsound. First divergence: "
                f"{_first_diff_line(a.code, b.code)}"))
    return findings
