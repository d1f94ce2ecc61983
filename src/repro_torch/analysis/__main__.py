"""CLI: lint the serve surface, write the report, gate on the baseline.

Exit code 1 iff any finding is not suppressed by the baseline (with
``--fail-on-new``; without it the run is informational). ``--ranks N``
spawns N gloo ranks on this host for the sharding pass (a (2, N/2)
``(data, model)`` mesh), as ``launch/train.py --mesh`` spawns its ranks;
``--no-sharding`` leaves the pass out.

    PYTHONPATH=src python -m repro_torch.analysis --fail-on-new --ranks 4
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis over the CHORDS serve surface of the "
                    "PyTorch/CUDA port.")
    p.add_argument("--out", default="results/analysis_report_torch.json",
                   help="report path (default: %(default)s)")
    p.add_argument("--baseline", default=None,
                   help="suppression baseline (default: the checked-in "
                        "src/repro_torch/analysis/baseline.json)")
    p.add_argument("--fail-on-new", action="store_true",
                   help="exit 1 on any finding not in the baseline")
    p.add_argument("--update-baseline", metavar="JUSTIFICATION",
                   help="rewrite the baseline from this run's findings, "
                        "tagging NEW entries with the given justification "
                        "(existing justifications are kept)")
    p.add_argument("--smem-budget-kb", type=float, default=227.0,
                   help="shared memory a block may use, for the launch "
                        "pass (default: %(default)s, an H100)")
    p.add_argument("--sms", type=int, default=132,
                   help="SMs of the card ssd_chunk's head group is picked "
                        "for (default: %(default)s, an H100 SXM)")
    p.add_argument("--ranks", type=int, default=4,
                   help="gloo ranks to spawn for the sharding pass "
                        "(default: %(default)s)")
    p.add_argument("--no-sharding", action="store_true",
                   help="skip the sharding pass (single-process quick run)")
    args = p.parse_args(argv)

    from repro_torch.analysis import BASELINE_PATH, Baseline, run_all
    from repro_torch.analysis.report import SEVERITIES

    baseline_path = args.baseline or BASELINE_PATH
    baseline = Baseline.load(baseline_path)
    report = run_all(smem_budget_bytes=int(args.smem_budget_kb * 1024),
                     sharding=not args.no_sharding, sms=args.sms,
                     ranks=args.ranks)
    doc = report.write(args.out, baseline)
    new = report.new_findings(baseline)

    counts = " ".join(f"{s}={doc['counts'][s]}" for s in SEVERITIES)
    print(f"repro_torch.analysis: {len(report.meta['programs'])} programs, "
          f"{len(report.meta['kernels'])} kernel cases -> "
          f"{len(report.findings)} finding(s) [{counts}], "
          f"{len(new)} new vs baseline ({len(baseline.keys)} suppressed)")
    stale = doc.get("baseline", {}).get("stale_entries", [])
    if stale:
        print(f"  note: {len(stale)} stale baseline entr(ies) no longer "
              f"produced: {', '.join(stale)}")
    for f in new:
        print(f"  NEW [{f.severity}] {f.key}: {f.message}")
    print(f"report: {args.out}")

    if args.update_baseline:
        keep = {e["key"]: e["justification"] for e in baseline.entries}
        entries = [{"key": k, "justification": keep.get(
                        k, args.update_baseline)}
                   for k in sorted({f.key for f in report.findings})]
        Baseline(keys={e["key"] for e in entries},
                 entries=entries).write(baseline_path)
        print(f"baseline rewritten: {baseline_path} "
              f"({len(entries)} entries)")
        return 0

    if args.fail_on_new and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
