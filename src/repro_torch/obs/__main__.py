"""CLI over obs artifacts: ``python -m repro_torch.obs <command> ...`` (the
reference's ``python -m repro.obs``).

* ``summarize TRACE`` — per-phase time breakdown, event counts, top
  round-gap and rollback offenders.
* ``diff A B [--threshold T]`` — regression deltas between two metrics
  snapshots (bare snapshot files or traces with embedded snapshots); exit
  1 when any lower-is-better metric's relative increase exceeds T.
* ``check TRACE [--max-gap-s S] [--max-rollbacks N]`` — machine-verify the
  async-serve timing contracts (structure, round-gap, host-sync
  amortization, rollback bounds) from the trace itself; exit 1 on any
  failed contract.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import check as check_mod
from repro_torch.obs import load_snapshot, load_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("summarize", help="per-phase breakdown of a trace")
    ps.add_argument("trace")
    ps.add_argument("--top", type=int, default=5,
                    help="offenders to list (default: %(default)s)")

    pd = sub.add_parser("diff", help="regression deltas between snapshots")
    pd.add_argument("a", help="baseline snapshot/trace")
    pd.add_argument("b", help="candidate snapshot/trace")
    pd.add_argument("--threshold", type=float, default=0.25,
                    help="relative increase on a lower-is-better metric "
                         "that counts as a regression (default: "
                         "%(default)s)")

    pc = sub.add_parser("check", help="verify serve timing contracts")
    pc.add_argument("trace")
    pc.add_argument("--max-gap-s", type=float, default=0.25,
                    help="mean busy-grid dispatch gap bound in seconds "
                         "(default: %(default)s)")
    pc.add_argument("--max-rollbacks", type=int, default=None,
                    help="absolute speculation-rollback cap (default: "
                         "bounded-only; deterministic rtol=0 traces "
                         "should pass 0)")
    args = p.parse_args(argv)

    if args.cmd == "summarize":
        doc = load_trace(args.trace)
        print(f"obs summarize: {args.trace}")
        for line in check_mod.summarize(doc, top=args.top):
            print(line)
        return 0

    if args.cmd == "diff":
        snap_a, snap_b = load_snapshot(args.a), load_snapshot(args.b)
        lines, regressions = check_mod.diff(snap_a, snap_b,
                                            threshold=args.threshold)
        print(f"obs diff: {args.a} -> {args.b} "
              f"(threshold {args.threshold:.0%})")
        for line in lines:
            print(line)
        if regressions:
            print(f"{len(regressions)} regression(s): "
                  + ", ".join(regressions))
            return 1
        print("no regressions")
        return 0

    doc = load_trace(args.trace)
    ok, lines = check_mod.check(doc, max_gap_s=args.max_gap_s,
                                max_rollbacks=args.max_rollbacks)
    print(f"obs check: {args.trace}")
    for line in lines:
        print(line)
    print("obs check: " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
