"""CLI for the distributed-invariant static analyzer.

``python -m h2o3_tpu_torch.analysis [options] [root]`` — see the package
docstring for the pass table. Exit codes: 0 clean (all findings
baselined or none), 1 findings (or baseline-hygiene problems), 2 usage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from h2o3_tpu_torch import analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m h2o3_tpu_torch.analysis",
        description="The port's invariant analyzer "
                    "(mirrored programs, lock order, serialization, "
                    "compat routing, compile ledger, sync hygiene + "
                    "registry guards) over h2o3_tpu_torch/.")
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--select", default=None, metavar="P1,P2",
                    help="comma-separated pass subset")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline file (default: <root>/"
                         f"{analysis.BASELINE_NAME})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept current baselineable findings into the "
                         "baseline (preserving existing notes)")
    ap.add_argument("--list", action="store_true", dest="list_passes",
                    help="list available passes and exit")
    args = ap.parse_args(argv)

    if args.list_passes:
        for name in analysis.PASSES:
            print(name)
        return 0

    passes = [p.strip() for p in args.select.split(",")] \
        if args.select else None
    t0 = time.perf_counter()
    try:
        new, baselined, problems = analysis.run_repo(
            root=Path(args.root) if args.root else None,
            passes=passes,
            baseline=Path(args.baseline) if args.baseline else None)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    if args.update_baseline:
        ctx_root = Path(args.root) if args.root else \
            Path(analysis.__file__).resolve().parents[2]
        bl_path = Path(args.baseline) if args.baseline else \
            ctx_root / analysis.BASELINE_NAME
        old_entries = analysis.load_baseline(bl_path)
        old = {e.get("fingerprint"): e.get("note", "")
               for e in old_entries}
        keep = [f for f in new + baselined
                if f.pass_id in analysis.BASELINEABLE]
        # a --select run only re-derives entries for the SELECTED passes:
        # everything else carries over verbatim, or a partial update
        # would silently delete audited entries
        carried = [e for e in old_entries
                   if passes and e.get("pass") not in passes]
        analysis.save_baseline(bl_path, keep, notes=old,
                               keep_entries=carried)
        hard = [f for f in new if f.pass_id not in analysis.BASELINEABLE]
        print(f"baseline written: {bl_path} "
              f"({len(keep) + len(carried)} entries; fill in any TODO "
              f"notes)")
        for f in hard:
            print(f.render())
        return 1 if hard else 0

    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in new],
            "baseline_problems": [f.to_dict() for f in problems],
            "baselined": [dict(f.to_dict(), note=f.note)
                          for f in baselined],
            "elapsed_s": round(dt, 3),
        }, indent=2))
    else:
        for f in new + problems:
            print(f.render())
        print(f"-- {len(new)} finding(s), {len(problems)} baseline "
              f"problem(s), {len(baselined)} baselined, "
              f"{len(analysis.PASSES)} passes in {dt:.2f}s")
    return 1 if (new or problems) else 0


if __name__ == "__main__":
    sys.exit(main())
