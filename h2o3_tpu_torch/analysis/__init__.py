"""The port's invariant analyzer: the JAX package's static analyzer
(h2o3_tpu/analysis/) read for ``h2o3_tpu_torch/``, which it alone scans.

The port's correctness rests on invariants no compiler checks: the
replay roots (a train, a score batch, a Rapids statement, a search
walk) must make the same decisions in every process that will replay
them (the multi-process control plane replays them), locks must nest in
one order, nothing may raw-unpickle external bytes, version-mobile
torch APIs and optional toolchains (``triton``, ``torch.export``,
``torch.utils.cpp_extension``) must be imported only through
``compat.py``/``kernels.py`` and only lazily (so the package imports on
a box without them), every CUDA-graph capture and ``torch.export`` must
land a compile-ledger row, trace spans must not smuggle device syncs,
and the registries (fault points, metrics, timeline kinds, lifecycle
phases, ``H2O_TPU_*`` knobs) must agree with their uses.

Usage::

    python -m h2o3_tpu_torch.analysis              # all passes
    python -m h2o3_tpu_torch.analysis --json       # machine-readable
    python -m h2o3_tpu_torch.analysis --select mirrored,lock-order
    python -m h2o3_tpu_torch.analysis --update-baseline

Exit code 0 = zero findings outside the baseline. The baseline
(``h2o3_tpu_torch/analysis/baseline.json``) may only carry
``sync-hygiene`` / ``compat-routing`` entries, each with a one-line
note; stale entries are findings themselves.

Everything is stdlib-``ast`` based: it imports neither torch nor JAX nor
the JAX package, and a whole-port run takes well under 10 s.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from h2o3_tpu_torch.analysis.core import (BASELINE_NAME, BASELINEABLE, Context,
                                    Finding, apply_baseline, load_baseline,
                                    make_context, save_baseline)

__all__ = ["Finding", "Context", "PASSES", "make_context", "run",
           "run_repo", "load_baseline", "save_baseline", "apply_baseline",
           "BASELINE_NAME", "BASELINEABLE"]


def _passes() -> Dict[str, object]:
    from h2o3_tpu_torch.analysis import (passes_locks, passes_mirrored,
                                   passes_misc, passes_registries)

    return {
        "mirrored": passes_mirrored.run,
        "lock-order": passes_locks.run,
        "serialization": passes_misc.run_serialization,
        "compat-routing": passes_misc.run_compat,
        "compile-ledger": passes_misc.run_compile_ledger,
        "sync-hygiene": passes_misc.run_sync_hygiene,
        "faultpoints": passes_registries.run_faultpoints,
        "metric-registry": passes_registries.run_metric_registry,
        "timeline-kinds": passes_registries.run_timeline_kinds,
        "knob-docs": passes_registries.run_knob_docs,
    }


PASSES = _passes()


def run(ctx: Context, passes: Optional[List[str]] = None) -> List[Finding]:
    """Run the selected passes (default: all) over `ctx`, deduplicated
    and ordered by (file, line, pass)."""
    selected = list(PASSES) if passes is None else list(passes)
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; "
                         f"available: {sorted(PASSES)}")
    findings: List[Finding] = []
    seen = set()
    for name in selected:
        for f in PASSES[name](ctx):
            key = (f.pass_id, f.file, f.line, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    findings.sort(key=lambda f: (f.file, f.line, f.pass_id, f.message))
    return findings


def run_repo(root: Optional[Path] = None,
             passes: Optional[List[str]] = None,
             baseline: Optional[Path] = None):
    """One-call repo run: returns ``(new_findings, baselined, problems)``
    where `new_findings` must be empty for a clean exit, `baselined` are
    accepted findings (note attached) and `problems` are baseline-hygiene
    findings (stale entries, illegal passes, missing notes)."""
    ctx = make_context(root)
    findings = run(ctx, passes)
    bl_path = Path(baseline) if baseline else ctx.root / BASELINE_NAME
    entries = load_baseline(bl_path)
    if passes is not None:
        # a partial run produces findings for the SELECTED passes only —
        # judging the whole baseline against it would misreport every
        # unselected pass's entry as stale
        entries = [e for e in entries if e.get("pass") in passes]
    covered_before = list(findings)
    new, problems = apply_baseline(findings, entries)
    baselined = [f for f in covered_before if f not in new]
    return new, baselined, problems
