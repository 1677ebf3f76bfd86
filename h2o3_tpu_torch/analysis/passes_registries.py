"""Registry passes (the port's copies of those in
h2o3_tpu/analysis/passes_registries.py), each over ``h2o3_tpu_torch/``:

- **faultpoints** — every fault point a port test arms
  (``inject("name")``) exists in the port, and every
  ``failure.faultpoint("name")`` in the port is armed by some port test
  (``registry.TEST_FILES``): a renamed fault point silently defuses its
  chaos test, and an unarmed one guards a path no test drives;
- **metric-registry** — metric names unique and ``^h2o3_[a-z0-9_]+$``,
  every name the port emits (``inc``/``observe``/``set_gauge``) is
  registered in ``obs/metrics.py``, and every directly registered
  counter, gauge or histogram is emitted somewhere (collector-backed
  ``*_fn`` series emit through their callbacks), unless
  ``registry.METRICS_RESERVED`` names it with its reason;
- **timeline-kinds** — every recorded timeline kind is declared in
  ``utils/timeline.py KINDS`` and every declared kind is recorded; the
  same for the lifecycle phases of ``obs/phases.py PHASES``;
- **knob-docs** — every ``H2O_TPU_*`` knob the port reads is documented
  in README.md's port section (``registry.README_SECTION`` to the end),
  not merely in the JAX package's index above it.
"""

from __future__ import annotations

import ast
import re
from collections import Counter
from typing import List

from h2o3_tpu_torch.analysis.core import (PKG, REGISTRY_FILE, Context,
                                          Finding)

_MIN_METRICS = 20

# the one source-scan pattern for metric registrations
METRIC_REG_PAT = re.compile(
    r"\br\.(?:counter|gauge|histogram)(?:_fn)?\(\s*['\"]([^'\"]+)['\"]")
_DIRECT_REG_PAT = re.compile(
    r"\br\.(?:counter|gauge|histogram)\(\s*['\"]([^'\"]+)['\"]")
_EMIT_PAT = re.compile(
    r"\b(?:metrics|obs_metrics)\.(?:inc|observe|set_gauge)\(\s*"
    r"['\"]([^'\"]+)['\"]"
    r"|\b_metric\(\s*['\"](?:inc|observe|set_gauge)['\"]\s*,\s*"
    r"['\"]([^'\"]+)['\"]")
_FAULT_PAT = re.compile(r"faultpoint\(\s*['\"]([^'\"]+)['\"]")


def _src_texts(ctx: Context):
    """The port's modules, the analyzer's own left out (its registry and
    messages quote names)."""
    for mod in ctx.project.modules.values():
        if mod.rel.startswith(f"{PKG}/") and \
                not mod.rel.startswith(f"{PKG}/analysis/"):
            yield mod


def _test_texts(ctx: Context):
    if ctx.tests_dir is None:
        return
    seen = set()
    for pat in ctx.reg("TEST_FILES", ("test_torch_*.py",)):
        for p in sorted(ctx.tests_dir.rglob(pat)):
            if "__pycache__" in p.parts or p in seen:
                continue
            seen.add(p)
            rel = p.relative_to(ctx.root).as_posix()
            if rel in ctx.reg("FAULTPOINT_SCAN_EXCLUDE", ()):
                continue
            yield rel, p.read_text(encoding="utf-8", errors="replace")


def run_faultpoints(ctx: Context) -> List[Finding]:
    defined = {}
    for mod in _src_texts(ctx):
        for m in _FAULT_PAT.finditer(mod.text):
            defined.setdefault(m.group(1), mod.rel)
    armed = {}
    inline = set()
    for rel, text in _test_texts(ctx):
        for name in re.findall(r"\binject\(\s*['\"]([^'\"]+)['\"]", text):
            armed.setdefault(name, rel)
        for name in re.findall(r"_FAULTS\[\s*['\"]([^'\"]+)['\"]\s*\]",
                               text):
            armed.setdefault(name, rel)
        # mechanism self-tests define throwaway faultpoints inline
        inline |= set(_FAULT_PAT.findall(text))
    findings = [Finding("faultpoints", rel, 0,
                        f"test arms faultpoint `{name}` that no longer "
                        f"exists in {PKG}/ — a renamed faultpoint silently "
                        f"defuses its chaos tests", symbol=name,
                        snippet=name)
                for name, rel in sorted(armed.items())
                if name not in defined and name not in inline]
    findings += [Finding("faultpoints", rel, 0,
                         f"faultpoint `{name}` is armed by no port test — "
                         f"the failure path it guards is never driven; "
                         f"add a test that injects it", symbol=name,
                         snippet=name)
                 for name, rel in sorted(defined.items())
                 if name not in armed]
    return findings


def run_metric_registry(ctx: Context) -> List[Finding]:
    names: Counter = Counter()
    where = {}
    direct = set()
    emitted = {}
    for mod in _src_texts(ctx):
        for m in METRIC_REG_PAT.finditer(mod.text):
            names[m.group(1)] += 1
            where.setdefault(m.group(1), mod.rel)
        direct |= set(_DIRECT_REG_PAT.findall(mod.text))
        for m in _EMIT_PAT.finditer(mod.text):
            emitted.setdefault(m.group(1) or m.group(2), mod.rel)
    findings: List[Finding] = []
    if not names:
        findings.append(Finding("metric-registry", f"{PKG}/", 0,
                                "no metric registrations found",
                                snippet="none"))
        return findings
    for n in sorted(names):
        if not re.match(r"^h2o3_[a-z0-9_]+$", n):
            findings.append(Finding(
                "metric-registry", where[n], 0,
                f"metric name `{n}` does not match ^h2o3_[a-z0-9_]+$ — "
                f"Prometheus scrapes reject it", symbol=n, snippet=n))
        if names[n] > 1:
            findings.append(Finding(
                "metric-registry", where[n], 0,
                f"metric `{n}` registered {names[n]} times — the registry "
                f"raises on the second registration", symbol=n,
                snippet=n))
    for n, rel in sorted(emitted.items()):
        if n not in names:
            findings.append(Finding(
                "metric-registry", rel, 0,
                f"metric `{n}` is emitted but never registered in "
                f"obs/metrics.py — its samples go nowhere", symbol=n,
                snippet=n))
    reserved = ctx.reg("METRICS_RESERVED", {})
    for n in sorted(set(reserved) - (direct - set(emitted))):
        findings.append(Finding(
            "metric-registry", REGISTRY_FILE, 0,
            f"METRICS_RESERVED entry `{n}` is stale (emitted, or not a "
            f"direct registration) — drop it", symbol=n, snippet=n))
    for n in sorted(direct - set(emitted) - set(reserved)):
        findings.append(Finding(
            "metric-registry", where[n], 0,
            f"metric `{n}` is registered but nothing emits it — a dead "
            f"series on /3/Metrics; emit it or drop it", symbol=n,
            snippet=n))
    if len(names) < _MIN_METRICS:
        findings.append(Finding(
            "metric-registry", f"{PKG}/obs/metrics.py", 0,
            f"only {len(names)} metrics registered — /3/Metrics promises "
            f">= {_MIN_METRICS} series", snippet="count"))
    return findings


def _declared(ctx: Context, modname: str, var: str) -> set:
    mod = ctx.project.modules.get(modname)
    if mod is None:
        return set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == var:
            return {n.value for n in ast.walk(node.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    return set()


def run_timeline_kinds(ctx: Context) -> List[Finding]:
    declared = _declared(ctx, f"{PKG}.utils.timeline", "KINDS")
    call_pat = re.compile(
        r"\btimeline\.(?:record|task)\(\s*['\"]([^'\"]+)['\"]")
    bare_pat = re.compile(r"(?<![\w.])record\(\s*['\"]([^'\"]+)['\"]")
    used = {}
    for mod in _src_texts(ctx):
        for m in call_pat.finditer(mod.text):
            used.setdefault(m.group(1), mod.rel)
        if mod.rel.endswith("utils/timeline.py"):
            for m in bare_pat.finditer(mod.text):
                used.setdefault(m.group(1), mod.rel)
    findings = [Finding("timeline-kinds", rel, 0,
                        f"timeline kind `{k}` is recorded but not "
                        f"declared in utils/timeline.py KINDS (the "
                        f"enumeration is the ring's query surface)",
                        symbol=k, snippet=k)
                for k, rel in sorted(used.items()) if k not in declared]
    for k in sorted(declared - set(used) - {"rest"}):
        findings.append(Finding(
            "timeline-kinds", f"{PKG}/utils/timeline.py", 0,
            f"timeline kind `{k}` is declared in KINDS but never "
            f"recorded — drop it or record it", symbol=k, snippet=k))
    findings.extend(_phase_name_findings(ctx))
    return findings


def _phase_name_findings(ctx: Context) -> List[Finding]:
    """Every phase literal passed to obs.phases ``enter`` is declared in
    ``obs/phases.py PHASES``, and every declared phase is entered
    somewhere — a dead phase name makes /3/Runtime's table lie."""
    declared = _declared(ctx, f"{PKG}.obs.phases", "PHASES")
    enter_pat = re.compile(
        r"\bphases\.(?:enter|first)\(\s*['\"]([^'\"]+)['\"]")
    used = {}
    for mod in _src_texts(ctx):
        for m in enter_pat.finditer(mod.text):
            used.setdefault(m.group(1), mod.rel)
    if not declared and not used:
        return []
    findings = [Finding(
        "timeline-kinds", rel, 0,
        f"lifecycle phase `{p}` is entered but not declared in "
        f"obs/phases.py PHASES (closed enumeration)", symbol=p, snippet=p)
        for p, rel in sorted(used.items()) if p not in declared]
    reserved = ctx.reg("PHASES_RESERVED", {})
    for p in sorted(set(reserved) - (declared - set(used))):
        findings.append(Finding(
            "timeline-kinds", REGISTRY_FILE, 0,
            f"PHASES_RESERVED entry `{p}` is stale (entered, or not "
            f"declared) — drop it", symbol=p, snippet=p))
    for p in sorted(declared - set(used) - set(reserved)):
        findings.append(Finding(
            "timeline-kinds", f"{PKG}/obs/phases.py", 0,
            f"lifecycle phase `{p}` is declared in PHASES but never "
            f"entered — drop it or wrap its boot step", symbol=p,
            snippet=p))
    return findings


def run_knob_docs(ctx: Context) -> List[Finding]:
    used = {}
    for mod in _src_texts(ctx):
        for m in re.finditer(r"\bH2O_TPU_[A-Z0-9_]+\b", mod.text):
            used.setdefault(m.group(0), mod.rel)
    readme = ctx.root / "README.md"
    documented = set()
    if readme.is_file():
        text = readme.read_text(encoding="utf-8", errors="replace")
        head = ctx.reg("README_SECTION", "## PyTorch/CUDA port")
        at = text.find(head)
        documented = set(re.findall(r"\bH2O_TPU_[A-Z0-9_]+\b",
                                    text[at:] if at >= 0 else ""))
    return [Finding("knob-docs", rel, 0,
                    f"env knob `{k}` is read in {PKG}/ but not documented "
                    f"in README.md's port section — operators discover "
                    f"knobs there, not by grepping source", symbol=k,
                    snippet=k)
            for k, rel in sorted(used.items()) if k not in documented]
