"""Serialization, compat-routing, compile-ledger and sync-hygiene
passes (the port's copies of those in h2o3_tpu/analysis/passes_misc.py).

- **serialization** — a ban on raw ``pickle.load(s)``,
  ``np.load(allow_pickle=True)`` and ``torch.load(..., weights_only=False)``
  everywhere; ``Unpickler`` subclasses may live only in the sanctioned
  homes (``registry.PICKLE_ALLOWED``).
- **compat-routing** — ``triton``, ``torch.utils.cpp_extension`` and the
  version-mobile ``torch._dynamo``/``torch.export`` APIs
  (``registry.DEVICE_ONLY_APIS``) are imported only through
  ``registry.COMPAT_MODULES`` and there only inside functions: a
  module-level import would break ``import h2o3_tpu_torch`` on a box
  without the toolchain (the CPU test box has neither triton nor nvcc).
- **compile-ledger** — every CUDA-graph capture (``torch.cuda.graph``,
  ``CUDAGraph.capture_begin``) and every ``torch.export`` records a row
  through ``obs/compiles`` (``record_compile`` or ``timed``): in its own
  function, lexically inside a ``compiles.timed`` block, or in the
  recorder the registry names for it (``COMPILE_RECORDED_BY``), which
  must itself record; ``COMPILE_EXEMPT`` names the rest with a reason.
- **sync-hygiene** — no ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()`` or ``torch.cuda.synchronize()`` inside a
  ``tracing.span`` body, unless the span measures exactly that copy (a
  baseline entry with its note); plus the swallowed-exception lint
  (``except: pass``) on the watchdog/supervisor tick paths.
"""

from __future__ import annotations

import ast
from typing import List

from h2o3_tpu_torch.analysis.core import REGISTRY_FILE, Context, Finding
from h2o3_tpu_torch.analysis.passes_mirrored import _dotted, _normalize

# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def run_serialization(ctx: Context) -> List[Finding]:
    """No module is exempt from the raw-load ban (an allowlist hole
    would only ever hide a NEW one).
    ``PICKLE_ALLOWED`` instead bounds where ``pickle.Unpickler``
    subclasses may be DEFINED — restricted unpicklers are a security
    surface and must not proliferate into bespoke per-module copies.
    Both call sites (``pickle.load(f)``) and bare references
    (``loads = loads or pickle.loads``) are findings."""
    allowed = tuple(ctx.reg("PICKLE_ALLOWED", ()))
    findings: List[Finding] = []
    for mod in ctx.project.modules.values():
        seen_lines = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = _normalize(_dotted(node), mod.imports) \
                    if isinstance(node, ast.Attribute) \
                    else mod.imports.get(node.id)
                if name in ("pickle.load", "pickle.loads") and \
                        node.lineno not in seen_lines:
                    seen_lines.add(node.lineno)
                    findings.append(ctx.finding(
                        "serialization", mod, node,
                        f"raw `{name}` on external bytes — route through "
                        f"the restricted unpickler (utils/unpickle.py); "
                        f"arbitrary pickles are remote code execution",
                        symbol=mod.rel))
            elif isinstance(node, ast.Call):
                fname = _normalize(_dotted(node.func), mod.imports) or ""
                if fname == "torch.load" and any(
                        kw.arg == "weights_only"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                        for kw in node.keywords):
                    findings.append(ctx.finding(
                        "serialization", mod, node,
                        "`torch.load(..., weights_only=False)` unpickles "
                        "arbitrary objects — load tensors with "
                        "weights_only=True, or route the bytes through "
                        "utils/unpickle.py", symbol=mod.rel))
                for kw in node.keywords:
                    if kw.arg == "allow_pickle" and \
                            isinstance(kw.value, ast.Constant) and \
                            kw.value.value is True:
                        findings.append(ctx.finding(
                            "serialization", mod, node,
                            "`allow_pickle=True` — npz/npy payloads must "
                            "stay pickle-free (allow_pickle=False is the "
                            "contract for every artifact surface)",
                            symbol=mod.rel))
            elif isinstance(node, ast.ClassDef) and not any(
                    mod.rel == a or mod.rel.startswith(a)
                    for a in allowed):
                for b in node.bases:
                    bname = _normalize(_dotted(b), mod.imports) or ""
                    if bname.endswith("Unpickler"):
                        findings.append(ctx.finding(
                            "serialization", mod, node,
                            f"Unpickler subclass `{node.name}` outside "
                            f"the sanctioned homes ({', '.join(allowed)})"
                            f" — extend utils/unpickle.py instead of "
                            f"forking the allowlist", symbol=mod.rel))
    return findings


# ---------------------------------------------------------------------------
# compat-routing
# ---------------------------------------------------------------------------

def _matches(name: str, key: str) -> bool:
    return name == key or name.startswith(key + ".")


def _toplevel_imports(mod) -> set:
    """ids of the Import/ImportFrom nodes that run at module import time
    (the module body, including its top-level if/try/with blocks, but
    not function or class bodies)."""
    out = set()
    stack = list(mod.tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.add(id(node))
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                stack.extend(getattr(node, field, []) or [])
            for h in getattr(node, "handlers", []) or []:
                stack.extend(h.body)
    return out


def run_compat(ctx: Context) -> List[Finding]:
    apis = ctx.reg("DEVICE_ONLY_APIS", {})
    homes = tuple(ctx.reg("COMPAT_MODULES", ()))
    findings: List[Finding] = []
    for mod in ctx.project.modules.values():
        home = mod.rel in homes
        eager = _toplevel_imports(mod)
        seen_lines = set()

        def emit(node, api, message):
            if node.lineno in seen_lines:
                return
            seen_lines.add(node.lineno)
            findings.append(ctx.finding("compat-routing", mod, node,
                                        message, symbol=mod.rel))

        def check_import(node, api):
            if not home:
                emit(node, api,
                     f"direct import of `{api}` ({apis[api]}) — route it "
                     f"through {' or '.join(homes)}")
            elif id(node) in eager:
                emit(node, api,
                     f"module-level import of `{api}` ({apis[api]}) — "
                     f"import it inside the function that needs it, so "
                     f"the package imports without it")

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    for api in apis:
                        if _matches(a.name, api):
                            check_import(node, api)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                for api in apis:
                    if _matches(base, api) or any(
                            _matches(f"{base}.{a.name}", api)
                            for a in node.names):
                        check_import(node, api)
                        break
            elif isinstance(node, ast.Attribute) and not home:
                name = _normalize(_dotted(node), mod.imports)
                if name:
                    for api in apis:
                        if _matches(name, api):
                            emit(node, api,
                                 f"direct use of `{api}` ({apis[api]}) — "
                                 f"route it through {' or '.join(homes)}")
    for rel in homes:
        if not any(m.rel == rel for m in ctx.project.modules.values()):
            findings.append(Finding(
                "compat-routing", REGISTRY_FILE, 0,
                f"COMPAT_MODULES entry `{rel}` matches no module — stale "
                f"registry path; fix it", symbol=rel, snippet=rel))
    return findings


# ---------------------------------------------------------------------------
# compile-ledger
# ---------------------------------------------------------------------------

_RECORDERS = ("record_compile", "timed")


def _capture_kind(node: ast.Call, imports) -> str:
    """'graph'/'export' when `node` captures a CUDA graph or exports a
    program, else ''."""
    name = _normalize(_dotted(node.func), imports) or ""
    if name == "torch.cuda.graph" or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "capture_begin"):
        return "graph"
    if name == "torch.export.export" or name.endswith(
            ".torch_export().export") or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "export"
            and isinstance(node.func.value, ast.Call)
            and (_dotted(node.func.value.func) or "").endswith(
                "torch_export")):
        return "export"
    return ""


def _records(fn_node) -> bool:
    """Whether the function body (nested defs included) calls the ledger:
    ``compiles.record_compile(...)`` or ``compiles.timed(...)``."""
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _RECORDERS:
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in _RECORDERS:
            return True
    return False


def _inside_timed(fn_node, target) -> bool:
    for n in ast.walk(fn_node):
        if isinstance(n, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and isinstance(it.context_expr.func, ast.Attribute)
                and it.context_expr.func.attr == "timed"
                for it in n.items):
            if any(sub is target for st in n.body for sub in ast.walk(st)):
                return True
    return False


def run_compile_ledger(ctx: Context) -> List[Finding]:
    proj = ctx.project
    recorded_by = dict(ctx.reg("COMPILE_RECORDED_BY", {}))
    exempt = dict(ctx.reg("COMPILE_EXEMPT", {}))
    findings: List[Finding] = []
    for q, fi in sorted(proj.functions.items()):
        rel = fi.module.rel
        if any(rel == e or rel.startswith(e) for e in exempt):
            continue
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _capture_kind(node, fi.module.imports)
            if not kind:
                continue
            if _records(fi.node) or _inside_timed(fi.node, node):
                continue
            rec = recorded_by.get(q)
            if rec is not None and rec in proj.functions and \
                    _records(proj.functions[rec].node):
                continue
            what = ("CUDA-graph capture" if kind == "graph"
                    else "torch.export")
            findings.append(ctx.finding(
                "compile-ledger", fi.module, node,
                f"{what} with no compile-ledger row — record it through "
                f"obs/compiles (record_compile or timed) here, or name "
                f"its recorder in registry.COMPILE_RECORDED_BY",
                symbol=q.split("h2o3_tpu_torch.", 1)[-1]))
    # registry self-check: stale names would silently excuse a site
    for q, rec in sorted(recorded_by.items()):
        for name in (q, rec):
            if name not in proj.functions:
                findings.append(Finding(
                    "compile-ledger", REGISTRY_FILE, 0,
                    f"COMPILE_RECORDED_BY names `{name}`, which resolves "
                    f"to no project function — fix the registry",
                    symbol=name, snippet=name))
        if rec in proj.functions and not _records(proj.functions[rec].node):
            findings.append(Finding(
                "compile-ledger", REGISTRY_FILE, 0,
                f"COMPILE_RECORDED_BY recorder `{rec}` (for `{q}`) records "
                f"no ledger row", symbol=rec, snippet=rec))
    for e in sorted(exempt):
        if not any(m.rel == e or m.rel.startswith(e)
                   for m in proj.modules.values()):
            findings.append(Finding(
                "compile-ledger", REGISTRY_FILE, 0,
                f"COMPILE_EXEMPT entry `{e}` matches no module — stale "
                f"registry path; fix it", symbol=e, snippet=e))
    return findings


# ---------------------------------------------------------------------------
# sync-hygiene
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}


def _is_span_with(node: ast.With, imports) -> bool:
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call):
            name = _normalize(_dotted(ce.func), imports) or ""
            if name.endswith("tracing.span") or name == "span":
                return True
    return False


def run_sync_hygiene(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.project.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.With) and
                    _is_span_with(node, mod.imports)):
                continue
            # calls under a NESTED span belong to that span's own scan
            nested: set = set()
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.With) and \
                            _is_span_with(sub, mod.imports):
                        for inner in ast.walk(sub):
                            if inner is not sub:
                                nested.add(id(inner))
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if id(sub) in nested or not isinstance(sub, ast.Call):
                        continue
                    name = _normalize(_dotted(sub.func), mod.imports)
                    if name in _SYNC_CALLS:
                        what = f"`{name}()`"
                    elif isinstance(sub.func, ast.Attribute) and \
                            sub.func.attr in _SYNC_METHODS and \
                            not sub.args:
                        what = f"`.{sub.func.attr}()`"
                    else:
                        continue
                    findings.append(ctx.finding(
                        "sync-hygiene", mod, sub,
                        f"{what} inside a tracing span waits for the "
                        f"device under instrumentation — move it out, or "
                        f"baseline it with the note that the span "
                        f"measures exactly that copy", symbol=mod.rel))
    # swallowed exceptions on recovery tick paths
    for rel in ctx.reg("SWALLOW_SCOPE", ()):
        mod = next((m for m in ctx.project.modules.values()
                    if m.rel == rel), None)
        if mod is None:
            findings.append(Finding(
                "sync-hygiene", REGISTRY_FILE, 0,
                f"SWALLOW_SCOPE entry `{rel}` matches no module — stale "
                f"registry path; fix it", symbol=rel, snippet=rel))
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and \
                    len(node.body) == 1 and \
                    isinstance(node.body[0], ast.Pass):
                findings.append(ctx.finding(
                    "sync-hygiene", mod, node,
                    "swallowed exception (`except: pass`) on a recovery "
                    "tick path — a permanently-failing tick dies "
                    "silently; log it at debug at minimum",
                    symbol=mod.rel))
    return findings
