"""Lock-order pass: deadlock cycles + declared-order violations (the
port's copy of h2o3_tpu/analysis/passes_locks.py).

Scope: the modules named in ``registry.LOCK_SCOPE``: every port module
that takes a lock (the REST server, the batcher, search, the data plane
and the graph captures).

The pass identifies every lock object (module-level ``threading.Lock/
RLock/Condition`` assignments and ``self.X = threading.Lock()`` instance
attributes), extracts acquisition nesting — ``with`` blocks, including
acquisitions made by functions CALLED inside a held block (one closure
over the call graph) — and reports:

- **cycles** in the resulting lock graph (a potential AB/BA deadlock),
- **self-nesting** of a non-reentrant ``Lock``,
- **reversals** of the declared order pairs in ``registry.LOCK_ORDER``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from h2o3_tpu_torch.analysis.core import REGISTRY_FILE, Context, Finding

PASS_ID = "lock-order"

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _mod_tail(modname: str) -> str:
    return modname.rsplit(".", 1)[-1]


def _is_lock_ctor(node, imports) -> Optional[str]:
    """'Lock'/'RLock'/... when `node` constructs a threading primitive."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and imports.get(fn.value.id, fn.value.id) == "threading" \
            and fn.attr in _LOCK_CTORS:
        return fn.attr
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS and \
            imports.get(fn.id, "").startswith("threading."):
        return fn.id
    return None


class _LockIndex:
    def __init__(self):
        self.kinds: Dict[str, str] = {}          # lock id -> ctor kind
        # module tail -> {name -> lock id} (module-level locks)
        self.module_locks: Dict[str, Dict[str, str]] = {}
        # attr name -> {lock ids} (instance locks, for `obj.attr` sites)
        self.attr_locks: Dict[str, Set[str]] = {}
        # class qualname tail -> {attr -> lock id}
        self.class_locks: Dict[str, Dict[str, str]] = {}


def _index_locks(ctx: Context, scoped_mods) -> _LockIndex:
    idx = _LockIndex()
    for mod in scoped_mods:
        tail = _mod_tail(mod.modname)
        owner = None
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _is_lock_ctor(node.value, mod.imports)
                if kind:
                    lid = f"{tail}.{node.targets[0].id}"
                    idx.kinds[lid] = kind
                    idx.module_locks.setdefault(tail, {})[
                        node.targets[0].id] = lid
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    kind = _is_lock_ctor(node.value, mod.imports)
                    if kind:
                        if owner is None:
                            owner = _class_owners(mod)
                        cls = owner.get(id(node))
                        if cls:
                            lid = f"{tail}.{cls}.{tgt.attr}"
                            idx.kinds[lid] = kind
                            idx.attr_locks.setdefault(tgt.attr,
                                                      set()).add(lid)
                            idx.class_locks.setdefault(cls, {})[
                                tgt.attr] = lid
            # class-level: `_slock = threading.RLock()` inside a ClassDef
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.Assign) and \
                            len(sub.targets) == 1 and \
                            isinstance(sub.targets[0], ast.Name):
                        kind = _is_lock_ctor(sub.value, mod.imports)
                        if kind:
                            lid = f"{tail}.{node.name}." \
                                  f"{sub.targets[0].id}"
                            idx.kinds[lid] = kind
                            idx.attr_locks.setdefault(
                                sub.targets[0].id, set()).add(lid)
                            idx.class_locks.setdefault(node.name, {})[
                                sub.targets[0].id] = lid
    return idx


def _class_owners(mod) -> Dict[int, str]:
    """id(node) -> the name of the innermost class whose body holds it
    (one walk per class, instead of one per lock assignment)."""
    out: Dict[int, str] = {}
    classes = [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]
    for node in classes:              # outer classes first (walk order)
        for sub in ast.walk(node):
            out[id(sub)] = node.name
    return out


def _resolve_lock(expr, mod, fi, idx: _LockIndex) -> Optional[str]:
    """Lock id for a with-item / acquire() receiver expression."""
    tail = _mod_tail(mod.modname)
    if isinstance(expr, ast.Name):
        lid = idx.module_locks.get(tail, {}).get(expr.id)
        if lid:
            return lid
        target = mod.imports.get(expr.id)
        if target:
            mt, _, name = target.rpartition(".")
            lid = idx.module_locks.get(_mod_tail(mt), {}).get(name)
            if lid:
                return lid
        return None
    if isinstance(expr, ast.Attribute):
        base = expr.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            cls = (fi.cls or "").rsplit(".", 1)[-1]
            lid = idx.class_locks.get(cls, {}).get(expr.attr)
            if lid:
                return lid
            cands = idx.attr_locks.get(expr.attr, set())
            return next(iter(cands)) if len(cands) == 1 else None
        if isinstance(base, ast.Name):
            target = mod.imports.get(base.id)
            if target:
                lid = idx.module_locks.get(_mod_tail(target),
                                           {}).get(expr.attr)
                if lid:
                    return lid
            # `job._status_lock` style: unique instance-attr owner wins
        cands = idx.attr_locks.get(expr.attr, set())
        return next(iter(cands)) if len(cands) == 1 else None
    return None


def _direct_acquisitions(fi, idx, nodes=None) -> List[Tuple[str, ast.AST]]:
    out = []
    for node in (nodes if nodes is not None else ast.walk(fi.node)):
        if isinstance(node, ast.With):
            for item in node.items:
                lid = _resolve_lock(item.context_expr, fi.module, fi, idx)
                if lid:
                    out.append((lid, node))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "acquire":
            lid = _resolve_lock(node.func.value, fi.module, fi, idx)
            if lid:
                out.append((lid, node))
    return out


def run(ctx: Context) -> List[Finding]:
    proj = ctx.project
    scope = tuple(ctx.reg("LOCK_SCOPE", ()))
    scoped_mods = [m for m in proj.modules.values()
                   if any(m.rel == s or m.rel.startswith(s)
                          for s in scope)]
    idx = _index_locks(ctx, scoped_mods)
    scoped_fns = [fi for fi in proj.functions.values()
                  if fi.module in scoped_mods]
    # every function's nodes, walked once for the three scans below
    nodes = {fi.qualname: list(ast.walk(fi.node)) for fi in scoped_fns}

    # bare-name `obj.m()` calls resolve ONLY when exactly one scoped
    # method bears the name (e.g. `job.fail()` -> Job.fail): callgraph
    # strict mode plus this uniqueness rule — a speculative loose edge
    # could fabricate a deadlock cycle out of two unrelated same-named
    # methods that each take a lock
    counts: Dict[str, List[str]] = {}
    for fi in scoped_fns:
        if fi.cls:
            counts.setdefault(fi.name, []).append(fi.qualname)
    scoped_unique = {n: qs[0] for n, qs in counts.items() if len(qs) == 1}
    by_fn: Dict[str, Set[str]] = {}
    for fi in scoped_fns:
        targets: Set[str] = set()
        for node in nodes[fi.qualname]:
            if isinstance(node, ast.Call):
                targets |= _call_targets(node, fi, proj, scoped_unique)
        by_fn[fi.qualname] = targets

    # closure: every lock a function may acquire (itself or via calls)
    acq: Dict[str, Set[str]] = {
        fi.qualname: {lid for lid, _ in _direct_acquisitions(
            fi, idx, nodes[fi.qualname])}
        for fi in scoped_fns}
    changed = True
    while changed:
        changed = False
        for fi in scoped_fns:
            mine = acq[fi.qualname]
            for callee in by_fn[fi.qualname]:
                extra = acq.get(callee)
                if extra and not extra <= mine:
                    mine |= extra
                    changed = True

    # edges: held lock -> lock acquired inside the held block
    edges: Dict[Tuple[str, str], List[str]] = {}

    def note(outer, inner, where):
        if outer == inner and idx.kinds.get(outer) != "Lock":
            return                       # re-entrant self-nesting is fine
        edges.setdefault((outer, inner), []).append(where)

    for fi in scoped_fns:
        for node in nodes[fi.qualname]:
            if not isinstance(node, ast.With):
                continue
            lids = [_resolve_lock(it.context_expr, fi.module, fi, idx)
                    for it in node.items]
            lids = [lid for lid in lids if lid]
            if not lids:
                continue
            where = f"{fi.module.rel}:{node.lineno}"
            for a, b in zip(lids, lids[1:]):
                note(a, b, where)
            body_calls: Set[str] = set()
            inner_direct: List[str] = []
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.With):
                        for it in sub.items:
                            lid = _resolve_lock(it.context_expr,
                                                fi.module, fi, idx)
                            if lid:
                                inner_direct.append(lid)
                    elif isinstance(sub, ast.Call):
                        if isinstance(sub.func, ast.Attribute) and \
                                sub.func.attr == "acquire":
                            lid = _resolve_lock(sub.func.value,
                                                fi.module, fi, idx)
                            if lid:
                                inner_direct.append(lid)
                        body_calls.add(id(sub))
            held = lids[-1]
            for lid in inner_direct:
                note(held, lid, where)
            # acquisitions by functions called while held
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        for callee in _call_targets(sub, fi, proj,
                                                    scoped_unique):
                            for lid in acq.get(callee, ()):
                                note(held, lid,
                                     f"{where} via "
                                     f"{callee.rsplit('.', 1)[-1]}()")

    findings: List[Finding] = []

    def emit(file_hint, message, symbol):
        findings.append(Finding(PASS_ID, file_hint, 0, message,
                                symbol=symbol, snippet=symbol))

    # registry self-check: a LOCK_SCOPE entry that matches no module
    # would silently shrink the scan to nothing (the renamed-faultpoint
    # failure mode, applied to this registry)
    for s in scope:
        if not any(m.rel == s or m.rel.startswith(s)
                   for m in proj.modules.values()):
            emit(REGISTRY_FILE,
                 f"LOCK_SCOPE entry `{s}` matches no module — the lock "
                 f"scan silently lost that scope; fix the path", symbol=s)

    # self-deadlock on a non-reentrant Lock
    for (a, b), sites in sorted(edges.items()):
        if a == b and idx.kinds.get(a) == "Lock":
            emit(sites[0].split(":")[0],
                 f"non-reentrant Lock `{a}` may be acquired while already "
                 f"held ({sites[0]}) — self-deadlock", symbol=a)

    # declared-order reversals
    for outer, inner in ctx.reg("LOCK_ORDER", ()):
        rev = edges.get((inner, outer))
        if rev:
            emit(rev[0].split(":")[0],
                 f"declared lock order `{outer}` -> `{inner}` is reversed "
                 f"at {rev[0]} — AB/BA deadlock with the declared sites",
                 symbol=f"{inner}->{outer}")

    # cycles (Tarjan SCC)
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        if a != b:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
    for comp in _sccs(graph):
        if len(comp) > 1:
            comp = sorted(comp)
            sites = [s for (a, b), ss in edges.items()
                     if a in comp and b in comp for s in ss[:1]]
            emit(sites[0].split(":")[0] if sites else "h2o3_tpu_torch/",
                 f"lock cycle {' -> '.join(comp)} -> {comp[0]} "
                 f"(sites: {', '.join(sites[:4])}) — potential deadlock",
                 symbol="+".join(comp))
    return findings


def _call_targets(call, fi, proj, scoped_unique: Dict[str, str]) \
        -> Set[str]:
    """Strict resolution (names, module attrs, self/cls family) plus
    bare ``obj.m()`` ONLY via the scoped-uniqueness map — never the
    global loose fallback, which fabricates edges between unrelated
    same-named methods."""
    fn = call.func
    out: Set[str] = set()
    mod = fi.module
    if isinstance(fn, ast.Name):
        target = mod.imports.get(fn.id)
        if target in proj.functions:
            out.add(target)
        elif f"{mod.modname}.{fn.id}" in proj.functions:
            out.add(f"{mod.modname}.{fn.id}")
    elif isinstance(fn, ast.Attribute):
        base = fn.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                and fi.cls:
            out.update(proj._family_methods(fi.cls, fn.attr))
        elif isinstance(base, ast.Name):
            target = mod.imports.get(base.id)
            if target and f"{target}.{fn.attr}" in proj.functions:
                out.add(f"{target}.{fn.attr}")
            elif fn.attr in scoped_unique:
                out.add(scoped_unique[fn.attr])
        elif fn.attr in scoped_unique:
            out.add(scoped_unique[fn.attr])
    return out


def _sccs(graph: Dict[str, Set[str]]) -> List[List[str]]:
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in graph.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        for v in graph:
            if v not in index:
                strong(v)
    finally:
        sys.setrecursionlimit(old)
    return out
