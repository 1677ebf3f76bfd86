"""Project model + call graph for the static-analysis passes (the port's
copy of h2o3_tpu/analysis/callgraph.py).

Stdlib-``ast`` only. Every ``*.py`` under the scanned roots is parsed once
into a :class:`Project`: modules, top-level functions, class methods, a
class hierarchy (bases resolved through imports), and a call graph with
two resolution modes:

- **strict** — only edges the resolver can actually justify: direct names
  (same module or imported), ``module.attr`` calls through an imported
  project module, and ``self.m()`` / ``cls.m()`` resolved within the
  enclosing class family (ancestors + descendants). The lock-order pass
  builds on this shape (its own ``_call_targets`` adds a scoped-unique
  bare-name rule) because a speculative edge can fabricate a deadlock
  cycle.
- **loose** — strict plus bare-name attribute calls (``obj.m()`` on an
  arbitrary value resolves to every project method named ``m``). Used by
  the mirrored-program pass, where MISSING an edge means missing a
  divergence: the replay roots reach trainers through dynamic registries
  (``BUILDERS[algo]().train``), so reachability must over-approximate.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple


class ModuleInfo:
    __slots__ = ("path", "rel", "modname", "tree", "lines", "imports",
                 "text")

    def __init__(self, path: Path, rel: str, modname: str, text: str):
        self.path = path
        self.rel = rel                  # repo-relative posix path
        self.modname = modname          # dotted module name
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        # alias bound in this module -> dotted target ("ckpt" ->
        # "h2o3_tpu_torch.parallel.ckpt", "load_model" ->
        # "h2o3_tpu_torch.artifact.load_model")
        self.imports: Dict[str, str] = {}

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class FunctionInfo:
    __slots__ = ("qualname", "node", "module", "cls")

    def __init__(self, qualname: str, node: ast.AST, module: ModuleInfo,
                 cls: Optional[str]):
        self.qualname = qualname        # "pkg.mod.Class.meth" / "pkg.mod.fn"
        self.node = node
        self.module = module
        self.cls = cls                  # class qualname or None

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[1]


class ClassInfo:
    __slots__ = ("qualname", "node", "module", "bases", "methods")

    def __init__(self, qualname: str, node: ast.ClassDef,
                 module: ModuleInfo):
        self.qualname = qualname
        self.node = node
        self.module = module
        self.bases: List[str] = []      # resolved base class qualnames
        self.methods: Dict[str, str] = {}   # bare name -> fn qualname


def _modname_for(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class Project:
    """Parsed view of the repo's python sources (package roots only)."""

    def __init__(self, root: Path,
                 pkg_dirs: Iterable[str] = ("h2o3_tpu_torch",)):
        self.root = Path(root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.methods_by_name: Dict[str, List[str]] = {}
        self._family_cache: Dict[str, Set[str]] = {}
        self._callee_cache: Dict[Tuple[str, bool], Set[str]] = {}
        for pkg in pkg_dirs:
            base = self.root / pkg
            if not base.is_dir():
                continue
            for p in sorted(base.rglob("*.py")):
                if "__pycache__" in p.parts:
                    continue
                rel = p.relative_to(self.root).as_posix()
                try:
                    text = p.read_text(encoding="utf-8", errors="replace")
                    mod = ModuleInfo(p, rel, _modname_for(rel), text)
                except SyntaxError:
                    continue            # not this tool's finding to make
                self.modules[mod.modname] = mod
        for mod in self.modules.values():
            self._index_module(mod)
        self._resolve_bases()

    # -- indexing ---------------------------------------------------------
    def _index_module(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        mod.imports[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # relative import -> absolute (best-effort: the repo
                    # itself uses absolute imports throughout)
                    parent = mod.modname.rsplit(".", node.level)[0] \
                        if "." in mod.modname else mod.modname
                    base = f"{parent}.{base}" if base else parent
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = f"{base}.{a.name}"
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{mod.modname}.{node.name}"
                self.functions[q] = FunctionInfo(q, node, mod, None)
            elif isinstance(node, ast.ClassDef):
                cq = f"{mod.modname}.{node.name}"
                ci = ClassInfo(cq, node, mod)
                self.classes[cq] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fq = f"{cq}.{sub.name}"
                        self.functions[fq] = FunctionInfo(fq, sub, mod, cq)
                        ci.methods[sub.name] = fq
                        self.methods_by_name.setdefault(
                            sub.name, []).append(fq)

    def _resolve_bases(self) -> None:
        for ci in self.classes.values():
            for b in ci.node.bases:
                name = None
                if isinstance(b, ast.Name):
                    name = b.id
                elif isinstance(b, ast.Attribute) and \
                        isinstance(b.value, ast.Name):
                    target = ci.module.imports.get(b.value.id)
                    if target:
                        name = f"{target}.{b.attr}"
                if name is None:
                    continue
                if name in self.classes:
                    ci.bases.append(name)
                    continue
                target = ci.module.imports.get(name, name)
                if target in self.classes:
                    ci.bases.append(target)
                else:
                    same = f"{ci.module.modname}.{name}"
                    if same in self.classes:
                        ci.bases.append(same)

    # -- class family (ancestors + descendants) ---------------------------
    def family(self, cls_qualname: str) -> Set[str]:
        cached = self._family_cache.get(cls_qualname)
        if cached is not None:
            return cached
        up: Set[str] = set()
        stack = [cls_qualname]
        while stack:
            c = stack.pop()
            if c in up:
                continue
            up.add(c)
            ci = self.classes.get(c)
            if ci:
                stack.extend(ci.bases)
        down: Set[str] = set(up)
        changed = True
        while changed:
            changed = False
            for q, ci in self.classes.items():
                if q not in down and any(b in down for b in ci.bases):
                    down.add(q)
                    changed = True
        self._family_cache[cls_qualname] = down
        return down

    def _family_methods(self, cls_qualname: str, name: str) -> List[str]:
        out = []
        for c in self.family(cls_qualname):
            fq = self.classes[c].methods.get(name) if c in self.classes \
                else None
            if fq:
                out.append(fq)
        return out

    # -- call resolution --------------------------------------------------
    def callees(self, qualname: str, loose: bool = False) -> Set[str]:
        """Project-function qualnames the body of `qualname` may call."""
        key = (qualname, loose)
        cached = self._callee_cache.get(key)
        if cached is not None:
            return cached
        fi = self.functions.get(qualname)
        out: Set[str] = set()
        if fi is None:
            self._callee_cache[key] = out
            return out
        mod = fi.module
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name):
                target = mod.imports.get(fn.id)
                if target and target in self.functions:
                    out.add(target)
                elif target and target in self.classes:
                    init = self.classes[target].methods.get("__init__")
                    if init:
                        out.add(init)
                elif f"{mod.modname}.{fn.id}" in self.functions:
                    out.add(f"{mod.modname}.{fn.id}")
                elif f"{mod.modname}.{fn.id}" in self.classes:
                    init = self.classes[
                        f"{mod.modname}.{fn.id}"].methods.get("__init__")
                    if init:
                        out.add(init)
            elif isinstance(fn, ast.Attribute):
                base = fn.value
                if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                        and fi.cls:
                    out.update(self._family_methods(fi.cls, fn.attr))
                elif isinstance(base, ast.Name):
                    target = mod.imports.get(base.id)
                    if target and f"{target}.{fn.attr}" in self.functions:
                        out.add(f"{target}.{fn.attr}")
                    elif target and f"{target}.{fn.attr}" in self.classes:
                        init = self.classes[
                            f"{target}.{fn.attr}"].methods.get("__init__")
                        if init:
                            out.add(init)
                    elif target and target in self.classes:
                        # ClassName.method(...) through an imported class
                        m = self.classes[target].methods.get(fn.attr)
                        if m:
                            out.add(m)
                    elif loose:
                        out.update(self.methods_by_name.get(fn.attr, ()))
                elif loose:
                    out.update(self.methods_by_name.get(fn.attr, ()))
        self._callee_cache[key] = out
        return out

    def reachable(self, roots: Iterable[str], loose: bool = True) \
            -> Set[str]:
        """Transitive closure of :meth:`callees` from `roots`."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(c for c in self.callees(q, loose=loose)
                         if c not in seen)
        return seen
