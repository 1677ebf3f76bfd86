"""Mirrored-program pass: per-process-divergent decisions in replayed
code (the port's copy of h2o3_tpu/analysis/passes_mirrored.py).

On a multi-process cloud every process replays the same operations (a
train, a score batch, a Rapids statement, a search walk) and must make
the same decisions, or the device work and the collectives around it
diverge. This pass closes over the project call graph from the
registry's roots (``registry.MIRRORED_ROOTS``) and flags, inside every
reachable function:

- **wall-clock** reads (``time.time/monotonic/perf_counter``) whose value
  feeds control flow (directly in a branch test/comparison, or through
  intra-function assignment taint);
- **fresh PRNG / entropy** (``random.*``, ``np.random`` module state,
  ``default_rng()`` with no/None seed, ``SeedSequence()``, ``uuid4``,
  torch's samplers drawing from the global generator, i.e. without a
  ``generator=``, and ``torch.seed()``) -- flagged on sight;
- **raw env reads** (``os.environ`` / ``os.getenv``) outside the declared
  knob helpers, when they feed control flow;
- **process-local topology** (``torch.distributed.get_rank()`` and the
  like) feeding control flow.

Functions listed in ``registry.GUARDED`` (audited, reason required) and
modules declared host-side are exempt; the call graph still flows
through them.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from h2o3_tpu_torch.analysis.core import REGISTRY_FILE, Context, Finding

PASS_ID = "mirrored"

_WALLCLOCK_ATTRS = {"time", "monotonic", "perf_counter", "time_ns",
                    "monotonic_ns", "perf_counter_ns"}
_TOPOLOGY_ATTRS = {"process_index", "local_device_count", "local_devices",
                   "get_rank", "get_node_local_rank"}
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like", "poisson"}


def _dotted(node) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _normalize(dotted: Optional[str], imports: Dict[str, str]) \
        -> Optional[str]:
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    target = imports.get(head)
    if target:
        return f"{target}.{rest}" if rest else target
    return dotted


def _contains_none(node) -> bool:
    return any(isinstance(n, ast.Constant) and n.value is None
               for n in ast.walk(node))


def _classify_call(node: ast.Call, imports: Dict[str, str]) \
        -> Optional[str]:
    """Divergence category for a call expression, else None."""
    name = _normalize(_dotted(node.func), imports)
    if not name:
        return None
    if name.startswith("time.") and name.split(".")[-1] in _WALLCLOCK_ATTRS:
        return "wall-clock"
    if name.split(".")[-1] in _TOPOLOGY_ATTRS:
        return "process-topology"
    if name.startswith("random.") or name.startswith("secrets."):
        return "fresh-prng"
    if name in ("uuid.uuid4", "uuid.uuid1"):
        return "fresh-prng"
    if name.endswith(".random.default_rng") or name == "random.default_rng":
        if not node.args and not node.keywords:
            return "fresh-prng"
        if any(_contains_none(a) for a in node.args) or \
                any(_contains_none(k.value) for k in node.keywords):
            return "fresh-prng"
        return None                     # explicitly seeded: deterministic
    if name.endswith(".random.SeedSequence") and not node.args:
        return "fresh-prng"
    if name == "torch.seed":
        return "fresh-prng"
    if name.startswith("torch.") and name.count(".") == 1 and \
            name.split(".")[-1] in _TORCH_SAMPLERS:
        if any(k.arg == "generator" for k in node.keywords):
            return None                 # an explicit generator: seeded
        return "fresh-prng"
    if ".random." in name and name.split(".random.")[0] in ("numpy", "np"):
        # module-global numpy samplers (np.random.randint etc.)
        if name.split(".")[-1] not in ("default_rng", "SeedSequence",
                                       "Generator"):
            return "fresh-prng"
    if name in ("os.getenv",):
        return "raw-env"
    if name in ("os.environ.get",):
        return "raw-env"
    return None


def _divergent_nodes(fn_node, imports) -> List[tuple]:
    """[(ast node, category, code)] divergent sources in the function."""
    out = []
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call):
            cat = _classify_call(node, imports)
            if cat:
                out.append((node, cat,
                            _normalize(_dotted(node.func), imports)))
        elif isinstance(node, ast.Subscript):
            name = _normalize(_dotted(node.value), imports)
            if name == "os.environ":
                out.append((node, "raw-env", "os.environ[...]"))
    return out


def _test_region_ids(fn_node) -> Set[int]:
    """ids of every AST node living inside a control-flow test: If/While/
    IfExp tests, assert tests, comprehension conditions, and any
    comparison/boolean expression (a compared divergent value is a branch
    in the making wherever the bool lands)."""
    region: Set[int] = set()

    def mark(sub):
        for n in ast.walk(sub):
            region.add(id(n))

    for node in ast.walk(fn_node):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            mark(node.test)
        elif isinstance(node, ast.Assert):
            mark(node.test)
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                mark(cond)
        elif isinstance(node, (ast.Compare, ast.BoolOp)):
            mark(node)
    return region


def _flagged_sources(fn_node, divergents) -> List[tuple]:
    """Subset of divergent sources that feed control flow (fresh-prng is
    flagged unconditionally). Taint flows through simple intra-function
    assignments: ``t0 = time.time() ... while time.time() < deadline``."""
    region = _test_region_ids(fn_node)
    flagged = []
    prng = [(n, c, code) for n, c, code in divergents if c == "fresh-prng"]
    rest = [(n, c, code) for n, c, code in divergents if c != "fresh-prng"]
    flagged.extend(prng)
    if not rest:
        return flagged
    direct = [(n, c, code) for n, c, code in rest if id(n) in region]
    flagged.extend(direct)
    pending = [t for t in rest if t not in direct]
    if not pending:
        return flagged
    # taint: name -> contributing source tuples
    taint: Dict[str, list] = {}
    for _ in range(5):
        changed = False
        for node in ast.walk(fn_node):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign, ast.NamedExpr)):
                continue
            value = node.value
            if value is None:
                continue
            sources = []
            vids = {id(n) for n in ast.walk(value)}
            for t in pending:
                if id(t[0]) in vids:
                    sources.append(t)
            for n in ast.walk(value):
                if isinstance(n, ast.Name) and n.id in taint:
                    sources.extend(taint[n.id])
            if not sources:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                # plain names (and name tuples) only: tainting the BASE of
                # an attribute target (`self.t0 = time.time()` -> `self`)
                # would poison every later `self` comparison
                names = [tgt] if isinstance(tgt, ast.Name) else (
                    [e for e in tgt.elts if isinstance(e, ast.Name)]
                    if isinstance(tgt, (ast.Tuple, ast.List)) else [])
                for n in names:
                    cur = taint.setdefault(n.id, [])
                    for s in sources:
                        if s not in cur:
                            cur.append(s)
                            changed = True
        if not changed:
            break
    tainted_hits: List[tuple] = []
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Name) and id(node) in region and \
                node.id in taint:
            for s in taint[node.id]:
                if s not in tainted_hits and s not in flagged:
                    tainted_hits.append(s)
    flagged.extend(tainted_hits)
    return flagged


def run(ctx: Context) -> List[Finding]:
    proj = ctx.project
    roots = ctx.reg("MIRRORED_ROOTS", ())
    guarded = ctx.reg("GUARDED", {})
    helpers = ctx.reg("KNOB_HELPERS", frozenset())
    host = tuple(ctx.reg("HOST_SIDE_MODULES", {}))
    reach = proj.reachable(roots, loose=True)
    findings: List[Finding] = []

    # registry self-check: an unresolvable qualname would silently shrink
    # the closure (renamed root => green no-op pass) or leave a stale
    # exemption standing — both are findings, mirroring the stale-baseline
    # rule. Registry findings are not baselineable by construction.
    reg_file = REGISTRY_FILE
    for name, what in ((roots, "MIRRORED_ROOTS"),
                       (tuple(guarded), "GUARDED"),
                       (tuple(helpers), "KNOB_HELPERS")):
        for q in name:
            if q not in proj.functions:
                findings.append(Finding(
                    PASS_ID, reg_file, 0,
                    f"{what} entry `{q}` resolves to no project function "
                    f"— a renamed symbol silently defuses the mirrored "
                    f"pass (or leaves a stale audit); fix the registry",
                    symbol=q, snippet=q))
    for h in host:
        if not any(m.rel == h or m.rel.startswith(h)
                   for m in proj.modules.values()):
            findings.append(Finding(
                PASS_ID, reg_file, 0,
                f"HOST_SIDE_MODULES entry `{h}` matches no module — "
                f"stale exemption; fix the path", symbol=h, snippet=h))
    for q in sorted(reach):
        if q in guarded:
            continue
        fi = proj.functions[q]
        rel = fi.module.rel
        if any(rel == h or rel.startswith(h) for h in host):
            continue
        divergents = _divergent_nodes(fi.node, fi.module.imports)
        if not divergents:
            continue
        if q in helpers:
            divergents = [t for t in divergents if t[1] != "raw-env"]
        for node, cat, code in _flagged_sources(fi.node, divergents):
            sym = q.split("h2o3_tpu_torch.", 1)[-1]
            findings.append(ctx.finding(
                PASS_ID, fi.module, node,
                f"{cat} source `{code}` in mirrored code (reachable from "
                f"the replay roots) — every process must make the same "
                f"decisions; pin/route it or add an audited GUARDED "
                f"entry", symbol=sym))
    return findings
