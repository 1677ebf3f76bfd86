"""Rapids statement fusion: one captured program per statement
(counterpart of h2o3_tpu/rapids/fusion.py).

- **Classification.** Every registered prim carries one of three
  fusibility classes (a closed enumeration, held against the registry by
  the tests): ``fusible`` prims can appear inside one fused program
  (elementwise arithmetic, comparison and logic, unary math, ifelse,
  is.na, column selection); ``barrier`` prims run on the device but
  bound a fused region (group-by, merge, sort, quantile, cumulative ops,
  the reducers and the ``rows`` filter consume a fused chain as input);
  ``host`` prims move data to the host, and every run of one counts as a
  ``barrier_fallbacks``.
- **Planning.** The evaluator offers every fusible application node to
  :func:`try_execute` before it evaluates eagerly. The planner binds
  Column leaves (checked by type, deduplicated by ``Column.token``, all
  of one length on one device) and scalar constants, and renders a
  structure-only signature: constants are program inputs, so statements
  that differ only in literals share one program. The edges the
  reference's compiler rewrites across (a multiply feeding ``+``/``-``,
  division, power and remainder chains) become sub-program boundaries
  (:func:`_split_rewrite_edges`), each segment a plan of its own. Torch
  rewrites nothing, so the split is kept only so that signatures,
  program counts and the pipeline exporter's refusal match the
  reference's.
- **Programs.** A plan executes the same expressions the eager prims
  call (ops/elementwise ``binop_expr``/``unop_expr``/``ifelse_expr``/
  ``logical_expr``/``isna_expr``/``cat_to_f32``), in the same order, so a
  fused result has the eager bits by construction. On the card a program
  is captured once per signature (structure, leaf dtypes, row count) into
  one CUDA graph over static input buffers: the first run is eager, and
  every later run copies its leaves into the static inputs, refreshes the
  constants buffer and replays. A replay rewrites the graph's output, so
  it is cloned before the next replay. Graphs share one memory pool and
  replay one at a time under one lock; a capture skips the allocator
  flush torch.cuda.graph runs first (:func:`capture`). The cache is an
  LRU bounded by count (256) and by bytes (2 GiB). On the CPU the same
  plan runs op by op. A failed capture or launch
  raises; nothing here turns an error into an eager result.
- **Windows.** Execution runs under memory/stream.run_windows: a
  budgeted or OOM-halved run executes power-of-two row windows of the
  plan (every node is elementwise, so windows concatenate to the
  single-run output on the card).

The reference pins outputs to its mesh's row sharding and serializes
programs across restarts through its persistent compile cache; on one
device the first collapses, and a CUDA graph does not outlive its
process (ROADMAP C31).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import (Column, Frame, T_CAT, T_INT, T_NUM,
                                       T_TIME)
from h2o3_tpu_torch.ops import elementwise as E
from h2o3_tpu_torch.rapids.parser import Id, NumList, Span, StrLit, StrList

# ---------------------------------------------------------------------------
# fusibility classes: a closed enumeration
# ---------------------------------------------------------------------------

FUSIBLE = "fusible"
BARRIER = "barrier"
HOST = "host"
FUSION_CLASSES = frozenset({FUSIBLE, BARRIER, HOST})

# canonical op aliases (h2o-py sends both spellings)
_OP_ALIAS = {"%%": "%", "%/%": "intDiv", "&&": "&", "||": "|"}

_BIN_NAMES = {"+", "-", "*", "/", "^", "%", "intDiv", "%%", "%/%",
              "==", "!=", "<", "<=", ">", ">="}
_LOGICAL_NAMES = {"&", "&&", "|", "||"}

# reducers and the `rows` filter consume a fused chain but always run as
# their own step: barriers
_FUSIBLE_NAMES = (_BIN_NAMES | _LOGICAL_NAMES | set(E._UNOPS)
                  | {"ifelse", "is.na", "cols", "cols_py"})

_BARRIER_NAMES = {
    ",", ":=", "GB", "append", "assign", "cbind", "colnames=",
    "columnsByType", "cor", "cummax", "cummin", "cumprod", "cumsum",
    "distance", "filterNACols", "getTimeZone", "h2o.fillna", "h2o.impute",
    "any.factor", "any.na", "difflag1", "is.character", "is.factor",
    "is.numeric",
    "kurtosis", "median", "merge", "model.reset.threshold", "na.omit",
    "ncol", "nlevels", "none", "nrow", "prod", "prod.na", "quantile",
    "rbind", "rename", "rm", "rows", "scale", "setDomain", "setTimeZone",
    "setproperty", "skewness", "sort", "sumNA", "sumaxis", "table",
    "tmp=", "unique", "which.max", "which.min", "x",
    "mean", "sum", "min", "max", "sd", "var", "all", "any", "naCnt",
    "nacnt", "rank_within_groupby",
}

_HOST_NAMES = {
    "apply", "as.Date", "as.character", "as.factor", "as.numeric",
    "ascharacter", "asfactor", "asnumeric", "countmatches", "cut", "day",
    "dayOfWeek", "ddply", "dropdup", "entropy", "flatten",
    "getrow", "grep", "grouped_permute", "h2o.mad",
    "h2o.random_stratified_split", "h2o.runif", "h2o.splitframe", "hist",
    "hour", "isax", "kfold_column", "levels", "listTimeZones", "ls",
    "lstrip", "mad", "match", "maxNA", "melt", "millis", "minNA",
    "minute", "mktime", "mode", "modulo_kfold_column", "moment", "month",
    "nchar", "num_valid_substrings", "perfectAUC", "pivot",
    "relevel", "rep_len", "replaceall",
    "replacefirst", "rstrip", "second", "segment_models_as_frame", "seq",
    "seq_len",
    "setLevel", "signif", "strDistance", "stratified_kfold_column",
    "strlen", "strsplit", "substring", "t", "tf-idf", "tokenize",
    "tolower", "topn", "toupper", "trim", "week", "which", "year",
}

PRIM_FUSION: Dict[str, str] = {}
for _n in _FUSIBLE_NAMES:
    PRIM_FUSION[_n] = FUSIBLE
for _n in _BARRIER_NAMES:
    PRIM_FUSION[_n] = BARRIER
for _n in _HOST_NAMES:
    PRIM_FUSION[_n] = HOST


# the prims a fused program can be rooted at
ROOT_OPS = (_BIN_NAMES | _LOGICAL_NAMES | set(E._UNOPS)
            | {"ifelse", "is.na"})


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COUNTS = {
    "statements": 0,              # exec_rapids calls
    "fused_statements": 0,        # statements that ran >= 1 fused program
    "fused_programs": 0,          # fused program executions
    "fused_programs_compiled": 0,  # programs built (a capture on the card)
    "compile_cache_hits": 0,      # executions served by a cached program
    "captures": 0,                # CUDA-graph captures (the card only)
    "barrier_fallbacks": 0,       # host-class prim executions
    "host_materialized_cells": 0,  # cells copied to the host by host prims
    "fused_rows": 0,              # rows through fused programs
}


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[key] += int(n)


def note_statement() -> None:
    _bump("statements")


def note_host_fallback() -> None:
    _bump("barrier_fallbacks")


def note_host_cells(cells: int) -> None:
    _bump("host_materialized_cells", cells)


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


# ---------------------------------------------------------------------------
# enable / force switches
# ---------------------------------------------------------------------------

_FORCE: Optional[bool] = None


def enabled() -> bool:
    """Master switch (H2O_TPU_RAPIDS_FUSION, default on). Off = the eager
    op-at-a-time evaluator everywhere, for A/B bitwise checks."""
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("H2O_TPU_RAPIDS_FUSION", "1").lower() not in (
        "0", "false", "off")


class force:
    """Context manager pinning fusion on or off whatever the env knob says
    (A/B runs and the equivalence tests)."""

    def __init__(self, on: bool):
        self._on = bool(on)
        self._prev: Optional[bool] = None

    def __enter__(self):
        global _FORCE
        self._prev = _FORCE
        _FORCE = self._on
        return self

    def __exit__(self, *exc):
        global _FORCE
        _FORCE = self._prev
        return False


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

class _NotFusible(Exception):
    """Internal: this subtree cannot enter a fused program."""


_LEAF_CTYPES = (T_NUM, T_INT, T_CAT, T_TIME)


class Plan:
    """A fused column program: an expression tree over Column leaves (or
    sub-plans) and scalar constants, with the layout facts its cache key
    needs. `padded` is the leaves' length (nothing is padded on one
    device, so it equals `nrows`)."""

    __slots__ = ("root", "leaves", "consts", "leaf_ctypes", "leaf_dtypes",
                 "padded", "nrows", "device", "n_ops", "out_name",
                 "signature")

    def __init__(self):
        self.root = None
        self.leaves: List[Any] = []
        self.consts: List[float] = []
        self.leaf_ctypes: List[str] = []
        self.leaf_dtypes: List[str] = []
        self.padded: Optional[int] = None
        self.nrows: Optional[int] = None
        self.device: Optional[torch.device] = None
        self.n_ops = 0
        self.out_name = "C1"
        self.signature = ""


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _Planner:
    def __init__(self, env):
        self.env = env
        self.plan = Plan()
        self._leaf_ix: Dict[int, int] = {}     # Column.token -> leaf index

    # -- leaves ------------------------------------------------------------
    def _leaf(self, col: Column) -> tuple:
        if col.ctype not in _LEAF_CTYPES:
            raise _NotFusible
        d = col.data                      # faults evicted columns back in
        if d is None:
            raise _NotFusible             # host-resident column
        p = self.plan
        rows = int(d.shape[0])
        if p.padded is None:
            p.padded, p.nrows, p.device = rows, col.nrows, d.device
        elif (p.padded != rows or p.nrows != col.nrows
              or p.device != d.device):
            raise _NotFusible             # ragged layout: eager
        ix = self._leaf_ix.get(col.token)
        if ix is None:
            ix = len(p.leaves)
            self._leaf_ix[col.token] = ix
            p.leaves.append(col)
            p.leaf_ctypes.append(col.ctype)
            p.leaf_dtypes.append(_dtype_name(d.dtype))
        return ("L", ix)

    def _const(self, v: float) -> tuple:
        p = self.plan
        p.consts.append(float(v))
        return ("K", len(p.consts) - 1)

    def _resolve_frame(self, a) -> Frame:
        if isinstance(a, Id):
            try:
                v = self.env.lookup(a.name)
            except KeyError:
                raise _NotFusible
            if isinstance(v, Frame):
                return v
        raise _NotFusible

    def _leaf_from_cols(self, ast) -> tuple:
        if len(ast) != 3:
            raise _NotFusible
        fr = self._resolve_frame(ast[1])
        try:
            name = cols_sel_name(fr, ast[2])
        except LookupError:
            raise _NotFusible
        return self._frame_leaf(fr, name)

    def _bind_value(self, v) -> Tuple[tuple, bool]:
        """Resolved Id value -> plan node. The lazy session planner
        overrides it to splice deferred-temp trees instead of their
        Columns."""
        if isinstance(v, Frame):
            if v.ncols != 1:
                raise _NotFusible
            return self._frame_leaf(v, v.names[0]), True
        if isinstance(v, Column):
            return self._leaf(v), True
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return self._const(float(v)), False
        raise _NotFusible

    def _frame_leaf(self, fr: Frame, name: str) -> tuple:
        """Named-column leaf binding (overridden like _bind_value: the lazy
        planner intercepts pending outputs before their lazy Columns are
        touched)."""
        return self._leaf(fr.col(name))

    # -- recursive build ---------------------------------------------------
    def build(self, ast) -> Tuple[tuple, bool]:
        """-> (node, is_column). Mirrors the eager evaluator's value rules;
        any shape the eager path would reject raises _NotFusible, and the
        eager path reports the error."""
        if isinstance(ast, bool):
            raise _NotFusible
        if isinstance(ast, (int, float)):
            return self._const(float(ast)), False
        if isinstance(ast, Id):
            try:
                v = self.env.lookup(ast.name)
            except KeyError:
                raise _NotFusible
            return self._bind_value(v)
        if not isinstance(ast, list) or not ast or \
                not isinstance(ast[0], Id):
            raise _NotFusible
        name = ast[0].name
        p = self.plan
        if name in ("cols", "cols_py"):
            return self._leaf_from_cols(ast), True
        if name in _BIN_NAMES:
            if len(ast) != 3:
                raise _NotFusible
            l, lcol = self.build(ast[1])
            r, rcol = self.build(ast[2])
            p.n_ops += 1
            return ("bin", _OP_ALIAS.get(name, name), l, r), lcol or rcol
        if name in _LOGICAL_NAMES:
            if len(ast) != 3:
                raise _NotFusible
            l, lcol = self.build(ast[1])
            r, rcol = self.build(ast[2])
            if not (lcol or rcol):
                raise _NotFusible         # eager needs a Column
            p.n_ops += 1
            return ("log", _OP_ALIAS.get(name, name), l, r), True
        if name in E._UNOPS:
            if len(ast) != 2:
                raise _NotFusible
            x, xcol = self.build(ast[1])
            if not xcol:
                raise _NotFusible
            p.n_ops += 1
            return ("un", name, x), True
        if name == "ifelse":
            if len(ast) != 4:
                raise _NotFusible
            c, ccol = self.build(ast[1])
            if not ccol:
                raise _NotFusible
            a, _ = self.build(ast[2])
            b, _ = self.build(ast[3])
            p.n_ops += 1
            return ("ifelse", c, a, b), True
        if name == "is.na":
            if len(ast) != 2:
                raise _NotFusible
            x, xcol = self.build(ast[1])
            if not xcol:
                raise _NotFusible
            p.n_ops += 1
            return ("isna", x), True
        raise _NotFusible


def cols_sel_name(fr: Frame, sel) -> str:
    """A single-column (cols fr sel) selector -> the column's name;
    LookupError for any other selector."""
    if isinstance(sel, StrLit):
        name = sel.s
    elif isinstance(sel, StrList) and len(sel) == 1:
        name = sel[0]
    elif (isinstance(sel, NumList) and len(sel) == 1
          and not isinstance(sel[0], Span)):
        i = int(sel[0])
        if not 0 <= i < fr.ncols:
            raise LookupError(i)
        name = fr.names[i]
    elif isinstance(sel, (int, float)) and not isinstance(sel, bool):
        i = int(sel)
        if not 0 <= i < fr.ncols:
            raise LookupError(i)
        name = fr.names[i]
    else:
        raise LookupError(sel)
    if name not in fr:
        raise LookupError(name)
    return name


def _render(node) -> str:
    k = node[0]
    if k in ("L", "K"):
        return f"{k}{node[1]}"
    if k in ("bin", "log", "un"):
        return "(" + node[1] + " " + " ".join(
            _render(c) for c in node[2:]) + ")"
    return "(" + k + " " + " ".join(_render(c) for c in node[1:]) + ")"


def _out_name(node) -> str:
    """Output column name, as the eager prims name theirs."""
    k = node[0]
    if k in ("bin", "log", "un"):
        return node[1]
    if k == "isna":
        return "isNA"
    return "C1"                            # ifelse


def plan_expr(ast, env) -> Optional[Plan]:
    """Plan `ast` as a fused program (plus its rewrite-boundary
    sub-programs); None when not fusible."""
    pl = _Planner(env)
    try:
        root, is_col = pl.build(ast)
    except _NotFusible:
        return None
    p = pl.plan
    if not is_col or not p.padded or p.n_ops == 0:
        return None
    p.root = root
    p.out_name = _out_name(root)
    _split_rewrite_edges(p)
    _finish_signature(p)
    return p


def _plan_is_scalar(plan: Plan) -> bool:
    """True when the program's output is 0-dim (a constant-only subtree)."""
    return all(isinstance(l, Plan) and _plan_is_scalar(l)
               for l in plan.leaves)


# the reference's compiler reassociates division, power and remainder
# chains, so such a node runs as its own segment there with compute
# operands materialized; the port keeps the same segments
_BOUNDARY_OPS = frozenset({"/", "^", "%", "intDiv"})


def _is_compute(node) -> bool:
    return node[0] not in ("L", "K")


def _is_boundary(node) -> bool:
    return node[0] == "bin" and node[1] in _BOUNDARY_OPS


def _split_rewrite_edges(plan: Plan) -> None:
    """Rewrite the plan so that no edge the reference's compiler rewrites
    across stays inside one program: a multiply feeding +/- (FMA
    contraction) and division/power/remainder nodes (reassociation).
    Each such producer becomes a sub-plan whose output re-enters the
    parent as a leaf; sub-plans are cached by their own signature, split
    recursively and shared across statements. Torch's eager kernels round
    every op either way; the split keeps signatures, program counts and
    the pipeline exporter's refusal equal to the reference's."""

    def walk(node):
        k = node[0]
        if k in ("L", "K"):
            return node
        if k == "bin":
            op = node[1]
            l = walk(node[2])
            r = walk(node[3])
            if op in _BOUNDARY_OPS:
                l = extract(l) if _is_compute(l) else l
                r = extract(r) if _is_compute(r) else r
            else:
                if op in ("+", "-"):
                    if l[0] == "bin" and l[1] == "*":
                        l = extract(l)
                    if r[0] == "bin" and r[1] == "*":
                        r = extract(r)
                l = extract(l) if _is_boundary(l) else l
                r = extract(r) if _is_boundary(r) else r
            return ("bin", op, l, r)
        kids = [c if isinstance(c, str) else walk(c) for c in node[1:]]
        kids = [c if isinstance(c, str) or not _is_boundary(c)
                else extract(c) for c in kids]
        return (k, *kids)

    def extract(node):
        sub = Plan()
        sub.padded, sub.nrows, sub.device = (plan.padded, plan.nrows,
                                             plan.device)
        remap_l: Dict[int, int] = {}
        remap_k: Dict[int, int] = {}

        def rebind(n):
            if n[0] == "L":
                ix = remap_l.get(n[1])
                if ix is None:
                    ix = remap_l[n[1]] = len(sub.leaves)
                    sub.leaves.append(plan.leaves[n[1]])
                    sub.leaf_ctypes.append(plan.leaf_ctypes[n[1]])
                    sub.leaf_dtypes.append(plan.leaf_dtypes[n[1]])
                return ("L", ix)
            if n[0] == "K":
                ix = remap_k.get(n[1])
                if ix is None:
                    ix = remap_k[n[1]] = len(sub.consts)
                    sub.consts.append(plan.consts[n[1]])
                return ("K", ix)
            return (n[0], *[c if isinstance(c, str) else rebind(c)
                            for c in n[1:]])

        sub.root = rebind(node)
        sub.n_ops = _count_ops(sub.root)
        _split_rewrite_edges(sub)
        _finish_signature(sub)
        ix = len(plan.leaves)
        plan.leaves.append(sub)
        plan.leaf_ctypes.append(T_NUM)
        plan.leaf_dtypes.append(_out_dtype(sub, sub.root))
        return ("L", ix)

    plan.root = walk(plan.root)
    _compact_leaves(plan)


def _count_ops(node) -> int:
    if node[0] in ("L", "K"):
        return 0
    return 1 + sum(_count_ops(c) for c in node[1:]
                   if not isinstance(c, str))


def _compact_leaves(plan: Plan) -> None:
    """Drop leaves and constants the rewritten tree no longer references
    and renumber the rest in first-use order."""
    used_l: Dict[int, int] = {}
    used_k: Dict[int, int] = {}

    def renum(n):
        if n[0] == "L":
            return ("L", used_l.setdefault(n[1], len(used_l)))
        if n[0] == "K":
            return ("K", used_k.setdefault(n[1], len(used_k)))
        return (n[0], *[c if isinstance(c, str) else renum(c)
                        for c in n[1:]])

    plan.root = renum(plan.root)
    plan.leaves = [plan.leaves[i] for i in used_l]
    plan.leaf_ctypes = [plan.leaf_ctypes[i] for i in used_l]
    plan.leaf_dtypes = [plan.leaf_dtypes[i] for i in used_l]
    plan.consts = [plan.consts[i] for i in used_k]


def _leaf_sig(plan: Plan, i: int) -> str:
    leaf = plan.leaves[i]
    if isinstance(leaf, Plan):
        return "P{" + leaf.signature + "}"
    return f"{plan.leaf_ctypes[i]}/{plan.leaf_dtypes[i]}"


def _finish_signature(plan: Plan) -> None:
    plan.signature = (_render(plan.root)
                      + "|" + ",".join(_leaf_sig(plan, i)
                                       for i in range(len(plan.leaves)))
                      + f"|k{len(plan.consts)}|r{plan.padded}")


# ---------------------------------------------------------------------------
# the shared emitter: the eager prims' expressions over a plan tree
# ---------------------------------------------------------------------------

def eval_tree(node, leaf: Callable[[int], torch.Tensor],
              const: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """Evaluate a plan tree: `leaf(i)` gives leaf i in its storage dtype
    (enum codes through cat_to_f32), `const(i)` constant i as a 0-dim
    float32 tensor.
    Every node is the ops/elementwise expression its eager prim calls."""
    k = node[0]
    if k == "L":
        return leaf(node[1])
    if k == "K":
        return const(node[1])
    if k == "bin":
        return E.binop_expr(node[1], eval_tree(node[2], leaf, const),
                            eval_tree(node[3], leaf, const))
    if k == "log":
        return E.logical_expr(node[1], eval_tree(node[2], leaf, const),
                              eval_tree(node[3], leaf, const)).float()
    if k == "un":
        return E.unop_expr(node[1], eval_tree(node[2], leaf, const))
    if k == "ifelse":
        return E.ifelse_expr(eval_tree(node[1], leaf, const),
                             eval_tree(node[2], leaf, const),
                             eval_tree(node[3], leaf, const))
    if k == "isna":
        return E.isna_expr(eval_tree(node[1], leaf, const))
    raise AssertionError(f"bad fused node {k!r}")


def leaf_reader(ctypes: List[str], leaves: List[torch.Tensor]
                ) -> Callable[[int], torch.Tensor]:
    def leaf(i):
        d = leaves[i]
        return E.cat_to_f32(d) if ctypes[i] == T_CAT else d
    return leaf


def _emit(plan: Plan) -> Callable:
    """The plan as fn(leaves, consts) -> tensor."""
    ctypes = list(plan.leaf_ctypes)
    root = plan.root

    def f(leaves, consts):
        return eval_tree(root, leaf_reader(ctypes, leaves),
                         consts.__getitem__)

    return f


# ---------------------------------------------------------------------------
# programs: static inputs and a CUDA graph on the card, op by op on the CPU
# ---------------------------------------------------------------------------

# every fused graph (statements and pipelines) allocates from one pool and
# runs on one stream under one lock: a graph's output is cloned on that
# stream before the next replay, so graphs whose pools overlap never read
# each other's memory
_RUN_LOCK = threading.RLock()
_POOLS: Dict[Any, tuple] = {}


def _pool(device: torch.device) -> tuple:
    """(the shared graph memory pool, the stream every fused program of a
    device is captured and replayed on)."""
    p = _POOLS.get(device)
    if p is None:
        with torch.cuda.device(device):
            p = _POOLS[device] = (torch.cuda.graph_pool_handle(),
                                  torch.cuda.Stream())
    return p


def capture(fn: Callable[[], torch.Tensor], device: torch.device):
    """(graph, output) of `fn` captured on a side stream into the shared
    pool. This is torch.cuda.graph without the synchronize, gc.collect
    and empty_cache it runs before every capture: a server captures once
    per new statement shape, and emptying the allocator's cache each time
    makes the next requests pay fresh cudaMallocs."""
    from h2o3_tpu_torch.core.runtime import CAPTURE_LOCK

    pool, side = _pool(device)
    g = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with CAPTURE_LOCK, torch.cuda.stream(side):
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            g.capture_end()
    cur.wait_stream(side)
    return g, out


_CONST_CACHE: "collections.OrderedDict[tuple, torch.Tensor]" = \
    collections.OrderedDict()
_CONST_CAP = 1024


def const_vector(consts, device: torch.device) -> torch.Tensor:
    """A plan's constants as one float32 device vector, cached by value:
    the first use copies them from pinned memory without blocking, later
    statements with the same literals copy nothing."""
    arr = np.asarray(consts, np.float32).reshape(-1)
    key = (device, arr.tobytes())
    with _LOCK:
        t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(arr).pin_memory().to(device, non_blocking=True)
        with _LOCK:
            if len(_CONST_CACHE) >= _CONST_CAP:
                _CONST_CACHE.popitem(last=False)
            _CONST_CACHE[key] = t
    return t


def cpu_consts(consts, device) -> List[torch.Tensor]:
    """Constants as 0-dim float32 tensors, as the eager prims make them."""
    return [torch.full((), float(np.float32(v)), dtype=torch.float32,
                       device=device) for v in consts]


class GraphProgram:
    """One program at one input layout. `fn(inputs, consts)` is the op
    sequence; `specs` the (shape, dtype) of each input. On the card the
    inputs live in static buffers: the first `run` executes `fn` eagerly
    over them (measuring its memory for the planner) and captures it;
    later runs copy their inputs in, refresh the constants and replay.
    `run(..., m=...)` fills the first m rows of row-shaped inputs (the
    rest zeroed) and returns the first m output rows. On the CPU `run`
    calls `fn` on the inputs as given."""

    def __init__(self, fn: Callable, specs: List[tuple], n_const: int,
                 device: torch.device, family: str, rows: int):
        self.fn = fn
        self.n_const = int(n_const)
        self.device = torch.device(device)
        self.family = family
        self.rows = int(rows)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.statics: List[torch.Tensor] = []
        self.kbuf: Optional[torch.Tensor] = None
        self.nbytes = 0
        if self.device.type == "cuda":
            self.statics = [torch.zeros(shape, dtype=dt, device=self.device)
                            for shape, dt in specs]
            self.kbuf = torch.zeros(max(self.n_const, 1),
                                    dtype=torch.float32, device=self.device)
            self.nbytes = sum(s.numel() * s.element_size()
                              for s in self.statics)

    def run(self, inputs: List[torch.Tensor], consts,
            m: Optional[int] = None) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.fn(list(inputs), cpu_consts(consts, self.device))
        kvec = const_vector(consts, self.device) if self.n_const else None
        stream = _pool(self.device)[1]
        cur = torch.cuda.current_stream(self.device)
        with _RUN_LOCK:
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                for st, x in zip(self.statics, inputs):
                    if m is None or st.dim() == 0:
                        st.copy_(x)
                    else:
                        st[:m].copy_(x)
                        if m < st.shape[0]:
                            st[m:].zero_()
                if kvec is not None:
                    kvec.record_stream(stream)
                    self.kbuf[: self.n_const].copy_(kvec)
                if self.graph is not None:
                    self.graph.replay()
                    out = (self.out if m is None else self.out[:m]).clone()
                else:
                    out = self._first_run()
                    out = out if m is None else out[:m]
            cur.wait_stream(stream)
        out.record_stream(cur)
        return out

    def _first_run(self) -> torch.Tensor:
        from h2o3_tpu_torch.memory import budget
        from h2o3_tpu_torch.obs import compiles

        dev = self.device
        ks = [self.kbuf[i] for i in range(self.n_const)]
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        # an OutOfMemoryError here leaves the program uncaptured, for the
        # memory ladder to retry in a smaller window
        out = self.fn(self.statics, ks)
        peak = torch.cuda.max_memory_allocated(dev) - base
        budget.note_compiled(self.family, self.rows, peak)
        t0 = time.perf_counter()
        self.graph, self.out = capture(lambda: self.fn(self.statics, ks),
                                       dev)
        self.nbytes += self.out.numel() * self.out.element_size()
        compiles.record_compile(
            self.family, (self.rows, [tuple(s.shape) for s in self.statics],
                          [str(s.dtype) for s in self.statics]),
            (time.perf_counter() - t0) * 1000.0,
            program=f"{self.family}_graph", hbm_bytes=peak)
        _bump("captures")
        return out


class ProgramCache:
    """LRU of GraphPrograms bounded by count and by the bytes of their
    static inputs and outputs."""

    def __init__(self, cap: int, cap_bytes: int):
        self.cap = int(cap)
        self.cap_bytes = int(cap_bytes)
        self._lock = threading.Lock()
        self._progs: "collections.OrderedDict[Any, GraphProgram]" = \
            collections.OrderedDict()

    def get(self, key) -> Optional[GraphProgram]:
        with self._lock:
            prog = self._progs.get(key)
            if prog is not None:
                self._progs.move_to_end(key)
            return prog

    def put(self, key, prog: GraphProgram) -> GraphProgram:
        with self._lock:
            cur = self._progs.setdefault(key, prog)
            self._progs.move_to_end(key)
            while len(self._progs) > 1 and (
                    len(self._progs) > self.cap
                    or sum(p.nbytes for p in self._progs.values())
                    > self.cap_bytes):
                self._progs.popitem(last=False)
            return cur

    def clear(self) -> None:
        with self._lock:
            self._progs.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._progs)


_PROGRAMS = ProgramCache(256, 2 << 30)


def clear_programs() -> None:
    """Drop every cached program (and its graph)."""
    _PROGRAMS.clear()


def _out_dtype(plan: Plan, node) -> str:
    """The dtype name a plan node evaluates to: a numeric leaf's own, an
    ifelse's branches' common dtype (ops/elementwise `promote`), float32
    for everything else."""
    k = node[0]
    if k == "L":
        return ("float32" if plan.leaf_ctypes[node[1]] == T_CAT
                else plan.leaf_dtypes[node[1]])
    if k == "ifelse":
        a, b = _out_dtype(plan, node[2]), _out_dtype(plan, node[3])
        return a if a == b else "float32"
    return "float32"


def _program_for(plan: Plan, win: Optional[int] = None) -> GraphProgram:
    rows = int(win if win is not None else plan.padded)
    key = (plan.device, plan.signature
           + (f"|w{rows}" if win is not None else ""))
    prog = _PROGRAMS.get(key)
    if prog is not None:
        from h2o3_tpu_torch.obs import compiles

        _bump("compile_cache_hits")
        compiles.record_hit("rapids")
        return prog
    specs = []
    for i, leaf in enumerate(plan.leaves):
        scalar = isinstance(leaf, Plan) and _plan_is_scalar(leaf)
        specs.append(((), torch.float32) if scalar else
                     ((rows,), getattr(torch, plan.leaf_dtypes[i])))
    prog = GraphProgram(_emit(plan), specs, len(plan.consts), plan.device,
                        "rapids", rows)
    _bump("fused_programs_compiled")
    return _PROGRAMS.put(key, prog)


def run_program(plan: Plan) -> torch.Tensor:
    """Run one plan over its full leaves, sub-plan leaves first (each its
    own program; their outputs stay on the device)."""
    args = [(run_program(l) if isinstance(l, Plan) else l.data)
            for l in plan.leaves]
    out = _program_for(plan).run(args, plan.consts)
    _bump("fused_programs")
    return out


# ---------------------------------------------------------------------------
# windowed execution (memory planner / OOM ladder)
# ---------------------------------------------------------------------------

def _window_pow2(m: int) -> int:
    """Windowed programs run at power-of-two row counts, so a ladder (or a
    ragged tail) makes at most log2(rows) program shapes."""
    return 1 << max(int(m) - 1, 0).bit_length()


def _run_windowed(plan: Plan, pos: int, m: int, win: int,
                  scalar_cache: Dict) -> torch.Tensor:
    """Rows [pos, pos + m) of the plan through its `win`-row program.
    Scalar sub-plans run once per statement; row-shaped ones window at
    the same offset, so no full-length intermediate is made."""
    args = []
    for leaf in plan.leaves:
        if isinstance(leaf, Plan):
            if _plan_is_scalar(leaf):
                if id(leaf) not in scalar_cache:
                    scalar_cache[id(leaf)] = run_program(leaf)
                args.append(scalar_cache[id(leaf)])
            else:
                args.append(_run_windowed(leaf, pos, m, win, scalar_cache))
        else:
            args.append(leaf.data[pos: pos + m])
    out = _program_for(plan, win).run(args, plan.consts, m=m)
    _bump("fused_programs")
    return out


def _run_streamed(plan: Plan) -> torch.Tensor:
    """The plan under memory/stream.run_windows: the planned-full case runs
    the single full program; a budgeted or OOM-halved run streams
    power-of-two windows and concatenates them on the device."""
    from h2o3_tpu_torch.memory import stream

    n = int(plan.padded)
    scalar_cache: Dict[int, Any] = {}

    def window(pos, m):
        if pos == 0 and m == n:
            return run_program(plan)
        return _run_windowed(plan, pos, m, _window_pow2(m), scalar_cache)

    pieces = stream.run_windows("rapids", n, window, max_window=n,
                                row_bytes=4.0 * (len(plan.leaves) + 2))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def execute_plan(plan: Plan) -> Column:
    """Run one fused statement plan; the result stays a device column.
    The ``fused_dispatch`` span times the host-side dispatch only (no
    device sync)."""
    from h2o3_tpu_torch.obs import tracing

    with tracing.span("fused_dispatch", ops=plan.n_ops, rows=int(plan.nrows),
                      leaves=len(plan.leaves)):
        out = _run_streamed(plan)
    _bump("fused_rows", int(plan.nrows))
    return Column.from_device(out, T_NUM, plan.nrows)


_MISS = object()


def try_execute(ast, env):
    """Offer an application node to the fusion engine: the fused result
    Frame, or _MISS when the subtree does not plan (the caller evaluates
    eagerly). Planning only reads the environment, so a miss has no side
    effects. Errors while running a plan propagate."""
    if not enabled():
        return _MISS
    from h2o3_tpu_torch.obs import tracing

    with tracing.span("plan", prim=ast[0].name):
        plan = plan_expr(ast, env)
    if plan is None:
        return _MISS
    col = execute_plan(plan)
    fr = Frame()
    fr.add(plan.out_name, col)
    return fr


def note_statement_result(fused_programs_before: int) -> None:
    """Statement epilogue: the statement counts as fused when at least one
    fused program ran during it."""
    with _LOCK:
        if _COUNTS["fused_programs"] > fused_programs_before:
            _COUNTS["fused_statements"] += 1


def stats() -> dict:
    """Counters, cache occupancy, the lazy planner's counters and the
    parse memo's (the reference's ScoringMetrics `rapids` block)."""
    from h2o3_tpu_torch.rapids import parser as _parser
    from h2o3_tpu_torch.rapids import planner as _planner

    out = counters()
    out["cached_programs"] = len(_PROGRAMS)
    out["enabled"] = enabled()
    lazy = _planner.counters()
    lazy["enabled"] = _planner.enabled()
    out["lazy"] = lazy
    info = _parser.parse_cached.cache_info()
    out["parse_cache"] = {"size": info.currsize, "cap": info.maxsize,
                          "hits": info.hits, "misses": info.misses}
    return out
