"""Lazy whole-session Rapids: the cross-statement DAG planner
(counterpart of h2o3_tpu/rapids/planner.py).

- **Deferral.** ``(tmp= k expr)`` / ``(assign k expr)`` statements whose
  right side the fusion engine can plan (fusible chains over device
  columns), device ``sort`` statements and contiguous row slices of a
  deferred sort are recorded as DAG nodes instead of running. The
  assigned temp is a real Frame whose columns are lazy
  (``Column.file_backed`` with a planner loader), so rows, names and
  types answer without running anything, and any data access (a
  reducer, a CSV export, a model build) is an observation point that
  flushes the DAG. A statement the planner cannot defer flushes first
  and then runs eagerly, so statement order holds.
- **SSA bindings and pinning.** Every identifier in a deferred right side
  is resolved when the statement defers and snapshotted on its node, so
  overwriting or ``rm``-ing a temp later cannot change what the node
  reads; its concrete input Columns are counted in the Session's
  refcounts (and held) until the node retires.
- **Flush.** At a flush the planner computes liveness: nodes whose key
  was overwritten or removed and that no live node reads are dead temps,
  never computed. A deferred intermediate read by exactly one live fused
  statement is inlined into that statement's program (no Column is
  made). Structurally identical live nodes over the same inputs and
  constants are computed once (``cse_hits``). A device sort whose only
  live reader is a row slice runs as one sort+window
  (``ops/sort.sort_frame(rows=(lo, hi))``).
- **Eager replay.** A node whose plan the fusion engine cannot hold (a
  ragged layout, a host column, fusion switched off) replays its
  recorded AST through the eager evaluator over its snapshotted
  bindings, with the same bits. An error while running a plan propagates
  (it is not turned into a replay).
- **Threads.** A flush holds the planner's reentrant lock: a reader on
  another thread waits for it and then finds its node done; a lazy
  Column still pending has no tensor, so the cleaner never evicts it.

``enabled()`` is False in a multi-process torch.distributed job: a
flush triggered on one rank would run device programs the other ranks
do not.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.ops import elementwise as E
from h2o3_tpu_torch.rapids import fusion
from h2o3_tpu_torch.rapids.parser import Id, NumList, StrLit, StrList

_MISS = object()

# ---------------------------------------------------------------------------
# enable / force switches (the contract of fusion.enabled / fusion.force)
# ---------------------------------------------------------------------------

_FORCE: Optional[bool] = None


def _world_size() -> int:
    """The ranks that run each statement in step: the row mesh's (a
    deferred statement would flush at observation points that not every
    rank shares), else the default process group's."""
    import torch.distributed as dist

    from h2o3_tpu_torch.parallel import mesh as M

    m = M.current()
    if m is not None and m.size > 1:
        return m.size
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def enabled() -> bool:
    """Master switch for deferral (H2O_TPU_RAPIDS_LAZY, default on); off
    in a multi-process job."""
    if _FORCE is not None:
        return _FORCE
    if _world_size() > 1:
        return False
    return os.environ.get("H2O_TPU_RAPIDS_LAZY", "1").lower() not in (
        "0", "false", "off")


class force:
    """Context manager pinning deferral on or off whatever the env knob
    says (A/B runs and the equivalence tests)."""

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
# counters
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COUNTS = {
    "deferred_statements": 0,      # statements recorded as DAG nodes
    "flushes": 0,                  # DAG flushes (>= 1 node processed)
    "cse_hits": 0,                 # nodes served from an identical node
    "dead_temps_eliminated": 0,    # nodes never computed (unobservable)
    "inlined_intermediates": 0,    # nodes spliced into readers' programs
    "fused_sort_selections": 0,    # sort+slice pairs run as one window
    "eager_replays": 0,            # nodes replayed through the evaluator
    "transparent_statements": 0,   # metadata-only munges over lazy columns
}
_PENDING = 0                       # deferred statements awaiting a flush


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[key] += int(n)


def _pending_add(n: int) -> None:
    global _PENDING
    with _LOCK:
        _PENDING += int(n)


def counters() -> dict:
    with _LOCK:
        out = dict(_COUNTS)
        out["deferred_pending"] = _PENDING
        return out


def reset_counters() -> None:
    global _PENDING
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
        _PENDING = 0


class _NotDeferrable(Exception):
    """Internal: this statement must flush and run eagerly."""


# ---------------------------------------------------------------------------
# DAG nodes and lazy frames
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("kind", "key", "ast", "bindings", "deps", "out",
                 "out_cols", "out_names", "output_dead", "state", "seq",
                 "by", "asc", "src_frame", "src", "lo", "hi", "nrows",
                 "pinned")

    def __init__(self, kind: str):
        self.kind = kind               # "expr" | "sort" | "slice"
        self.key: Optional[str] = None
        self.ast = None
        self.bindings: Dict[str, Any] = {}
        self.deps: List["_Node"] = []
        self.out: Optional[Frame] = None
        self.out_cols: List[Column] = []
        self.out_names: List[str] = []
        self.output_dead = False
        self.state = "pending"         # pending -> done
        self.seq = 0
        self.by = None                 # sort: key names
        self.asc = True                # sort: direction(s)
        self.src_frame: Optional[Frame] = None   # sort: input frame
        self.src: Optional["_Node"] = None       # slice: the sort node
        self.lo = 0                    # slice window
        self.hi = 0
        self.nrows = 0
        self.pinned: List[Column] = []


class DeferredFrame(Frame):
    """Pending output of a deferred statement: a Frame whose lazy Columns
    materialize through the owning planner on first data access."""

    def __init__(self, node: _Node, key: Optional[str] = None):
        super().__init__(key=key)
        self._node = node

    def __repr__(self) -> str:
        return (f"<DeferredFrame {self._key} {self.nrows}x{self.ncols} "
                f"{self._node.kind}:{self._node.state}>")


def _lazy_column(planner: "SessionPlanner", node: _Node, ctype: str,
                 nrows: int, domain=None) -> Column:
    """A Column whose first data access observes `node`. The flush binds
    the tensor through the data setter (which also drops the loader, so
    an eviction afterwards copies to the host and never runs the flush
    again); the loader hands the bound tensor back."""
    holder: Dict[str, Column] = {}

    def _load():
        planner.observe(node)
        d = holder["col"]._data
        if d is None:
            raise RuntimeError(
                f"deferred rapids node #{node.seq} ({node.kind}) failed "
                "to materialize")
        return d

    col = Column.file_backed(_load, ctype, nrows, domain=domain)
    holder["col"] = col
    return col


# ---------------------------------------------------------------------------
# deferral scanning: the shapes the eager evaluator accepts, so a statement
# the eager path would reject is never deferred and fails where it stands
# ---------------------------------------------------------------------------

class _Scan:
    __slots__ = ("bindings", "deps", "_dep_ids", "nrows", "cols")

    def __init__(self):
        self.bindings: Dict[str, Any] = {}
        self.deps: List[_Node] = []
        self._dep_ids: set = set()
        self.nrows: Optional[int] = None
        self.cols: List[Column] = []   # concrete columns (to pin)


class _SnapEnv:
    """Env over a node's SSA binding snapshot."""

    __slots__ = ("b",)

    def __init__(self, bindings: Dict[str, Any]):
        self.b = bindings

    def lookup(self, name: str):
        if name in self.b:
            return self.b[name]
        raise KeyError(name)


# live planners, found by column token: the pipeline splicer gets only a
# Frame and must find the planner whose DAG owns its lazy columns without
# touching them (a data access would flush)
_PLANNERS: "weakref.WeakSet" = weakref.WeakSet()


def pending_node_for_token(tok: int):
    """(planner, node) owning a still-pending lazy column, else None."""
    for pl in list(_PLANNERS):
        n = pl.node_for_token(tok)
        if n is not None and n.state == "pending":
            return pl, n
    return None


class SessionPlanner:
    """Per-Session deferred-statement DAG (see the module docstring)."""

    def __init__(self, session):
        self.session = session
        self._lock = threading.RLock()
        self._nodes: List[_Node] = []
        self._by_key: Dict[str, _Node] = {}
        self._by_token: Dict[int, _Node] = {}
        self._cse: Dict[tuple, Column] = {}
        self._seq = 0
        self._flushing = False
        _PLANNERS.add(self)

    # -- lookup ------------------------------------------------------------
    def node_for_token(self, tok: int) -> Optional[_Node]:
        return self._by_token.get(tok)

    def node_for_frame(self, fr: Frame) -> Optional[_Node]:
        """The single pending node all of fr's columns belong to."""
        node = None
        for c in fr.columns:
            n = self._by_token.get(c.token)
            if n is None or n.state != "pending" or \
                    (node is not None and n is not node):
                return None
            node = n
        return node

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._nodes)

    # -- statement entry ---------------------------------------------------
    def offer(self, ast, env):
        """The statement's result when it defers, else _MISS after
        flushing the pending DAG (the statement is an observation point,
        except `rm`, which only retires, and the metadata-only munges)."""
        with self._lock:
            if enabled():
                try:
                    got = self._try_defer(ast, env)
                except _NotDeferrable:
                    got = _MISS
                if got is not _MISS:
                    return got
            if self._is_rm(ast):
                return _MISS       # retirement rides Session.remove
            if self._is_assign(ast):
                # the key will be rebound: its pending node (if any) stays
                # observable only through still-deferred readers
                old = self._by_key.pop(self._assign_key(ast), None)
                if old is not None:
                    old.output_dead = True
            if self._nodes and self._is_transparent(ast):
                # cbind / append / colnames= / cols move Column references
                # between frames without reading a value: running them
                # over lazy columns observes nothing, and the assembled
                # frame keeps its pending tokens for the pipeline splice
                _bump("transparent_statements")
                return _MISS
            if self._nodes:
                from h2o3_tpu_torch.obs import tracing

                with tracing.span("flush", reason="statement"):
                    self.flush()
            return _MISS

    @staticmethod
    def _is_assign(ast) -> bool:
        return (isinstance(ast, list) and len(ast) == 3
                and isinstance(ast[0], Id)
                and ast[0].name in ("tmp=", "assign"))

    @staticmethod
    def _assign_key(ast) -> str:
        k = ast[1]
        return k.name if isinstance(k, Id) else str(k)

    @staticmethod
    def _is_rm(ast) -> bool:
        return (isinstance(ast, list) and len(ast) == 2
                and isinstance(ast[0], Id) and ast[0].name == "rm")

    # prims that only assemble frames from Column references
    # (Frame.cbind/subframe/add/rename) and never touch `.data`
    _TRANSPARENT = frozenset({"cbind", "append", "colnames=", "cols",
                              "cols_py"})

    @classmethod
    def _is_transparent(cls, ast) -> bool:
        if cls._is_assign(ast):
            ast = ast[2]
        return (isinstance(ast, list) and bool(ast)
                and isinstance(ast[0], Id)
                and ast[0].name in cls._TRANSPARENT)

    # -- deferral ----------------------------------------------------------
    def _try_defer(self, ast, env):
        if not self._is_assign(ast):
            # a bare statement hands its result straight back: deferring
            # buys nothing; chaining happens through temps
            return _MISS
        key = self._assign_key(ast)
        rhs = ast[2]
        if not (isinstance(rhs, list) and rhs and isinstance(rhs[0], Id)):
            return _MISS
        head = rhs[0].name
        if head == "sort":
            node = self._scan_sort(rhs, env)
        elif head == "rows":
            node = self._scan_slice(rhs, env)
        elif head in fusion.ROOT_OPS:
            node = self._scan_expr_node(rhs, env)
        else:
            return _MISS
        self._seq += 1
        node.seq = self._seq
        node.key = key
        old = self._by_key.get(key)
        if old is not None:
            old.output_dead = True
        self._by_key[key] = node
        self._nodes.append(node)
        for c in node.out_cols:
            self._by_token[c.token] = node
        self.session.pin_columns(node.pinned)
        _bump("deferred_statements")
        _pending_add(1)
        return self.session.assign(key, node.out)

    def _bind_name(self, name: str, env, sc: _Scan):
        if name in sc.bindings:
            return sc.bindings[name]
        try:
            v = env.lookup(name)
        except KeyError:
            raise _NotDeferrable
        sc.bindings[name] = v
        return v

    def _note_col(self, col: Column, sc: _Scan) -> None:
        if col.ctype not in fusion._LEAF_CTYPES:
            raise _NotDeferrable
        if sc.nrows is None:
            sc.nrows = col.nrows
        elif sc.nrows != col.nrows:
            raise _NotDeferrable       # eager would raise a row mismatch
        node = self._by_token.get(col.token)
        if node is not None and node.state == "pending":
            if id(node) not in sc._dep_ids:
                sc._dep_ids.add(id(node))
                sc.deps.append(node)
        else:
            sc.cols.append(col)

    def _scan_expr(self, ast, env, sc: _Scan) -> bool:
        """-> is_col; _NotDeferrable on any shape the fusion planner (or
        the eager evaluator) would not take."""
        if isinstance(ast, bool):
            raise _NotDeferrable
        if isinstance(ast, (int, float)):
            return False
        if isinstance(ast, Id):
            v = self._bind_name(ast.name, env, sc)
            if isinstance(v, Frame):
                if v.ncols != 1:
                    raise _NotDeferrable
                self._note_col(v.col(0), sc)
                return True
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return False
            raise _NotDeferrable
        if not isinstance(ast, list) or not ast or \
                not isinstance(ast[0], Id):
            raise _NotDeferrable
        name = ast[0].name
        if name in ("cols", "cols_py"):
            if len(ast) != 3 or not isinstance(ast[1], Id):
                raise _NotDeferrable
            fr = self._bind_name(ast[1].name, env, sc)
            if not isinstance(fr, Frame):
                raise _NotDeferrable
            try:
                cname = fusion.cols_sel_name(fr, ast[2])
            except LookupError:
                raise _NotDeferrable
            self._note_col(fr.col(cname), sc)
            return True
        if name in fusion._BIN_NAMES:
            if len(ast) != 3:
                raise _NotDeferrable
            l = self._scan_expr(ast[1], env, sc)
            r = self._scan_expr(ast[2], env, sc)
            return l or r
        if name in fusion._LOGICAL_NAMES:
            if len(ast) != 3:
                raise _NotDeferrable
            l = self._scan_expr(ast[1], env, sc)
            r = self._scan_expr(ast[2], env, sc)
            if not (l or r):
                raise _NotDeferrable
            return True
        if name in E._UNOPS:
            if len(ast) != 2 or not self._scan_expr(ast[1], env, sc):
                raise _NotDeferrable
            return True
        if name == "ifelse":
            if len(ast) != 4 or not self._scan_expr(ast[1], env, sc):
                raise _NotDeferrable
            self._scan_expr(ast[2], env, sc)
            self._scan_expr(ast[3], env, sc)
            return True
        if name == "is.na":
            if len(ast) != 2 or not self._scan_expr(ast[1], env, sc):
                raise _NotDeferrable
            return True
        raise _NotDeferrable

    def _lazy_frame(self, node: _Node, fr: Frame, nrows: int) -> None:
        """node.out: one lazy column per column of `fr`."""
        df = DeferredFrame(node)
        for nm in fr.names:
            c = fr.col(nm)
            lc = _lazy_column(self, node, c.ctype, nrows, domain=c.domain)
            df.add(nm, lc)
            node.out_cols.append(lc)
            node.out_names.append(nm)
        node.out = df

    def _scan_expr_node(self, rhs, env) -> _Node:
        sc = _Scan()
        if not self._scan_expr(rhs, env, sc) or sc.nrows is None:
            raise _NotDeferrable
        node = _Node("expr")
        node.ast = rhs
        node.bindings = sc.bindings
        node.deps = sc.deps
        node.nrows = sc.nrows
        node.pinned = sc.cols
        col = _lazy_column(self, node, T_NUM, sc.nrows)
        name = _expr_out_name(rhs)
        df = DeferredFrame(node)
        df.add(name, col)
        node.out = df
        node.out_cols = [col]
        node.out_names = [name]
        return node

    def _scan_sort(self, rhs, env) -> _Node:
        # (sort fr by asc...): every column rides a lazy device Column, so
        # frames with host (string) columns stay eager
        if len(rhs) < 3 or not isinstance(rhs[1], Id):
            raise _NotDeferrable
        sc = _Scan()
        fr = self._bind_name(rhs[1].name, env, sc)
        if not isinstance(fr, Frame) or not fr.ncols:
            raise _NotDeferrable
        by = _sort_by_names(fr, rhs[2])
        asc = _sort_ascending(rhs[3:])
        for c in fr.columns:
            self._note_col(c, sc)
        node = _Node("sort")
        node.ast = rhs
        node.bindings = sc.bindings
        node.deps = sc.deps
        node.nrows = fr.nrows
        node.pinned = sc.cols
        node.by = by
        node.asc = asc
        node.src_frame = fr
        self._lazy_frame(node, fr, fr.nrows)
        return node

    def _scan_slice(self, rhs, env) -> _Node:
        # (rows s [lo:hi]) over a deferred sort: the pair the flush runs
        # as one windowed sort
        if len(rhs) != 3 or not isinstance(rhs[1], Id):
            raise _NotDeferrable
        sc = _Scan()
        fr = self._bind_name(rhs[1].name, env, sc)
        if not isinstance(fr, Frame) or not fr.ncols:
            raise _NotDeferrable
        src = self.node_for_frame(fr)
        if src is None or src.kind != "sort":
            raise _NotDeferrable
        sel = rhs[2]
        if not isinstance(sel, NumList):
            raise _NotDeferrable
        from h2o3_tpu_torch.rapids.eval import _idx_list

        idx = _idx_list(sel, fr.nrows)
        if not len(idx) or idx[0] < 0 or \
                not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            raise _NotDeferrable
        n = fr.nrows
        lo = max(0, min(int(idx[0]), n))
        hi = max(lo, min(int(idx[-1]) + 1, n))
        node = _Node("slice")
        node.ast = rhs
        node.bindings = sc.bindings
        node.deps = [src]
        node.src = src
        node.lo = lo
        node.hi = hi
        node.nrows = hi - lo
        self._lazy_frame(node, fr, node.nrows)
        return node

    # -- session hooks -----------------------------------------------------
    def note_removed(self, key: str) -> None:
        with self._lock:
            n = self._by_key.pop(key, None)
            if n is not None:
                n.output_dead = True

    def end(self) -> None:
        """Session teardown: every pending output is unobservable; retire
        the DAG without computing anything."""
        with self._lock:
            nodes = self._nodes
            for n in nodes:
                n.output_dead = True
            dead = [n for n in nodes if n.state == "pending"]
            _bump("dead_temps_eliminated", len(dead))
            self._retire(nodes)

    # -- flush -------------------------------------------------------------
    def flush(self, target: Optional[_Node] = None) -> None:
        """Observation point: plan the DAG (liveness, CSE, inlining,
        sort+window) and run what is observable, in statement order."""
        with self._lock:
            nodes = list(self._nodes)
            if not nodes:
                return
            _bump("flushes")
            needed = self._needed(nodes, target)
            consumers: Dict[int, set] = {}
            for n in nodes:
                if id(n) not in needed:
                    continue
                for d in n.deps:
                    consumers.setdefault(id(d), set()).add(id(n))
            by_id = {id(n): n for n in nodes}
            inline: set = set()
            slice_fused: set = set()
            for n in nodes:
                if id(n) not in needed or not n.output_dead:
                    continue
                cons = consumers.get(id(n), set())
                if len(cons) != 1:
                    continue
                consumer = by_id.get(next(iter(cons)))
                if consumer is None:
                    continue
                # inlining pays only inside a fused reader; with fusion
                # off every reader replays eagerly and needs its deps made
                if n.kind == "expr" and consumer.kind == "expr" and \
                        fusion.enabled():
                    inline.add(id(n))
                elif n.kind == "sort" and consumer.kind == "slice":
                    slice_fused.add(id(consumer))
            self._flushing = True
            try:
                for n in nodes:
                    if id(n) not in needed or id(n) in inline:
                        continue
                    if n.kind == "sort" and self._sort_is_fused(
                            n, consumers, slice_fused):
                        continue
                    self._materialize(n, inline, slice_fused)
            finally:
                self._flushing = False
            _bump("inlined_intermediates", len(inline))
            dead = [n for n in nodes if id(n) not in needed]
            _bump("dead_temps_eliminated", len(dead))
            self._retire(nodes)

    @staticmethod
    def _sort_is_fused(n: _Node, consumers, slice_fused) -> bool:
        cons = consumers.get(id(n), set())
        return len(cons) == 1 and next(iter(cons)) in slice_fused

    @staticmethod
    def _needed(nodes: List[_Node], target: Optional[_Node]) -> set:
        roots = [n for n in nodes if not n.output_dead]
        if target is not None and target.state == "pending":
            roots.append(target)
        needed: set = set()
        stack = list(roots)
        while stack:
            n = stack.pop()
            if id(n) in needed:
                continue
            needed.add(id(n))
            stack.extend(d for d in n.deps if d.state == "pending")
        return needed

    def _retire(self, nodes: List[_Node]) -> None:
        for n in nodes:
            self.session.unpin_columns(n.pinned)
            n.pinned = []
            for c in n.out_cols:
                if self._by_token.get(c.token) is n:
                    self._by_token.pop(c.token)
            if n.key is not None and self._by_key.get(n.key) is n:
                self._by_key.pop(n.key)
        _pending_add(-len(nodes))
        self._nodes = []
        self._cse.clear()

    # -- materialization ---------------------------------------------------
    def observe(self, node: _Node) -> None:
        """A lazy Column of `node` was touched: flush the current epoch
        with full planning when the node belongs to it; a retired
        straggler (a dead temp observed later) materializes alone from
        its recorded recipe."""
        with self._lock:
            if node.state == "done":
                return
            if not self._flushing and any(n is node for n in self._nodes):
                from h2o3_tpu_torch.obs import tracing

                with tracing.span("flush", reason="data_access"):
                    self.flush(target=node)
            if node.state != "done":
                # a re-entry mid-flush (an eager replay touching a lazy
                # leaf) or a straggler: re-entering flush() would loop
                self.ensure(node)

    def ensure(self, node: _Node) -> None:
        """Idempotent on-demand materialization."""
        with self._lock:
            if node.state == "done":
                return
            self._materialize(node, frozenset(), frozenset())

    def _materialize(self, node: _Node, inline, slice_fused) -> None:
        if node.state == "done":
            return
        if node.kind == "slice" and id(node) in slice_fused and \
                node.src is not None and node.src.state == "pending":
            for d in node.src.deps:
                self.ensure(d)
            self._mat_slice_fused(node)
            node.state = "done"
            return
        for d in node.deps:
            if id(d) not in inline:
                self.ensure(d)
        if node.kind == "expr":
            self._mat_expr(node, inline)
        elif node.kind == "sort":
            self._mat_sort(node)
        else:
            self.ensure(node.src)
            self._mat_slice(node)
        node.state = "done"

    def _mat_expr(self, node: _Node, inline) -> None:
        col: Optional[Column] = None
        if fusion.enabled():
            plan = self._build_plan(node, inline)
            if plan is not None:
                ck = _cse_key(plan)
                col = self._cse.get(ck)
                if col is not None:
                    _bump("cse_hits")
                else:
                    col = fusion.execute_plan(plan)
                    self._cse[ck] = col
        if col is None:
            # the replay reads its deps' columns directly: make every dep
            # first, inline-marked ones too, or a lazy leaf's loader would
            # re-enter the flush
            for d in node.deps:
                self.ensure(d)
            col = self._eager_col(node)
            _bump("eager_replays")
        node.out_cols[0].data = col.data

    def _build_plan(self, node: _Node, inline):
        pl = _LazyPlanner(_SnapEnv(node.bindings), self, inline)
        try:
            root, is_col = pl.build(node.ast)
        except fusion._NotFusible:
            return None
        p = pl.plan
        if not is_col or not p.padded or p.n_ops == 0:
            return None
        p.root = root
        p.out_name = fusion._out_name(root)
        fusion._split_rewrite_edges(p)
        fusion._finish_signature(p)
        return p

    def _eager_col(self, node: _Node) -> Column:
        from h2o3_tpu_torch.rapids import eval as _ev

        env = _ev.Env(self.session)
        env.vars.update(node.bindings)
        res = _ev._eval(node.ast, env)
        return res if isinstance(res, Column) else _ev._one_col(res)

    def _mat_sort(self, node: _Node) -> None:
        from h2o3_tpu_torch.ops.sort import sort_frame

        self._fill(node, sort_frame(node.src_frame, node.by,
                                    ascending=node.asc))

    def _mat_slice(self, node: _Node) -> None:
        from h2o3_tpu_torch.ops.filters import slice_rows

        self._fill(node, slice_rows(node.src.out, node.lo, node.hi))

    def _mat_slice_fused(self, node: _Node) -> None:
        from h2o3_tpu_torch.ops.sort import sort_frame

        src = node.src
        res = sort_frame(src.src_frame, src.by, ascending=src.asc,
                         rows=(node.lo, node.hi))
        _bump("fused_sort_selections")
        self._fill(node, res)

    @staticmethod
    def _fill(node: _Node, res: Frame) -> None:
        for lc, nm in zip(node.out_cols, node.out_names):
            d = res.col(nm).data
            if d is None:
                raise RuntimeError(
                    f"deferred {node.kind} produced a host column {nm!r}")
            lc.data = d


# ---------------------------------------------------------------------------
# fused planning over deferred leaves
# ---------------------------------------------------------------------------

class _LazyPlanner(fusion._Planner):
    """fusion._Planner that resolves pending deferred outputs: inlined
    deps splice their expression trees; everything else is made first
    and bound as a leaf."""

    def __init__(self, env, planner: SessionPlanner, inline):
        super().__init__(env)
        self._lazy = planner
        self._inline = inline

    def _bind_value(self, v):
        if isinstance(v, Frame) and v.ncols == 1:
            col = v.col(0)
            node = self._lazy.node_for_token(col.token)
            if node is not None and node.state == "pending":
                return self._pending(node, col), True
        return super()._bind_value(v)

    def _frame_leaf(self, fr, name):
        col = fr.col(name)
        node = self._lazy.node_for_token(col.token)
        if node is not None and node.state == "pending":
            return self._pending(node, col)
        return super()._frame_leaf(fr, name)

    def _pending(self, node: _Node, col: Column):
        if id(node) in self._inline and node.kind == "expr":
            env0 = self.env
            self.env = _SnapEnv(node.bindings)
            try:
                n, is_col = self.build(node.ast)
            finally:
                self.env = env0
            if not is_col:
                raise fusion._NotFusible
            return n
        self._lazy.ensure(node)
        return self._leaf(col)


def _cse_key(plan) -> tuple:
    """Value-level identity of a fused plan: its signature, the concrete
    leaf Column tokens and the constant values."""
    leaves = tuple(("P",) + _cse_key(l) if isinstance(l, fusion.Plan)
                   else ("C", l.token) for l in plan.leaves)
    return (plan.signature, leaves, tuple(plan.consts))


# ---------------------------------------------------------------------------
# scan helpers
# ---------------------------------------------------------------------------

def _expr_out_name(ast) -> str:
    name = ast[0].name
    if name in fusion._BIN_NAMES or name in fusion._LOGICAL_NAMES:
        return fusion._OP_ALIAS.get(name, name)
    if name in E._UNOPS:
        return name
    if name == "is.na":
        return "isNA"
    return "C1"


def _sort_by_names(fr: Frame, by) -> List[str]:
    """The eager sort prim's key names, for the shapes the planner can
    check statically (anything else stays eager)."""
    from h2o3_tpu_torch.rapids.eval import _idx_list

    if isinstance(by, str):
        names = [by]
    elif isinstance(by, StrLit):
        names = [by.s]
    elif isinstance(by, (int, float)) and not isinstance(by, bool):
        i = int(by)
        if not 0 <= i < fr.ncols:
            raise _NotDeferrable
        names = [fr.names[i]]
    elif isinstance(by, StrList):
        names = [s.s if isinstance(s, StrLit) else s for s in by]
    elif isinstance(by, NumList):
        try:
            names = [fr.names[i] for i in _idx_list(by, fr.ncols)]
        except IndexError:
            raise _NotDeferrable
    else:
        raise _NotDeferrable
    if not names or any(n not in fr for n in names):
        raise _NotDeferrable
    return names


def _sort_ascending(rest):
    """The eager sort prim's directions (only the first direction
    argument counts; 1 ascending, <= 0 descending)."""
    if not rest:
        return True
    a0 = rest[0]
    items = a0 if isinstance(a0, (list, NumList)) else [a0]
    asc = []
    for a in items:
        if not isinstance(a, (int, float)) or isinstance(a, bool):
            raise _NotDeferrable
        asc.append(int(a) > 0)
    return asc


# ---------------------------------------------------------------------------
# eval entry
# ---------------------------------------------------------------------------

def offer_statement(ast, env):
    """exec_rapids hook: defer when possible, flush when the statement is
    an observation point. A no-op for a session that never deferred while
    the knob is off."""
    s = env.session
    if getattr(s, "_planner", None) is None and not enabled():
        return _MISS
    return s.planner.offer(ast, env)
