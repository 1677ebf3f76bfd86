"""Munge→score pipeline fusion: one program from raw columns to margins
(counterpart of h2o3_tpu/pipeline.py).

A :class:`~h2o3_tpu_torch.scoring.ScoringSession` (and GLM's predict)
consumes the lazy session planner's DAG:

- **Capture.** When the frame offered to ``predict`` carries still-pending
  deferred Rapids outputs (lazy Columns of a session planner),
  :func:`try_capture` splices each pending expression tree, resolved
  over its SSA binding snapshot as the flush planner's inlining does,
  into one ``("pipe", feat_0, ..., feat_{F-1})`` plan in the model's
  training feature order. Capture only reads the DAG: no node is
  observed and no Column is made (``materialized_columns`` stays 0).
- **One program per row bucket.** On the card one CUDA graph per bucket
  copies the bucket's window of every raw leaf into its static inputs,
  evaluates the feature expressions (the eager prims' expressions, as
  fusion runs them), stacks the feature matrix and runs
  ``compressed.score_core``. On the CPU the features are evaluated over
  the whole frame and scored through the session's bucket programs: the
  CPU's vectorized kernels round a transcendental op by its position in
  the tensor, so this is what keeps the CPU bitwise with the staged
  path.
- **Bitwise contract.** Features are row-local elementwise programs, so a
  pipeline margin equals the staged flush→adapt→pack→score margin bit
  for bit (rewrite-boundary sub-plans run first as their own fusion
  programs, exactly as a flush runs them).
- **GLM.** :func:`try_glm_raw` evaluates the engineered predictors as
  fused plans (tensors, never Columns) and runs the expansion, the
  intercept matmul and the inverse link of ``glm_predict`` in one graph
  at the frame's length.

What capture cannot hold (pending sorts, remapped, unseen or missing
predictors, ragged layouts, host columns) takes the staged path, counted
under ``fallbacks`` with its pending columns under
``materialized_columns``. An error while running a captured program
propagates: it is never turned into a staged result.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT
from h2o3_tpu_torch.rapids import fusion
from h2o3_tpu_torch.rapids import planner as lazy_planner

# ---------------------------------------------------------------------------
# enable / force switches
# ---------------------------------------------------------------------------

_FORCE: Optional[bool] = None


def enabled() -> bool:
    """Master switch (H2O_TPU_PIPELINE_FUSION, default on). Needs both
    upstream engines: statement fusion and the lazy planner."""
    if _FORCE is False:
        return False
    if not (fusion.enabled() and lazy_planner.enabled()):
        return False
    if _FORCE is True:
        return True
    return os.environ.get("H2O_TPU_PIPELINE_FUSION", "1").lower() not in (
        "0", "false", "off")


class force:
    """Context manager pinning pipeline splicing on or off whatever the env
    knob says. Forcing it on still needs fusion and the lazy planner."""

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
    "captures": 0,                 # frames spliced onto a model core
    "fused_dispatches": 0,         # pipeline program executions
    "spliced_nodes": 0,            # pending DAG nodes spliced (no Column)
    "materialized_columns": 0,     # pending columns made by a fallback
    "fused_rows": 0,               # rows through pipeline programs
    "programs_compiled": 0,        # pipeline programs built
    "compile_cache_hits": 0,       # runs served by a cached program
    "fallbacks": 0,                # pending frames left to the staged path
}


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[key] += int(n)


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


# ---------------------------------------------------------------------------
# capture: splice pending DAG expressions into one ("pipe", ...) plan
# ---------------------------------------------------------------------------

class _PipelinePlanner(fusion._Planner):
    """fusion._Planner that splices pending deferred expression nodes
    (over their SSA snapshots) instead of making them, and records the
    frame-level name of every concrete leaf (the raw-input schema a
    pipeline artifact ships)."""

    def __init__(self, env, planner):
        super().__init__(env)
        self._lazy = planner                   # SessionPlanner or None
        self.spliced: set = set()              # id(node) of spliced nodes
        self.names_by_token: Dict[int, str] = {}

    def _pending_node(self, col: Column):
        if self._lazy is None:
            return None
        n = self._lazy.node_for_token(col.token)
        return n if (n is not None and n.state == "pending") else None

    def _splice(self, node):
        if node.kind != "expr":
            raise fusion._NotFusible          # pending sort/slice: staged
        self.spliced.add(id(node))
        env0 = self.env
        self.env = lazy_planner._SnapEnv(node.bindings)
        try:
            n, is_col = self.build(node.ast)
        finally:
            self.env = env0
        if not is_col:
            raise fusion._NotFusible
        return n

    def _bind_value(self, v):
        if isinstance(v, Frame) and v.ncols == 1:
            node = self._pending_node(v.col(0))
            if node is not None:
                return self._splice(node), True
        return super()._bind_value(v)

    def _frame_leaf(self, fr, name):
        col = fr.col(name)
        node = self._pending_node(col)
        if node is not None:
            return self._splice(node)
        return self._leaf_named(col, name)

    def _leaf_named(self, col: Column, name: str):
        leaf = self._leaf(col)
        prev = self.names_by_token.setdefault(col.token, name)
        if prev != name:                       # one column, two names: the
            self.names_by_token[col.token] = ""  # artifact schema refuses
        return leaf


class Capture:
    """One splice: the fused ("pipe", ...) plan and the layout facts its
    execution and export need. It holds the concrete leaf Columns; the
    DAG stays pending."""

    __slots__ = ("plan", "nrows", "spliced", "names_by_token",
                 "feature_names")

    def __init__(self, plan, nrows: int, spliced: int,
                 names_by_token: Dict[int, str],
                 feature_names: List[str]):
        self.plan = plan
        self.nrows = int(nrows)
        self.spliced = int(spliced)
        self.names_by_token = names_by_token
        self.feature_names = list(feature_names)


def _owning_planner(frame: Frame, names) -> Optional[tuple]:
    """(planner, n_pending) for the one live SessionPlanner all of the
    frame's pending feature columns belong to; None when no feature is
    pending or the ownership is split."""
    owner = None
    n_pending = 0
    for name in names:
        if name not in frame:
            return None
        got = lazy_planner.pending_node_for_token(frame.col(name).token)
        if got is None:
            continue
        pl, _node = got
        if owner is not None and pl is not owner:
            return None
        owner = pl
        n_pending += 1
    if owner is None or n_pending == 0:
        return None
    return owner, n_pending


def _pending_count(frame: Frame, names) -> int:
    """Feature columns of `frame` that are pending lazy outputs."""
    return sum(1 for nm in names if nm in frame and
               lazy_planner.pending_node_for_token(frame.col(nm).token)
               is not None)


def _capture_pipe(frame: Frame, names, planner) -> Optional[Capture]:
    """The fused ("pipe", feat...) plan over `names` in order: every
    pending expression splices, every concrete column binds as a leaf.
    None when a feature cannot enter one program."""
    pp = _PipelinePlanner(None, planner)
    feats = []
    try:
        for name in names:
            col = frame.col(name)
            node = pp._pending_node(col)
            feats.append(pp._splice(node) if node is not None
                         else pp._leaf_named(col, name))
    except fusion._NotFusible:
        return None
    p = pp.plan
    if not p.padded or not pp.spliced or p.nrows != frame.nrows:
        return None
    p.root = ("pipe",) + tuple(feats)
    p.out_name = "pipe"
    fusion._split_rewrite_edges(p)
    fusion._finish_signature(p)
    return Capture(p, frame.nrows, len(pp.spliced),
                   dict(pp.names_by_token), list(names))


def note_fallback(frame: Frame, names) -> None:
    """A frame with pending features that capture cannot hold: the staged
    path will make its pending columns (ROADMAP C33)."""
    n = _pending_count(frame, names)
    if n:
        _bump("fallbacks")
        _bump("materialized_columns", n)


def try_capture(session, frame: Frame) -> Optional[Capture]:
    """Splice a (possibly lazy) frame onto a forest ScoringSession: a
    Capture when every training feature is a concrete, exactly matching
    column or a pending deferred expression, else None (the staged
    adapt→pack→score path). Only reads the DAG."""
    if not enabled():
        return None
    cap = capture_forest(session, frame)
    if cap is None:
        note_fallback(frame, session.spec.names)
        return None
    _bump("captures")
    _bump("spliced_nodes", cap.spliced)
    return cap


def capture_forest(session, frame: Frame) -> Optional[Capture]:
    """try_capture without the switch and the counters (the artifact
    exporter captures through this whatever H2O_TPU_PIPELINE_FUSION
    says)."""
    spec = session.spec
    model = session.model
    got = _owning_planner(frame, spec.names)
    if got is None:
        return None
    planner, _n = got
    # anything adapt_test would raise on, NA-fill or remap stays staged,
    # so its errors surface there
    if model.check_test_compat(frame) is not None:
        return None
    domains = model._output.domains
    for name in spec.names:
        col = frame.col(name)
        train_dom = domains.get(name)
        if train_dom is not None:
            if col.ctype != T_CAT or list(col.domain or []) != \
                    list(train_dom):
                return None
        elif col.ctype == T_CAT:
            return None
    with planner._lock:           # no concurrent flush mid-capture
        cap = _capture_pipe(frame, spec.names, planner)
    if cap is None or cap.plan.device != session.device:
        return None
    return cap


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

_PROGRAMS = fusion.ProgramCache(128, 2 << 30)


def clear_programs() -> None:
    _PROGRAMS.clear()


def _program(key, make) -> fusion.GraphProgram:
    prog = _PROGRAMS.get(key)
    if prog is not None:
        from h2o3_tpu_torch.obs import compiles

        _bump("compile_cache_hits")
        compiles.record_hit("pipeline")
        return prog
    _bump("programs_compiled")
    return _PROGRAMS.put(key, make())


def _features(plan, leaves: List[torch.Tensor], consts, rows: int
              ) -> torch.Tensor:
    """(rows, F) float32 features of a "pipe" plan: a bare column is cast
    as the packer casts it (enum codes stay codes, NA negative); an
    expression evaluates through fusion.eval_tree."""
    leaf = fusion.leaf_reader(list(plan.leaf_ctypes), leaves)
    parts = []
    for f in plan.root[1:]:
        x = (leaves[f[1]].float() if f[0] == "L"
             else fusion.eval_tree(f, leaf, consts.__getitem__))
        parts.append(x.expand(rows) if x.dim() == 0 else x)
    return torch.stack(parts, dim=1)


def _leaf_specs(plan, rows: int) -> List[tuple]:
    specs = []
    for i, leaf in enumerate(plan.leaves):
        scalar = (isinstance(leaf, fusion.Plan)
                  and fusion._plan_is_scalar(leaf))
        specs.append(((), torch.float32) if scalar else
                     ((rows,), getattr(torch, plan.leaf_dtypes[i])))
    return specs


def _forest_program(session, cap: Capture, bucket: int
                    ) -> fusion.GraphProgram:
    plan = cap.plan
    res = session._res

    def make():
        def fn(leaves, consts):
            return res.margins(_features(plan, leaves, consts, bucket))
        return fusion.GraphProgram(fn, _leaf_specs(plan, bucket),
                                   len(plan.consts), session.device,
                                   "pipeline", bucket)

    return _program(("pipe", id(res), plan.signature, bucket), make)


def _leaf_tensors(plan) -> List[torch.Tensor]:
    """The plan's leaves as tensors: sub-plans (rewrite-boundary splits)
    run first as their own fusion programs, as a flush runs them."""
    return [fusion.run_program(l) if isinstance(l, fusion.Plan) else l.data
            for l in plan.leaves]


def execute_margins(session, cap: Capture):
    """Run a captured pipeline over the bucket ladder: (margins,
    n_dispatches), the margins one (n,) or (n, K) tensor of the frame's
    rows."""
    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.memory import stream

    plan = cap.plan
    leaves = _leaf_tensors(plan)
    n = cap.nrows
    n_disp = 0
    cuda = session.device.type == "cuda"
    X = None if cuda else _features(
        plan, leaves, fusion.cpu_consts(plan.consts, session.device), n)

    def window(pos: int, m: int):
        nonlocal n_disp
        if cuda:
            prog = _forest_program(session, cap, session._bucket_for(m))
            out = prog.run([x if x.dim() == 0 else x[pos: pos + m]
                            for x in leaves], plan.consts, m=m)
        else:
            out = session._dispatch("score", X[pos: pos + m])
        n_disp += 1
        _bump("fused_dispatches")
        scoring.note_dispatch("pipeline")
        return out

    outs = stream.run_windows(
        "pipeline", n, window, session.buckets[-1],
        row_bytes=4.0 * (2 * max(len(plan.leaves), 1)
                         + len(session.spec.names) + session._out_k()),
        window_sizer=session._window_snap)
    _bump("fused_rows", n)
    if not outs:
        K = session._out_k()
        return torch.zeros((0,) if K == 1 else (0, K), dtype=torch.float32,
                           device=session.device), 0
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), n_disp


# ---------------------------------------------------------------------------
# GLM: engineered predictors as fused plans + one linear-predictor program
# ---------------------------------------------------------------------------

def glm_eligible(model, frame: Frame) -> Optional[str]:
    """None when `model` can splice over `frame`; else the reason (shared
    by the in-process path and the pipeline artifact exporter)."""
    from h2o3_tpu_torch.models.glm import GLMModel

    if not isinstance(model, GLMModel):
        return f"{type(model).__name__} is not a GLM"
    d = model.dinfo
    if d is None or model.beta is None:
        return "model has no trained coefficients"
    if model.linkname == "ordinal":
        return "ordinal GLMs stay on the staged path"
    if model._parms.get("interactions"):
        return "GLMs with interaction columns expand frames at adapt time"
    oc = model._parms.get("offset_column")
    if oc and oc in frame:
        return "per-request offsets stay on the staged path"
    for name in d.cat_names:
        if name not in frame:
            return f"categorical predictor {name!r} missing"
        col = frame.col(name)
        if col.ctype != T_CAT or list(col.domain or []) != \
                list(d.domains.get(name) or []):
            return f"categorical predictor {name!r} needs domain adaptation"
    for name in d.num_names:
        if name not in frame:
            return f"numeric predictor {name!r} missing"
        if frame.col(name).ctype == T_CAT:
            return f"predictor {name!r} was numeric in training"
    return None


def _glm_feature_plans(model, frame: Frame) -> Optional[tuple]:
    """Per-predictor (DataInfo order) concrete Columns or fused Plans for
    the engineered ones, or None when nothing is pending or a pending
    predictor cannot fuse."""
    d = model.dinfo
    got = _owning_planner(frame, d.predictor_names)
    if got is None:
        return None
    planner, _n = got
    entries: List[tuple] = []
    rows = None
    device = None
    spliced = 0
    with planner._lock:
        for name in d.predictor_names:
            col = frame.col(name)
            node = planner.node_for_token(col.token)
            if node is not None and node.state == "pending":
                pp = _PipelinePlanner(
                    lazy_planner._SnapEnv(node.bindings), planner)
                try:
                    root = pp._splice(node)
                except fusion._NotFusible:
                    return None
                p = pp.plan
                if not p.padded or p.nrows != frame.nrows:
                    return None
                p.root = root
                p.out_name = name
                fusion._split_rewrite_edges(p)
                fusion._finish_signature(p)
                n, dev = p.padded, p.device
                spliced += max(len(pp.spliced), 1)
                entries.append(("plan", p))
            else:
                dcol = col.data
                if dcol is None:
                    return None
                n, dev = int(dcol.shape[0]), dcol.device
                entries.append(("col", col))
            if rows is None:
                rows, device = n, dev
            elif rows != n or device != dev:
                return None
    if spliced == 0:
        return None
    return entries, rows, device, spliced


def _glm_program(model, rows: int, device, dtypes: tuple
                 ) -> fusion.GraphProgram:
    from h2o3_tpu_torch.models.data_info import expand_columns
    from h2o3_tpu_torch.models.glm import glm_predict

    d = model.dinfo
    K = int(model._output.nclasses)

    def make():
        def t(a):
            return torch.as_tensor(a, device=device)

        moments = (t(d.cat_modes.astype("int64")), t(d.impute_values),
                   t(d.num_means), t(d.num_sigmas))
        beta = model.beta.to(device)
        layout = dict(cards=tuple(int(c) for c in d.cards),
                      use_all_factor_levels=d.use_all_factor_levels,
                      standardize=d.standardize, n_cat=len(d.cat_names))

        def fn(arrays, consts):
            X = expand_columns(arrays, *moments, **layout)
            if K > 2:
                return glm_predict(X, beta, 0.0, linkname=model.linkname,
                                   nclasses=K)
            return glm_predict(X, beta, 0.0, linkname=model.linkname,
                               link_power=model.link_power)

        return fusion.GraphProgram(
            fn, [((rows,), getattr(torch, dt)) for dt in dtypes], 0,
            device, "pipeline", rows)

    return _program(("glm", id(model), id(model.beta), rows, dtypes), make)


def try_glm_raw(model, frame: Frame) -> Optional[dict]:
    """The raw prediction dict (``probs``/``value``, as GLMModel's
    _predict_raw gives it) of a GLM fed by a pending lazy feature
    pipeline, made without any engineered Column: each feature plan runs
    as a fusion program, then one program runs the expansion, the
    intercept matmul and the inverse link. None: the staged path."""
    if not enabled():
        return None
    d = getattr(model, "dinfo", None)
    names = list(d.predictor_names) if d is not None else []
    if glm_eligible(model, frame) is not None:
        note_fallback(frame, names)
        return None
    got = _glm_feature_plans(model, frame)
    if got is None:
        note_fallback(frame, names)
        return None
    entries, rows, device, spliced = got
    arrays = [fusion.run_program(v) if kind == "plan" else v.data
              for kind, v in entries]
    dtypes = tuple(fusion._dtype_name(a.dtype) for a in arrays)
    out = _glm_program(model, rows, device, dtypes).run(arrays, [])
    from h2o3_tpu_torch import scoring

    _bump("captures")
    _bump("spliced_nodes", spliced)
    _bump("fused_dispatches")
    _bump("fused_rows", frame.nrows)
    scoring.note_dispatch("pipeline")
    K = int(model._output.nclasses)
    if K > 2:
        return {"probs": out}
    if K == 2:
        return {"probs": torch.stack([1 - out, out], dim=-1)}
    return {"value": out}


def stats() -> dict:
    out = counters()
    out["cached_programs"] = len(_PROGRAMS)
    out["enabled"] = enabled()
    return out
