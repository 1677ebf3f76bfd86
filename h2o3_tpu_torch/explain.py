"""Explanation suite: partial dependence, TreeSHAP contributions, feature
interactions and the multi-model varimp / correlation matrices
(counterpart of h2o3_tpu/explain.py: `partial_dependence` :80,
`partial_dependence_2d` :125, `_shap_one_tree` :153, `_expected_value`
:240, `predict_contributions` :249, `feature_interactions` :291,
`varimp_matrix` :348, `model_correlation` :368).

Reference: hex/PartialDependence.java (grid sweep -> mean/stddev of the
response), h2o-genmodel algos/tree/TreeSHAP.java (Lundberg's
path-dependent algorithm, surfaced as predict_contributions),
hex/tree/FeatureInteraction*.java, and h2o-py explanation/_explain.py
(the varimp heatmap and model correlation data; plotting stays with the
client).

Where the work runs: the partial-dependence sweep and the correlation
matrix score through the model's own device path, one predict per grid
value or model, and reduce each response vector on the host with the
reference's numpy calls; on a row-sharded frame each rank scores its own
rows and the ranks' float64 sums are all-reduced. TreeSHAP bins the
frame on the device, copies the bin matrix to the host once and walks
every row through every tree in the host library's C++
(csrc/treeshap.cpp, threads over rows): a tree-shaped recursion with
per-row path state. `_shap_one_tree` is its
plain Python version, which the tests hold the native walk to. Feature
interactions walk the forest's node tables on the host.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import (Column, Frame, T_CAT, T_NUM,
                                       torch_code_dtype, widen)
from h2o3_tpu_torch.core.runtime import in_full_float32
from h2o3_tpu_torch.core.sharded_frame import block_column, sharded_mesh
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.parallel import mesh as M


# ---------------------------------------------------------------------------
# partial dependence (hex/PartialDependence.java)
# ---------------------------------------------------------------------------

def _response_vector(model: Model, frame: Frame,
                     target: Optional[str] = None) -> np.ndarray:
    """The PDP response on the host: P(class 1) for binomial, P(target)
    for multinomial (hex/PartialDependence requires _targets for
    multiclass), the prediction for regression."""
    raw = model._predict_raw(model.adapt_test(frame))
    if "probs" in raw:
        dom = model._output.response_domain or []
        if len(dom) > 2 and target is None:
            raise ValueError("multinomial partial dependence needs a target "
                             f"class (one of {dom})")
        k = dom.index(target) if target is not None else 1
        return raw["probs"][: frame.local_rows, k].cpu().numpy()
    return raw["value"][: frame.local_rows].cpu().numpy()


def _grid_for(col: Column, nbins: int) -> List:
    """The column's grid: its domain, or nbins points over its finite
    range (on a row-sharded frame the all-reduced min and max, exact,
    so the grid is one process's bit for bit)."""
    if col.is_categorical:
        return list(col.domain or [])
    mesh = sharded_mesh(col)
    if mesh is None:
        vals = col.to_numpy()
        vals = vals[np.isfinite(vals)]
        if len(vals) == 0:
            return []
        lo, hi = float(vals.min()), float(vals.max())
    else:
        v = col.data.double()
        v = v[torch.isfinite(v)]
        ends = torch.tensor([float(v.min()) if len(v) else np.inf,
                             -float(v.max()) if len(v) else np.inf],
                            dtype=torch.float64)
        mesh.all_reduce(ends, "min")
        lo, hi = float(ends[0]), -float(ends[1])
        if not np.isfinite(lo):
            return []
    if lo == hi:
        return [lo]
    return list(np.linspace(lo, hi, nbins))


def _stats(resps: List[np.ndarray], w: Optional[np.ndarray], mesh):
    """(means, standard deviations) of each grid value's response vector,
    weighted by w where given. One process: numpy's float32 mean and
    std (two-pass weighted), as the reference takes them. A row-sharded
    frame: each rank's float64 sums of w, w·r and w·r² for every grid
    value, all-reduced in one collective."""
    if mesh is None:
        means, stds = [], []
        for resp in resps:
            if w is not None:
                wm = float(np.sum(w * resp) / max(np.sum(w), 1e-12))
                var = float(np.sum(w * (resp - wm) ** 2)
                            / max(np.sum(w), 1e-12))
                means.append(wm)
                stds.append(np.sqrt(var))
            else:
                means.append(float(np.mean(resp)))
                stds.append(float(np.std(resp)))
        return means, stds
    sums = np.zeros((len(resps), 3), np.float64)
    for i, resp in enumerate(resps):
        r = resp.astype(np.float64)
        wr = np.ones_like(r) if w is None else w.astype(np.float64)
        sums[i] = (wr.sum(), (wr * r).sum(), (wr * r * r).sum())
    tot = mesh.all_reduce(torch.from_numpy(sums), "sum").numpy()
    den = np.maximum(tot[:, 0], 1e-12)
    mean = tot[:, 1] / den
    var = np.maximum(tot[:, 2] / den - mean * mean, 0.0)
    return [float(m) for m in mean], [float(np.sqrt(v)) for v in var]


def _ice_row(frame: Frame, row_index: int) -> Frame:
    """The one row `row_index` of `frame` as a frame of one row: on a
    row-sharded frame the rank that holds it keeps it (a frame of its
    own, scored under `mesh.alone`), every other rank none."""
    from h2o3_tpu_torch.ops.filters import take_rows

    if sharded_mesh(frame) is None:
        return take_rows(frame, np.array([row_index]))
    lo, hi = frame.shard
    i = row_index - lo
    keep = slice(i, i + 1) if lo <= row_index < hi else slice(0, 0)
    out = Frame()
    with M.alone():
        for name in frame.names:
            c = frame.col(name)
            data = None if c.data is None else c.data[keep]
            host = None if c.host_data is None else c.host_data[keep]
            n = len(data if data is not None else host)
            out.add(name, Column(data, c.ctype, n, domain=c.domain,
                                 host_data=host))
    return out


def _with_value(frame: Frame, col_name: str, value, is_cat: bool,
                domain) -> Frame:
    """`frame` with column `col_name` set to `value` on every row, made on
    the column's device (the values Column.from_numpy would store)."""
    out = Frame()
    n, rows = frame.nrows, frame.local_rows
    for name in frame.names:
        if name != col_name:
            out.add(name, frame.col(name))
            continue
        dev = frame.col(name).device
        if is_cat:
            code = (domain.index(value) if value in domain else -1)
            data = torch.full((rows,), code, dtype=torch_code_dtype(
                max(len(domain), 1)), device=dev)
            out.add(name, Column(data, T_CAT, n, domain=list(domain)))
        else:
            data = torch.full((rows,), float(value), dtype=torch.float32,
                              device=dev)
            out.add(name, Column(data, T_NUM, n))
    return out


@in_full_float32
def partial_dependence(model: Model, frame: Frame,
                       cols: Optional[Sequence[str]] = None,
                       nbins: int = 20,
                       weight_column: Optional[str] = None,
                       row_index: int = -1,
                       target: Optional[str] = None) -> List[dict]:
    """One table per column: {column, values, mean_response,
    stddev_response}. row_index >= 0 gives an ICE curve for that one row
    instead of the data average (PartialDependence.java _row_index). On
    a row-sharded frame each rank scores its own rows and the tables are
    the cloud's (`_stats`); an ICE row is scored on the rank that holds
    it."""
    cols = list(cols) if cols else list(model._output.names)
    mesh = sharded_mesh(frame)
    w = None
    if weight_column and weight_column in frame:
        wc = frame.col(weight_column)
        w = wc.to_numpy() if mesh is None else widen(wc.data).cpu().numpy()
    # grids come from the whole frame's value range; an ICE request then
    # scores the one row over that grid
    grids = {c: _grid_for(frame.col(c), nbins) for c in cols if c in frame}
    scope = contextlib.nullcontext
    if row_index >= 0:
        frame = _ice_row(frame, row_index)
        w = None
        if mesh is not None:
            scope = M.alone
    tables = []
    for cname in cols:
        if cname not in frame:
            continue
        col = frame.col(cname)
        grid = grids[cname]
        with scope():
            resps = [_response_vector(model, _with_value(
                frame, cname, v, col.is_categorical, col.domain or []),
                target) for v in grid]
        means, stds = _stats(resps, w, mesh)
        tables.append({"column": cname, "values": grid,
                       "mean_response": means, "stddev_response": stds})
    return tables


@in_full_float32
def partial_dependence_2d(model: Model, frame: Frame,
                          col_pairs: Sequence[Tuple[str, str]],
                          nbins: int = 20,
                          target: Optional[str] = None) -> List[dict]:
    """2-D partial dependence (PartialDependence.java _col_pairs_2dpdp);
    on a row-sharded frame the cloud's, as `partial_dependence`."""
    mesh = sharded_mesh(frame)
    tables = []
    for c1, c2 in col_pairs:
        g1 = _grid_for(frame.col(c1), nbins)
        g2 = _grid_for(frame.col(c2), nbins)
        is1, is2 = frame.col(c1).is_categorical, frame.col(c2).is_categorical
        d1, d2 = frame.col(c1).domain or [], frame.col(c2).domain or []
        pairs, resps = [], []
        for v1 in g1:
            fr1 = _with_value(frame, c1, v1, is1, d1)
            for v2 in g2:
                fr12 = _with_value(fr1, c2, v2, is2, d2)
                pairs.append((v1, v2))
                resps.append(_response_vector(model, fr12, target))
        means, stds = _stats(resps, None, mesh)
        rows = [(v1, v2, m, sd) for (v1, v2), m, sd in zip(pairs, means,
                                                           stds)]
        tables.append({"columns": (c1, c2), "rows": rows})
    return tables


# ---------------------------------------------------------------------------
# TreeSHAP (genmodel algos/tree/TreeSHAP.java: Lundberg's algorithm 2,
# the path-dependent formulation over node covers)
# ---------------------------------------------------------------------------

def _shap_one_tree(x: np.ndarray, t: int, forest, phi: np.ndarray):
    """Add the SHAP values of one binned row through tree t into phi
    (size F+1; the last slot is the bias, filled by the caller). The
    plain version of csrc/treeshap.cpp's walk."""
    feat = forest.feat[t]
    thresh = forest.thresh_bin[t]
    na_left = forest.na_left[t]
    left = forest.left[t]
    right = forest.right[t]
    leaf_val = forest.leaf_val[t]
    cat_split = forest.cat_split[t]
    cover = forest.cover[t]
    na_bins = forest.na_bins

    def goes_left(node: int) -> bool:
        f = feat[node]
        b = x[f]
        if b == na_bins[f]:
            return bool(na_left[node])
        cs = cat_split[node]
        if cs >= 0:
            return bool(forest.cat_table[cs, min(b, forest.cat_table.shape[1]
                                                 - 1)])
        return b <= thresh[node]

    # path elements: [feature d, zero fraction z, one fraction o,
    # permutation weight w] (Lundberg's m)
    def extend(m, pz, po, pi):
        # the element lists are copied: the hot and the cold recursion
        # each extend the same parent path, and the updates mutate
        l = len(m)
        m = [e[:] for e in m] + [[pi, pz, po, 1.0 if l == 0 else 0.0]]
        for i in range(l - 1, -1, -1):
            m[i + 1][3] += po * m[i][3] * (i + 1) / (l + 1)
            m[i][3] = pz * m[i][3] * (l - i) / (l + 1)
        return m

    def unwind(m, i):
        l = len(m) - 1
        n = m[l][3]
        out = [e[:] for e in m[:-1]]
        for j in range(l - 1, -1, -1):
            if m[i][2] != 0:
                t_ = out[j][3]
                out[j][3] = n * (l + 1) / ((j + 1) * m[i][2])
                n = t_ - out[j][3] * m[i][1] * (l - j) / (l + 1)
            else:
                out[j][3] = out[j][3] * (l + 1) / (m[i][1] * (l - j))
        for j in range(i, l):
            out[j][0], out[j][1], out[j][2] = (m[j + 1][0], m[j + 1][1],
                                               m[j + 1][2])
        return out

    def unwound_sum(m, i):
        l = len(m) - 1
        if m[i][2] != 0:
            n = m[l][3]
            tot = 0.0
            for j in range(l - 1, -1, -1):
                tmp = n / ((j + 1) * m[i][2])
                tot += tmp
                n = m[j][3] - tmp * m[i][1] * (l - j)
            return tot * (l + 1)
        tot = 0.0
        for j in range(l):
            tot += m[j][3] / (m[i][1] * (l - j))
        return tot * (l + 1)

    def recurse(node, m, pz, po, pi):
        m = extend(m, pz, po, pi)
        if feat[node] < 0:
            v = leaf_val[node]
            for i in range(1, len(m)):
                w = unwound_sum(m, i)
                phi[m[i][0]] += w * (m[i][2] - m[i][1]) * v
            return
        h, c = (left[node], right[node]) if goes_left(node) \
            else (right[node], left[node])
        iz, io = 1.0, 1.0
        k = next((i for i in range(1, len(m)) if m[i][0] == feat[node]), -1)
        if k >= 0:
            iz, io = m[k][1], m[k][2]
            m = unwind(m, k)
        rj = max(float(cover[node]), 1e-12)
        recurse(h, m, iz * float(cover[h]) / rj, io, int(feat[node]))
        recurse(c, m, iz * float(cover[c]) / rj, 0.0, int(feat[node]))

    recurse(0, [], 1.0, 1.0, -1)


def _expected_value(forest, t: int) -> float:
    """Cover-weighted mean leaf value of tree t (its part of the bias)."""
    feat, cover, lv = forest.feat[t], forest.cover[t], forest.leaf_val[t]
    leaves = feat < 0
    used = leaves & (cover > 0)
    root = max(float(cover[0]), 1e-12)
    return float(np.sum(cover[used] * lv[used]) / root)


def predict_contributions(model, frame: Frame) -> Frame:
    """Per-row, per-feature SHAP contributions in margin space and the
    BiasTerm (Model.scoreContributions: the row sum of the contributions
    plus BiasTerm is the raw prediction). Binomial contributions are
    log-odds, as in the reference. The frame is binned on its device,
    the bin matrix is copied to the host once, and the host library's
    walk (native.native_treeshap) computes the contributions; there is
    no other path. Row-local: on a row-sharded frame each rank walks its
    own rows, and the result is sharded as its input."""
    from h2o3_tpu_torch import native

    forest = getattr(model, "forest", None)
    if forest is None or getattr(forest, "cover", None) is None:
        raise ValueError("predict_contributions needs a tree model trained "
                         "with node covers (GBM/DRF)")
    if forest.nclasses > 2:
        raise ValueError("predict_contributions supports binomial/regression "
                         "models only (reference restriction)")
    adapted = model.adapt_test(frame)
    binned = model.spec.bin_columns(adapted)[: frame.local_rows]
    dev = binned.device
    binned = binned.cpu().numpy()
    names = model._output.names
    n = frame.nrows
    bias = forest.init_f
    for t in range(forest.n_trees):
        bias += _expected_value(forest, t)
    phi = native.native_treeshap(binned, forest)
    out = Frame()
    for j, nm in enumerate(names):
        out.add(nm, block_column(phi[:, j], n, device=dev))
    out.add("BiasTerm", block_column(
        np.full(binned.shape[0], bias, np.float64), n, device=dev))
    return out


# ---------------------------------------------------------------------------
# feature interactions (hex/tree FeatureInteraction: XGBoost-style path
# pair statistics)
# ---------------------------------------------------------------------------

def feature_interactions(model, max_interaction_depth: int = 2) -> List[dict]:
    """Ranked interaction table over all trees:

    - depth-0 rows, one per feature: gain/cover/count summed over exactly
      that feature's split nodes (so the singleton gains total the
      forest's split gain, with nothing counted twice);
    - depth-1 rows, one per unordered feature pair: each split node v
      with an ancestor split a on another feature adds v's gain/cover
      once to the pair {feat(a), feat(v)}.

    max_interaction_depth bounds pairs (deeper combinations reduce to
    repeated application of the same attribution).
    """
    forest = getattr(model, "forest", None)
    if forest is None or getattr(forest, "gain", None) is None:
        raise ValueError("feature_interactions needs a tree model with "
                         "recorded split gains")
    names = model._output.names
    stats: Dict[Tuple[str, ...], List[float]] = {}

    def record(combo: Tuple[str, ...], gain: float, cover: float):
        s = stats.setdefault(combo, [0.0, 0.0, 0])
        s[0] += gain
        s[1] += cover
        s[2] += 1

    for t in range(forest.n_trees):
        feat, left, right = forest.feat[t], forest.left[t], forest.right[t]
        gain, cover = forest.gain[t], forest.cover[t]

        def walk(node, anc_feats):
            if feat[node] < 0:
                return
            fname = names[feat[node]]
            record((fname,), float(gain[node]), float(cover[node]))
            if max_interaction_depth >= 2:
                for af in set(anc_feats):
                    if af != fname:
                        record(tuple(sorted((af, fname))),
                               float(gain[node]), float(cover[node]))
            nxt = anc_feats + [fname]
            walk(int(left[node]), nxt)
            walk(int(right[node]), nxt)

        walk(0, [])
    rows = [{"interaction": " | ".join(k), "depth": len(k) - 1,
             "gain": v[0], "cover": v[1], "count": v[2]}
            for k, v in stats.items()]
    rows.sort(key=lambda r: -r["gain"])
    return rows


# ---------------------------------------------------------------------------
# multi-model explanation matrices (h2o-py explanation/_explain.py data)
# ---------------------------------------------------------------------------

def varimp_matrix(models: Sequence[Model]) -> dict:
    """The variable-importance matrix across models (the varimp heatmap's
    data): {features, models, matrix}, NaN where a model lacks a
    feature."""
    feats: List[str] = []
    for m in models:
        for f in (m.varimp() or {}):
            if f not in feats:
                feats.append(f)
    mat = np.full((len(feats), len(models)), np.nan)
    for j, m in enumerate(models):
        vi = m.varimp() or {}
        for i, f in enumerate(feats):
            if f in vi:
                mat[i, j] = vi[f]
    return {"features": feats,
            "models": [str(m.key) for m in models],
            "matrix": mat}


@in_full_float32
def model_correlation(models: Sequence[Model], frame: Frame,
                      target: Optional[str] = None) -> dict:
    """Pairwise correlation of the models' predictions (the model
    correlation heatmap's data): binomial models correlate P(class 1),
    multinomial P(target), by default the second response level so a
    mixed list never raises, regression models their predictions."""

    def _resp(m):
        t = target
        dom = m._output.response_domain or []
        if t is None and len(dom) > 2:
            t = dom[1]
        return _response_vector(m, frame, t)

    P = np.stack([_resp(m) for m in models])
    C = np.corrcoef(P)
    return {"models": [str(m.key) for m in models], "matrix": C}
