"""Reference-format (Java) MOJO: read real h2o-3 artifacts and write the
port's tree and GLM models in that format (counterpart of
h2o3_tpu/models/mojo_java.py: `_Backend` :48, `parse_model_ini` :101,
`decode_tree` :149, `_bitset_member` :209, `JavaForest` :222, `_scorer`
:321, `_link_inv` :382, `read_java_mojo` :395, `_read_tree_mojo` :472,
`_read_glm_mojo` :561, `is_java_mojo` :624, `_encode_tree` :638,
`_java_split_vals` :687, `export_java_mojo_bytes` :704,
`_export_glm_java` :827).

Reads the reference's MOJO layout (model.ini + domains/*.txt +
trees/*.bin) and decodes the compressed-tree byte format into dense
(T, M) node tables, so a MOJO trained by stock h2o-3 scores on the
runtime's device, with no JVM anywhere.

Format spec sources (behavioural, re-implemented):
  - model.ini layout: hex/genmodel/ModelMojoReader.java (parseModelInfo)
  - tree bytes:       hex/genmodel/algos/tree/SharedTreeMojoModel.java:128
                      (scoreTree walk), utils/ByteBufferWrapper.java,
                      utils/GenmodelBitSet.java (fill2/fill3)
  - GBM combine:      hex/genmodel/algos/gbm/GbmMojoModel.java (unifyPreds)
  - DRF combine:      hex/genmodel/algos/drf/DrfMojoModel.java (unifyPreds)
  - GLM score:        hex/genmodel/algos/glm/GlmMojoModel.java (glmScore0)

Byte grammar per internal node (little-endian):
  u8  nodeType      bits: 0..1+4..5 = lmask, 2..3 = equal, 6..7 = rmask<<2
  u16 colId         0xFFFF = the whole tree is one leaf (then f32 value)
  u8  naSplitDir    1=NAvsREST 2=NALeft 3=NARight 4=Left 5=Right
  [ f32 splitVal                         if equal==0 and not NAvsREST ]
  [ 4-byte inline bitset                 if equal==8                  ]
  [ u16 bitoff, i32 nbits, ceil(nbits/8) bytes of bitset  if equal==12]
  [ left-subtree byte length as (lmask+1)-byte int        if lmask<=3 ]
  left child bytes (an f32 leaf if lmask==48), then right child bytes
  (an f32 leaf if rmask&16 — rmask = (nodeType & 0xC0) >> 2).
Decision (scoreTree): NaN / out-of-bitset-range / out-of-domain goes
!leftward; else NAvsREST goes left; else numeric d>=split or bitset
membership goes right.

The walk (`_walk`) is torch ops on the rows' device: every row steps
through one tree at a time in lockstep, each tree's leaf value added in
float32 into its class's column in tree order, as the reference's
lax.scan adds it, so the forest scores equal the reference's bit for bit
given the same X. The link, calibration and GLM formulas follow the
reference's numpy code as torch ops (float32 for the tree models,
float64 for GLM).
"""

from __future__ import annotations

import io
import os
import struct
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.mojo import _default_threshold, _threshold_metrics

NA_VS_REST = 1
NA_LEFT = 2
LEFT = 4


class _Backend:
    """Uniform reader over a MOJO zip file or an exploded directory."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray)):
            self._zf = zipfile.ZipFile(io.BytesIO(bytes(source)))
            self._dir = None
        elif os.path.isdir(source):
            self._zf, self._dir = None, source
        else:
            self._zf = zipfile.ZipFile(source)
            self._dir = None

    def exists(self, name: str) -> bool:
        if self._dir is not None:
            return os.path.exists(os.path.join(self._dir, name))
        try:
            self._zf.getinfo(name)
            return True
        except KeyError:
            return False

    def read(self, name: str) -> bytes:
        if self._dir is not None:
            with open(os.path.join(self._dir, name), "rb") as f:
                return f.read()
        return self._zf.read(name)

    def text(self, name: str) -> List[str]:
        return self.read(name).decode("utf-8").splitlines()


def _parse_value(s: str):
    s = s.strip()
    if s in ("null", ""):
        return None
    if s in ("true", "false"):
        return s == "true"
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(x) for x in inner.split(",")]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def parse_model_ini(backend: _Backend):
    """model.ini → (info dict, column names, {col_idx: domain list})."""
    info: Dict[str, object] = {}
    columns: List[str] = []
    domains: Dict[int, List[str]] = {}
    section = None
    for ln in backend.text("model.ini"):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        if ln.startswith("["):
            section = ln.strip("[]").lower()
            continue
        if section == "info":
            if "=" in ln:
                k, v = ln.split("=", 1)
                info[k.strip()] = _parse_value(v)
        elif section == "columns":
            columns.append(ln)
        elif section == "domains":
            head, fname = ln.rsplit(" ", 1)
            idx = int(head.split(":")[0])
            domains[idx] = [l for l in backend.text(f"domains/{fname}")]
    return info, columns, domains


# ---------------------------------------------------------------------------
# compressed-tree decoder
# ---------------------------------------------------------------------------

class _DecodedNode:
    __slots__ = ("feat", "split", "leftward", "navsrest", "is_bitset",
                 "bitoff", "nbits", "bits", "left", "right", "leaf")

    def __init__(self):
        self.feat = -1
        self.split = np.nan
        self.leftward = False
        self.navsrest = False
        self.is_bitset = False
        self.bitoff = 0
        self.nbits = 0
        self.bits = b""
        self.left = None
        self.right = None
        self.leaf = np.nan


def decode_tree(blob: bytes, mojo_version: float) -> _DecodedNode:
    """Decode one compressed tree into a node graph (grammar above)."""
    if mojo_version < 1.2:
        raise ValueError(f"MOJO tree format {mojo_version} predates the "
                         "1.20 bitset layout; re-export with h2o >= 3.12")

    def f32(pos):
        return struct.unpack_from("<f", blob, pos)[0]

    def leaf(pos):
        n = _DecodedNode()
        n.leaf = f32(pos)
        return n

    def parse(pos: int) -> _DecodedNode:
        node_type = blob[pos]
        col = struct.unpack_from("<H", blob, pos + 1)[0]
        pos += 3
        if col == 0xFFFF:
            return leaf(pos)
        na_dir = blob[pos]
        pos += 1
        n = _DecodedNode()
        n.feat = col
        n.navsrest = na_dir == NA_VS_REST
        n.leftward = na_dir in (NA_LEFT, LEFT)
        lmask = node_type & 51
        equal = node_type & 12
        if not n.navsrest:
            if equal == 0:
                n.split = f32(pos)
                pos += 4
            elif equal == 8:              # inline 32-bit bitset
                n.is_bitset = True
                n.bitoff, n.nbits = 0, 32
                n.bits = blob[pos:pos + 4]
                pos += 4
            else:                         # equal == 12: offset bitset
                n.is_bitset = True
                n.bitoff = struct.unpack_from("<H", blob, pos)[0]
                n.nbits = struct.unpack_from("<i", blob, pos + 2)[0]
                nbytes = ((n.nbits - 1) >> 3) + 1
                n.bits = blob[pos + 6:pos + 6 + nbytes]
                pos += 6 + nbytes
        if lmask <= 3:
            width = lmask + 1
            skip = int.from_bytes(blob[pos:pos + width], "little")
            pos += width
            n.left = parse(pos)
            right_pos = pos + skip
        else:                             # lmask == 48: left child is a leaf
            n.left = leaf(pos)
            right_pos = pos + 4
        rmask = (node_type & 0xC0) >> 2
        n.right = leaf(right_pos) if (rmask & 16) else parse(right_pos)
        return n

    return parse(0)


def _bitset_member(n: _DecodedNode, card: int) -> Tuple[np.ndarray, np.ndarray]:
    """(in_range, member) boolean LUTs over 0..card-1 domain codes."""
    idx = np.arange(card)
    rel = idx - n.bitoff
    in_range = (rel >= 0) & (rel < n.nbits)
    member = np.zeros(card, bool)
    arr = np.frombuffer(n.bits, np.uint8)
    ok = in_range & (rel < len(arr) * 8)
    r = np.clip(rel, 0, len(arr) * 8 - 1)
    member[ok] = (arr[r[ok] >> 3] >> (r[ok] & 7).astype(np.uint8)) & 1 > 0
    return in_range, member


class JavaForest:
    """Decoded reference trees as dense (T, M) node tables and bitset LUTs
    (host arrays, moved to the rows' device when scored): the compressed
    forest's layout but with raw float thresholds, since reference trees
    carry floats, not training-bin ids."""

    def __init__(self, roots: List[Optional[_DecodedNode]], tree_class,
                 n_cols: int, domains: Dict[int, List[str]]):
        nodes_per_tree: List[List[_DecodedNode]] = []
        for root in roots:
            order: List[_DecodedNode] = []

            def walk(nd):
                order.append(nd)
                if nd.left is not None:
                    walk(nd.left)
                    walk(nd.right)

            if root is not None:
                walk(root)
            nodes_per_tree.append(order)
        T = len(roots)
        M = max((len(o) for o in nodes_per_tree), default=1) or 1
        card = max((len(d) for d in domains.values()), default=1) or 1

        feat = np.full((T, M), -1, np.int32)
        split = np.full((T, M), np.nan, np.float32)
        left = np.zeros((T, M), np.int32)
        right = np.zeros((T, M), np.int32)
        leafv = np.zeros((T, M), np.float32)
        leftward = np.zeros((T, M), bool)
        navsrest = np.zeros((T, M), bool)
        catrow = np.full((T, M), -1, np.int32)
        domlen = np.zeros(n_cols, np.int32)
        for ci, d in domains.items():
            if ci < n_cols:
                domlen[ci] = len(d)
        luts_in: List[np.ndarray] = []
        luts_mem: List[np.ndarray] = []
        for t, order in enumerate(nodes_per_tree):
            index = {id(nd): i for i, nd in enumerate(order)}
            for i, nd in enumerate(order):
                if nd.left is None:
                    leafv[t, i] = nd.leaf
                    continue
                feat[t, i] = nd.feat
                split[t, i] = nd.split
                leftward[t, i] = nd.leftward
                navsrest[t, i] = nd.navsrest
                left[t, i] = index[id(nd.left)]
                right[t, i] = index[id(nd.right)]
                if nd.is_bitset:
                    inr, mem = _bitset_member(nd, card)
                    catrow[t, i] = len(luts_in)
                    luts_in.append(inr)
                    luts_mem.append(mem)
        self.feat = feat
        self.split = split
        self.left = left
        self.right = right
        self.leaf_val = leafv
        self.leftward = leftward
        self.navsrest = navsrest
        self.cat_row = catrow
        self.lut_in = (np.stack(luts_in) if luts_in
                       else np.zeros((1, card), bool))
        self.lut_mem = (np.stack(luts_mem) if luts_mem
                        else np.zeros((1, card), bool))
        self.dom_len = domlen
        self.tree_class = np.asarray(tree_class, np.int32)
        self.max_nodes = M
        # the true max depth across trees bounds the walk (imported trees
        # can exceed the 64-level leaf-assignment cap; plain scoring in the
        # reference walks unbounded)

        def depth(nd):
            if nd is None or nd.left is None:
                return 0
            return 1 + max(depth(nd.left), depth(nd.right))

        self.max_depth = max((depth(r) for r in roots), default=0)

    def score(self, X: torch.Tensor, nclasses: int) -> torch.Tensor:
        """Sum tree outputs per class: X (n, n_features) float32 on a
        device, NaN for NA and categorical codes as floats -> (n, K) on
        X's device. K=1 for regression and single-tree-per-group
        binomial; K=nclasses when trees are per class (multinomial, or
        DRF binomial_double_trees: tree_class > 0 present)."""
        per_class = int(self.tree_class.max(initial=0)) > 0
        K = nclasses if (nclasses > 2 or (nclasses == 2 and per_class)) else 1
        dev = X.device
        a = {name: torch.as_tensor(getattr(self, name), device=dev)
             for name in ("feat", "split", "left", "right", "leaf_val",
                          "leftward", "navsrest", "cat_row", "lut_in",
                          "lut_mem", "dom_len")}
        return _walk(X.float(), a, self.tree_class.tolist(), K,
                     max(self.max_depth, 1))


def _walk(X: torch.Tensor, a: dict, tree_class: List[int], K: int,
          max_depth: int) -> torch.Tensor:
    """The reference's `_scorer` as torch ops: every row walks each tree
    in turn for max_depth + 1 steps (a leaf keeps its node), and the
    tree's leaf value is added into the row's class column of an (n, K)
    float32 accumulator, in tree order."""
    n = X.shape[0]
    card = a["lut_in"].shape[1]
    acc = torch.zeros((n, K), dtype=torch.float32, device=X.device)
    for t, k in enumerate(tree_class):
        tfeat, tsplit = a["feat"][t].long(), a["split"][t]
        tleft, tright = a["left"][t].long(), a["right"][t].long()
        tlw, tnvr, tcat = a["leftward"][t], a["navsrest"][t], a["cat_row"][t]
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(max_depth + 1):
            f = tfeat[node]
            is_leaf = f < 0
            fx = torch.clamp_min(f, 0)
            d = torch.gather(X, 1, fx[:, None])[:, 0]
            nan = torch.isnan(d)
            # the integer view of d is read only for categorical codes;
            # NaN rows and huge numeric values are masked below, so they
            # are pinned into range before the conversion
            di = torch.where(nan, 0.0, d).clamp(-1.0, 2.0 ** 30).int()
            code = torch.clamp(di, 0, card - 1).long()
            crow = tcat[node]
            cr = torch.clamp_min(crow, 0).long()
            has_bs = crow >= 0
            in_rng = torch.where(has_bs, a["lut_in"][cr, code], True)
            member = a["lut_mem"][cr, code]
            dl = a["dom_len"][fx]
            out_dom = (dl > 0) & (di >= dl)
            na_ish = nan | (has_bs & ~in_rng) | out_dom
            go_right_split = torch.where(has_bs, member, d >= tsplit[node])
            cond = torch.where(na_ish, ~tlw[node],
                               (~tnvr[node]) & go_right_split)
            nxt = torch.where(cond, tright[node], tleft[node])
            node = torch.where(is_leaf, node, nxt)
        contrib = a["leaf_val"][t][node]
        kk = k if K > 1 else 0
        acc[:, kk] = acc[:, kk] + contrib
    return acc


# ---------------------------------------------------------------------------
# model wrappers
# ---------------------------------------------------------------------------

def _sanitized_exp(x):
    return torch.clamp_max(torch.exp(x), 1e19)


def _link_inv(name: str, f: torch.Tensor) -> torch.Tensor:
    if name in ("logit", "ologit"):
        return 1.0 / (1.0 + _sanitized_exp(-f))
    if name == "log":
        return _sanitized_exp(f)
    if name == "ologlog":
        return 1.0 - torch.exp(-_sanitized_exp(f))
    if name == "inverse":
        xx = torch.where(f < 0, torch.clamp_max(f, -1e-5),
                         torch.clamp_min(f, 1e-5))
        return 1.0 / xx
    return f


def read_java_mojo(source):
    """Parse a reference-format MOJO (zip path, bytes or exploded
    directory) into a Model that scores on the device of the frame it is
    given."""
    backend = _Backend(source)
    info, columns, domains = parse_model_ini(backend)
    algo = str(info.get("algo", "") or "").lower()
    if not algo:
        # mojo 1.0 files carry only the long name
        long_name = str(info.get("algorithm", "")).lower()
        algo = {"generalized linear modeling": "glm",
                "gradient boosting machine": "gbm",
                "distributed random forest": "drf",
                "isolation forest": "isofor"}.get(long_name, long_name)
    if algo in ("gbm", "drf"):
        return _read_tree_mojo(backend, info, columns, domains, algo)
    if algo == "glm":
        return _read_glm_mojo(backend, info, columns, domains)
    raise ValueError(f"unsupported reference MOJO algo {algo!r} "
                     "(gbm, drf, glm implemented)")


def _common_output(model, info, columns, domains, supervised: bool):
    n_features = int(info.get("n_features") or len(columns) - 1)
    names = columns[:n_features]
    model._output.names = list(names)
    model._output.domains = {
        columns[i]: list(d) for i, d in domains.items() if i < n_features}
    cat = str(info.get("category", "") or "")
    model._output.model_category = {
        "Binomial": ModelCategory.Binomial,
        "Multinomial": ModelCategory.Multinomial,
        "Regression": ModelCategory.Regression,
        "Clustering": ModelCategory.Clustering,
        "AnomalyDetection": ModelCategory.AnomalyDetection,
    }.get(cat, ModelCategory.Regression)
    if supervised:
        resp_idx = int(info.get("n_columns") or len(columns)) - 1
        model._output.response_name = columns[resp_idx] \
            if resp_idx < len(columns) else None
        model._output.response_domain = list(domains.get(resp_idx, [])) or None
    if model._output.model_category == ModelCategory.Binomial:
        model._output.training_metrics = _threshold_metrics(
            float(info.get("default_threshold") or 0.5))
    return n_features


def _frame_matrix(model, frame) -> torch.Tensor:
    """Adapted frame -> (n, n_features) float32 genmodel rows on the
    frame's device: numerics as they are, categoricals as their domain
    codes, NA as NaN."""
    cols = []
    for name in model._output.names:
        c = frame.col(name)
        v = c.data.float()
        if c.is_categorical:
            v = torch.where(c.data < 0, float("nan"), v)   # NA code -> NaN
        cols.append(v)
    if not cols:
        return torch.zeros((frame.nrows, 0), dtype=torch.float32)
    return torch.stack(cols, dim=1)


class JavaTreeModel:
    """GBM/DRF read from a reference MOJO: the decoded forest and its
    class count."""

    def __init__(self, algo, forest, info, nclasses):
        self.algo_name = algo
        self.forest = forest
        self.info = info
        self.nclasses = nclasses

    def raw_scores(self, X: torch.Tensor) -> torch.Tensor:
        return self.forest.score(X, self.nclasses)


def _read_tree_mojo(backend, info, columns, domains, algo):
    mojo_version = float(info.get("mojo_version") or 0.0)
    nclasses = int(info.get("n_classes") or 1)
    ntrees = int(info.get("n_trees") or 0)
    tpc = info.get("n_trees_per_class")
    if tpc is None:
        bdt = bool(info.get("binomial_double_trees") or False)
        tpc = nclasses if (nclasses > 2 or (nclasses == 2 and bdt)) else 1
    tpc = int(tpc)

    roots: List[Optional[_DecodedNode]] = []
    tree_class: List[int] = []
    for cls_idx in range(tpc):
        for grp in range(ntrees):
            name = f"trees/t{cls_idx:02d}_{grp:03d}.bin"
            if backend.exists(name):
                roots.append(decode_tree(backend.read(name), mojo_version))
            else:
                roots.append(None)
            tree_class.append(cls_idx)
    n_features = int(info.get("n_features") or len(columns) - 1)
    forest = JavaForest(roots, tree_class, n_features, domains)

    inner = JavaTreeModel(algo, forest, info, nclasses)

    model = Model()
    _common_output(model, info, columns, domains,
                   supervised=bool(info.get("supervised", True)))
    init_f = float(info.get("init_f") or 0.0)
    family = str(info.get("distribution", "") or "")
    link = {"bernoulli": "logit", "quasibinomial": "logit",
            "modified_huber": "logit", "poisson": "log", "gamma": "log",
            "tweedie": "log"}.get(family, "identity")
    calib = None
    if info.get("calib_method") == "platt":
        b = info.get("calib_glm_beta") or []
        if len(b) == 2:
            # the reference stores [beta, intercept]
            calib = ("platt_raw", (float(b[0]), float(b[1])))

    def _predict_raw(frame):
        X = _frame_matrix(model, frame)
        preds = inner.raw_scores(X)       # (n, K)
        cat = model._output.model_category
        if algo == "gbm":
            if cat == ModelCategory.Binomial and tpc == 1:
                if family in ("bernoulli", "quasibinomial", "modified_huber"):
                    p1 = _link_inv(link, preds[:, 0] + init_f)
                else:                     # multinomial 1-tree optimisation
                    f = preds[:, 0] + init_f
                    two = torch.stack([f, -f], 1)   # slots [class0, class1]
                    two = two - two.max(1, keepdim=True).values
                    e = torch.exp(two)
                    p1 = (e / e.sum(1, keepdim=True))[:, 1]
                return {"probs": torch.stack([1.0 - p1, p1], 1)}
            if cat == ModelCategory.Multinomial:
                z = preds - preds.max(1, keepdim=True).values
                e = torch.exp(z)
                return {"probs": e / e.sum(1, keepdim=True)}
            return {"value": _link_inv(link, preds[:, 0] + init_f)}
        # DRF
        if cat == ModelCategory.Binomial and tpc == 1:
            p0 = preds[:, 0] / max(ntrees, 1)
            return {"probs": torch.stack([p0, 1.0 - p0], 1)}
        if cat in (ModelCategory.Binomial, ModelCategory.Multinomial):
            s = preds.sum(1, keepdim=True)
            s = torch.where(s > 0, s, 1.0)
            return {"probs": preds / s}
        return {"value": preds[:, 0] / max(ntrees, 1)}

    model._predict_raw = _predict_raw
    model.algo_name = algo
    if calib is not None:
        # PlattScalingMojoHelper: p_cal = sigmoid(beta * P(class0) + icept)
        beta, ic = calib[1]

        def _calibrated(p1):
            p0 = 1.0 - p1
            return 1.0 / (1.0 + torch.exp(-(beta * p0 + ic)))

        model._calibrator = ("platt_raw", None)
        model._calibrated_p1 = _calibrated
    return model


def _read_glm_mojo(backend, info, columns, domains):
    model = Model()
    _common_output(model, info, columns, domains,
                   supervised=bool(info.get("supervised", True)))
    beta_h = np.asarray(info.get("beta") or [], np.float64)
    cats = int(info.get("cats") or 0)
    nums = int(info.get("nums") or 0)
    cat_offsets = np.asarray(info.get("cat_offsets") or [0], np.int64)
    use_all = bool(info.get("use_all_factor_levels", False))
    mean_imp = bool(info.get("mean_imputation", False))
    num_means = np.asarray(info.get("num_means") or [0.0] * nums, np.float64)
    cat_modes = np.asarray(info.get("cat_modes") or [0] * cats, np.int64)
    family = str(info.get("family", "gaussian"))
    link = str(info.get("link", "identity"))
    tweedie_lp = float(info.get("tweedie_link_power") or 0.0)

    def _predict_raw(frame):
        X = _frame_matrix(model, frame).double()
        dev = X.device
        beta = torch.as_tensor(beta_h, device=dev)
        n = X.shape[0]
        eta = torch.zeros(n, dtype=torch.float64, device=dev)
        for i in range(cats):
            d = X[:, i]
            if mean_imp:
                d = torch.where(torch.isnan(d), float(cat_modes[i]), d)
            nan = torch.isnan(d)
            code = torch.where(nan, 0.0, d).long()
            if not use_all:
                valid = ~nan & (code > 0)
                ival = code - 1 + int(cat_offsets[i])
            else:
                valid = ~nan
                ival = code + int(cat_offsets[i])
            ival = torch.clamp(ival, 0, len(beta_h) - 1)
            ok = valid & (ival < int(cat_offsets[i + 1]))
            eta = eta + torch.where(ok, beta[ival], 0.0)
        noff = int(cat_offsets[cats]) - cats
        for i in range(nums):
            d = X[:, cats + i]
            if mean_imp:
                d = torch.where(torch.isnan(d), float(num_means[i]), d)
            eta = eta + float(beta_h[noff + cats + i]) * d
        eta = eta + float(beta_h[-1])
        if link == "tweedie":
            # link power 0 = log link, 1 = identity, else inverse power
            # (GLM_tweedieInv semantics)
            if tweedie_lp == 0.0:
                mu = _sanitized_exp(eta)
            elif tweedie_lp == 1.0:
                mu = eta
            else:
                mu = torch.pow(torch.clamp_min(eta, 1e-10), 1.0 / tweedie_lp)
        else:
            mu = _link_inv("logit" if link == "logit" else link, eta)
        if family in ("binomial", "fractionalbinomial"):
            return {"probs": torch.stack([1.0 - mu, mu], 1)}
        return {"value": mu}

    model._predict_raw = _predict_raw
    model.algo_name = "glm"
    return model


def is_java_mojo(source) -> bool:
    """True when the artifact is a reference-format MOJO (model.ini)."""
    try:
        return _Backend(source).exists("model.ini")
    except (OSError, zipfile.BadZipFile):
        return False


# ---------------------------------------------------------------------------
# writer: the port's tree and GLM models in the reference byte format, so
# the stock dependency-free genmodel jar (hex.genmodel.MojoModel.load)
# scores them; the exact inverse of decode_tree's grammar (mojo_version
# 1.20 layout). Host code only.
# ---------------------------------------------------------------------------

def _encode_tree(feat, thresh, na_left, left, right, leaf_val, cat_split,
                 cat_table, split_vals, cards_by_feat) -> bytes:
    """Serialize one tree (dense-array node form) to compressed bytes."""

    def leaf_bytes(node) -> bytes:
        return struct.pack("<f", float(leaf_val[node]))

    def encode(node) -> bytes:
        f = int(feat[node])
        if f < 0:        # root-only leaf: col sentinel 0xFFFF + value
            return struct.pack("<BH", 0, 0xFFFF) + leaf_bytes(node)
        csid = int(cat_split[node])
        na_dir = NA_LEFT if na_left[node] else 3          # NARight
        if csid >= 0:
            equal = 12
            card = int(cards_by_feat[f])
            nbytes = ((card - 1) >> 3) + 1
            bits = bytearray(nbytes)
            for code in range(card):
                # our LUT holds go-LEFT; the reference bitset holds go-RIGHT
                if not cat_table[csid, code]:
                    bits[code >> 3] |= 1 << (code & 7)
            split_payload = struct.pack("<Hi", 0, card) + bytes(bits)
        else:
            equal = 0
            split_payload = struct.pack("<f", float(split_vals[node]))

        l, r = int(left[node]), int(right[node])
        left_leaf = int(feat[l]) < 0
        right_leaf = int(feat[r]) < 0
        lbytes = leaf_bytes(l) if left_leaf else encode(l)
        rbytes = leaf_bytes(r) if right_leaf else encode(r)
        if left_leaf:
            lmask = 48
            offset_field = b""
        else:
            skip = len(lbytes)
            width = next(w for w in (1, 2, 3, 4) if skip < (1 << (8 * w)))
            lmask = width - 1
            offset_field = skip.to_bytes(width, "little")
        rmask = 16 if right_leaf else 0
        node_type = equal | lmask | (rmask << 2)
        return (struct.pack("<BH", node_type, f)
                + bytes([na_dir]) + split_payload
                + offset_field + lbytes + rbytes)

    return encode(0)


def _java_split_vals(forest, spec) -> np.ndarray:
    """Binned thresholds → float split values. Our traversal goes LEFT on
    bin(x) <= t ⇔ x <= edges[t]; the reference goes RIGHT on d >= splitVal,
    so splitVal must be the smallest float32 ABOVE edges[t]."""
    T, M = forest.feat.shape
    out = np.zeros((T, M), np.float32)
    for t in range(T):
        for i in range(M):
            f = int(forest.feat[t, i])
            if f < 0 or int(forest.cat_split[t, i]) >= 0:
                continue
            edges = np.asarray(spec.edges[f], np.float64)
            b = int(np.clip(forest.thresh_bin[t, i], 0, len(edges) - 1))
            out[t, i] = np.nextafter(np.float32(edges[b]), np.float32(np.inf))
    return out


def export_java_mojo_bytes(model) -> bytes:
    """Serialize a GBM/DRF model to the REFERENCE MOJO zip format
    (model.ini + domains/*.txt + trees/t{class}_{group}.bin, v1.20)."""
    algo = model.algo_name
    if algo == "glm":
        return _export_glm_java(model)
    if algo not in ("gbm", "drf"):
        raise ValueError(f"reference-format export supports gbm/drf/glm, "
                         f"not {algo!r}")
    fo = model.forest
    spec = model.spec
    o = model._output
    cat = o.model_category
    nclasses = {ModelCategory.Binomial: 2,
                ModelCategory.Multinomial: len(o.response_domain or []),
                }.get(cat, 1)
    dist = getattr(model, "_distribution", None)
    dname = getattr(dist, "name", None) or \
        ("bernoulli" if cat == ModelCategory.Binomial else "gaussian")

    names = list(spec.names)
    n_features = len(names)
    domains: Dict[int, List[str]] = {}
    for i, nm in enumerate(names):
        if spec.is_cat[i]:
            domains[i] = list(o.domains.get(nm) or
                              [str(j) for j in range(int(spec.cards[i]))])
    columns = names + [o.response_name or "response"]
    if o.response_domain:
        domains[n_features] = list(o.response_domain)

    # per-(class, group) trees from the stacked forest arrays. Binomial
    # DRF with binomial_double_trees trains one tree PER CLASS per group
    # (tree_class 0/1 present) — the format then needs tpc=2 and the
    # multinomial-style accumulate/normalize, not the single-slot flip.
    double_trees = nclasses == 2 and fo.per_class_trees
    tpc = nclasses if fo.per_class_trees else 1
    split_vals = _java_split_vals(fo, spec)
    cards_by_feat = np.asarray(spec.cards, np.int64)
    by_class = _group_by_class(fo, tpc)
    ntree_groups = max((len(v) for v in by_class.values()), default=0)

    leaf_val = np.asarray(fo.leaf_val, np.float64).copy()
    if algo == "drf":
        # our DRF pre-scales leaves by 1/ntrees at compression time
        # (drf.py:11); the reference stores RAW per-tree values and divides
        # by n_trees at score time — and its SINGLE-tree binomial slot
        # accumulates P(class0), not P(class1). Double-trees/multinomial
        # artifacts normalize by the class-vote sum instead, so only the
        # 1/N pre-scaling needs undoing there.
        leaf_val = leaf_val * max(ntree_groups, 1)
        if cat == ModelCategory.Binomial and not double_trees:
            leaf_val = 1.0 - leaf_val
    if tpc > 1 and fo.init_class is not None:
        # the reference multinomial format has no per-class init margin —
        # fold ours into every leaf of each class's FIRST tree (exact under
        # sum semantics)
        init_c = np.asarray(fo.init_class, np.float64)
        for k, tlist0 in by_class.items():
            t0 = tlist0[0]
            leaves = np.asarray(fo.feat[t0]) < 0
            leaf_val[t0, leaves] += float(init_c[k])

    thr = _default_threshold(model)
    init_f = float(fo.init_f or 0.0)
    lines = [
        "[info]",
        "h2o_version = 3.46.0-tpu",
        "mojo_version = 1.20",
        "license = Apache License Version 2.0",
        f"algo = {algo}",
        "algorithm = " + ("Gradient Boosting Machine" if algo == "gbm"
                          else "Distributed Random Forest"),
        "endianness = LITTLE_ENDIAN",
        f"category = {cat}",
        "uuid = 0",
        "supervised = true",
        f"n_features = {n_features}",
        f"n_classes = {nclasses}",
        f"n_columns = {len(columns)}",
        f"n_domains = {len(domains)}",
        "balance_classes = false",
        f"default_threshold = {thr!r}",
        "prior_class_distrib = null",
        "model_class_distrib = null",
        "timestamp = 2026-01-01T00:00:00.000Z",
        f"n_trees = {ntree_groups}",
        f"n_trees_per_class = {tpc}",
        f"distribution = {dname if algo == 'gbm' else 'gaussian'}",
        f"init_f = {init_f!r}",
        "offset_column = null",
    ]
    if algo == "drf":
        lines.append(f"binomial_double_trees = "
                     f"{'true' if double_trees else 'false'}")
    lines.append("")
    lines.append("[columns]")
    lines.extend(columns)
    lines.append("")
    lines.append("[domains]")
    dom_files = {}
    for di_idx, (ci, dom) in enumerate(sorted(domains.items())):
        fname = f"d{di_idx:03d}.txt"
        lines.append(f"{ci}: {len(dom)} {fname}")
        dom_files[fname] = "\n".join(dom) + "\n"

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(lines) + "\n")
        for fname, content in dom_files.items():
            z.writestr(f"domains/{fname}", content)
        for k, tlist in by_class.items():
            for g, t in enumerate(tlist):
                blob = _encode_tree(
                    fo.feat[t], fo.thresh_bin[t], fo.na_left[t], fo.left[t],
                    fo.right[t], leaf_val[t], fo.cat_split[t], fo.cat_table,
                    split_vals[t], cards_by_feat)
                z.writestr(f"trees/t{k:02d}_{g:03d}.bin", blob)
    return buf.getvalue()


def _export_glm_java(model) -> bytes:
    """GLM → reference model.ini format (GlmMojoReader fields). The Java
    scorer applies beta to RAW values (glmScore0 has no standardization),
    so standardized coefficients de-standardize here: β'_j = β_j/σ_j,
    intercept' = intercept − Σ β_j μ_j/σ_j."""
    o = model._output
    di = model.dinfo
    beta = model.beta.detach().cpu().numpy().astype(np.float64)
    if beta.ndim != 1:
        raise ValueError("reference-format GLM export supports binomial/"
                         "regression (1-D beta); multinomial not yet")
    if model._parms.get("interactions"):
        raise ValueError("reference-format GLM export does not cover "
                         "interaction columns")
    if model._parms.get("offset_column"):
        raise ValueError("reference-format GLM export does not cover "
                         "offset_column (the MOJO format scores without "
                         "per-row offsets)")
    family = str(model._parms.get("family") or "gaussian").lower()
    if family == "auto":
        family = ("binomial" if o.model_category == ModelCategory.Binomial
                  else "gaussian")
    link = str(getattr(model, "linkname", "") or
               ("logit" if family == "binomial" else "identity"))
    if family == "ordinal" or link == "ordinal":
        raise ValueError("reference-format GLM export does not cover "
                         "ordinal models (beta carries threshold params)")
    if family == "quasibinomial":
        family = "binomial"     # identical scoring: logit inverse + threshold
    # de-standardized beta in the Java layout (cats, nums, intercept LAST):
    # coef() owns the de-standardization math — single source of truth
    coefs = model.coef()
    b = np.asarray([coefs[nm] for nm in di.coef_names() + ["Intercept"]],
                   np.float64)
    nums = len(di.num_names)
    mean_imp = str(di.missing_values_handling or "").lower() \
        .replace("_", "") == "meanimputation"

    names = list(di.cat_names) + list(di.num_names)
    columns = names + [o.response_name or "response"]
    domains: Dict[int, List[str]] = {
        i: list(di.domains[nm]) for i, nm in enumerate(di.cat_names)}
    if o.response_domain:
        domains[len(names)] = list(o.response_domain)
    thr = _default_threshold(model)
    lines = [
        "[info]",
        "h2o_version = 3.46.0-tpu",
        "mojo_version = 1.0",
        "license = Apache License Version 2.0",
        "algo = glm",
        "algorithm = Generalized Linear Modeling",
        "endianness = LITTLE_ENDIAN",
        f"category = {o.model_category}",
        "uuid = 0",
        "supervised = true",
        f"n_features = {len(names)}",
        f"n_classes = "
        f"{2 if o.model_category == ModelCategory.Binomial else 1}",
        f"n_columns = {len(columns)}",
        f"n_domains = {len(domains)}",
        "balance_classes = false",
        f"default_threshold = {thr!r}",
        "prior_class_distrib = null",
        "model_class_distrib = null",
        "timestamp = 2026-01-01T00:00:00.000Z",
        f"use_all_factor_levels = "
        f"{'true' if di.use_all_factor_levels else 'false'}",
        f"cats = {len(di.cat_names)}",
        "cat_modes = [" + ", ".join(str(int(m))
                                    for m in di.cat_modes) + "]",
        "cat_offsets = [" + ", ".join(str(int(x))
                                      for x in di.cat_offsets) + "]",
        f"nums = {nums}",
        "num_means = [" + ", ".join(repr(float(v))
                                    for v in di.impute_values) + "]",
        f"mean_imputation = {'true' if mean_imp else 'false'}",
        "beta = [" + ", ".join(repr(float(v)) for v in b) + "]",
        f"family = {family}",
        f"link = {link}",
        *( [f"tweedie_link_power = {float(model.link_power)!r}"]
           if link == "tweedie" else [] ),
        "",
        "[columns]", *columns,
        "",
        "[domains]",
    ]
    dom_files = {}
    for di_idx, (ci, dom) in enumerate(sorted(domains.items())):
        fname = f"d{di_idx:03d}.txt"
        lines.append(f"{ci}: {len(dom)} {fname}")
        dom_files[fname] = "\n".join(dom) + "\n"
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(lines) + "\n")
        for fname, content in dom_files.items():
            z.writestr(f"domains/{fname}", content)
    return buf.getvalue()


def _group_by_class(fo, tpc: int) -> Dict[int, List[int]]:
    by_class: Dict[int, List[int]] = {}
    for t in range(fo.n_trees):
        k = int(fo.tree_class[t]) if tpc > 1 else 0
        by_class.setdefault(k, []).append(t)
    return by_class

