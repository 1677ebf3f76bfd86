"""MOJO: the portable scoring artifact, export and import (counterpart of
h2o3_tpu/models/mojo.py: `_datainfo_state` :46, the per-family payload
writers and readers :97-464, `_model_class` :218, `_default_threshold`
:471, `export_mojo_bytes` :477, `export_mojo` :548, `_threshold_metrics`
:567, `read_mojo` :583).

Reference: h2o-genmodel ModelMojoReader.java / AbstractMojoWriter.java.
The container is the reference package's, byte for byte: a zip holding
`model.ini` ([info] key = value pairs, [columns], [domains]),
`domains/dNNN.txt`, `scorer.json` (names, domains, category, threshold,
plain parameters and the family's metadata) and the family's arrays as
`data/<name>.npy`, with mojo_version 99.0. So the JAX package, this port
and the numpy-only `h2o3_genmodel` runtime read each other's files;
only `h2o_version`, `uuid` and `timestamp` tell them apart.

Export copies every tensor to the host. Import rebuilds the family's
model through its own constructor (so every attribute the class sets is
there), restores the payload, and puts the tensors the family keeps on
a device (GLM's beta, DeepLearning's weights) on the runtime's device.
Every `.npy` is read with allow_pickle=False. A zip holding `model.ini`
but no `scorer.json`, or a directory, is a reference-format (Java) MOJO
and goes to `mojo_java.read_java_mojo`.
"""

from __future__ import annotations

import io
import json
import os
import uuid as _uuid
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.models.model import Model, ModelCategory

MOJO_VERSION = 99.0


def _host(a) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device():
    from h2o3_tpu_torch.core.runtime import cluster

    return cluster().device


# ---------------------------------------------------------------------------
# DataInfo (de)hydration: linear, NN and clustering models carry one
# ---------------------------------------------------------------------------

def _datainfo_state(di) -> dict:
    return {
        "response_name": di.response_name,
        "weights_name": di.weights_name,
        "offset_name": di.offset_name,
        "standardize": di.standardize,
        "use_all_factor_levels": di.use_all_factor_levels,
        "missing_values_handling": di.missing_values_handling,
        "cat_names": di.cat_names,
        "num_names": di.num_names,
        "domains": di.domains,
        "cards": di.cards,
        "num_means": _host(di.num_means).tolist(),
        "num_sigmas": _host(di.num_sigmas).tolist(),
        "cat_modes": _host(di.cat_modes).tolist(),
        "impute_values": _host(di.impute_values).tolist(),
    }


def _datainfo_restore(state: dict):
    from h2o3_tpu_torch.models.data_info import DataInfo

    return DataInfo.from_state(state)


# ---------------------------------------------------------------------------
# per-family payload writers / readers
# ---------------------------------------------------------------------------

def _forest_payload(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    fo = model.forest
    spec = model.spec
    arrays = {
        "feat": fo.feat, "thresh_bin": fo.thresh_bin,
        "na_left": np.asarray(fo.na_left).astype(np.int8),
        "left": fo.left, "right": fo.right, "leaf_val": fo.leaf_val,
        "cat_split": fo.cat_split,
        "cat_table": np.asarray(fo.cat_table).astype(np.int8),
        "tree_class": fo.tree_class, "na_bins": fo.na_bins,
        "spec_nbins": np.asarray(spec.nbins, np.int64),
        "spec_is_cat": np.asarray(spec.is_cat, np.int8),
        "spec_cards": np.asarray(spec.cards, np.int64),
        "spec_edges_flat": (np.concatenate([np.asarray(e, np.float64)
                                            for e in spec.edges])
                            if spec.edges else np.zeros(0)),
        "spec_edges_len": np.asarray([len(e) for e in spec.edges], np.int64),
    }
    if fo.init_class is not None:
        arrays["init_class"] = np.asarray(fo.init_class, np.float32)
    dist = getattr(model, "_distribution", None)
    # the reference reads attributes its distributions do not have
    # (they are `power` and `alpha`), so these are always 1.5 and 0.5;
    # scoring needs only the link, which the name fixes
    meta = {
        "max_depth": fo.max_depth, "init_f": fo.init_f,
        "nclasses": fo.nclasses,
        "spec_names": spec.names,
        "distribution": getattr(dist, "name", None),
        "tweedie_power": float(getattr(dist, "tweedie_power", 1.5) or 1.5)
        if dist is not None else 1.5,
        "quantile_alpha": float(getattr(dist, "quantile_alpha", 0.5) or 0.5)
        if dist is not None else 0.5,
        "cnorm": float(model._parms.get("_cnorm", 1.0) or 1.0),
    }
    return meta, arrays


def _forest_restore(model, meta: dict, arrays: Dict[str, np.ndarray]):
    from h2o3_tpu_torch.models.distribution import get_distribution
    from h2o3_tpu_torch.models.tree.binning import BinSpec
    from h2o3_tpu_torch.models.tree.compressed import CompressedForest

    lens = arrays["spec_edges_len"]
    flat = arrays["spec_edges_flat"]
    edges, pos = [], 0
    for ln in lens:
        edges.append(np.asarray(flat[pos: pos + int(ln)], np.float32))
        pos += int(ln)
    spec = BinSpec(meta["spec_names"], arrays["spec_is_cat"].astype(bool),
                   arrays["spec_nbins"], edges, arrays["spec_cards"])
    forest = CompressedForest(
        arrays["feat"], arrays["thresh_bin"], arrays["na_left"].astype(bool),
        arrays["left"], arrays["right"], arrays["leaf_val"],
        arrays["cat_split"], arrays["cat_table"].astype(bool),
        arrays["tree_class"], arrays["na_bins"],
        max_depth=int(meta["max_depth"]), init_f=float(meta["init_f"]),
        nclasses=int(meta["nclasses"]))
    if "init_class" in arrays:
        forest.init_class = arrays["init_class"]
    model.forest = forest
    model.spec = spec
    if meta.get("distribution"):
        model._distribution = get_distribution(
            meta["distribution"], tweedie_power=meta["tweedie_power"],
            quantile_alpha=meta["quantile_alpha"])
    model._parms.setdefault("_cnorm", meta.get("cnorm", 1.0))


def _glm_payload(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    arrays = {"beta": _host(model.beta).astype(np.float64)}
    meta = {"linkname": model.linkname, "link_power": model.link_power,
            "dinfo": _datainfo_state(model.dinfo)}
    return meta, arrays


def _glm_restore(model, meta, arrays):
    model.beta = torch.as_tensor(arrays["beta"].astype(np.float32),
                                 device=_device())
    model.linkname = meta["linkname"]
    model.link_power = float(meta["link_power"])
    model.dinfo = _datainfo_restore(meta["dinfo"])
    model.p_values = None
    model.std_errors = None


def _kmeans_payload(model):
    return ({"k": model.k, "dinfo": _datainfo_state(model.data_info)},
            {"centers": _host(model.centers).astype(np.float64),
             "centers_raw": _host(model.centers_raw).astype(np.float64)})


def _kmeans_restore(model, meta, arrays):
    model.centers = np.asarray(arrays["centers"], np.float32)
    model.centers_raw = np.asarray(arrays["centers_raw"], np.float32)
    model.k = int(meta["k"])
    model.data_info = _datainfo_restore(meta["dinfo"])


def _dl_payload(model):
    arrays = {}
    for i, (W, b) in enumerate(model.params_tree):
        arrays[f"W{i}"] = _host(W).astype(np.float32)
        arrays[f"b{i}"] = _host(b).astype(np.float32)
    meta = {"n_layers": len(model.params_tree),
            "activation": model.activation,
            "nclasses": model.nclasses,
            "autoencoder": model.autoencoder,
            "dinfo": _datainfo_state(model.data_info)}
    return meta, arrays


def _dl_restore(model, meta, arrays):
    dev = _device()
    model.params_tree = [
        (torch.as_tensor(arrays[f"W{i}"], device=dev),
         torch.as_tensor(arrays[f"b{i}"], device=dev))
        for i in range(int(meta["n_layers"]))]
    model.activation = meta["activation"]
    model.nclasses = int(meta["nclasses"])
    model.autoencoder = bool(meta["autoencoder"])
    model.data_info = _datainfo_restore(meta["dinfo"])


def _pca_payload(model):
    """hex/genmodel/algos/pca/PcaMojoModel analog: eigenvectors and the
    DataInfo standardisation state."""
    return ({"k": model.k, "dinfo": _datainfo_state(model.data_info)},
            {"eigenvectors": _host(model.eigenvectors).astype(np.float64),
             "std_deviation": _host(model.std_deviation).astype(np.float64),
             "prop_var": _host(model.prop_var).astype(np.float64),
             "cum_var": _host(model.cum_var).astype(np.float64)})


def _pca_restore(model, meta, arrays):
    model.eigenvectors = np.asarray(arrays["eigenvectors"], np.float32)
    model.std_deviation = np.asarray(arrays["std_deviation"], np.float64)
    model.prop_var = np.asarray(arrays["prop_var"], np.float64)
    model.cum_var = np.asarray(arrays["cum_var"], np.float64)
    model.k = int(meta["k"])
    model.data_info = _datainfo_restore(meta["dinfo"])


def _glrm_payload(model):
    """hex/genmodel/algos/glrm/GlrmMojoModel analog: the archetypes Y
    and the loss/regulariser settings the fixed-Y X-solve reads."""
    p = model._parms
    return ({"k": model.k, "dinfo": _datainfo_state(model.data_info),
             "loss": str(p.get("loss") or "Quadratic"),
             "period": float(p.get("period") or 1.0),
             "multi_loss": str(p.get("multi_loss") or "Categorical"),
             "loss_by_col": list(p.get("loss_by_col") or []),
             "loss_by_col_idx": [int(i)
                                 for i in (p.get("loss_by_col_idx") or [])],
             "names": list(model._output.names or []),
             "regularization_x": str(p.get("regularization_x") or "None"),
             "gamma_x": float(p.get("gamma_x") or 0.0)},
            {"archetypes": _host(model.archetypes).astype(np.float64)})


def _glrm_restore(model, meta, arrays):
    model.archetypes = np.asarray(arrays["archetypes"], np.float32)
    model.k = int(meta["k"])
    model.data_info = _datainfo_restore(meta["dinfo"])
    model._parms.setdefault("loss", meta["loss"])
    model._parms.setdefault("period", meta.get("period", 1.0))
    model._parms.setdefault("multi_loss", meta.get("multi_loss",
                                                   "Categorical"))
    if meta.get("loss_by_col"):
        model._parms.setdefault("loss_by_col", list(meta["loss_by_col"]))
        model._parms.setdefault("loss_by_col_idx",
                                list(meta["loss_by_col_idx"]))
    model._parms.setdefault("regularization_x", meta["regularization_x"])
    model._parms.setdefault("gamma_x", meta["gamma_x"])
    model.x_key = None
    model.objective = float("nan")


def _w2v_payload(model):
    """hex/genmodel/algos/word2vec/Word2VecMojoModel analog: the vocabulary
    as the word list in index order, and the embedding matrix."""
    words = [w for w, _ in sorted(model.vocab.items(), key=lambda kv: kv[1])]
    return ({"words": words},
            {"vectors": _host(model.vectors).astype(np.float32)})


def _w2v_restore(model, meta, arrays):
    model.vectors = np.asarray(arrays["vectors"], np.float32)
    model.vocab = {w: i for i, w in enumerate(meta["words"])}


def _ensemble_payload(model):
    """hex/genmodel/algos/ensemble/StackedEnsembleMojoModel analog: the
    base models and the metalearner ship inside the artifact as nested
    MOJO zips (uint8 arrays), so the export stands alone."""
    from h2o3_tpu_torch.models.ensemble import _resolve

    meta = {"base_names": [str(k) for k in model.base_keys]}
    arrays = {}
    for i, bk in enumerate(model.base_keys):
        arrays[f"base{i}"] = np.frombuffer(
            export_mojo_bytes(_resolve(bk)), np.uint8)
    arrays["metalearner"] = np.frombuffer(
        export_mojo_bytes(model.metalearner), np.uint8)
    return meta, arrays


def _ensemble_restore(model, meta, arrays):
    base_keys = []
    for i, name in enumerate(meta["base_names"]):
        bm = read_mojo(arrays[f"base{i}"].tobytes())
        bm._key = str(name)          # level-one column names derive from it
        bm.install()
        base_keys.append(name)
    model.base_keys = base_keys
    model.metalearner = read_mojo(arrays["metalearner"].tobytes())


def _te_payload(model):
    """hex/genmodel/algos/targetencoder/TargetEncoderMojoModel analog:
    per column the level -> (num, den) tables, the prior and the
    blending settings."""
    p = model._parms
    meta = {"prior": float(model.prior), "nfolds": int(model.nfolds),
            "columns": [], "blending": bool(p.get("blending")),
            "inflection_point": float(p.get("inflection_point", 10.0) or 10.0),
            "smoothing": float(p.get("smoothing", 20.0) or 20.0),
            "keep_original_categorical_columns":
                bool(p.get("keep_original_categorical_columns", True))}
    arrays = {}
    for i, (col, enc) in enumerate(sorted(model.encodings.items())):
        meta["columns"].append({"name": col, "domain": list(enc["domain"])})
        arrays[f"num{i}"] = _host(enc["num"]).astype(np.float64)
        arrays[f"den{i}"] = _host(enc["den"]).astype(np.float64)
    return meta, arrays


def _te_restore(model, meta, arrays):
    model.prior = float(meta["prior"])
    model.nfolds = int(meta["nfolds"])
    model.encodings = {}
    for i, centry in enumerate(meta["columns"]):
        model.encodings[centry["name"]] = {
            "domain": list(centry["domain"]),
            "num": np.asarray(arrays[f"num{i}"], np.float64),
            "den": np.asarray(arrays[f"den{i}"], np.float64)}
    for k in ("blending", "inflection_point", "smoothing",
              "keep_original_categorical_columns"):
        model._parms.setdefault(k, meta[k])


def _coxph_payload(model):
    """hex/genmodel/algos/coxph/CoxPHMojoModel analog: beta, the
    strata-free baseline hazard and the DataInfo centering state."""
    bh = model.baseline_hazard
    return ({"dinfo": _datainfo_state(model.data_info),
             "coefficients": {k: float(v)
                              for k, v in model.coefficients.items()},
             "strata": model.strata,
             "loglik": float(model.loglik),
             "concordance": float(model.concordance)},
            {"beta": _host(model.beta).astype(np.float64),
             "baseline_hazard": (_host(bh).astype(np.float64)
                                 if bh is not None else np.zeros((0, 2)))})


def _coxph_restore(model, meta, arrays):
    model.beta = np.asarray(arrays["beta"], np.float32)
    bh = np.asarray(arrays["baseline_hazard"], np.float64)
    model.baseline_hazard = bh if bh.size else None
    model.data_info = _datainfo_restore(meta["dinfo"])
    model.coefficients = dict(meta["coefficients"])
    model.strata = meta.get("strata")
    model.loglik = float(meta["loglik"])
    model.loglik_null = float("nan")
    model.concordance = float(meta["concordance"])


_TREE_ALGOS = {"gbm", "drf", "isolationforest", "xgboost"}

# algo -> (module, model class, payload writer, payload reader)
_FAMILIES = {
    "gbm": ("models.tree.gbm", "GBMModel", _forest_payload, _forest_restore),
    "xgboost": ("models.xgboost", "XGBoostModel", _forest_payload,
                _forest_restore),
    "drf": ("models.tree.drf", "DRFModel", _forest_payload, _forest_restore),
    "isolationforest": ("models.tree.isofor", "IsolationForestModel",
                        _forest_payload, _forest_restore),
    "glm": ("models.glm", "GLMModel", _glm_payload, _glm_restore),
    "kmeans": ("models.kmeans", "KMeansModel", _kmeans_payload,
               _kmeans_restore),
    "deeplearning": ("models.deeplearning", "DeepLearningModel",
                     _dl_payload, _dl_restore),
    "pca": ("models.pca", "PCAModel", _pca_payload, _pca_restore),
    "glrm": ("models.glrm", "GLRMModel", _glrm_payload, _glrm_restore),
    "word2vec": ("models.word2vec", "Word2VecModel", _w2v_payload,
                 _w2v_restore),
    "stackedensemble": ("models.ensemble", "StackedEnsembleModel",
                        _ensemble_payload, _ensemble_restore),
    "targetencoder": ("models.target_encoder", "TargetEncoderModel",
                      _te_payload, _te_restore),
    "coxph": ("models.coxph", "CoxPHModel", _coxph_payload, _coxph_restore),
}


def _family(algo: str):
    fam = _FAMILIES.get(algo)
    if fam is None:
        raise ValueError(f"MOJO export not supported for algo {algo!r}")
    return fam


def _model_class(algo: str):
    import importlib

    mod, cls, _, _ = _family(algo)
    return getattr(importlib.import_module(f"h2o3_tpu_torch.{mod}"), cls)


def _payload(model) -> Tuple[dict, Dict[str, np.ndarray]]:
    return _family(model.algo_name)[2](model)


def _restore_payload(model, algo, meta, arrays):
    _family(algo)[3](model, meta, arrays)


# ---------------------------------------------------------------------------
# writer (AbstractMojoWriter analog)
# ---------------------------------------------------------------------------

def _default_threshold(model) -> float:
    tm = model._output.training_metrics
    aucd = getattr(tm, "auc_data", None)
    return float(aucd.max_f1_threshold) if aucd is not None else 0.5


def export_mojo_bytes(model: Model) -> bytes:
    """A trained model as MOJO zip bytes."""
    inner = getattr(model, "_inner", None)
    if inner is not None:          # Generic wraps a MOJO-loaded model:
        model = inner              # re-export the wrapped scorer
    o = model._output
    meta, arrays = _payload(model)

    columns = list(o.names)
    if o.response_name:
        columns.append(o.response_name)
    dom_cols = []          # (column_index, domain) as the reference's ini
    for i, c in enumerate(columns):
        d = (o.domains.get(c) if c != o.response_name else o.response_domain)
        if d:
            dom_cols.append((i, c, d))

    ini = ["[info]"]
    info = {
        "algo": model.algo_name,
        "algorithm": model.algo_name.upper(),
        "h2o_version": "h2o3_tpu_torch",
        "mojo_version": MOJO_VERSION,
        "category": o.model_category,
        "uuid": _uuid.uuid4().hex,
        "supervised": "true" if o.response_name else "false",
        "n_features": len(o.names),
        "n_classes": o.nclasses,
        "n_columns": len(columns),
        "n_domains": len(dom_cols),
        "balance_classes": "false",
        "default_threshold": _default_threshold(model),
        "prior_class_distrib": "null",
        "model_class_distrib": "null",
        "timestamp": "",
    }
    ini += [f"{k} = {v}" for k, v in info.items()]
    ini.append("")
    ini.append("[columns]")
    ini += columns
    ini.append("")
    ini.append("[domains]")
    for j, (i, _c, d) in enumerate(dom_cols):
        ini.append(f"{i}: {len(d)} d{j:03d}.txt")

    scorer = {
        "algo": model.algo_name,
        "model_category": o.model_category,
        "names": o.names,
        "response_name": o.response_name,
        "response_domain": o.response_domain,
        "domains": o.domains,
        "default_threshold": _default_threshold(model),
        "parms": {k: v for k, v in model._parms.items()
                  if isinstance(v, (int, float, str, bool, type(None)))},
        "meta": meta,
    }

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini) + "\n")
        for j, (_i, _c, d) in enumerate(dom_cols):
            z.writestr(f"domains/d{j:03d}.txt",
                       "\n".join(str(x) for x in d) + "\n")
        z.writestr("scorer.json", json.dumps(scorer, default=str))
        for name, arr in arrays.items():
            ab = io.BytesIO()
            np.save(ab, np.asarray(arr))
            z.writestr(f"data/{name}.npy", ab.getvalue())
    return buf.getvalue()


def export_mojo(model: Model, path: str) -> str:
    """h2o-py model.download_mojo / save_mojo: a directory argument means
    "save into it as <key>.zip"; another path gains ".zip" if it lacks
    it."""
    data = export_mojo_bytes(model)
    if os.path.isdir(path):
        path = os.path.join(path, f"{model.key}.zip")
    elif not path.endswith(".zip"):
        path = path + ".zip"
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# reader (ModelMojoReader analog)
# ---------------------------------------------------------------------------

def _threshold_metrics(thr: float):
    """Stand-in training metrics that carry only the labelling threshold,
    so Model.predict labels with the trained model's max-F1 threshold
    after a MOJO round trip: a NaN-filled ModelMetricsBinomial."""
    from h2o3_tpu_torch.models import metrics as M

    mm = M.ModelMetricsBinomial(description="restored from MOJO artifact")
    mm.auc_data = M.AUCData(
        auc=float("nan"), pr_auc=float("nan"), gini=float("nan"),
        max_f1=float("nan"), max_f1_threshold=float(thr),
        thresholds=np.asarray([thr]), tps=np.zeros(1), fps=np.zeros(1),
        p=0.0, n=0.0)
    return mm


def read_mojo(source) -> Model:
    """Load a MOJO (path, bytes or file-like) back into a scoring model.
    Reference-format (Java) MOJOs, model.ini + trees/*.bin, go to the
    mojo_java reader, so `Generic(path=...)` takes real h2o-3 artifacts
    (hex/generic/Generic.java)."""
    from h2o3_tpu_torch.models import mojo_java

    if not isinstance(source, (bytes, bytearray)) and \
            isinstance(source, (str, os.PathLike)) and os.path.isdir(source):
        return mojo_java.read_java_mojo(source)     # exploded reference MOJO
    if isinstance(source, (bytes, bytearray)):
        source = io.BytesIO(source)
    with zipfile.ZipFile(source) as z:
        names = set(z.namelist())
        if "scorer.json" not in names:
            if "model.ini" in names:
                if hasattr(source, "seek"):
                    source.seek(0)
                return mojo_java.read_java_mojo(
                    source.read() if hasattr(source, "read") else source)
            raise ValueError("not a MOJO: neither scorer.json (h2o3_tpu) "
                             "nor model.ini (reference format) present")
        scorer = json.loads(z.read("scorer.json").decode())
        arrays = {}
        for n in names:
            if n.startswith("data/") and n.endswith(".npy"):
                arrays[n[len("data/"):-len(".npy")]] = np.load(
                    io.BytesIO(z.read(n)), allow_pickle=False)

    algo = scorer["algo"]
    model = _model_class(algo)(parms=dict(scorer.get("parms") or {}))
    o = model._output
    o.names = list(scorer["names"])
    o.response_name = scorer.get("response_name")
    o.response_domain = scorer.get("response_domain")
    o.domains = {k: list(v) for k, v in (scorer.get("domains") or {}).items()}
    o.model_category = scorer["model_category"]
    if o.model_category == ModelCategory.Binomial:
        o.training_metrics = _threshold_metrics(
            float(scorer["default_threshold"]))
    _restore_payload(model, algo, scorer["meta"], arrays)
    return model
