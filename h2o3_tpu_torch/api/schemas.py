"""V3 REST schema emission — the JSON shapes stock h2o-py parses
(counterpart of h2o3_tpu/api/schemas.py, over the port's Frame, Column,
Model and metrics).

Reference: water/api/Schema.java:95 (versioned DTOs with @API fields),
water/api/schemas3/*V3.java, hex/schemas/*V3.java. h2o-py dispatches on
`__meta.schema_name` (h2o-py/h2o/backend/connection.py H2OResponse.__new__):
CloudV3 -> H2OCluster, TwoDimTableV3 -> H2OTwoDimTable, ModelMetrics*V3 ->
metric classes — so every response here carries the exact meta tag and the
exact field names the client's accessors read.

Notable client-side contracts honored here:
- CloudV3 may only contain keys in h2o-py's _cloud_v3_valid_keys
  (backend/cluster.py:381) — an unknown key raises AttributeError client-side.
- TwoDimTableV3 "data" is COLUMN-major; client transposes
  (two_dim_table.py:146 `zip(*values)`).
- thresholds_and_metric_scores rows are indexed positionally by
  metrics_base.confusion_matrix (tns=row[11], fns=12, fps=13, tps=14).
- Frame ColV3 "data" NAs are the string "NaN" (expr.py _fill_data).

A column preview copies only its requested rows off the card; its
rollups are computed on the device (ops/rollups.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_STR, widen
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.model import Model, ModelCategory

SERVER_VERSION = "3.46.0.1"   # advertise a modern h2o-3 line for client checks


def meta(name: str, schema_type: str = "Iced") -> dict:
    return {"schema_version": 3, "schema_name": name, "schema_type": schema_type}


def key_ref(name: Optional[str], ktype: str = "Key<Frame>") -> Optional[dict]:
    if name is None:
        return None
    return {"__meta": meta("KeyV3", ktype.replace("<", "").replace(">", "")),
            "name": str(name), "type": ktype,
            "URL": f"/3/{'Frames' if 'Frame' in ktype else 'Models'}/{name}"}


def trace_v3(trace_id: str, spans: List[dict], tree: List[dict]) -> dict:
    """One trace's span tree (GET /3/Trace/{id}): the flat start-ordered
    span list plus the parent-nested tree — clients graph either."""
    return {"__meta": meta("TraceV3"), "trace_id": trace_id,
            "span_count": len(spans), "spans": spans, "tree": tree}


def flight_records_v3(records: List[dict]) -> dict:
    """Flight-record listing (GET /3/FlightRecords)."""
    return {"__meta": meta("FlightRecordsV3"), "records": records,
            "count": len(records)}


def artifact_v3(info: dict, **extra) -> dict:
    """AOT-artifact DTO (the /3/Artifacts family): a validated manifest
    summary — never raw manifest internals — plus route-specific fields
    (dir, model_id)."""
    out = {"__meta": meta("ArtifactV3")}
    out.update(info)
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# TwoDimTable
# ---------------------------------------------------------------------------

def twodim(name: str, cols: Sequence[Tuple[str, str]], data_cols: Sequence[Sequence],
           description: str = "") -> dict:
    """cols = [(col_name, col_type)]; data_cols is COLUMN-major.
    col_type in {"string","int","long","float","double"}."""
    return {
        "__meta": meta("TwoDimTableV3"),
        "name": name,
        "description": description,
        "columns": [{"__meta": meta("ColumnSpecsBase"),
                     "name": cn, "type": ct,
                     "format": "%s" if ct == "string" else "%d" if ct in ("int", "long") else "%.5f",
                     "description": cn} for cn, ct in cols],
        "rowcount": len(data_cols[0]) if data_cols else 0,
        "data": [list(c) for c in data_cols],
    }


def dict_table(name: str, d: Dict[str, Sequence], types: Optional[Dict[str, str]] = None) -> dict:
    cols = [(k, (types or {}).get(k, "double")) for k in d]
    return twodim(name, cols, [list(v) for v in d.values()])


# ---------------------------------------------------------------------------
# Cloud
# ---------------------------------------------------------------------------

def frame_byte_size(fr) -> int:
    """A frame's byte size as the reference reports it, 4 bytes a value,
    except that a bfloat16 column counts the 2 bytes a value it stores
    (the `numeric_dtype` opt-in)."""
    import torch

    size = 0
    for c in fr.columns:
        d = c._data
        size += (2 if d is not None and d.dtype == torch.bfloat16
                 else 4) * fr.nrows
    return size


def cloud_v3(info: Dict[str, Any]) -> dict:
    size = int(info.get("cloud_size", 1))
    node = {
        "__meta": meta("NodeV3"),
        # the device this node serves on (the reference writes the cloud
        # name here); node dicts are free-form to h2o-py
        "h2o": ((info.get("nodes") or [{}])[0].get("name")
                or info.get("cloud_name", "h2o3_tpu_torch")),
        "ip_port": "127.0.0.1:54321",
        "healthy": True, "last_ping": int(time.time() * 1000),
        "pid": 0, "num_cpus": 1, "cpus_allowed": 1, "nthreads": 1,
        "sys_load": 0.0, "my_cpu_pct": 0, "sys_cpu_pct": 0,
        "mem_value_size": int(info.get("mem_value_size", 0)),
        "pojo_mem": 0, "swap_mem": 0,
        "free_mem": 0, "max_mem": 0, "num_keys": 0,
        "free_disk": 0, "max_disk": 0,
        "rpcs_active": 0, "fjthrds": [], "fjqueue": [],
        "open_fds": 0, "gflops": info.get("gflops", 0.0),
        "mem_bw": info.get("mem_bw", 0.0),
        "tcps_active": 0,
    }
    # ONLY _cloud_v3_valid_keys (h2o-py backend/cluster.py:381) may appear.
    return {
        "__meta": meta("CloudV3"),
        "version": SERVER_VERSION,
        "branch_name": "rel-tpu",
        "build_number": "1",
        "build_age": "0 days",
        "build_too_old": False,
        "cloud_name": info.get("cloud_name", "h2o3_tpu_torch"),
        "cloud_size": size,
        "cloud_uptime_millis": int(info.get("cloud_uptime_millis", 0)),
        "cloud_internal_timezone": "UTC",
        "datafile_parser_timezone": "UTC",
        "cloud_healthy": bool(info.get("cloud_healthy", True)),
        "consensus": True,
        "locked": bool(info.get("locked", True)),
        "bad_nodes": 0,
        "is_client": False,
        "node_idx": 0,
        "leader_idx": 0,
        "skip_ticks": False,
        "internal_security_enabled": False,
        "nodes": [dict(node) for _ in range(size)],
    }


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

def _auto_recoverable(job, status: str) -> bool:
    """True only while the watchdog could actually still resume this job:
    it has a re-dispatch recipe, is not terminal-successful, and has not
    been parked at the attempt cap (a stale True makes operators wait for
    a recovery that can never happen instead of resubmitting)."""
    from h2o3_tpu_torch.parallel.watchdog import MAX_ATTEMPTS, enabled

    if not enabled():
        return False                 # manual drills: nothing will resume it
    if status == "FAILED":
        if not getattr(job, "failed_externally", False):
            return False             # worker-crashed: client resubmits
        from h2o3_tpu_torch.parallel import ckpt

        if not ckpt.has_job_progress(str(job.key)):
            return False             # died before the first durable save
    return (bool(getattr(job, "resume_spec", None))
            and status not in ("DONE", "CANCELLED")
            and int(getattr(job, "attempt", 1) or 1) < MAX_ATTEMPTS)


def job_v3(job) -> dict:
    status = str(job.status)
    if status == "RESUMING":
        # internal recovery state: h2o-py pollers treat anything beyond
        # CREATED/RUNNING as terminal, so on the wire a resuming job is
        # simply RUNNING (attempt/resumed_from_iteration tell the story)
        status = "RUNNING"
    dest = getattr(job, "dest_key", None) or getattr(job, "dest", None)
    start = getattr(job, "start_time", 0.0) or 0.0
    end = getattr(job, "end_time", 0.0) or 0.0
    out = {
        "__meta": meta("JobV3"),
        "key": {"__meta": meta("JobKeyV3"), "name": str(job.key),
                "type": "Key<Job>", "URL": f"/3/Jobs/{job.key}"},
        "description": job.description,
        "status": status,
        "progress": float(job.progress),
        "progress_msg": getattr(job, "progress_msg", "") or "",
        "start_time": int(start * 1000),
        "msec": int(((end or time.time()) - start) * 1000) if start else 0,
        "dest": key_ref(dest, getattr(job, "dest_type", "Key<Frame>"))
        or {"name": None},
        "exception": getattr(job, "exception", None),
        "warnings": list(getattr(job, "warnings", []) or []),
        # crash-survivable jobs: dispatch count (1 = original submit) and,
        # after a watchdog resume, the iteration training continued from
        "attempt": int(getattr(job, "attempt", 1) or 1),
        "resumed_from_iteration": getattr(job, "resumed_from_iteration",
                                          None),
        "failed_externally": bool(getattr(job, "failed_externally", False)),
        "auto_recoverable": _auto_recoverable(job, status),
        "ready_for_view": True,
    }
    if status == "FAILED" and getattr(job, "exception", None):
        out["stacktrace"] = job.exception
    return out


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

_CTYPE_TO_REST = {"real": "real", "int": "int", "enum": "enum", "time": "time",
                  "string": "string", "uuid": "uuid", "bad": "bad"}


def col_v3(name: str, col: Column, offset: int, count: int) -> dict:
    n = col.nrows
    lo = max(0, min(offset, n))
    hi = max(lo, min(lo + count, n)) if count >= 0 else n
    rtype = _CTYPE_TO_REST.get(col.ctype, "real")
    out = {
        "__meta": meta("ColV3"),
        "label": name,
        "type": rtype,
        "missing_count": 0, "zero_count": 0,
        "positive_infinity_count": 0, "negative_infinity_count": 0,
        "mins": [], "maxs": [], "mean": None, "sigma": None,
        "histogram_bins": None, "histogram_base": None, "histogram_stride": None,
        "percentiles": None,
        "domain": col.domain, "domain_cardinality": col.cardinality,
        "data": None, "string_data": None, "precision": -1,
    }
    if col.is_string:
        vals = col.host_data[lo:hi]
        out["string_data"] = [None if v is None else str(v) for v in vals]
        out["missing_count"] = int(sum(1 for v in col.host_data if v is None))
        return out
    r = col.rollups
    out["missing_count"] = int(r.na_count)
    if col.is_categorical:
        arr = col.data[lo:hi].cpu().numpy()
        out["data"] = [("NaN" if v < 0 else int(v)) for v in arr.tolist()]
        return out
    out["zero_count"] = int(max(r.rows - r.nz_count, 0))
    out["mins"] = [float(r.min)] if r.min == r.min else []
    out["maxs"] = [float(r.max)] if r.max == r.max else []
    out["mean"] = float(r.mean) if r.mean == r.mean else None
    out["sigma"] = float(r.sigma) if r.sigma == r.sigma else None
    arr = widen(col.data[lo:hi]).cpu().numpy().astype(np.float64)
    data = []
    for v in arr.tolist():
        if v != v:
            data.append("NaN")
        elif col.ctype == "int" and float(v).is_integer():
            data.append(int(v))
        else:
            data.append(v)
    out["data"] = data
    return out


def frame_v3(fr: Frame, row_count: int = 10, row_offset: int = 0,
             column_count: int = -1, column_offset: int = 0,
             with_data: bool = True) -> dict:
    names = fr.names
    ncols = len(names)
    if column_count is None or column_count < 0:
        column_count = ncols
    sel = names[column_offset: column_offset + column_count]
    columns = []
    if with_data:
        columns = [col_v3(n, fr.col(n), row_offset, row_count) for n in sel]
    return {
        "__meta": meta("FrameV3"),
        "frame_id": key_ref(str(fr.key), "Key<Frame>"),
        "byte_size": frame_byte_size(fr),
        "is_text": False,
        "row_offset": row_offset, "row_count": min(row_count, fr.nrows),
        "column_offset": column_offset, "column_count": len(sel),
        "full_column_count": ncols, "total_column_count": ncols,
        "rows": fr.nrows, "num_columns": ncols,
        "checksum": 0, "default_percentiles": [],
        "columns": columns,
        "compatible_models": [],
        "chunk_summary": None, "distribution_summary": None,
    }


def frame_key_v3(fr: Frame) -> dict:
    return {"__meta": meta("FrameKeyV3"), "name": str(fr.key),
            "type": "Key<Frame>", "URL": f"/3/Frames/{fr.key}"}


# ---------------------------------------------------------------------------
# Model metrics
# ---------------------------------------------------------------------------

_EPS = 1e-15


def _binomial_threshold_tables(aucd: M.AUCData) -> Tuple[dict, dict]:
    """Rebuild AUC2's thresholds_and_metric_scores + max_criteria tables from
    the 400-bin sweep (hex/AUC2.java ThresholdCriterion). Column ORDER is a
    client contract: metrics_base.confusion_matrix reads tns=row[11],
    fns=row[12], fps=row[13], tps=row[14]."""
    thr = np.asarray(aucd.thresholds, np.float64)
    tps = np.asarray(aucd.tps, np.float64)
    fps = np.asarray(aucd.fps, np.float64)
    p, n = float(aucd.p), float(aucd.n)
    fns = p - tps
    tns = n - fps
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(tps + fps > 0, tps / (tps + fps), 1.0)
        recall = np.where(p > 0, tps / max(p, _EPS), 0.0)
        specificity = np.where(n > 0, tns / max(n, _EPS), 0.0)
        accuracy = (tps + tns) / max(p + n, _EPS)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
        f2 = np.where(4 * precision + recall > 0, 5 * precision * recall / (4 * precision + recall), 0.0)
        f05 = np.where(0.25 * precision + recall > 0, 1.25 * precision * recall / (0.25 * precision + recall), 0.0)
        mcc_den = np.sqrt((tps + fps) * (tps + fns) * (tns + fps) * (tns + fns))
        mcc = np.where(mcc_den > 0, (tps * tns - fps * fns) / np.maximum(mcc_den, _EPS), 0.0)
        tpr = recall
        fpr = np.where(n > 0, fps / max(n, _EPS), 0.0)
        tnr = specificity
        fnr = np.where(p > 0, fns / max(p, _EPS), 0.0)
        min_pca = np.minimum(tpr, tnr)
        mean_pca = 0.5 * (tpr + tnr)
    idx = np.arange(len(thr))
    col_order = [
        ("threshold", thr), ("f1", f1), ("f2", f2), ("f0point5", f05),
        ("accuracy", accuracy), ("precision", precision), ("recall", recall),
        ("specificity", specificity), ("absolute_mcc", np.abs(mcc)),
        ("min_per_class_accuracy", min_pca), ("mean_per_class_accuracy", mean_pca),
        ("tns", tns), ("fns", fns), ("fps", fps), ("tps", tps),
        ("tnr", tnr), ("fnr", fnr), ("fpr", fpr), ("tpr", tpr),
        ("idx", idx),
    ]
    thresh_table = twodim(
        "Metrics for Thresholds",
        [(cn, "long" if cn == "idx" else "double") for cn, _ in col_order],
        [np.nan_to_num(cv, nan=0.0).tolist() for _, cv in col_order],
        description="Binomial metrics as a function of classification thresholds",
    )
    criteria = [("max f1", f1), ("max f2", f2), ("max f0point5", f05),
                ("max accuracy", accuracy), ("max precision", precision),
                ("max recall", recall), ("max specificity", specificity),
                ("max absolute_mcc", np.abs(mcc)),
                ("max min_per_class_accuracy", min_pca),
                ("max mean_per_class_accuracy", mean_pca),
                ("max tns", tns), ("max fns", fns), ("max fps", fps),
                ("max tps", tps), ("max tnr", tnr), ("max fnr", fnr),
                ("max fpr", fpr), ("max tpr", tpr)]
    names, thrs, vals, idxs = [], [], [], []
    for cname, cvals in criteria:
        i = int(np.nanargmax(cvals)) if len(cvals) else 0
        names.append(cname)
        thrs.append(float(thr[i]))
        vals.append(float(cvals[i]))
        idxs.append(i)
    max_table = twodim(
        "Maximum Metrics",
        [("metric", "string"), ("threshold", "double"), ("value", "double"), ("idx", "long")],
        [names, thrs, vals, idxs],
        description="Maximum metrics at their respective thresholds",
    )
    return thresh_table, max_table


def _metrics_common(mm: M.ModelMetrics, schema: str, model_key: Optional[str],
                    frame_key: Optional[str]) -> dict:
    return {
        "__meta": meta(schema + "V3", schema),
        "model": key_ref(model_key, "Key<Model>") if model_key else None,
        "model_checksum": 0,
        "frame": {"name": str(frame_key)} if frame_key else None,
        "frame_checksum": 0,
        "description": mm.description or None,
        "scoring_time": int(time.time() * 1000),
        "MSE": mm.mse, "RMSE": mm.rmse, "nobs": int(mm.nobs),
        "custom_metric_name": None, "custom_metric_value": 0.0,
    }


def metrics_v3(mm, model_key: Optional[str] = None,
               frame_key: Optional[str] = None) -> Optional[dict]:
    """Map a framework metrics dataclass to its reference V3 schema."""
    if mm is None:
        return None
    if isinstance(mm, M.ModelMetricsBinomial):
        out = _metrics_common(mm, "ModelMetricsBinomial", model_key, frame_key)
        gl = getattr(mm, "gains_lift_table", None)
        out.update({"r2": None, "logloss": mm.logloss, "AUC": mm.auc,
                    "pr_auc": mm.pr_auc, "Gini": mm.gini,
                    "mean_per_class_error": mm.mean_per_class_error,
                    "domain": (mm.cm.domain if mm.cm else None),
                    # genuine h2o-py metrics_base.gains_lift reads this as a
                    # TwoDimTableV3
                    "gains_lift_table": gl.to_v3() if gl is not None else None})
        if mm.auc_data is not None:
            tt, mt = _binomial_threshold_tables(mm.auc_data)
            out["thresholds_and_metric_scores"] = tt
            out["max_criteria_and_metric_scores"] = mt
        return out
    if isinstance(mm, M.ModelMetricsMultinomial):
        out = _metrics_common(mm, "ModelMetricsMultinomial", model_key, frame_key)
        cm_table = None
        if mm.cm is not None:
            dom = list(mm.cm.domain)
            tbl = np.asarray(mm.cm.table, np.float64)
            rates = []
            for i in range(len(dom)):
                tot = tbl[i].sum()
                err = (tot - tbl[i, i]) / tot if tot else 0.0
                rates.append("%.4f = %d / %d" % (err, int(tot - tbl[i, i]), int(tot)))
            cols = [(d, "long") for d in dom] + [("Error", "double"), ("Rate", "string")]
            data = [tbl[:, j].tolist() for j in range(len(dom))]
            errs = [float((tbl[i].sum() - tbl[i, i]) / tbl[i].sum()) if tbl[i].sum() else 0.0
                    for i in range(len(dom))]
            cm_table = {"__meta": meta("ConfusionMatrixV3", "ConfusionMatrix"),
                        "table": twodim("Confusion Matrix", cols, data + [errs, rates])}
        hit = None
        if mm.hit_ratios:
            hit = twodim("Top-K Hit Ratios", [("k", "int"), ("hit_ratio", "double")],
                         [list(range(1, len(mm.hit_ratios) + 1)), list(mm.hit_ratios)])
        out.update({"r2": None, "logloss": mm.logloss,
                    "mean_per_class_error": mm.mean_per_class_error,
                    "cm": cm_table, "hit_ratio_table": hit,
                    "multinomial_auc_table": None, "multinomial_aucpr_table": None})
        return out
    if isinstance(mm, M.ModelMetricsRegression):
        out = _metrics_common(mm, "ModelMetricsRegression", model_key, frame_key)
        out.update({"r2": mm.r2, "mae": mm.mae, "rmsle": mm.rmsle,
                    "mean_residual_deviance": mm.mean_residual_deviance})
        return out
    if isinstance(mm, M.ModelMetricsClustering):
        out = _metrics_common(mm, "ModelMetricsClustering", model_key, frame_key)
        out.update({"tot_withinss": mm.tot_withinss, "totss": mm.totss,
                    "betweenss": mm.betweenss,
                    "centroid_stats": None})
        return out
    # generic fallback: emit the base fields under the plain schema
    out = _metrics_common(mm, "ModelMetrics", model_key, frame_key)
    for k, v in (mm.to_dict() or {}).items():
        out.setdefault(k, v)
    return out


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def _mojo_available() -> bool:
    try:
        import h2o3_tpu_torch.models.mojo  # noqa: F401, PLC0415
        return True
    except ImportError:
        return False


def _param_type(v: Any) -> str:
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, int):
        return "long"
    if isinstance(v, float):
        return "double"
    if isinstance(v, (list, tuple)):
        return "string[]"
    return "string"


def model_parameter_v3(name: str, default: Any, actual: Any) -> dict:
    def enc(v):
        if isinstance(v, Frame):
            return {"name": str(v.key)}
        if isinstance(v, (list, tuple)):
            return list(v)
        return v
    return {
        "__meta": meta("ModelParameterSchemaV3"),
        "name": name, "label": name, "help": name,
        "required": False, "type": _param_type(default if default is not None else actual),
        "default_value": enc(default), "actual_value": enc(actual),
        "input_value": enc(actual),
        "level": "critical", "values": [], "gridable": True,
        "is_member_of_frames": [], "is_mutually_exclusive_with": [],
    }


def _varimp_table(vi: Dict[str, float]) -> dict:
    names = list(vi.keys())
    rel = np.asarray([max(float(vi[k]), 0.0) for k in names], np.float64)
    mx = rel.max() if len(rel) and rel.max() > 0 else 1.0
    scaled = rel / mx
    tot = rel.sum() or 1.0
    pct = rel / tot
    order = np.argsort(-rel)
    return twodim(
        "Variable Importances",
        [("variable", "string"), ("relative_importance", "double"),
         ("scaled_importance", "double"), ("percentage", "double")],
        [[names[i] for i in order], rel[order].tolist(),
         scaled[order].tolist(), pct[order].tolist()])


def _scoring_history_table(hist: List[dict]) -> Optional[dict]:
    if not hist:
        return None
    keys: List[str] = []
    for h in hist:
        for k in h:
            if k not in keys:
                keys.append(k)
    cols = [(k, "string" if any(isinstance(h.get(k), str) for h in hist) else "double")
            for k in keys]
    data = [[h.get(k) for h in hist] for k in keys]
    return twodim("Scoring History", cols, data)


def model_v3(model: Model, builder_cls=None) -> dict:
    o = model._output
    st = getattr(o, "start_time", 0.0)     # absent from older model files
    algo = model.algo_name
    params = []
    defaults = builder_cls.default_params() if builder_cls else {}
    merged = dict(defaults)
    merged.update(model._parms or {})
    for k in merged:
        params.append(model_parameter_v3(k, defaults.get(k), merged[k]))
    mk = str(model.key)
    col_names = list(o.names)
    if o.response_name:
        col_names = col_names + [o.response_name]
    domains = [o.domains.get(c) for c in o.names]
    if o.response_name:
        domains = domains + [o.response_domain]
    output = {
        "__meta": meta("ModelOutputSchemaV3", "ModelOutput"),
        "model_category": o.model_category,
        "names": col_names,
        "original_names": col_names,
        "column_types": ["Enum" if (o.domains.get(c) or
                                    (c == o.response_name and o.response_domain))
                         else "Numeric" for c in col_names],
        "domains": domains,
        "cross_validation_models": ([key_ref(str(k), "Key<Model>") for k in
                                     getattr(o, "cv_model_keys", [])] or None),
        "cross_validation_predictions": None,
        "cross_validation_holdout_predictions_frame_id": None,
        "cross_validation_fold_assignment_frame_id": None,
        "training_metrics": metrics_v3(o.training_metrics, mk, None),
        "validation_metrics": metrics_v3(o.validation_metrics, mk, None),
        "cross_validation_metrics": metrics_v3(o.cross_validation_metrics, mk, None),
        "cross_validation_metrics_summary": None,
        "model_summary": None,
        "scoring_history": _scoring_history_table(o.scoring_history),
        "variable_importances": (_varimp_table(o.variable_importances)
                                 if o.variable_importances else None),
        "status": "DONE",
        "start_time": int(st * 1000) if st else 0,
        "end_time": int(st * 1000 + o.run_time_ms) if st else 0,
        "run_time": o.run_time_ms,
        "default_threshold": (float(o.training_metrics.auc_data.max_f1_threshold)
                              if getattr(o.training_metrics, "auc_data", None) is not None
                              else 0.5),
        "help": {},
    }
    return {
        "__meta": meta(f"{algo.upper()}ModelV3", "Model"),
        "model_id": key_ref(mk, "Key<Model>"),
        "algo": algo,
        "algo_full_name": algo.upper(),
        "parameters": params,
        "output": output,
        "compatible_frames": [],
        "have_pojo": False,
        "have_mojo": _mojo_available(),
        "response_column_name": o.response_name,
        "data_frame": {"name": str(model._parms.get("training_frame"))
                       if model._parms.get("training_frame") else None},
        "timestamp": int(time.time() * 1000),
    }


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

def error_v3(msg: str, status: int, stacktrace: Optional[List[str]] = None,
             exception_type: str = "java.lang.RuntimeException",
             schema: str = "H2OErrorV3") -> dict:
    out = {
        "__meta": meta(schema, "H2OError"),
        "timestamp": int(time.time() * 1000),
        "error_url": "",
        "msg": msg,
        "dev_msg": msg,
        "http_status": status,
        "values": {},
        "exception_type": exception_type,
        "exception_msg": msg,
        "stacktrace": stacktrace or [],
    }
    if schema == "H2OModelBuilderErrorV3":
        out["messages"] = []
        out["error_count"] = 1
        out["parameters"] = {}
    return out
