"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for one NVIDIA H100.

    import h2o3_tpu_torch as h2o
    h2o.init()                      # the CUDA device; device="cpu" on a CPU
    fr = h2o.import_file("data.csv")   # an H2OFrame in the DKV
    fr["x"].mean(); fr["x"].median(); fr[fr["x"] > 0]
    fr.group_by("g").count().mean("x").get_frame()
    tr, te = fr.split_frame([0.8], seed=1)
    fr.sort("x"); fr.merge(other); fr.impute("x", method="median")
    h2o.exec_rapids("(+ (cols fr.hex [0]) 5)")   # Rapids statements
    h2o.H2OFrame({"a": [1.0, 2.0]}); h2o.create_frame(rows=100, seed=1)
    m = h2o.GBM(ntrees=20, max_depth=5).train(y="y", training_frame=fr)
    m.predict(fr); m.model_performance()
    h2o.DRF(ntrees=50).train(y="y", training_frame=fr, validation_frame=va)
    h2o.XGBoost(ntrees=20, booster="dart", rate_drop=0.1).train(y="y", ...)
    h2o.IsolationForest(ntrees=50).train(training_frame=fr).predict(fr)
    h2o.ExtendedIsolationForest(extension_level=1).train(training_frame=fr)
    m = h2o.GLM(family="binomial", lambda_=0).train(y="y", training_frame=fr)
    m.coef(); h2o.GLM(lambda_search=True, alpha=0.5).train(y="y", ...)
    h2o.GAM(gam_columns=["x"], bs=[0]).train(y="y", training_frame=fr)
    h2o.RuleFit(max_rule_length=3).train(y="y", training_frame=fr)
    m = h2o.DeepLearning(hidden=[200, 200], epochs=1).train(y="y", ...)
    h2o.DeepLearning(autoencoder=True).train(training_frame=fr).anomaly(fr)
    h2o.GBM(nfolds=5, keep_cross_validation_predictions=True).train(...)
    h2o.GBM(calibrate_model=True, calibration_frame=cal).train(...)
    h2o.GBM(ntrees=20, checkpoint=m10).train(y="y", training_frame=fr)
    m.save("m.bin"); h2o.load_model("m.bin")
    h2o.H2OGenericEstimator(path=m.download_mojo("/tmp")).train()
    m.predict_contributions(fr); m.partial_plot(fr, cols=["x"], nbins=20)
    m.gains_lift(); m.kolmogorov_smirnov()
    m.predict_leaf_node_assignment(fr, type="Path")
    km = h2o.KMeans(k=10, init="Furthest").train(training_frame=fr)
    h2o.PCA(k=5, pca_method="Randomized").train(training_frame=fr)
    h2o.SVD(nv=5).train(training_frame=fr); h2o.GLRM(k=5).train(...)
    h2o.NaiveBayes(laplace=1).train(y="y", training_frame=fr)
    w2v = h2o.Word2Vec(vec_size=100).train(training_frame=words)
    w2v.find_synonyms("king", 10)
    base = [h2o.GBM(nfolds=5, seed=1,
                    keep_cross_validation_predictions=True).train(...), ...]
    h2o.StackedEnsemble(base_models=base).train(y="y", training_frame=fr)
    te = h2o.TargetEncoder(data_leakage_handling="KFold",
                           fold_column="fold").train(y="y", ...)
    te.transform(fr, as_training=True)
    h2o.CoxPH(stop_column="t").train(y="event", training_frame=surv)
    h2o.PSVM(hyper_param=1.0).train(y="y", training_frame=fr)
    h2o.Aggregator(target_num_exemplars=1000).train(training_frame=fr)
    h2o.IsotonicRegression().train(x=["x"], y="y", training_frame=fr)
    h2o.train_segments(h2o.GLM, {}, fr, ["c0"], y="y").as_frame()
    aml = h2o.H2OAutoML(max_models=2, seed=1).train(y="y", training_frame=fr)
    aml.leaderboard; aml.leader.predict(fr)
    g = h2o.H2OGridSearch(h2o.GBM, {"max_depth": [3, 5]}).train(
        y="y", training_frame=fr, ntrees=20)
    g.sorted_metric_table(); g.best_model()
    h2o.H2OGradientBoostingEstimator(ntrees=5)   # the h2o-py names
    h2o.get_model(key); h2o.get_frame(key); h2o.remove(key); h2o.ls()
    h2o.export_file(fr, "out.csv"); h2o.no_progress()
    srv = h2o.start_server(port=0)       # the REST API on srv.port
    h2o.init(port=srv.port)              # a client of a running server
    h2o.cluster_info(); h2o.shutdown()

Importing the package builds nothing: each CUDA kernel is compiled on
its first launch (or all at once by ``kernels.build_all``), and the C++
CSV parser of ``import_file`` on its first parse (``native.build``).
"""

from h2o3_tpu_torch.core.dkv import DKV, Key, Scope
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.core.runtime import cluster, cluster_info, shutdown
from h2o3_tpu_torch.core.runtime import init as _local_init
from h2o3_tpu_torch.frame_factory import H2OFrame, create_frame
from h2o3_tpu_torch.ingest.parser import (import_file, parse_setup,
                                          upload_file)
from h2o3_tpu_torch.ingest.sql import import_sql_select, import_sql_table
from h2o3_tpu_torch.models import BUILDERS
from h2o3_tpu_torch.models.aggregator import Aggregator, AggregatorModel
from h2o3_tpu_torch.models.coxph import CoxPH, CoxPHModel
from h2o3_tpu_torch.models.deeplearning import DeepLearning, DeepLearningModel
from h2o3_tpu_torch.models.ensemble import (StackedEnsemble,
                                            StackedEnsembleModel)
from h2o3_tpu_torch.models.extended_isofor import (
    ExtendedIsolationForest, ExtendedIsolationForestModel)
from h2o3_tpu_torch.models.gam import GAM, GAMModel
from h2o3_tpu_torch.models.generic import Generic, GenericModel
from h2o3_tpu_torch.models.glm import GLM, GLMModel
from h2o3_tpu_torch.models.glrm import GLRM, GLRMModel
from h2o3_tpu_torch.models.isotonic import (IsotonicRegression,
                                            IsotonicRegressionModel)
from h2o3_tpu_torch.models.kmeans import KMeans, KMeansModel
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from h2o3_tpu_torch.models.pca import PCA, PCAModel
from h2o3_tpu_torch.models.psvm import PSVM, PSVMModel
from h2o3_tpu_torch.models.rulefit import RuleFit, RuleFitModel
from h2o3_tpu_torch.models.segments import SegmentModels, train_segments
from h2o3_tpu_torch.models.svd import SVD, SVDModel
from h2o3_tpu_torch.models.target_encoder import (TargetEncoder,
                                                  TargetEncoderModel)
from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel
from h2o3_tpu_torch.models.tree.isofor import (IsolationForest,
                                               IsolationForestModel)
from h2o3_tpu_torch.models.word2vec import Word2Vec, Word2VecModel
from h2o3_tpu_torch.models.xgboost import XGBoost, XGBoostModel
from h2o3_tpu_torch.rapids import Session, exec_rapids

load_model = Model.load


def init(*args, url: str = None, ip: str = None, port: int = None,
         username: str = None, password: str = None, **kw):
    """Boot the local runtime (`core/runtime.init`: the card, or
    ``device="cpu"``), or, given url/ip/port, connect to a running
    server as its client (h2o-py ``h2o.init(url=...)``) and return the
    client module."""
    if url or ip or port:
        if args or kw:
            raise ValueError(
                f"client-mode init(url/ip/port) does not accept extra "
                f"arguments: {list(kw) or args}")
        from urllib.parse import urlparse

        from h2o3_tpu_torch import client as _client

        if url:
            u = urlparse(url)
            ip, port = u.hostname or "127.0.0.1", u.port or 54321
        _client.connect(ip=ip or "127.0.0.1", port=port or 54321,
                        username=username, password=password)
        return _client
    return _local_init(*args, **kw)


def connect(ip: str = "127.0.0.1", port: int = 54321, **kw):
    """Attach this process as a client of a REST server (h2o.connect)."""
    from h2o3_tpu_torch import client as _client

    _client.connect(ip=ip, port=port, **kw)
    return _client


def start_server(*args, **kw):
    """Bind the REST server (api/server.start_server)."""
    from h2o3_tpu_torch.api.server import start_server as _start

    return _start(*args, **kw)


def flow() -> str:
    """The Flow page's URL on the connected server (opened in a browser
    where there is one)."""
    from h2o3_tpu_torch import client as _client

    base = getattr(_client, "_BASE", None) or "http://127.0.0.1:54321"
    url = f"{base}/flow/index.html"
    try:
        import webbrowser

        webbrowser.open(url)
    except Exception:   # noqa: BLE001 — headless
        pass
    return url

# the h2o-py estimator surface, resolved lazily (h2o3_tpu/__init__.py:61)
_ESTIMATORS = {
    **{name: "h2o3_tpu_torch.estimators" for name in (
        "H2OGeneralizedLinearEstimator", "H2OGradientBoostingEstimator",
        "H2ORandomForestEstimator", "H2OIsolationForestEstimator",
        "H2OExtendedIsolationForestEstimator", "H2ODeepLearningEstimator",
        "H2OAutoEncoderEstimator", "H2OKMeansEstimator",
        "H2OPrincipalComponentAnalysisEstimator",
        "H2OSingularValueDecompositionEstimator", "H2ONaiveBayesEstimator",
        "H2OGeneralizedLowRankEstimator", "H2OWord2vecEstimator",
        "H2OXGBoostEstimator", "H2OStackedEnsembleEstimator",
        "H2ORuleFitEstimator", "H2OGeneralizedAdditiveEstimator",
        "H2OCoxProportionalHazardsEstimator", "H2OAggregatorEstimator",
        "H2OTargetEncoderEstimator", "H2OGenericEstimator",
        "H2OIsotonicRegressionEstimator",
        "H2OSupportVectorMachineEstimator")},
    "H2OGridSearch": "h2o3_tpu_torch.grid",
    "H2OAssembly": "h2o3_tpu_torch.assembly",
    "H2OAutoML": "h2o3_tpu_torch.automl.automl",
}


def __getattr__(name):
    mod = _ESTIMATORS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'h2o3_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_ESTIMATORS))


def no_progress():
    """Turn progress output off (h2o.no_progress)."""
    from h2o3_tpu_torch.utils import log

    log.PROGRESS = False


def show_progress():
    from h2o3_tpu_torch.utils import log

    log.PROGRESS = True


def export_file(frame, path: str, force: bool = False) -> str:
    """Write a frame to a local CSV (h2o.export_file): a header, enum
    labels, strings, real values in float32's shortest round-trip form,
    integers as integers, times as epoch milliseconds, and NA as an
    empty field. No pandas."""
    import csv
    import os

    import numpy as np

    if os.path.exists(path) and not force:
        raise FileExistsError(f"{path} exists (use force=True)")
    cols = []
    for name in frame.names:
        c = frame.col(name)
        if c.is_categorical or c.data is None:
            cols.append(["" if v is None else str(v) for v in c.values()])
        elif c.ctype == "time" and c.host_data is not None:
            # exact epoch milliseconds from the host copy
            ms = np.asarray(c.host_data).astype("datetime64[ms]")
            cols.append(["" if np.isnat(v) else str(v.astype(np.int64))
                         for v in ms])
        elif c.ctype == "real":
            cols.append(["" if np.isnan(v) else str(v)
                         for v in c.to_numpy().astype(np.float32)])
        else:
            cols.append(["" if np.isnan(v) else str(int(v))
                         for v in c.to_numpy().astype(np.float64)])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(frame.names)
        w.writerows(zip(*cols))
    return path


def ls():
    """The DKV's keys (h2o.ls)."""
    return sorted(DKV.keys())


def get_frame(key):
    fr = DKV.get(key)
    if fr is None:
        raise KeyError(f"No frame under key {key!r}")
    return fr


def get_model(key):
    m = DKV.get(key)
    if m is None:
        raise KeyError(f"No model under key {key!r}")
    return m


def remove(key):
    DKV.remove(key)


def remove_all():
    DKV.clear()


def frame(frame_id):
    return get_frame(frame_id)


__all__ = ["Aggregator", "AggregatorModel", "BUILDERS", "Column", "CoxPH",
           "CoxPHModel", "DKV", "DRF", "DRFModel", "DeepLearning",
           "DeepLearningModel", "ExtendedIsolationForest",
           "ExtendedIsolationForestModel", "Frame", "GAM", "GAMModel", "GBM",
           "GBMModel", "GLM", "GLMModel", "GLRM", "GLRMModel", "Generic",
           "GenericModel", "H2OFrame",
           "IsolationForest", "IsolationForestModel", "IsotonicRegression",
           "IsotonicRegressionModel", "Job", "KMeans", "KMeansModel", "Key",
           "Model",
           "NaiveBayes", "NaiveBayesModel", "PCA", "PCAModel", "PSVM",
           "PSVMModel", "RuleFit", "RuleFitModel", "SVD", "SVDModel",
           "Scope", "SegmentModels", "Session", "StackedEnsemble",
           "StackedEnsembleModel", "TargetEncoder", "TargetEncoderModel",
           "Word2Vec", "Word2VecModel", "XGBoost", "XGBoostModel", "cluster",
           "cluster_info", "connect", "create_frame", "exec_rapids",
           "export_file", "flow", "frame", "get_frame", "get_model",
           "import_file", "import_sql_select", "import_sql_table", "init",
           "load_model", "ls", "no_progress", "parse_setup", "remove",
           "remove_all", "show_progress", "shutdown", "start_server",
           "train_segments", "upload_file"]
