"""Grid search: hyperparameter sweeps with Cartesian and RandomDiscrete
walkers (counterpart of h2o3_tpu/grid.py: `H2OGridSearch` :53,
`_candidates` :99, `_persist_model` :116, `load` :123, `_record` :197,
`train` :206, `get_grid` :328, `sorted_metric_table` :348, `best_model`
:355).

Reference: hex/grid/GridSearch.java + HyperSpaceWalker.java (Cartesian
and RandomDiscrete with max_models / max_runtime_secs budgets and a
seed), with parallel model building (GridSearch.java `parallelism`).

Each candidate trains through its builder's normal train on the one
device, driven by the in-process search engine (`automl/search.py`): a
member that fails is retried or parked and listed in `failed`, and never
fails the grid. `parallelism` > 1 overlaps the members' host work; their
device work takes turns (ROADMAP C27). `save(dir)` writes the grid and
its models as ``/3/Grid.bin/{grid_id}/export`` does, and `load(path)`
reads them back through the REST layer's restricted unpickler
(``/3/Grid.bin/import``, h2o-py ``load_grid``).

Grid recovery (Grid.exportBinary and the resume of GridSearchHandler):
`train(recovery_dir=d)` writes each finished model to ``d/models/<key>
.bin`` and the search engine's snapshot to ``d`` after every member.
After a crash `load(d)` (a directory, where `save`'s grid is a file)
rebuilds the grid and its done models from there, and `train` walks on
through the members that are not done; no done member trains again.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from h2o3_tpu_torch.core.dkv import DKV, Keyed
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import (BUILDERS, ModelBuilder,
                                                 random_seed)

_LOWER_IS_BETTER = {"rmse", "mse", "logloss", "mae", "mean_residual_deviance",
                    "mean_per_class_error", "err", "rmsle"}


def _metric_value(model: Model, metric: str) -> float:
    mm = (model._output.cross_validation_metrics
          or model._output.validation_metrics
          or model._output.training_metrics)
    if mm is None:
        return float("nan")
    return float(getattr(mm, metric.lower(), float("nan")))


def _default_metric(model: Model) -> str:
    cat = model._output.model_category
    return {"Binomial": "auc", "Multinomial": "logloss",
            "Regression": "rmse"}.get(cat, "rmse")


class H2OGridSearch(Keyed):
    """h2o-py H2OGridSearch surface: build over hyper_params, rank models.

    `model` is a builder class, an instance (its non-default parameters
    become the base configuration) or an algo name."""

    def __init__(self, model, hyper_params: Dict[str, Sequence],
                 grid_id: Optional[str] = None,
                 search_criteria: Optional[Dict[str, Any]] = None):
        super().__init__(grid_id)
        if isinstance(model, str):
            self.builder_cls: Type[ModelBuilder] = BUILDERS[model.lower()]
            self.base_params: Dict[str, Any] = {}
        elif isinstance(model, type):
            self.builder_cls = model
            self.base_params = {}
        else:
            self.builder_cls = type(model)
            self.base_params = {k: v for k, v in model.params.items()
                                if v != model.default_params().get(k)}
        self.hyper_params = {k: list(v) for k, v in hyper_params.items()}
        self.search_criteria = dict(search_criteria
                                    or {"strategy": "Cartesian"})
        self.models: List[Model] = []
        self.failed: List[Dict[str, Any]] = []
        self._done: set = set()            # combo keys already trained
        self._lock = threading.Lock()
        self.recovery_dir: Optional[str] = None
        self.install()

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        d.pop("_search_engine", None)
        d.pop("_search_job", None)
        d.pop("_resume_search_state", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()

    def save(self, grid_directory: str) -> str:
        """Write the grid to ``<grid_directory>/<grid id>`` and each of
        its models beside it under its key (h2o-py ``save_grid``);
        returns the grid file's path."""
        from h2o3_tpu_torch.api.routes_ext import _artifact_dump

        os.makedirs(grid_directory, exist_ok=True)
        path = os.path.join(grid_directory, str(self.key))
        _artifact_dump(self, path)
        for m in self.models:
            _artifact_dump(m, os.path.join(grid_directory, str(m.key)))
        return path

    @classmethod
    def load(cls, path: str) -> "H2OGridSearch":
        """Read a grid `save` wrote (h2o-py ``load_grid``): the grid file
        and the model files beside it, through the restricted unpickler,
        all installed in the DKV. A directory is a `recovery_dir` and
        takes `_load_recovery`. Raises TypeError when `path` holds
        something else."""
        from h2o3_tpu_torch.api.routes_ext import _artifact_load_file

        if os.path.isdir(path):
            return cls._load_recovery(path)
        grid = _artifact_load_file(path)
        if not isinstance(grid, cls):
            raise TypeError(f"{path} is not a saved grid")
        d = os.path.dirname(path)
        for m in grid.models:
            mp = os.path.join(d, str(m.key))
            if os.path.exists(mp):
                _artifact_load_file(mp).install()
        grid.install()
        return grid

    @classmethod
    def _load_recovery(cls, recovery_dir: str) -> "H2OGridSearch":
        """A grid from its recovery directory: the search snapshot (the
        newest sidecar's, the previous generation if the current one is
        torn), then every done member's model file, installed. A done
        member whose model is neither in its file nor in the DKV goes
        back to pending, so `train` builds it again. The
        reference's older ``grid.json`` layout is not read: the port
        never wrote it, and the JAX package's model files are not the
        port's (ROADMAP C37)."""
        from h2o3_tpu_torch.api.routes_ext import _artifact_load_file
        from h2o3_tpu_torch.parallel import ckpt

        names = sorted(n for n in os.listdir(recovery_dir)
                       if n.startswith("searchckpt_")
                       and n.endswith(".pkl.json"))
        if not names:
            raise FileNotFoundError(
                f"{recovery_dir} holds no grid search snapshot")
        with open(os.path.join(recovery_dir, names[-1]),
                  encoding="utf-8") as f:
            sk = json.load(f)["search"]
        data = ckpt.load_search_state(sk, sdir=recovery_dir)
        if data is None:
            raise RuntimeError(
                f"grid recovery dir {recovery_dir}: the search state of "
                f"{sk!r} is unreadable (current and previous snapshots)")
        state = data.get("state") or {}
        spec = state.get("spec") or {}
        base = BUILDERS[spec["algo"]](**(spec.get("params") or {}))
        g = cls(base, spec["hyper"], grid_id=spec.get("grid_id"),
                search_criteria=spec.get("criteria"))
        g.recovery_dir = recovery_dir
        g._resume_search_state = state
        for name, mem in (state.get("members") or {}).items():
            if mem.get("status") == "done" and mem.get("model_id"):
                path = os.path.join(recovery_dir, "models",
                                    f"{mem['model_id']}.bin")
                if os.path.exists(path):
                    m = _artifact_load_file(path)
                    m.install()
                else:
                    m = DKV.get(mem["model_id"])
                if m is None:
                    mem["status"], mem["model_id"] = "pending", None
                    continue
                m._grid_params = dict(mem.get("params") or {})
                g.models.append(m)
                g._done.add(name)
            elif mem.get("status") == "parked":
                g.failed.append({"params": dict(mem.get("params") or {}),
                                 "error": mem.get("error"),
                                 "combo_key": name})
        g.install()
        return g

    def _persist_model(self, model: Model) -> None:
        from h2o3_tpu_torch.api.routes_ext import _artifact_dump

        mdir = os.path.join(self.recovery_dir, "models")
        os.makedirs(mdir, exist_ok=True)
        _artifact_dump(model, os.path.join(mdir, f"{model.key}.bin"))

    @staticmethod
    def _combo_key(params: Dict[str, Any]) -> str:
        return json.dumps(sorted((k, str(v)) for k, v in params.items()))

    # -- walkers (HyperSpaceWalker.java) ----------------------------------
    def _candidates(self):
        """-> (hyperparameter names, combos in walk order): the Cartesian
        product, shuffled by numpy's default_rng(seed) for RandomDiscrete
        (a fresh seed when it is negative or absent)."""
        keys = list(self.hyper_params)
        grids = [self.hyper_params[k] for k in keys]
        strategy = (self.search_criteria.get("strategy")
                    or "Cartesian").lower()
        combos = list(itertools.product(*grids))
        if strategy == "randomdiscrete":
            seed = int(self.search_criteria.get("seed", -1))
            rng = np.random.default_rng(
                seed if seed >= 0 else random_seed())
            rng.shuffle(combos)
        return keys, combos

    def _record(self, combo_params: Dict[str, Any], model: Model) -> None:
        with self._lock:
            model._grid_params = dict(combo_params)
            self.models.append(model)
            self._done.add(self._combo_key(combo_params))
            if self.recovery_dir:
                self._persist_model(model)

    def train(self, x=None, y=None, training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None,
              parallelism: Optional[int] = None,
              recovery_dir: Optional[str] = None, **kw):
        """Walk the hyper space through the search engine. `parallelism`
        is the member-scheduling width (GridSearch.java parallelism);
        None takes ``H2O_TPU_SEARCH_CONCURRENCY``. Combos already trained
        by an earlier train() of this grid are skipped. `recovery_dir`
        keeps every finished model and the search's snapshot there, for
        `load` after a crash; the directory keeps its files when the
        grid ends."""
        from h2o3_tpu_torch.automl.search import SearchEngine

        keys, combos = self._candidates()
        if recovery_dir:
            self.recovery_dir = recovery_dir
            os.makedirs(recovery_dir, exist_ok=True)
        max_models = int(self.search_criteria.get("max_models", 0) or 0)
        max_secs = float(self.search_criteria.get("max_runtime_secs", 0)
                         or 0)
        t0 = time.time()

        wire_kw = {k: v for k, v in {**self.base_params, **kw}.items()
                   if isinstance(v, (str, int, float, bool, list, tuple,
                                     type(None)))}
        job = getattr(self, "_search_job", None)
        engine = SearchEngine(
            str(job.key) if job is not None else str(self.key), "grid", {
                "kind": "grid", "description": f"Grid {self.key} Build",
                "dest": str(self.key), "algo": self.builder_cls.algo_name,
                "params": wire_kw, "hyper": self.hyper_params,
                "grid_id": str(self.key), "criteria": self.search_criteria,
                "x": list(x) if isinstance(x, (list, tuple)) else x, "y": y,
                "training_frame": (str(training_frame.key)
                                   if training_frame is not None else None),
                "validation_frame": (str(validation_frame.key)
                                     if validation_frame is not None
                                     else None),
                "recovery_dir": self.recovery_dir},
            job=job, state=getattr(self, "_resume_search_state", None),
            sdir=self.recovery_dir)
        self._search_engine = engine

        members = []
        for combo in combos:
            combo_params = dict(zip(keys, combo))
            ck = self._combo_key(combo_params)
            if ck in self._done:
                continue
            mem = engine.member(ck, self.builder_cls.algo_name, combo_params)
            mem["_combo"] = combo_params
            members.append(mem)

        def can_start(inflight: int) -> bool:
            # the models cap counts in-flight builds too, so the budget
            # holds exactly as in a sequential walk
            if max_models and len(self.models) + inflight >= max_models:
                return False
            if max_secs and time.time() - t0 > max_secs:
                return False
            return True

        def build(mem: dict) -> Model:
            combo_params = dict(mem["_combo"])
            params = dict(self.base_params)
            params.update(kw)
            params.update(combo_params)
            m = self.builder_cls(**params).train(
                x=x, y=y, training_frame=training_frame,
                validation_frame=validation_frame)
            self._record(combo_params, m)
            return m

        def score(mem, model):
            return _metric_value(model, _default_metric(model))

        def reattach(mem: dict) -> Optional[Model]:
            # a done member of a resumed search (watchdog, or a snapshot
            # handed in): its model from the DKV
            m = DKV.get(mem["model_id"]) if mem.get("model_id") else None
            if isinstance(m, Model):
                self._record(dict(mem["_combo"]), m)
                return m
            return None

        engine.run(members, build, can_start=can_start, score_fn=score,
                   concurrency=int(parallelism) if parallelism else None,
                   reattach=reattach)
        for mem in members:
            if mem.get("status") == "parked" and not any(
                    f.get("combo_key") == mem["name"] for f in self.failed):
                with self._lock:
                    self.failed.append({"params": dict(mem["_combo"]),
                                        "error": mem.get("error"),
                                        "combo_key": mem["name"]})
        engine.finish()
        if not self.models:
            raise RuntimeError(f"grid produced no models; failures: "
                               f"{self.failed[:3]}")
        return self

    # -- ranking (Grid.java getModels sorted) ------------------------------
    def get_grid(self, sort_by: Optional[str] = None,
                 decreasing: Optional[bool] = None):
        metric = (sort_by or _default_metric(self.models[0])).lower()
        if decreasing is None:
            decreasing = metric not in _LOWER_IS_BETTER

        def keyfn(m):
            v = _metric_value(m, metric)
            if v != v:
                return float("inf")
            return -v if decreasing else v

        order = sorted(self.models, key=keyfn)
        g = H2OGridSearch.__new__(H2OGridSearch)
        g.__dict__.update(self.__dict__)
        g.models = order
        return g

    @property
    def model_ids(self) -> List[str]:
        return [str(m.key) for m in self.models]

    def sorted_metric_table(self, sort_by: Optional[str] = None
                            ) -> List[dict]:
        metric = (sort_by or _default_metric(self.models[0])).lower()
        rows = [{"model_id": str(m.key), metric: _metric_value(m, metric),
                 **getattr(m, "_grid_params", {})} for m in self.models]
        return sorted(rows, key=lambda r: r[metric],
                      reverse=metric not in _LOWER_IS_BETTER)

    def best_model(self, metric: Optional[str] = None) -> Model:
        return self.get_grid(sort_by=metric).models[0]

    def __getitem__(self, i: int) -> Model:
        return self.models[i]

    def __len__(self):
        return len(self.models)
