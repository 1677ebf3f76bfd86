"""AutoML: automatic model selection and a leaderboard (counterpart of
h2o3_tpu/automl/automl.py: `H2OAutoML` :52, the target-encoding stage
:97, `run_steps` :227, `_build_ensembles` :361, `_ranked` :393).

Reference: h2o-automl/src/main/java/ai/h2o/automl/AutoML.java, a step
registry (ModelingStepsRegistry over per-algo providers: default
configurations, then random grids, then exploitation of each family's
best), time and model budgets (WorkAllocations), a leaderboard ranked by
the CV metric (leaderboard/Leaderboard.java) and an event log.

Every candidate trains through its builder on the one device, driven by
the in-process search engine (`automl/search.py`); every base model
shares one pinned seed, so their CV folds agree and the stacked
ensembles can combine their holdout predictions.

On a row-sharded training frame every rank runs the same members, one
after another (the device lane, C27, with no overlap), and issues the
same collectives in the same order. So no rank decides alone on time:
the members get no time budget of their own, and the run's budget is
read at member boundaries as an all-reduced "out of time" flag. A plan
whose member cannot train across ranks (a builder that is not
row-sharded, the target-encoding stage) is refused before any member
runs, naming ROADMAP A14.6c.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model

_LOWER_IS_BETTER = {"rmse", "mse", "logloss", "mae", "mean_residual_deviance",
                    "mean_per_class_error", "rmsle"}


def _metric(model: Model, name: str) -> float:
    mm = (model._output.cross_validation_metrics
          or model._output.validation_metrics
          or model._output.training_metrics)
    return float(getattr(mm, name, float("nan"))) if mm else float("nan")


def _leaderboard_metric(model: Model, name: str, frame: Optional[Frame],
                        cache: Dict[str, float]) -> float:
    """The rank metric: each model scored on the leaderboard frame when
    one is given (Leaderboard.java), else its CV / validation metric."""
    if frame is None:
        return _metric(model, name)
    key = str(model.key)
    if key not in cache:
        try:
            mm = model.model_performance(frame)
            cache[key] = (float(getattr(mm, name, float("nan"))) if mm
                          else float("nan"))
        except Exception:    # noqa: BLE001 — an unrankable model sorts last
            cache[key] = float("nan")
    return cache[key]


class H2OAutoML:
    """h2o-py H2OAutoML surface: train(), then .leader and .leaderboard.

    nfolds 0 disables cross-validation (then no ensembles are stacked);
    a negative value means AUTO, 5. `preprocessing=["target_encoding"]`
    adds a KFold TargetEncoder stage over the AutoML fold assignment."""

    def __init__(self, max_models: int = 10, max_runtime_secs: float = 0.0,
                 seed: int = -1, nfolds: int = 5,
                 sort_metric: str = "AUTO",
                 include_algos: Optional[List[str]] = None,
                 exclude_algos: Optional[List[str]] = None,
                 project_name: Optional[str] = None,
                 preprocessing: Optional[List[str]] = None, **_ignored):
        from h2o3_tpu_torch.models.model_builder import random_seed

        self.max_models = int(max_models)
        self.max_runtime_secs = float(max_runtime_secs)
        # one shared seed even when the user gives none, so every base
        # model draws the same CV folds (the ensembles need it)
        self.seed = int(seed) if int(seed) >= 0 else random_seed()
        nf = int(nfolds)
        self.nfolds = 0 if nf == 0 else (nf if nf >= 2 else 5)
        self.sort_metric = sort_metric
        self.include_algos = ([a.lower() for a in include_algos]
                              if include_algos else None)
        self.exclude_algos = [a.lower() for a in (exclude_algos or [])]
        self.project_name = project_name or f"automl_{int(time.time())}"
        self.preprocessing = [str(p).lower() for p in (preprocessing or [])]
        self.te_model = None
        self.models: List[Model] = []
        self.event_log: List[Dict[str, Any]] = []
        self._metric_name: str = "rmse"

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_search_engine", None)
        d.pop("_search_job", None)
        d.pop("_resume_search_state", None)
        return d

    def _apply_target_encoding(self, y, train, valid, lb):
        """KFold TargetEncoder over the shared AutoML fold assignment: the
        encoded columns are added to every frame, the training frame's
        out of fold, and the fold column is every builder's
        fold_column, so the CV holdouts are the folds the encoder left
        out."""
        from h2o3_tpu_torch.core.frame import Column
        from h2o3_tpu_torch.models.target_encoder import TargetEncoder

        cats = [c for c in train.names
                if c != y and train.col(c).is_categorical]
        if not cats:
            return train, valid, lb
        rng = np.random.default_rng(self.seed)
        assign = rng.integers(0, self.nfolds, train.nrows)
        tr = train.subframe(train.names)
        tr.add("_automl_te_fold", Column.from_numpy(
            assign.astype(np.float64), device=train.col(y).device))
        te = TargetEncoder(blending=True, noise=0.0,
                           data_leakage_handling="KFold",
                           fold_column="_automl_te_fold",
                           seed=self.seed).train(y=y, training_frame=tr)
        self.te_model = te
        out_train = te.transform(tr, as_training=True)
        self._te_fold_col = "_automl_te_fold"
        out_valid = te.transform(valid) if valid is not None else None
        out_lb = te.transform(lb) if lb is not None else None
        self._log(f"target encoding applied to {len(cats)} column(s)")
        return out_train, out_valid, out_lb

    def predict(self, frame: Frame):
        """Score with the leader, after the target-encoding stage when one
        was trained."""
        if self.leader is None:
            raise RuntimeError("AutoML has no models")
        if self.te_model is not None:
            frame = self.te_model.transform(frame)
        return self.leader.predict(frame)

    def _steps(self, classification: bool):
        from h2o3_tpu_torch.automl.steps import build_plan

        return build_plan({"classification": classification}, self.seed,
                          self.include_algos, self.exclude_algos)

    @property
    def modeling_plan(self) -> List[Dict[str, Any]]:
        """The executed (or to-execute) step list (h2o-py modeling_plan)."""
        return getattr(self, "_plan", [])

    def _log(self, msg: str):
        self.event_log.append({"timestamp": time.time(), "message": msg})

    # -- training loop ------------------------------------------------------
    def train(self, x=None, y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None,
              leaderboard_frame: Optional[Frame] = None) -> "H2OAutoML":
        from h2o3_tpu_torch.automl.search import SearchEngine
        from h2o3_tpu_torch.automl.steps import REGISTRY, exploitation_steps
        from h2o3_tpu_torch.core import sharded_frame as SF
        from h2o3_tpu_torch.models.model_builder import BUILDERS

        if training_frame is None or y is None:
            raise ValueError("AutoML requires y and training_frame")
        y_col = training_frame.col(y)
        classification = y_col.is_categorical
        mesh = (SF.mesh_of(training_frame) if SF._is_sharded(training_frame)
                else None)
        if mesh is not None:
            self._refuse_unsharded_plan(training_frame, classification)

        def past(deadline) -> bool:
            # one verdict for every rank of a mesh: the slowest rank's
            if deadline is None:
                return False
            late = time.time() >= deadline
            if mesh is None:
                return late
            import torch

            flag = torch.tensor([int(late)], dtype=torch.int64)
            return bool(mesh.all_reduce(flag, "max")[0])
        if self.sort_metric in ("AUTO", None, ""):
            self._metric_name = ("auc" if classification
                                 and y_col.cardinality == 2
                                 else "logloss" if classification
                                 else "rmse")
        else:
            self._metric_name = self.sort_metric.lower()
        self._leaderboard_frame = leaderboard_frame
        self._lb_cache: Dict[str, float] = {}

        # durable search state: a search run under a Job (the REST
        # handler's) saves its snapshot under the Job's key while
        # H2O_TPU_SEARCH_CKPT is on; the spec names the frames by key
        job = getattr(self, "_search_job", None)
        engine = SearchEngine(
            str(job.key) if job is not None else self.project_name,
            "automl", {
                "kind": "automl", "description": "AutoML",
                "dest": self.project_name,
                "spec": {"max_models": self.max_models,
                         "max_runtime_secs": self.max_runtime_secs,
                         "seed": self.seed, "nfolds": self.nfolds,
                         "sort_metric": self.sort_metric,
                         "include_algos": self.include_algos,
                         "exclude_algos": self.exclude_algos,
                         "project_name": self.project_name,
                         "preprocessing": self.preprocessing},
                "x": list(x) if isinstance(x, (list, tuple)) else x, "y": y,
                "training_frame": str(training_frame.key),
                "validation_frame": (str(validation_frame.key)
                                     if validation_frame is not None
                                     else None),
                "leaderboard_frame": (str(leaderboard_frame.key)
                                      if leaderboard_frame is not None
                                      else None)},
            job=job, state=getattr(self, "_resume_search_state", None))
        self._search_engine = engine

        def _note_failure(mem, attempt):
            retrying = mem.get("status") != "parked"
            self._log(f"step {mem['name']} attempt {attempt} FAILED: "
                      f"{mem.get('error')}"
                      + (" — retrying" if retrying else " — parked"))

        engine.on_member_failure = _note_failure

        if "target_encoding" in self.preprocessing:
            training_frame, validation_frame, leaderboard_frame = \
                self._apply_target_encoding(y, training_frame,
                                            validation_frame,
                                            leaderboard_frame)
            self._leaderboard_frame = leaderboard_frame

        t0 = time.time()
        self._log(f"AutoML start: project={self.project_name}"
                  + (" (resumed)" if engine.resumed else ""))
        plan = self._steps(classification)
        self._plan = plan

        def score(mem, model):
            return _metric(model, self._metric_name)

        def run_steps(steps, budget_end, model_cap):
            # WorkAllocations: the remaining time splits over the
            # remaining step weights, so a slow early model shrinks what
            # later steps may spend instead of starving them
            steps = [st for st in steps if st["algo"] in BUILDERS]
            total_weight = sum(st["weight"] for st in steps) or 1
            box = {"spent": 0, "stopped": False}
            members = []
            for st in steps:
                mem = engine.member(st["name"], st["algo"], st["params"])
                mem["_step"] = st
                if mem.get("status") == "done" and mem.get("model_id"):
                    st["model_id"] = mem["model_id"]
                if mem.get("status") == "parked":
                    st["failed"] = True
                members.append(mem)

            def can_start(inflight):
                if model_cap and len(self.models) + inflight >= model_cap:
                    box["stopped"] = True
                    return False
                if past(budget_end):
                    if not box["stopped"]:
                        self._log("time budget exhausted")
                    box["stopped"] = True
                    return False
                return True

            def build(mem):
                st = mem["_step"]
                algo, params = st["algo"], dict(st["params"])
                if budget_end is not None and mesh is None:
                    remaining = max(budget_end - time.time(), 0.0)
                    rem_weight = max(total_weight - box["spent"], 1)
                    alloc = remaining * st["weight"] / rem_weight
                    params["max_runtime_secs"] = alloc
                    self._log(f"step {st['name']}: allocated {alloc:.1f}s "
                              f"of {remaining:.1f}s remaining")
                box["spent"] += st["weight"]
                params.update(seed=self.seed)
                if mesh is not None:
                    # every rank's member gets the same key (a random one
                    # would differ between the processes)
                    params.setdefault("model_id",
                                      f"{self.project_name}_{st['name']}")
                if self.nfolds:
                    params.update(nfolds=self.nfolds,
                                  keep_cross_validation_predictions=True)
                if getattr(self, "_te_fold_col", None):
                    params.update(fold_column=self._te_fold_col)
                m = BUILDERS[algo](**params).train(
                    x=x, y=y, training_frame=training_frame,
                    validation_frame=validation_frame)
                self.models.append(m)
                st["model_id"] = str(m.key)
                self._log(f"built {st['name']} ({algo}): "
                          f"{self._metric_name}="
                          f"{_metric(m, self._metric_name):.4f}")
                return m

            def reattach(mem):
                from h2o3_tpu_torch.core.dkv import DKV

                m = DKV.get(mem["model_id"]) if mem.get("model_id") else None
                if m is not None:
                    self.models.append(m)
                    mem["_step"]["model_id"] = mem["model_id"]
                    self._log(f"reattached {mem['name']} from durable "
                              f"search state")
                return m

            ok = engine.run(members, build, can_start=can_start,
                            score_fn=score, reattach=reattach)
            for mem in members:
                st = mem["_step"]
                if mem.get("status") == "parked" and not st.get("failed"):
                    st["failed"] = True
                    self._log(f"FAILED {st['name']} ({st['algo']}): "
                              f"{mem.get('error')}")
            return ok and not box["stopped"]

        budget_end = (t0 + self.max_runtime_secs
                      if self.max_runtime_secs else None)
        # exploitation reserve (AutoML.java exploitation_ratio): the
        # exploration phases leave ~10% of a time budget and, under a
        # model budget, one model slot per exploitable family
        explore_end = (t0 + 0.9 * self.max_runtime_secs
                       if self.max_runtime_secs else None)
        reserve = 0
        if self.max_models:
            exploitable = [a for a, prov in REGISTRY.items()
                           if prov.has_exploitation
                           and (not self.include_algos
                                or a in self.include_algos)
                           and a not in self.exclude_algos]
            reserve = min(len(exploitable), 2, max(self.max_models - 1, 0))
        explore_cap = (self.max_models - reserve) if self.max_models else 0
        run_steps(plan, explore_end, explore_cap)

        # exploitation (group 60): refine each family's current best
        if not past(budget_end):
            best_by_algo = {}
            for m in self._ranked():
                best_by_algo.setdefault(m.algo_name, m)
            exploit = exploitation_steps({"classification": classification},
                                         best_by_algo, self.include_algos,
                                         self.exclude_algos)
            if exploit:
                self._plan = plan + exploit
                self._log(f"exploitation phase: {len(exploit)} step(s)")
                run_steps(exploit, budget_end, self.max_models)
        # reserved slots exploitation could not use go back to the steps
        # the reserve skipped (not to failed ones), so max_models fills
        if self.max_models and len(self.models) < self.max_models and \
                not past(budget_end):
            leftover = [st for st in plan
                        if "model_id" not in st and not st.get("failed")]
            if leftover:
                run_steps(leftover, budget_end, self.max_models)

        se_wanted = "stackedensemble" not in self.exclude_algos and (
            self.include_algos is None
            or "stackedensemble" in self.include_algos)
        if se_wanted:
            self._build_ensembles(y, training_frame)
        engine.finish()
        self._log(f"AutoML done: {len(self.models)} models")
        return self

    def _refuse_unsharded_plan(self, train: Frame, classification):
        """Refuse, before any member runs, a plan with a member that
        cannot train on the row-sharded `train` (ROADMAP A14.6c part
        4)."""
        from h2o3_tpu_torch.core.sharded_frame import refuse
        from h2o3_tpu_torch.models.model_builder import BUILDERS

        if "target_encoding" in self.preprocessing:
            refuse(train, "AutoML's target-encoding stage")
        algos = {st["algo"] for st in self._steps(classification)}
        if self.nfolds and "stackedensemble" not in self.exclude_algos:
            algos.add("stackedensemble")
        for a in sorted(algos):
            if a in BUILDERS and not BUILDERS[a].row_sharded:
                refuse(train, f"AutoML's {a} member")

    def _build_ensembles(self, y: str, train: Frame):
        """StackedEnsemble_BestOfFamily (each family's best) and
        StackedEnsemble_AllModels, over the models with CV holdout
        predictions; each is logged as built or FAILED."""
        from h2o3_tpu_torch.models.ensemble import StackedEnsemble

        usable = [m for m in self.models
                  if m._output.cross_validation_holdout_predictions
                  is not None]
        if len(usable) < 2:
            return
        by_family: Dict[str, Model] = {}
        for m in self._ranked(usable):
            by_family.setdefault(m.algo_name, m)
        for name, bases in (("BestOfFamily", list(by_family.values())),
                            ("AllModels", usable)):
            if len(bases) < 2:
                continue
            try:
                # metalearner_nfolds = AutoML's nfolds, so the ensemble's
                # rank metric is a CV metric like its bases'
                from h2o3_tpu_torch.core import sharded_frame as SF

                key = (f"{self.project_name}_StackedEnsemble_{name}"
                       if SF._is_sharded(train) else None)
                se = StackedEnsemble(base_models=bases, seed=self.seed,
                                     metalearner_nfolds=self.nfolds,
                                     model_id=key,
                                     ).train(y=y, training_frame=train)
                se._se_name = f"StackedEnsemble_{name}"
                self.models.append(se)
                self._log(f"built StackedEnsemble_{name}")
            except Exception as e:       # noqa: BLE001
                self._log(f"FAILED StackedEnsemble_{name}: {e}")

    # -- leaderboard --------------------------------------------------------
    def _ranked(self, models: Optional[List[Model]] = None) -> List[Model]:
        models = models if models is not None else self.models
        reverse = self._metric_name not in _LOWER_IS_BETTER
        lb = getattr(self, "_leaderboard_frame", None)
        cache = getattr(self, "_lb_cache", {})

        def keyfn(m):
            v = _leaderboard_metric(m, self._metric_name, lb, cache)
            if v != v:
                return float("-inf") if reverse else float("inf")
            return v

        return sorted(models, key=keyfn, reverse=reverse)

    @property
    def leader(self) -> Optional[Model]:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    @property
    def leaderboard(self) -> List[Dict[str, Any]]:
        lb = getattr(self, "_leaderboard_frame", None)
        cache = getattr(self, "_lb_cache", {})
        rows = []
        for m in self._ranked():
            rows.append({
                "model_id": getattr(m, "_se_name", None) or str(m.key),
                "algo": m.algo_name,
                self._metric_name: _leaderboard_metric(
                    m, self._metric_name, lb, cache),
            })
        return rows
