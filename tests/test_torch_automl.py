"""AutoML in the port (h2o3_tpu_torch/automl, on the CPU) against the JAX
package's on the same numpy fixtures.

Tolerances:
- exact: the step plans (`build_plan`, `exploitation_steps`: names,
  weights, groups and every drawn parameter, floats included), AutoML's
  `modeling_plan`, the names and order of the steps it built, and the
  fold assignment digests;
- C2's bars: each member's and ensemble's CV metric (AUC) abs 1e-6, the
  leader's predictions abs 1e-5; target encodings abs 1e-6 (ROADMAP
  C14's level sums);
- the target-encoding case's GLM: its holdout predictions abs 1e-5, its
  CV AUC abs 1e-4: its encodings and folds equal the reference's, but a
  fold's holdout predictions hold pairs within 1e-6 of each other,
  whose order rounding may swap, and one swapped pair moves a 320-row
  fold's AUC by ~4e-5;
- leaderboard order: equal wherever two neighbours of the reference's
  leaderboard differ by more than the AUC bar (closer neighbours may
  swap on rounding).
The JAX side trains its GBMs through its Pallas histogram kernel in
interpret mode (H2O_TPU_PALLAS_HIST=1), as the port's other tree parity
tests do. Fixtures have 640 rows, a multiple of the JAX mesh's 64-row
padding."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import both_frames, flagship_cols

AUC_ATOL = 1e-6
PRED_ATOL = 1e-5


class _Best:
    """A family leader as the exploitation providers read it."""

    def __init__(self, **parms):
        self._parms = parms


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("include,exclude", [
    (None, []), (["gbm"], []), (["gbm", "deeplearning"], []),
    (None, ["gbm"]), (["glm", "drf", "xgboost"], ["drf"]),
    (["glm"], [])])
@pytest.mark.parametrize("classification", [True, False])
def test_build_plan_matches_reference(seed, include, exclude,
                                      classification):
    from h2o3_tpu.automl import steps as jsteps

    from h2o3_tpu_torch.automl import steps as tsteps

    ctx = {"classification": classification}
    want = jsteps.build_plan(ctx, seed, include, exclude)
    got = tsteps.build_plan(ctx, seed, include, exclude)
    assert got == want
    assert [s["group"] for s in got] == sorted(s["group"] for s in got)


@pytest.mark.parametrize("best,include,exclude", [
    ({"gbm": _Best(learn_rate=0.1, ntrees=50, max_depth=6,
                   sample_rate=0.8, col_sample_rate_per_tree=0.8),
      "xgboost": _Best(learn_rate=0.05, ntrees=300, max_depth=None)},
     None, []),
    ({"gbm": _Best(learn_rate=None, ntrees=None, min_rows=5.0)}, ["gbm"],
     []),
    ({"xgboost": _Best(learn_rate=0.2, ntrees=100, max_depth=4)}, None,
     ["gbm"]),
    ({}, None, []),
])
def test_exploitation_steps_match_reference(best, include, exclude):
    from h2o3_tpu.automl import steps as jsteps

    from h2o3_tpu_torch.automl import steps as tsteps

    ctx = {"classification": True}
    assert tsteps.exploitation_steps(ctx, best, include, exclude) == \
        jsteps.exploitation_steps(ctx, best, include, exclude)


def _run_both(cols, **kw):
    """The same AutoML in both packages -> (jax AutoML, port AutoML,
    jax frame, port frame)."""
    from h2o3_tpu.automl.automl import H2OAutoML as JAutoML

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_PALLAS_HIST", "1")
        jf, tf = both_frames(cols)
        ja = JAutoML(**kw).train(y="y", training_frame=jf)
        ta = th.H2OAutoML(**kw).train(y="y", training_frame=tf)
    return ja, ta, jf, tf


def _built(aml):
    """Names of the steps built, in the order they were built."""
    order = {st["model_id"]: st["name"] for st in aml.modeling_plan
             if st.get("model_id")}
    names = [order.get(str(m.key)) for m in aml.models]
    return [n if n is not None else getattr(m, "_se_name", None)
            for n, m in zip(names, aml.models)]


def _plan_names(aml):
    return [(st["name"], st["algo"], st["group"], st["weight"])
            for st in aml.modeling_plan]


def _assert_leaderboards_match(ja, ta, metric="auc", atol=AUC_ATOL):
    jname = {str(m.key): n for m, n in zip(ja.models, _built(ja))}
    tname = {str(m.key): n for m, n in zip(ta.models, _built(ta))}
    jm = {jname[str(m.key)]: m for m in ja.models}
    tm = {tname[str(m.key)]: m for m in ta.models}
    assert sorted(jm) == sorted(tm)
    jlb = [jname.get(r["model_id"], r["model_id"]) for r in ja.leaderboard]
    tlb = [tname.get(r["model_id"], r["model_id"]) for r in ta.leaderboard]
    jv = {n: r[metric] for n, r in zip(jlb, ja.leaderboard)}
    tv = {n: r[metric] for n, r in zip(tlb, ta.leaderboard)}
    for n in jv:
        assert tv[n] == pytest.approx(jv[n], abs=atol), n
    # the leaderboard order, wherever neighbours are apart by more than
    # the bar
    pos = {n: i for i, n in enumerate(tlb)}
    for a, b in zip(jlb, jlb[1:]):
        if abs(jv[a] - jv[b]) > atol:
            assert pos[a] < pos[b], (jlb, tlb)


@pytest.fixture(scope="module")
def binomial(cl):
    return _run_both(flagship_cols(640, seed=3), max_models=2, nfolds=2,
                     seed=1, include_algos=["glm", "gbm", "stackedensemble"])


def test_automl_binomial_matches_reference(binomial):
    ja, ta, jf, tf = binomial
    assert _plan_names(ta) == _plan_names(ja)
    # the reserve keeps def_gbm_1 out of exploration; GLM has no
    # exploitation, so the leftover pass builds it, then both ensembles
    assert _built(ta) == _built(ja) == [
        "def_glm", "def_gbm_1", "StackedEnsemble_BestOfFamily",
        "StackedEnsemble_AllModels"]
    _assert_leaderboards_match(ja, ta)
    for jm, tm in zip(ja.models[:2], ta.models[:2]):
        assert tm._output.fold_assignment_digest == \
            jm._output.fold_assignment_digest
        np.testing.assert_allclose(
            tm._output.cross_validation_holdout_predictions,
            jm._output.cross_validation_holdout_predictions[:jf.nrows],
            atol=PRED_ATOL)
    jp, tp = ja.predict(jf), ta.predict(tf)
    assert tp.names == jp.names
    np.testing.assert_allclose(tp.col("Y").data.numpy(),
                               np.asarray(jp.col("Y").data)[:jf.nrows],
                               atol=PRED_ATOL)
    lb = ta.leaderboard
    assert lb[0]["auc"] >= lb[-1]["auc"]
    assert ta.leader is ta._ranked()[0]
    msgs = [e["message"] for e in ta.event_log]
    assert msgs[0].startswith("AutoML start") and \
        msgs[-1] == "AutoML done: 4 models"


def test_automl_exploitation_matches_reference(cl):
    """nfolds=0: no CV and no ensembles; the reserve leaves one slot for
    the exploitation step, which refines the best GBM at half its
    learning rate."""
    ja, ta, jf, tf = _run_both(
        flagship_cols(640, seed=17), max_models=3, seed=7, nfolds=0,
        include_algos=["GBM", "GLM"], exclude_algos=["StackedEnsemble"])
    assert _plan_names(ta) == _plan_names(ja)
    assert _built(ta) == _built(ja) == [
        "def_glm", "def_gbm_1", "exploit_gbm_lr_annealing"]
    em = ta.models[2]
    best_lr = float(ta._ranked(ta.models[1:2])[0]._parms["learn_rate"])
    assert float(em._parms["learn_rate"]) == best_lr / 2
    assert em._parms["ntrees"] == ja.models[2]._parms["ntrees"] == 100
    # without CV the rank metric is the training AUC
    _assert_leaderboards_match(ja, ta)
    groups = [st["group"] for st in ta.modeling_plan]
    assert groups == sorted(groups)


def test_automl_target_encoding_matches_reference(cl):
    """preprocessing=["target_encoding"]: the same fold assignment (every
    member's fold column is the AutoML one), the same encodings, and
    predict() encodes the frame before the leader scores it."""
    ja, ta, jf, tf = _run_both(
        flagship_cols(640, seed=5), max_models=1, seed=7, nfolds=2,
        include_algos=["glm"], preprocessing=["target_encoding"])
    assert _built(ta) == _built(ja) == ["def_glm"]
    assert ta.models[0]._output.fold_assignment_digest == \
        ja.models[0]._output.fold_assignment_digest
    assert ta.models[0]._parms["fold_column"] == "_automl_te_fold"
    je, te = ja.te_model.transform(jf), ta.te_model.transform(tf)
    enc = [n for n in te.names if n.endswith("_te")]
    assert enc == [n for n in je.names if n.endswith("_te")] == \
        ["c0_te", "c1_te"]
    for n in enc:
        np.testing.assert_allclose(te.col(n).data.numpy(),
                                   np.asarray(je.col(n).data)[:jf.nrows],
                                   atol=1e-6)
    np.testing.assert_allclose(
        ta.models[0]._output.cross_validation_holdout_predictions,
        ja.models[0]._output.cross_validation_holdout_predictions[
            :jf.nrows], atol=PRED_ATOL)
    _assert_leaderboards_match(ja, ta, atol=1e-4)
    # the GLM reads its fold column as a predictor, in both packages
    # (ROADMAP C28), so the frame to score carries the AutoML folds
    fold = np.random.default_rng(7).integers(0, 2, jf.nrows).astype(float)
    cols = flagship_cols(640, seed=5)
    cols["_automl_te_fold"] = (fold, None)
    jf2, tf2 = both_frames(cols)
    jp, tp = ja.predict(jf2), ta.predict(tf2)
    np.testing.assert_allclose(tp.col("Y").data.numpy(),
                               np.asarray(jp.col("Y").data)[:jf.nrows],
                               atol=PRED_ATOL)
    assert any("target encoding applied to 2" in e["message"]
               for e in ta.event_log)


def test_automl_regression_and_nfolds_auto(cl):
    """A numeric response ranks by RMSE (lower first); a negative nfolds
    means 5; the pinned seed is shared, so both members' folds agree."""
    rng = np.random.default_rng(1)
    n = 300
    X = rng.normal(size=(n, 3))
    y = 2 * X[:, 0] + X[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    th.init(device="cpu")
    fr = th.Frame.from_numpy(np.column_stack([X, y]),
                             names=["a", "b", "c", "y"])
    aml = th.H2OAutoML(max_models=2, nfolds=-1, seed=3,
                       include_algos=["glm", "gbm"])
    assert aml.nfolds == 5
    aml.train(y="y", training_frame=fr)
    lb = aml.leaderboard
    assert [r["rmse"] for r in lb] == sorted(r["rmse"] for r in lb)
    assert lb[0]["rmse"] < 1.0
    assert len({m._output.fold_assignment_digest for m in aml.models}) == 1


def test_automl_logs_a_parked_step_and_goes_on(cl, monkeypatch):
    """A member whose builder raises a configuration error is parked and
    logged; the search builds the next step in its place."""
    from h2o3_tpu_torch.models.glm import GLM

    def broken(self, train):
        raise ValueError("bad configuration")

    monkeypatch.setattr(GLM, "_fit", broken)
    _, tf = both_frames(flagship_cols(192, seed=2))
    aml = th.H2OAutoML(max_models=1, nfolds=0, seed=1,
                       include_algos=["glm", "gbm"])
    aml.train(y="y", training_frame=tf)
    assert _built(aml) == ["def_gbm_1"]
    msgs = [e["message"] for e in aml.event_log]
    assert any("def_glm attempt 1 FAILED" in m and "parked" in m
               for m in msgs), msgs
    assert any(m.startswith("FAILED def_glm") for m in msgs), msgs
    with pytest.raises(RuntimeError, match="no models"):
        th.H2OAutoML(max_models=1, include_algos=["glm"]).predict(tf)
