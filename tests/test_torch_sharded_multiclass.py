"""Multiclass training on row-sharded frames (h2o3_tpu_torch/models/glm.py's
multinomial and ordinal L-BFGS, models/tree/{gbm,drf}.py's per-class
forests, models/ensemble.py's multinomial metalearner, automl/ on a
multiclass response, model_builder.py's stratified folds): ranks run as
threads of this process (`run_ranks`), R = 2, 3 and 4.

Bars, against one process of the port:
- bit for bit: the multinomial GBM and DRF forests and their logloss,
  the AutoML leaderboard's tree members, the stratified fold ids and
  their digest (SHA-1 chained through the ranks);
- ROADMAP C46 (rtol 1e-6, atol 1e-6): ordinal GLM coefficients and
  probabilities, the penalised multinomial's, the ensemble's
  metalearner; every GLM's residual deviance (the cloud's) rtol 1e-6;
- ROADMAP C54: an unpenalised multinomial GLM's coefficients and
  probabilities within tests/test_torch_glm.py's JAX bar (rtol 1e-5,
  atol 1e-5), its iterations one apart at most: L-BFGS stops where the
  gradient's norm falls under 1e-6, and the ranks' float64 sums round
  the gradient otherwise than one float32 sum, so the two runs stop at
  different points of a flat optimum (their deviances agree to C46).
Against the JAX package, at the one-process parity tests' bars:
tests/test_torch_glm.py's `assert_glm_close` for the GLMs and
tests/test_torch_automl.py's for the AutoML (the steps built, each
member's CV logloss abs 1e-6, the leaderboard's order). Every case
asserts that no row was gathered. The AutoML cases cut the GBM steps of
both packages to 2-tree depth-3 members (the plan is otherwise the
reference's: its GLM member fails on a multiclass response and its
AUTO metalearner refuses a multinomial family, in both packages)."""

import hashlib

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import native
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import widen

from test_torch_glm import assert_glm_close, class_cols
from test_torch_sharded import _forest, run_ranks
from torch_port_support import both_frames

C46 = dict(rtol=1e-6, atol=1e-6)
C54 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_cpu():
    """The port on the CPU; what a test leaves in the DKV is removed."""
    th.init(device="cpu")
    before = set(th.DKV.keys())
    yield
    for k in set(th.DKV.keys()) - before:
        th.DKV.remove(k)


def _port_frame(cols):
    fr = th.Frame()
    for nm, (a, ct) in cols.items():
        fr.add(nm, th.Column.from_numpy(a, ctype=ct))
    return fr


def _on_ranks(R, cols, fn, timeout_s=30.0):
    """fn(frame, mesh) on R ranks, each on its block of `cols`' rows;
    -> [(rank's (lo, hi), fn's result)], asserting no rank gathered."""
    before = SF.counters()["gathered_rows"]

    def rank(r, m):
        fr = _port_frame(cols)
        assert fr.shard == m.rows(fr.nrows)
        return fr.shard, fn(fr, m)

    outs = run_ranks(R, rank, timeout_s=timeout_s)
    assert SF.counters()["gathered_rows"] == before
    return outs


def _bitwise(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, ctx
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), ctx


# -- GLM: multinomial and ordinal L-BFGS ------------------------------------

GLM_KW = {"default": {}, "lambda": {"lambda_": 0.5},
          "unstandardized": {"standardize": False}}
_ONE: dict = {}


def _glm_cols(family):
    return class_cols(K=4 if family == "multinomial" else 3)


def _glm_state(m, fr):
    """(coefficients, iterations, residual deviance, this process's rows
    of the class probabilities)."""
    p = m.predict(fr)
    probs = np.stack([widen(p.col(c).data).numpy() for c in p.names[1:]],
                     1)
    return m.beta.numpy(), m.iterations, m.residual_deviance, probs


def _one_glm(family, kw):
    if (family, kw) not in _ONE:
        fr = _port_frame(_glm_cols(family))
        m = th.GLM(family=family, **GLM_KW[kw]).train(y="y",
                                                      training_frame=fr)
        _ONE[family, kw] = _glm_state(m, fr)
    return _ONE[family, kw]


# the defaults on 2, 3 and 4 ranks; the other settings on 2 and 4
GLM_CASES = [(f, kw, R) for f in ("multinomial", "ordinal")
             for kw in sorted(GLM_KW)
             for R in ((2, 3, 4) if kw == "default" else (2, 4))]


@pytest.mark.parametrize("family,kw,R", GLM_CASES)
def test_glm_across_ranks_is_one_process(family, kw, R):
    """Every rank sees the cloud's float32 value and gradient, so each
    takes the same line-search steps: the ranks agree with each other
    bit for bit, and with one process at C46 (C54 for an unpenalised
    multinomial)."""
    beta1, it1, dev1, probs1 = _one_glm(family, kw)
    outs = _on_ranks(R, _glm_cols(family), lambda fr, m: _glm_state(
        th.GLM(family=family, **GLM_KW[kw]).train(y="y", training_frame=fr),
        fr))
    c54 = family == "multinomial" and kw != "lambda"
    bar = C54 if c54 else C46
    for (lo, hi), (beta, it, dev, probs) in outs:
        _bitwise(beta, outs[0][1][0], "the ranks' coefficients")
        assert it == outs[0][1][1]
        np.testing.assert_allclose(beta, beta1, **bar)
        np.testing.assert_allclose(probs, probs1[lo:hi], **bar)
        assert dev == pytest.approx(dev1, rel=1e-6)
        assert abs(it - it1) <= (1 if c54 else 0)
    if family == "ordinal":
        p = beta.shape[0] - 2
        assert beta[p] < beta[p + 1]          # the thresholds stay ordered


JAX_GLM = [("multinomial", "default"), ("multinomial", "lambda"),
           ("multinomial", "unstandardized"), ("ordinal", "default"),
           ("ordinal", "lambda")]


@pytest.mark.parametrize("family,kw", JAX_GLM)
def test_glm_across_ranks_against_the_jax_package(cl, family, kw):
    """tests/test_torch_glm.py's `assert_glm_close` (coefficients,
    deviances, metrics and predictions at 1e-5) for the fit of two
    ranks, its predictions scored in one process."""
    from h2o3_tpu.models.glm import GLM as JGLM

    cols = _glm_cols(family)
    jf, tf = both_frames(cols)
    jm = JGLM(family=family, **GLM_KW[kw]).train(y="y", training_frame=jf)
    (_sh, tm), _ = _on_ranks(2, cols, lambda fr, m: th.GLM(
        family=family, **GLM_KW[kw]).train(y="y", training_frame=fr))
    assert_glm_close(jm, tm, jf, tf)


# -- per-class forests, the multinomial metalearner -------------------------

FORESTS = {
    "gbm": lambda: th.GBM(ntrees=2, max_depth=3, seed=1),
    "gbm_sampled": lambda: th.GBM(ntrees=2, max_depth=3, seed=1,
                                  sample_rate=0.7),
    "drf": lambda: th.DRF(ntrees=2, max_depth=4, seed=3),
}


@pytest.mark.parametrize("algo,R", [("gbm", 2), ("drf", 3),
                                    ("gbm_sampled", 4)])
def test_multinomial_forests_are_one_process(algo, R):
    cols = class_cols(n=256, K=4)
    one = FORESTS[algo]().train(y="y", training_frame=_port_frame(cols))
    want = _forest(one)
    for _sh, m in _on_ranks(R, cols, lambda fr, mesh: FORESTS[algo]().train(
            y="y", training_frame=fr)):
        got = _forest(m)
        assert m.forest.n_trees == one.forest.n_trees == 8
        for k in want:
            _bitwise(got[k], want[k], k)
        assert m._output.training_metrics.logloss == \
            one._output.training_metrics.logloss


def _stack(fr):
    kw = dict(nfolds=2, seed=3, keep_cross_validation_predictions=True)
    a = th.GBM(ntrees=2, max_depth=3, **kw).train(y="y", training_frame=fr)
    b = th.DRF(ntrees=2, max_depth=3, **kw).train(y="y", training_frame=fr)
    se = th.StackedEnsemble(base_models=[a, b], seed=3,
                            metalearner_algorithm="glm").train(
        y="y", training_frame=fr)
    return (se.metalearner.beta.numpy(), se.metalearner.residual_deviance,
            se._output.training_metrics.logloss)


def test_multinomial_ensemble_is_one_process_within_c46():
    cols = class_cols(n=256, K=3)
    beta1, dev1, ll1 = _stack(_port_frame(cols))
    assert beta1.shape[1] == 3
    for _sh, (beta, dev, ll) in _on_ranks(2, cols, lambda fr, m: _stack(fr)):
        np.testing.assert_allclose(beta, beta1, **C46)
        assert dev == pytest.approx(dev1, rel=1e-6)
        assert ll == pytest.approx(ll1, rel=1e-6)


# -- AutoML on a multiclass response -----------------------------------------

AML = dict(max_models=2, nfolds=2, seed=7,
           include_algos=["glm", "gbm", "stackedensemble"])


def _small_gbm_steps(mp):
    """Both packages' default GBM step cut to 2 trees of depth 3 (the
    exploitation step doubles them)."""
    from h2o3_tpu.automl import steps as jsteps

    from h2o3_tpu_torch.automl import steps as tsteps

    for mod in (jsteps, tsteps):
        def defaults(self, ctx, step=mod.step, group=mod.GROUP_DEFAULTS):
            return [step("def_gbm_1", "gbm", 10, group, ntrees=2,
                         max_depth=3, learn_rate=0.1, sample_rate=0.8,
                         col_sample_rate_per_tree=0.8)]
        mp.setattr(mod.GBMSteps, "defaults", defaults)


def _aml_run(tag, fr):
    a = th.H2OAutoML(project_name=f"mcaml_{tag}", **AML).train(
        y="y", training_frame=fr)
    failed = sorted(e["message"] for e in a.event_log
                    if e["message"].startswith("FAILED"))
    return a, [(r["algo"], r["logloss"]) for r in a.leaderboard], failed


@pytest.fixture(scope="module")
def multiclass_automl():
    """(cols, one process's run, rank 0's run of two ranks): each run is
    (the AutoML, its leaderboard's (algo, logloss), its FAILED lines)."""
    cols = class_cols(n=128, K=3)
    with pytest.MonkeyPatch.context() as mp:
        _small_gbm_steps(mp)
        th.init(device="cpu")
        one = _aml_run("one", _port_frame(cols))
        (_sh, ranks), _ = _on_ranks(
            2, cols, lambda fr, m: _aml_run(f"r{m.rank}", fr),
            timeout_s=60.0)
    return cols, one, ranks


def test_multiclass_automl_across_ranks_is_one_process(multiclass_automl):
    """The multiclass plan runs across ranks: its GLM member fails on the
    response and its ensemble on the AUTO metalearner, as in one process;
    the GBM members, their CV metrics and the leaderboard are one
    process's bit for bit."""
    _cols, (_a1, one, failed1), (_a, got, failed) = multiclass_automl
    assert [r[0] for r in one] == ["gbm", "gbm"]
    assert [f.split(":")[0] for f in failed1] == [
        "FAILED StackedEnsemble_AllModels", "FAILED def_glm (glm)"]
    assert got == one
    assert failed == failed1


def test_multiclass_automl_across_ranks_against_the_jax_package(
        cl, monkeypatch):
    """tests/test_torch_automl.py's bars on a multiclass response, without
    CV (the reference compiles each CV train anew), its GBMs through its
    Pallas histogram in interpret mode as there: the same steps built in
    the same order, each member's logloss abs 1e-6, the leaderboard's
    order where neighbours differ by more."""
    from h2o3_tpu.automl.automl import H2OAutoML as JAutoML

    from test_torch_automl import _assert_leaderboards_match, _built

    _small_gbm_steps(monkeypatch)
    kw = dict(AML, nfolds=0)
    cols = class_cols(n=128, K=3)
    jf, _tf = both_frames(cols)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_PALLAS_HIST", "1")
        ja = JAutoML(**kw).train(y="y", training_frame=jf)
    (_sh, ta), _ = _on_ranks(2, cols, lambda fr, m: th.H2OAutoML(
        project_name=f"mcaml_jx{m.rank}", **kw).train(
        y="y", training_frame=fr))
    assert _built(ta) == _built(ja) == ["def_gbm_1",
                                        "exploit_gbm_lr_annealing"]
    _assert_leaderboards_match(ja, ta, metric="logloss")


# -- stratified folds --------------------------------------------------------

@pytest.mark.parametrize("R", [2, 3])
def test_stratified_folds_across_ranks_are_one_process(R):
    """Each rank draws its own block's fold ids from the class counts of
    the ranks before it: their digest (chained through the ranks), the
    fold forests, the holdout predictions and the CV metrics are one
    process's, and no response code moves."""
    cols = class_cols(n=192, K=4)

    def cv(fr):
        m = th.GBM(ntrees=1, max_depth=2, seed=4, nfolds=3,
                   fold_assignment="Stratified",
                   keep_cross_validation_predictions=True).train(
            y="y", training_frame=fr)
        o = m._output
        preds = o.cross_validation_holdout_predictions
        return (o.fold_assignment_digest, np.asarray(
            preds if isinstance(preds, np.ndarray) else preds.numpy()),
            [_forest(f) for f in o.cross_validation_models],
            o.cross_validation_metrics.logloss)

    dig1, preds1, forests1, ll1 = cv(_port_frame(cols))
    for (lo, hi), (dig, preds, forests, ll) in _on_ranks(
            R, cols, lambda fr, m: cv(fr)):
        assert dig == dig1
        _bitwise(preds, preds1[lo:hi])
        for got, want in zip(forests, forests1):
            for k in want:
                _bitwise(got[k], want[k], k)
        assert ll == ll1


@pytest.mark.parametrize("R", [1, 2, 3, 4])
@pytest.mark.parametrize("nbytes", [0, 40, 64, 1000])
def test_chained_sha1_is_hashlib_over_the_ranks_bytes(R, nbytes):
    """SHA-1 with its state handed from rank to rank equals hashlib's
    digest of every rank's bytes in rank order, for blocks that split
    64-byte blocks anywhere (an empty rank included)."""
    data = np.random.default_rng(nbytes).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    want = hashlib.sha1(data).hexdigest()
    assert native.chained_sha1(data) == want

    def rank(r, m):
        cuts = [0] + sorted(np.random.default_rng(R).integers(
            0, nbytes + 1, R - 1).tolist()) + [nbytes]
        return native.chained_sha1(data[cuts[r]:cuts[r + 1]], m)

    assert run_ranks(R, rank) == [want] * R
