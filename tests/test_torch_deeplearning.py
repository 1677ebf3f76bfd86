"""DeepLearning in the port (models/deeplearning.py) against the JAX
package's, on the CPU.

Tolerances: one step (same weights, batch and dropout key): the loss to
1e-6 relative, gradients and the weights after one ADADELTA update to
1e-5 relative (float32 sums in different orders). Short trains (n = 640,
a multiple of the JAX test mesh's 64-row padding, so both draw the same
batch rows; hidden [16, 16], 2 epochs = 40 steps): predictions atol
1e-4, the last epoch's training loss 1e-5 relative. A model carried
across with deeplearning_model_from_numpy: predictions, deep features,
reconstruction errors and Garson importances to 1e-6. The optimizers
alone, over 50 updates of the same gradients: atol 1e-6 to optax."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert, native
from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.models import deeplearning as dl
from h2o3_tpu_torch.optim.sgd import SGD, Adadelta

from torch_port_support import both_frames, dl_cols


def _jdl():
    from h2o3_tpu.models.deeplearning import DeepLearning as JDL

    return JDL


# --- one step -------------------------------------------------------------

STEP_CASES = {
    "binomial": dict(nclasses=2, loss="crossentropy"),
    "multinomial_dropout": dict(nclasses=3, loss="crossentropy",
                                in_drop=0.2, hid_drop=(0.5, 0.3)),
    "huber_l1_l2": dict(nclasses=1, loss="huber", l1=1e-3, l2=1e-2,
                        act="tanh"),
    "autoencoder_maxout": dict(nclasses=1, loss="quadratic",
                               autoencoder=True, act="maxout",
                               hid_drop=(0.1, 0.0)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_step_matches_jax(case):
    """Loss, gradients and the updated weights of one minibatch step,
    the batch rows and dropout masks drawn from the same key chain."""
    import jax
    import jax.numpy as jnp
    import optax

    from h2o3_tpu.models import deeplearning as jdl

    c = STEP_CASES[case]
    act, K = c.get("act", "rectifier"), c["nclasses"]
    auto = c.get("autoencoder", False)
    in_drop, hid_drop = c.get("in_drop", 0.0), c.get("hid_drop", ())
    l1, l2 = c.get("l1", 0.0), c.get("l2", 0.0)
    n, d, hidden, batch = 640, 15, [16, 16], 32
    rng = np.random.default_rng(5)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.integers(0, K, n).astype(np.int32) if K > 1
         else rng.standard_normal(n).astype(np.float32))
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    out_dim = d if auto else K
    jparams = jdl._init_params(d, hidden, out_dim, 7, "UniformAdaptive", 1.0)
    tparams = dl._init_params(d, hidden, out_dim, 7, "UniformAdaptive", 1.0,
                              "cpu")
    for (jW, jb), (tW, tb) in zip(jparams, tparams):
        assert np.asarray(jW).tobytes() == tW.numpy().tobytes()

    # the reference's step: key, kidx, kdrop = split(key, 3)
    jkey, kidx, kdrop = jax.random.split(jax.random.PRNGKey(11), 3)
    idx = np.asarray(jax.random.randint(kidx, (batch,), 0, n))
    sub, _ = native.split_chain(rnd.PRNGKey(11), 1, 3)
    tidx = rnd.randint(sub[0, 0], (batch,), 0, n).numpy()
    np.testing.assert_array_equal(tidx, idx)

    def jloss(params, xb, yb, wb, key):
        # h2o3_tpu/models/deeplearning.py loss_fn (:328-351)
        out = jdl._forward(params, xb, act, dropout_key=key,
                           input_dropout=in_drop, hidden_dropout=hid_drop,
                           train=True)
        if auto:
            per_row = jnp.mean((out - xb) ** 2, axis=-1)
        elif K > 1:
            logp = jax.nn.log_softmax(out, axis=-1)
            per_row = -jnp.take_along_axis(logp, yb[:, None], axis=-1)[:, 0]
        else:
            dd = jnp.abs(yb - out[:, 0])
            per_row = jnp.where(dd <= 1.0, 0.5 * dd * dd, dd - 0.5)
        data_loss = jnp.sum(per_row * wb) / jnp.maximum(jnp.sum(wb), 1.0)
        reg = 0.0
        if l1 > 0 or l2 > 0:
            for W, _ in params:
                reg = reg + l1 * jnp.sum(jnp.abs(W)) + l2 * 0.5 * jnp.sum(W * W)
        return data_loss + reg

    xb, yb, wb = X[idx], y[idx], w[idx]
    jl, jg = jax.value_and_grad(jloss)(jparams, jnp.asarray(xb),
                                       jnp.asarray(yb), jnp.asarray(wb),
                                       kdrop)
    opt = optax.adadelta(learning_rate=1.0, rho=0.99, eps=1e-8)
    upd, _ = opt.update(jg, opt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, upd)

    loss_fn = dl.make_loss(activation=act, autoencoder=auto, nclasses=K,
                           loss=c["loss"], l1=l1, l2=l2,
                           input_dropout=in_drop, hidden_dropout=hid_drop,
                           device="cpu")
    masks = dl.dropout_masks(sub[0, 1], batch, [d] + hidden, in_drop,
                             hid_drop)
    assert (masks[0] is not None) == (in_drop > 0)
    flat = [t.clone().requires_grad_(True) for W, b in tparams
            for t in (W, b)]
    tyb = torch.from_numpy(yb).long() if K > 1 else torch.from_numpy(yb)
    tl = loss_fn(flat, torch.from_numpy(xb), tyb, torch.from_numpy(wb),
                 masks)
    tg = torch.autograd.grad(tl, flat)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    jflat = [a for W, b in jg for a in (W, b)]
    for a, b in zip(tg, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    with torch.no_grad():
        Adadelta(flat, 0.99, 1e-8).step(flat, list(tg))
    for a, b in zip(flat, [a for W, b in jnew for a in (W, b)]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


# --- the optimizers ---------------------------------------------------------

OPT_CASES = {
    "adadelta": dict(adaptive=True, rho=0.99, eps=1e-8),
    "adadelta_rho95": dict(adaptive=True, rho=0.95, eps=1e-6),
    "sgd": dict(rate=0.005, anneal=0.0, momentum=0.0),
    "sgd_momentum": dict(rate=0.005, anneal=0.0, momentum=0.9),
    "sgd_annealed": dict(rate=0.05, anneal=1e-3, momentum=0.0),
    "sgd_momentum_annealed": dict(rate=0.05, anneal=1e-3, momentum=0.5),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax_over_50_updates(case):
    """`Adadelta` and `SGD` (plain, trace momentum, annealed rate and
    both) against the optax chains h2o3_tpu/models/deeplearning.py
    builds (:311-326), fed the same 50 gradients: atol 1e-6."""
    import jax.numpy as jnp
    import optax

    c, batch = OPT_CASES[case], 32
    rng = np.random.default_rng(11)
    shapes = [(15, 16), (16,), (16, 2), (2,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(50)]
    if c.get("adaptive"):
        opt = optax.adadelta(learning_rate=1.0, rho=c["rho"], eps=c["eps"])
    else:
        def lr_sched(step):
            return c["rate"] / (1.0 + c["anneal"] * step * batch)

        opt = (optax.sgd(learning_rate=lr_sched, momentum=c["momentum"])
               if c["momentum"] > 0 else optax.sgd(learning_rate=lr_sched))
    jp = [jnp.asarray(a) for a in p0]
    state = opt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    topt = (Adadelta(tp, c["rho"], c["eps"]) if c.get("adaptive") else
            SGD(tp, rate=c["rate"], rate_annealing=c["anneal"], batch=batch,
                momentum=c["momentum"]))
    for g in grads:
        upd, state = opt.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, [torch.from_numpy(a) for a in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    if not c.get("adaptive"):
        assert float(topt.count) == 50.0


# --- short trains -----------------------------------------------------------

TRAIN_CASES = {
    "binomial": ("binomial", {}),
    "multinomial": ("multinomial", {}),
    "quadratic": ("regression", {}),
    "absolute": ("regression", {"loss": "Absolute"}),
    "huber": ("regression", {"loss": "Huber"}),
    "autoencoder": ("autoencoder", {"autoencoder": True}),
    "tanh": ("binomial", {"activation": "Tanh"}),
    "maxout": ("binomial", {"activation": "Maxout"}),
    "dropout": ("binomial", {"activation": "RectifierWithDropout",
                             "input_dropout_ratio": 0.2}),
    "l1_l2": ("multinomial", {"l1": 1e-4, "l2": 1e-3}),
    "sgd_momentum": ("regression", {"adaptive_rate": False, "rate": 0.01,
                                    "rate_annealing": 1e-4,
                                    "momentum_start": 0.5}),
}


def _both_models(kind, n=640, **kw):
    jf, tf = both_frames(dl_cols(kind, n=n))
    kw = dict(hidden=[16, 16], epochs=2, seed=5) | kw
    y = None if kw.get("autoencoder") else "y"
    jm = _jdl()(**kw).train(y=y, training_frame=jf)
    tm = th.DeepLearning(**kw).train(y=y, training_frame=tf)
    return jm, tm, jf, tf


def _pred_cols(m, fr):
    if m.autoencoder:
        return {"mse": m.anomaly(fr).col("Reconstruction.MSE")}
    p = m.predict(fr)
    return {nm: p.col(nm) for nm in p.names if nm != "predict"} \
        if m.nclasses > 1 else {"predict": p.col("predict")}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_short_train_matches_jax(cl, case):
    kind, kw = TRAIN_CASES[case]
    jm, tm, jf, tf = _both_models(kind, **kw)
    n = tf.nrows
    jp, tp = _pred_cols(jm, jf), _pred_cols(tm, tf)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].to_numpy(),
                                   jp[k].to_numpy()[:n], atol=1e-4,
                                   err_msg=k)
    jh, thh = jm._output.scoring_history, tm._output.scoring_history
    assert [h["epoch"] for h in thh] == [h["epoch"] for h in jh] == [1, 2]
    assert thh[-1]["training_loss"] == pytest.approx(
        jh[-1]["training_loss"], rel=1e-5)
    assert tm._output.model_category == jm._output.model_category
    assert tm.epochs_trained == jm.epochs_trained == 2
    if not kw.get("autoencoder"):
        jv, tv = jm._output.variable_importances, \
            tm._output.variable_importances
        assert sorted(jv) == sorted(tv)
        for k in jv:
            assert tv[k] == pytest.approx(jv[k], abs=1e-4), k
    else:
        jmt, tmt = jm._output.training_metrics, tm._output.training_metrics
        assert type(tmt).__name__ == "ModelMetricsAutoEncoder"
        assert tmt.mse == pytest.approx(jmt.mse, rel=1e-5)


def test_c13_padded_draws_differ_from_the_ports(cl):
    """ROADMAP C13: the reference draws batch rows over its padded
    length (640 for 600 rows on the test mesh), the port over n, so at
    n = 600 the first batch differs; at n = 640 the two coincide."""
    import jax

    from h2o3_tpu.core.runtime import cluster

    assert cluster().pad_rows(600) == 640 and cluster().pad_rows(640) == 640
    _, kidx, _ = jax.random.split(jax.random.PRNGKey(5), 3)
    sub, _ = native.split_chain(rnd.PRNGKey(5), 1, 3)
    ref600 = np.asarray(jax.random.randint(kidx, (32,), 0, 640))
    port600 = rnd.randint(sub[0, 0], (32,), 0, 600).numpy()
    assert not np.array_equal(ref600, port600)
    ref640 = np.asarray(jax.random.randint(kidx, (32,), 0, 640))
    np.testing.assert_array_equal(rnd.randint(sub[0, 0], (32,), 0,
                                              640).numpy(), ref640)
    # and so the trained models differ at n = 600 by more than the bar
    jm, tm, jf, tf = _both_models("binomial", n=600)
    gap = np.abs(tm.predict(tf).col("Y").to_numpy()
                 - jm.predict(jf).col("Y").to_numpy()[:600]).max()
    assert gap > 1e-4


def carry_dl(jm):
    """A JAX DeepLearningModel's state as plain values."""
    di = jm.data_info
    state = {k: getattr(di, k) for k in
             ("standardize", "cat_names", "num_names", "domains", "cards",
              "use_all_factor_levels", "num_means", "num_sigmas",
              "cat_modes", "impute_values")}
    o = jm._output
    return {"params": [(np.asarray(W), np.asarray(b))
                       for W, b in jm.params_tree],
            "data_info": state, "activation": jm.activation,
            "nclasses": jm.nclasses, "autoencoder": jm.autoencoder,
            "epochs_trained": jm.epochs_trained,
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "response_domain": o.response_domain,
                       "model_category": o.model_category,
                       "response_name": o.response_name}}


@pytest.mark.parametrize("kind", ["binomial", "autoencoder"])
def test_jax_model_carried_across(cl, kind):
    kw = {"autoencoder": True} if kind == "autoencoder" else {}
    jf, tf = both_frames(dl_cols(kind, n=256, seed=9))
    jm = _jdl()(hidden=[8, 6], epochs=1, seed=2, activation="Tanh",
                **kw).train(y=None if kw else "y", training_frame=jf)
    tm = convert.deeplearning_model_from_numpy(carry_dl(jm))
    n = tf.nrows
    for layer in (0, 1):
        a, b = jm.deepfeatures(jf, layer), tm.deepfeatures(tf, layer)
        assert a.names == b.names
        for nm in a.names:
            np.testing.assert_allclose(b.col(nm).to_numpy(),
                                       a.col(nm).to_numpy()[:n], atol=1e-6)
    if kw:
        np.testing.assert_allclose(
            tm.anomaly(tf).col("Reconstruction.MSE").to_numpy(),
            jm.anomaly(jf).col("Reconstruction.MSE").to_numpy()[:n],
            atol=1e-6)
        return
    np.testing.assert_allclose(tm.predict(tf).col("Y").to_numpy(),
                               jm.predict(jf).col("Y").to_numpy()[:n],
                               atol=1e-6)
    from h2o3_tpu.models.deeplearning import _garson_importance as jg

    a, b = jg(jm.params_tree, jm.data_info), dl._garson_importance(
        tm.params_tree, tm.data_info)
    assert list(a) == list(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], abs=1e-6)


def test_parameter_guards_match_jax(cl):
    jf, tf = both_frames(dl_cols("binomial", n=128))
    for kw, msg in (({"activation": "Softplus"}, "unknown activation"),
                    ({"initial_weight_distribution": "Cauchy"},
                     "initial_weight_distribution")):
        for cls, fr in ((_jdl(), jf), (th.DeepLearning, tf)):
            with pytest.raises(ValueError, match=msg):
                cls(hidden=[4], epochs=1, **kw).train(y="y",
                                                      training_frame=fr)
    for cls in (_jdl(), th.DeepLearning):
        with pytest.raises(ValueError):
            cls(calibrate_model=True)


def test_eager_steps_are_counted():
    th.init(device="cpu")
    _, tf = both_frames(dl_cols("binomial", n=100))
    dl.eager_steps = dl.graph_replays = 0
    th.DeepLearning(hidden=[4], epochs=2, mini_batch_size=16).train(
        y="y", training_frame=tf)
    assert (dl.eager_steps, dl.graph_replays) == (2 * 7, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"activation": "RectifierWithDropout",
                                     "input_dropout_ratio": 0.2},
                                {"adaptive_rate": False,
                                 "momentum_start": 0.9}])
def test_cuda_graph_loop_equals_eager_loop(kw):
    """On the card the captured step replays the eager step bit for bit
    (chip_smoke.py phase 3m makes the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    th.init(device="cuda")
    cols = dl_cols("binomial", n=4000)
    fr = th.Frame()
    for k, (a, ct) in cols.items():
        fr.add(k, th.Column.from_numpy(a, ctype=ct))
    out = {}
    for mode in ("graph", "eager"):
        b = th.DeepLearning(hidden=[64, 64], epochs=2, seed=3, **kw)
        b._force_eager = mode == "eager"
        m = b.train(y="y", training_frame=fr)
        out[mode] = [t.cpu() for W, bb in m.params_tree for t in (W, bb)]
    for a, b in zip(out["graph"], out["eager"]):
        assert torch.equal(a, b)
