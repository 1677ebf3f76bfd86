"""Shared fixtures of the PyTorch-port parity tests: one numpy dataset
loaded into the JAX package and into the port (on the CPU)."""

import numpy as np


def both_frames(cols):
    """cols: {name: (array, ctype or None)} -> (JAX Frame, port Frame)."""
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame

    import h2o3_tpu_torch as th

    th.init(device="cpu")
    jf, tf = JFrame(), th.Frame()
    for name, (arr, ctype) in cols.items():
        jf.add(name, JColumn.from_numpy(arr, ctype=ctype))
        tf.add(name, th.Column.from_numpy(arr, ctype=ctype))
    return jf, tf


def train_cols(seed=7, n=600, gaussian=False):
    """The reference's `_train_frame` fixture (tests/test_pallas_hist.py):
    x numeric, g a 3-level enum, y bernoulli in (2x + [g == a]); with
    `gaussian`, y = 2x + [g == a] + noise instead."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    if gaussian:
        y = 2 * x + (g == "a") + 0.3 * rng.standard_normal(n)
        return {"x": (x, None), "g": (g, "enum"), "y": (y, None)}
    yv = np.where(rng.random(n) < 1 / (1 + np.exp(-(2 * x + (g == "a")))),
                  "Y", "N")
    return {"x": (x, None), "g": (g, "enum"), "y": (yv, "enum")}


def flagship_cols(n, seed=0, n_num=8, n_cat=2):
    """The flagship benchmark's generator (h2o3_tpu/bench.py run_flagship)
    at n rows."""
    rng = np.random.default_rng(seed)
    cols, logit = {}, np.zeros(n)
    for i in range(n_num):
        x = rng.standard_normal(n)
        logit += x * rng.uniform(-1, 1)
        cols[f"n{i}"] = (x, None)
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    for i in range(n_cat):
        codes = rng.integers(0, len(doms[i % 2]), n)
        logit += (codes - 1) * 0.3
        cols[f"c{i}"] = (doms[i % 2][codes], "enum")
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
    cols["y"] = (y, "enum")
    return cols


def forest_arrays(forest):
    return {k: np.asarray(getattr(forest, k)) for k in
            ("feat", "thresh_bin", "na_left", "left", "right", "cat_split",
             "cat_table")}


def _host_strings(values):
    """A string column's host values with NaN (the reference's NA) read
    as None (the port's)."""
    return [None if isinstance(v, float) and v != v else v for v in values]


def assert_frames_match(jf, tf, ctx=""):
    """A JAX-package frame and a port frame hold the same data: names,
    types and domains equal; numeric and time values, NA masks and enum
    codes bitwise equal over the reference's first nrows (its columns are
    padded); string columns equal with NA as None."""
    assert jf.names == tf.names, (ctx, jf.names, tf.names)
    assert jf.nrows == tf.nrows, (ctx, jf.nrows, tf.nrows)
    assert jf.types == tf.types, (ctx, jf.types, tf.types)
    n = jf.nrows
    for nm in jf.names:
        jc, tc = jf.col(nm), tf.col(nm)
        assert (jc.domain or None) == (tc.domain or None), \
            (ctx, nm, jc.domain, tc.domain)
        if jc.data is None:
            assert tc.data is None, (ctx, nm)
            assert _host_strings(jc.host_data[:n]) == \
                list(tc.host_data[:n]), (ctx, nm)
            continue
        a, b = np.asarray(jc.data)[:n], tc.data.cpu().numpy()
        assert a.dtype == b.dtype, (ctx, nm, a.dtype, b.dtype)
        assert_bitwise(a, b, (ctx, nm))


def assert_bitwise(a, b, ctx=""):
    """Equal bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (ctx, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        na, nb = np.isnan(a), np.isnan(b)
        iv = {4: np.int32, 8: np.int64}[a.dtype.itemsize]
        bad = (na != nb) | (~na & (a.view(iv) != b.view(iv)))
    else:
        bad = a != b
    idx = np.flatnonzero(bad)
    assert len(idx) == 0, (ctx, [(int(i), a[i], b[i]) for i in idx[:5]])


def frames_bitwise(a, b, ctx=""):
    """Two port frames hold the same data bit for bit."""
    assert a.names == b.names and a.nrows == b.nrows, ctx
    assert a.types == b.types, (ctx, a.types, b.types)
    for nm in a.names:
        ca, cb = a.col(nm), b.col(nm)
        assert (ca.domain or None) == (cb.domain or None), (ctx, nm)
        if ca.data is None:
            assert list(ca.host_data[:ca.nrows]) == \
                list(cb.host_data[:cb.nrows]), (ctx, nm)
        else:
            assert_bitwise(ca.data.cpu().numpy(), cb.data.cpu().numpy(),
                           (ctx, nm))


def dl_cols(kind, n=640, seed=3):
    """The flagship's features (8 numeric, 2 enums) with a binomial,
    3-class ("multinomial"), numeric ("regression") or no
    ("autoencoder") response."""
    cols = flagship_cols(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    x0, x1 = cols["n0"][0], cols["n1"][0]
    if kind == "multinomial":
        k = np.digitize(x0 + 0.5 * rng.standard_normal(n), [-0.5, 0.5])
        cols["y"] = (np.array(["a", "b", "c"], object)[k], "enum")
    elif kind == "regression":
        cols["y"] = (1.5 * x0 - x1 + 0.3 * rng.standard_normal(n), None)
    elif kind == "autoencoder":
        del cols["y"]
    return cols


def carry_forest(jm):
    """A JAX-trained tree model's state as numpy arrays and plain values
    (the input of convert.gbm_model_from_numpy and its siblings)."""
    fo, sp, o = jm.forest, jm.spec, jm._output
    forest = {k: np.asarray(getattr(fo, k)) for k in
              ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val",
               "cat_split", "cat_table", "tree_class", "na_bins")}
    forest |= {"max_depth": fo.max_depth, "init_f": fo.init_f,
               "nclasses": fo.nclasses, "init_class": fo.init_class,
               "gain": getattr(fo, "gain", None),
               "cover": getattr(fo, "cover", None)}
    return {
        "forest": forest,
        "spec": {"names": list(sp.names), "is_cat": np.asarray(sp.is_cat),
                 "nbins": np.asarray(sp.nbins),
                 "edges": [np.asarray(e) for e in sp.edges],
                 "cards": np.asarray(sp.cards)},
        "output": {"names": list(o.names), "domains": dict(o.domains),
                   "response_domain": o.response_domain,
                   "model_category": o.model_category,
                   "response_name": o.response_name},
    }


# ---------------------------------------------------------------------------
# the data plane: frames under one key in both packages' DKVs, Rapids
# statements through both evaluators, results compared
# ---------------------------------------------------------------------------

def carry_glm(jm):
    """A JAX GLMModel's fitted state as plain values."""
    di = jm.dinfo
    state = {k: getattr(di, k) for k in
             ("standardize", "cat_names", "num_names", "domains", "cards",
              "use_all_factor_levels", "num_means", "num_sigmas",
              "cat_modes", "impute_values")}
    o = jm._output
    return {"beta": np.asarray(jm.beta), "link": jm.linkname,
            "link_power": jm.link_power, "data_info": state,
            "residual_deviance": jm.residual_deviance,
            "null_deviance": jm.null_deviance, "aic": jm.aic,
            "iterations": jm.iterations,
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "response_domain": o.response_domain,
                       "model_category": o.model_category,
                       "response_name": o.response_name},
            "parms": {k: jm._parms.get(k) for k in
                      ("offset_column", "weights_column", "interactions")}}


def install_both(key, cols):
    """cols: {name: (array, ctype or None)} -> (JAX Frame, port Frame),
    each installed in its package's DKV under `key`."""
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame

    import h2o3_tpu_torch as th

    th.init(device="cpu")
    jf, tf = JFrame(key=key), th.Frame(key=key)
    for name, (arr, ctype) in cols.items():
        jf.add(name, JColumn.from_numpy(arr, ctype=ctype))
        tf.add(name, th.Column.from_numpy(arr, ctype=ctype))
    jf.install()
    tf.install()
    return jf, tf


class Both:
    """One Rapids session in each package; `run` evaluates a statement
    in both and returns (reference result, port result)."""

    def __init__(self, name="t"):
        from h2o3_tpu.rapids import Session as JSession

        import h2o3_tpu_torch as th

        self.j, self.t = JSession(name), th.Session(name)

    def run(self, expr):
        from h2o3_tpu.rapids import exec_rapids as jexec

        import h2o3_tpu_torch as th

        return jexec(expr, self.j), th.exec_rapids(expr, self.t)

    def end(self):
        self.j.end()
        self.t.end()


def _close(a, b, rtol, scale):
    """|b - a| <= rtol * max(|a|, scale) elementwise, NaN where NaN, inf
    where inf (same sign)."""
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    assert a.shape == b.shape, (a.shape, b.shape)
    na, nb = np.isnan(a), np.isnan(b)
    ia, ib = np.isinf(a), np.isinf(b)
    ok = (na == nb) & (ia == ib)
    ok &= ~ia | (a == b)
    fin = ~(na | nb | ia | ib)
    ok[fin] &= (np.abs(b[fin] - a[fin])
                <= rtol * np.maximum(np.abs(a[fin]), scale))
    return ok


def assert_close(a, b, rtol, scale=0.0, ctx=""):
    ok = _close(a, b, rtol, scale)
    idx = np.flatnonzero(~ok)
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    assert len(idx) == 0, (ctx, [(int(i), a[i], b[i]) for i in idx[:5]])


def _col_host(c, n):
    """A column's first n values: enum codes (int64), floats, or host
    strings with NA as None."""
    if c.data is None:
        return "str", _host_strings(list(c.host_data[:n]))
    d = c.data
    arr = (np.asarray(d)[:n] if not hasattr(d, "cpu")
           else d.cpu().numpy()[:n])
    if c.ctype == "enum":
        return "enum", arr.astype(np.int64)
    return "num", arr.astype(np.float32)


def assert_same(j, t, rtol=None, scale=0.0, ctx="", zero_sign=True):
    """A reference result and a port result agree: frames in names,
    types, domains and values; lists and scalars in values. rtol None
    means bit for bit (any NaN equal to any NaN); else within
    rtol * max(|ref|, scale). zero_sign=False reads -0 as +0: the
    reference's row gathers on its 8-device test mesh sum the shards'
    parts, and -0 + 0 is +0."""
    from h2o3_tpu.core.frame import Frame as JFrame

    if isinstance(j, JFrame):
        assert j.names == t.names, (ctx, j.names, t.names)
        assert j.nrows == t.nrows, (ctx, j.nrows, t.nrows)
        assert j.types == t.types, (ctx, j.types, t.types)
        for nm in j.names:
            jc, tc = j.col(nm), t.col(nm)
            assert (jc.domain or None) == (tc.domain or None), \
                (ctx, nm, jc.domain, tc.domain)
            kj, a = _col_host(jc, j.nrows)
            kt, b = _col_host(tc, t.nrows)
            assert kj == kt, (ctx, nm, kj, kt)
            if kj != "num":
                assert list(a) == list(b), (ctx, nm)
            elif rtol is not None:
                assert_close(a, b, rtol, scale, (ctx, nm))
            elif not zero_sign:
                assert_bitwise(a + np.float32(0), b + np.float32(0),
                               (ctx, nm))
            else:
                assert_bitwise(a, b, (ctx, nm))
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), (ctx, j, t)
        for x, y in zip(j, t):
            assert_same(x, y, rtol, scale, ctx, zero_sign)
        return
    if isinstance(j, str):
        assert j == t, (ctx, j, t)
        return
    if rtol is None:
        assert_bitwise(np.float64(j), np.float64(t), ctx)
    else:
        assert_close(j, t, rtol, scale, ctx)


# ---------------------------------------------------------------------------
# export and explanation: fixtures and what the tests compare
# ---------------------------------------------------------------------------

def family_cols(kind, n=256, seed=11):
    """The flagship's 8 numeric and 2 enum features, with a response:
    bin (Y/N), multi (a/b/c), reg, count (Poisson counts), none; or
    words (one enum column of words), surv (x1, x2, time, event)."""
    rng = np.random.default_rng(seed)
    if kind == "words":
        w = np.asarray(["alpha", "beta", "gamma", "delta"])[
            rng.integers(0, 4, 4 * n)]
        return {"w": (w, "enum")}
    if kind == "surv":
        x1, x2 = rng.normal(size=n), rng.normal(size=n)
        t = rng.exponential(1.0 / np.exp(0.8 * x1 - 0.5 * x2))
        ev = np.where(rng.random(n) < 0.8, "1", "0")
        return {"x1": (x1, None), "x2": (x2, None), "time": (t, None),
                "event": (ev, "enum")}
    cols = flagship_cols(n, seed=seed)
    x0, x1 = cols["n0"][0], cols["n1"][0]
    if kind == "multi":
        k = np.digitize(x0 + 0.5 * rng.standard_normal(n), [-0.5, 0.5])
        cols["y"] = (np.array(["a", "b", "c"], object)[k], "enum")
    elif kind == "reg":
        cols["y"] = (1.5 * x0 - x1 + 0.3 * rng.standard_normal(n), None)
    elif kind == "count":
        cols["y"] = (rng.poisson(np.exp(0.3 * x0)).astype(float), None)
    elif kind == "none":
        del cols["y"]
    return cols


def model_outputs(model, fr, what, n):
    """The compared values as host arrays: every column of predict (or
    transform), enum columns as their codes."""
    out = model.predict(fr) if what == "predict" else model.transform(fr)
    res = {}
    for nm in out.names:
        c = out.col(nm)
        d = c.data
        arr = d.cpu().numpy() if hasattr(d, "cpu") else np.asarray(d)
        res[nm] = arr[:n]
    return res


def mojo_parts(blob):
    """A zip's entries: {name: bytes}."""
    import io
    import zipfile

    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {n: z.read(n) for n in z.namelist()}
