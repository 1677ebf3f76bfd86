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
               "nclasses": fo.nclasses, "init_class": fo.init_class}
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
