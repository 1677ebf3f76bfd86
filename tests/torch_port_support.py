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
