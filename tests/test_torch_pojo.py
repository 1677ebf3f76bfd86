"""The port's POJO export (models/pojo.py) against the JAX package's.

Each model is trained by the port on the CPU and reaches the JAX package
through the native MOJO (the same forest or coefficients, bit for bit),
so both packages generate the source of one model. The sources are equal
character for character once the class name, which each package derives
from its own model key, is replaced by one placeholder. Algorithms
without a POJO raise in both.
"""

import re

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.models import mojo, pojo

from torch_port_support import both_frames, family_cols

MODELS = {
    "gbm_binomial": ("bin", lambda fr: th.GBM(
        ntrees=3, max_depth=3, seed=1).train(y="y", training_frame=fr)),
    "gbm_multinomial": ("multi", lambda fr: th.GBM(
        ntrees=2, max_depth=3, seed=1).train(y="y", training_frame=fr)),
    "gbm_poisson": ("count", lambda fr: th.GBM(
        ntrees=3, max_depth=3, seed=1, distribution="poisson").train(
        y="y", training_frame=fr)),
    "drf_binomial": ("bin", lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=2).train(y="y", training_frame=fr)),
    "drf_double_trees": ("bin", lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=2, binomial_double_trees=True).train(
        y="y", training_frame=fr)),
    "drf_regression": ("reg", lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=2).train(y="y", training_frame=fr)),
    "isolationforest": ("none", lambda fr: th.IsolationForest(
        ntrees=4, seed=1).train(training_frame=fr)),
    "glm_binomial": ("bin", lambda fr: th.GLM(family="binomial").train(
        y="y", training_frame=fr)),
    "glm_gaussian": ("reg", lambda fr: th.GLM(family="gaussian").train(
        y="y", training_frame=fr)),
    "glm_poisson": ("count", lambda fr: th.GLM(family="poisson").train(
        y="y", training_frame=fr)),
    "glm_multinomial": ("multi", lambda fr: th.GLM(
        family="multinomial").train(y="y", training_frame=fr)),
}


def _normalised(src: str, model) -> str:
    name = re.sub(r"\W", "_", str(model.key))
    return src.replace(str(model.key), "MODEL").replace(name, "MODEL")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pojo_source_equals_the_reference(name):
    from h2o3_tpu.models import mojo as jmojo
    from h2o3_tpu.models.pojo import pojo_source as jpojo

    kind, train = MODELS[name]
    _, tf = both_frames(family_cols(kind))
    pm = train(tf)
    rm = jmojo.read_mojo(mojo.export_mojo_bytes(pm))
    got = _normalised(pojo.pojo_source(pm), pm)
    want = _normalised(jpojo(rm), rm)
    assert got == want, name
    assert "public class MODEL {" in got
    assert "score0(double[] row, double[] preds)" in got
    if name.startswith(("gbm", "drf", "isolation")):
        assert got.count("},{") >= pm.forest.n_trees - 1


def test_pojo_names_every_tree_of_the_flagship_shape():
    """A 20-tree GBM's FEAT table holds 20 rows."""
    _, tf = both_frames(family_cols("bin"))
    m = th.GBM(ntrees=20, max_depth=3, seed=1).train(y="y",
                                                     training_frame=tf)
    src = pojo.pojo_source(m)
    feat = re.search(r"static final int\[\]\[\] FEAT = \{(.*)\};", src)
    rows = re.findall(r"\{[^{}]*\}", feat.group(1))
    assert len(rows) == m.forest.n_trees == 20


@pytest.mark.parametrize("algo", ["xgboost", "kmeans"])
def test_pojo_refuses_what_the_reference_refuses(algo):
    from h2o3_tpu.models import mojo as jmojo
    from h2o3_tpu.models.pojo import pojo_source as jpojo

    _, tf = both_frames(family_cols("bin"))
    m = (th.XGBoost(ntrees=2, max_depth=2, seed=1, nbins=16).train(
        y="y", training_frame=tf) if algo == "xgboost"
        else th.KMeans(k=2, seed=1).train(training_frame=tf))
    with pytest.raises(ValueError) as port_err:
        pojo.pojo_source(m)
    with pytest.raises(ValueError) as ref_err:
        jpojo(jmojo.read_mojo(mojo.export_mojo_bytes(m)))
    assert str(port_err.value) == str(ref_err.value)
    assert np.isfinite(m.predict(tf).col("predict").to_numpy()
                       .astype(float)).all()
