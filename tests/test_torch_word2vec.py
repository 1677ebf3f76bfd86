"""Word2Vec in the port (on the CPU) against the JAX package: the
vocabulary, the subsampled corpus and the pairs equal; each step's pair
rows and negatives bit for bit those jax.random draws (the key chain,
`randint`, and `choice` with weights through `core.random.choice_p`,
its cumulative sum taken in XLA's CPU order); the trained vectors of
SkipGram and CBOW atol 1e-5 (the steps' einsums and scatter-adds sum
in a different order); synonyms, `transform` and `to_frame`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import native
from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.models import word2vec as w2v

from torch_port_support import both_frames


def zipf_words(n=6000, V=200, seed=0, every=25):
    """A seeded Zipf corpus over V words, an NA every `every` words."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, n), V) - 1
    words = np.array([f"w{r}" for r in ranks], object)
    words[::every] = None
    return words


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 257, 4097, 10000])
def test_cumsum_f32_is_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    p = rng.random(n).astype(np.float32) ** 3
    p = (p / p.sum()).astype(np.float32)
    np.testing.assert_array_equal(rnd.cumsum_f32(p),
                                  np.asarray(jnp.cumsum(jnp.asarray(p))))


@pytest.mark.parametrize("V,shape", [(5, (7,)), (300, (64, 5)),
                                     (2000, (1024, 5))])
def test_choice_p_is_jax_choice(V, shape):
    rng = np.random.default_rng(V)
    f = rng.zipf(1.5, V).astype(float)
    f[::7] = 0.0                     # zero weights are never drawn
    ns = f ** 0.75
    p = jnp.asarray(ns / ns.sum(), jnp.float32)
    pc = torch.as_tensor(rnd.cumsum_f32(np.asarray(p)))
    for seed in (0, 3):
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), V,
                                            shape, p=p))
        got = rnd.choice_p(rnd.PRNGKey(seed), shape, pc).numpy()
        np.testing.assert_array_equal(got, want)
        assert (np.asarray(p)[got] > 0).all()


def test_step_draws_are_the_references(cl):
    """The reference's scan body draws key, k1, k2 = split(key, 3),
    randint(k1, (1024,), 0, n_pairs), choice(k2, V, (1024, 5), p); the
    port draws a chunk of steps at once from the host key chain."""
    V, n_pairs, steps, seed = 500, 123_457, 6, 17
    f = np.random.default_rng(2).zipf(1.4, V).astype(float) ** 0.75
    p = jnp.asarray(f / f.sum(), jnp.float32)

    @jax.jit
    def ref(key):
        def body(key, _):
            key, k1, k2 = jax.random.split(key, 3)
            return key, (jax.random.randint(k1, (w2v.BATCH,), 0, n_pairs),
                         jax.random.choice(k2, V, (w2v.BATCH, 5), p=p))
        return jax.lax.scan(body, key, jnp.arange(steps))

    kj, (idx_j, negs_j) = ref(jax.random.PRNGKey(seed))
    sub, kt = native.split_chain(rnd.PRNGKey(seed), steps, 3)
    idx_t = rnd.randint(sub[:, 0], (w2v.BATCH,), 0, n_pairs)
    pc = torch.as_tensor(rnd.cumsum_f32(np.asarray(p)))
    negs_t = rnd.choice_p(sub[:, 1], (w2v.BATCH, 5), pc)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(negs_t.numpy(), np.asarray(negs_j))
    np.testing.assert_array_equal(
        kt.numpy(), np.asarray(jax.random.key_data(kj)
                               if jnp.issubdtype(kj.dtype, jax.dtypes.prng_key)
                               else kj).astype(np.int64))


def fit_both(words, **kw):
    from h2o3_tpu.models.word2vec import Word2Vec as JW

    jf, tf = both_frames({"w": (words, None)})
    jm = JW(**kw).train(training_frame=jf)
    tm = th.Word2Vec(**kw).train(training_frame=tf)
    return jm, tm, jf, tf


@pytest.mark.parametrize("word_model", ["SkipGram", "CBOW"])
def test_vectors_match_jax(cl, word_model):
    kw = dict(vec_size=16, epochs=2, min_word_freq=3, seed=4,
              window_size=3, word_model=word_model)
    jm, tm, jf, tf = fit_both(zipf_words(), **kw)
    assert list(tm.vocab.items()) == list(jm.vocab.items())
    np.testing.assert_allclose(tm.vectors, jm.vectors, atol=1e-5)
    assert tm._output.model_category == "WordEmbedding"
    assert tm._output.training_metrics is None


def test_synonyms_transform_and_frame_match_jax(cl):
    jm, tm, jf, tf = fit_both(zipf_words(seed=1), vec_size=16, epochs=3,
                              min_word_freq=3, seed=2, window_size=2)
    js, ts = jm.find_synonyms("w1", 5), tm.find_synonyms("w1", 5)
    assert list(ts) == list(js)
    np.testing.assert_allclose(list(ts.values()), list(js.values()),
                               atol=1e-4)
    assert tm.find_synonyms("nope") == {}
    words = np.array(["w0", "w3", None, "nope", "w1", None, "w2"], object)
    jq, tq = both_frames({"w": (words, None)})
    for agg in ("NONE", "AVERAGE"):
        a, b = jm.transform(jq, agg), tm.transform(tq, agg)
        assert a.names == b.names and a.nrows == b.nrows
        for nm in a.names:
            np.testing.assert_allclose(b.col(nm).data.numpy(),
                                       np.asarray(a.col(nm).data)[:a.nrows],
                                       atol=1e-5)
    fr = tm.to_frame()
    assert fr.names[0] == "Word" and fr.nrows == len(tm.vocab)
    assert list(fr.col("Word").host_data) == list(tm.vocab)


def planted_words(n_sent=4000, V=100, seed=1):
    """Zipf sentences of 8 words; in a fifth of them "alpha" or "beta"
    (one or the other at random) sits between "w7" and "w8"."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.3, n_sent * 8), V) - 1
    words = np.array([f"w{r}" for r in ranks], object).reshape(n_sent, 8)
    rows = rng.random(n_sent) < 0.2
    twin = np.where(rng.random(n_sent) < 0.5, "alpha", "beta")
    words[rows, 3] = twin[rows]
    words[rows, 2], words[rows, 4] = "w7", "w8"
    return np.concatenate([words, np.full((n_sent, 1), None, object)],
                          axis=1).ravel()


def test_planted_synonyms_rank_first(cl):
    """Two words that stand in for each other in the same contexts end
    up nearest neighbours."""
    _, tf = both_frames({"w": (planted_words(), None)})
    m = th.Word2Vec(vec_size=16, epochs=5, min_word_freq=3, seed=1,
                    window_size=2).train(training_frame=tf)
    assert list(m.find_synonyms("alpha", 10))[0] == "beta"


@pytest.mark.gpu
@pytest.mark.parametrize("cbow", [False, True])
def test_c24_card_steps_part_from_the_cpu_by_rounding(cbow, monkeypatch):
    """ROADMAP C24: one SGD step on the card from the CPU's vectors and
    draws updates each vector within 64 ulp-units of the sum of |terms|
    that its row's scatter-add adds (the card adds a row's repeated
    updates in the order its atomics land, and its einsums sum in
    cuBLAS's order); over a 20k-token epoch the vectors drift apart by
    that rounding, within 1e-4, the bar of chip_smoke.py's phase 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    V, dim, B, neg, win = 400, 100, w2v.BATCH, 5, 2
    ranks = np.minimum(rng.zipf(1.3, 6000), V) - 1   # repeated rows
    cen = ranks.astype(np.int64)
    ctx = (np.minimum(rng.zipf(1.3, (6000, 2 * win)), V + 1) - 2)
    ctx = ctx if cbow else ctx[:, 0].clip(0)
    idx = rng.integers(0, 6000, B)
    negs = rng.integers(0, V, (B, neg))
    Win0 = ((rng.random((V + 1, dim)) - 0.5) / dim).astype(np.float32)
    Win0[-1] = 0
    Wout0 = (rng.random((V, dim)) * 0.1).astype(np.float32)
    labels = np.zeros((1, 1 + neg), np.float32)
    labels[0, 0] = 1
    out = {}
    for dev in ("cpu", "cuda"):
        t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
            Win=Win0.copy(), Wout=Wout0.copy(), cen=cen, ctx=ctx, idx=idx,
            negs=negs, labels=labels).items()}
        w2v._sgd_step(t["Win"], t["Wout"], t["cen"], t["ctx"], t["idx"],
                      t["negs"], t["labels"], 0.025, cbow)
        out[dev] = (t["Win"].cpu().numpy(), t["Wout"].cpu().numpy())
    # each entry's sum of |terms| that the step adds, in float64 on the
    # CPU: the same step with every scatter-add also adding |terms|
    w = [torch.as_tensor(Win0, dtype=torch.float64),
         torch.as_tensor(Wout0, dtype=torch.float64)]
    mag = [torch.zeros_like(w[0]), torch.zeros_like(w[1])]
    add = torch.Tensor.index_add_

    def index_add_(self, dim, index, source):
        k = 0 if self is w[0] else 1
        add(mag[k], dim, index, source.abs())
        return add(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_add_", index_add_)
    w2v._sgd_step(w[0], w[1], torch.as_tensor(cen), torch.as_tensor(ctx),
                  torch.as_tensor(idx), torch.as_tensor(negs),
                  torch.as_tensor(labels, dtype=torch.float64), 0.025, cbow)
    monkeypatch.undo()
    for k, W0 in enumerate((Win0, Wout0)):
        bound = 64 * 2.0**-24 * (np.abs(W0) + mag[k].numpy())
        diff = np.abs(out["cuda"][k].astype(np.float64) - out["cpu"][k])
        assert (diff <= bound).all(), float((diff - bound).max())
    print("entries that differ after one step:",
          [int((out["cuda"][k] != out["cpu"][k]).sum()) for k in (0, 1)])
    words = zipf_words(n=20_000, V=2000, seed=9, every=10_000)
    m = {}
    for dev in ("cpu", "cuda"):
        th.init(device=dev)
        fr = th.Frame({"w": th.Column.from_numpy(words, device=dev)})
        m[dev] = th.Word2Vec(vec_size=100, epochs=1, seed=1,
                             word_model="CBOW" if cbow else "SkipGram"
                             ).train(training_frame=fr)
    assert list(m["cpu"].vocab) == list(m["cuda"].vocab)
    np.testing.assert_allclose(m["cuda"].vectors, m["cpu"].vectors,
                               atol=1e-4, rtol=0)
