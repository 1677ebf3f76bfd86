"""Word2Vec: SkipGram or CBOW embeddings trained with negative sampling
(counterpart of h2o3_tpu/models/word2vec.py: `find_synonyms` :44,
`transform` :65, `to_frame` :96, `_fit` :132, the vocabulary and
subsampling :141-176, pair generation :178-215, the SGD step :241-280,
the epoch loop :286-290).

The host builds the vocabulary (words at or above min_word_freq, by
decreasing count, ties in first-seen order), subsamples frequent words
with the reference's numpy Generator draws (one per in-vocabulary word,
in corpus order) and makes the (center, context) pairs of each
NA-delimited sentence, or CBOW's context windows. Training runs on the
device, one step per batch of 1024 pairs as the reference's `lax.scan`
runs them: the step's keys come from the host walk of key <- split(key,
3) (native.split_chain), and a chunk of steps' pair rows (`randint`)
and negatives (`choice_p` over the unigram^0.75 table, whose float32
cumulative sum is taken once on the host in the reference's order) is
drawn at once, bit for bit as jax.random draws them. A step gathers the
input and output vectors, takes the sigmoid gradient and scatter-adds
the updates (index_add_). Synonyms, word vectors and `transform` are
host numpy over the trained vectors.
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch import native
from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register

BATCH = 1024
# bytes of one chunk's draws (pair rows and negatives, int64 and float32
# working copies)
CHUNK_BYTES = 64 * 1024 * 1024


def _is_break(w) -> bool:
    return w is None or w != w or w == ""


class Word2VecModel(Model):
    algo_name = "word2vec"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.vocab: Dict[str, int] = {}
        self.vectors: Optional[np.ndarray] = None   # (V, dim)

    def find_synonyms(self, word: str, count: int = 20) -> Dict[str, float]:
        """The `count` words of largest cosine similarity to `word`."""
        if word not in self.vocab:
            return {}
        V = self.vectors
        q = V[self.vocab[word]]
        sims = V @ q / (np.linalg.norm(V, axis=1) * np.linalg.norm(q) + 1e-12)
        order = np.argsort(sims)[::-1]
        words = list(self.vocab)
        out = {}
        for i in order:
            if words[i] == word:
                continue
            out[words[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def word_vec(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.get(word)
        return self.vectors[i] if i is not None else None

    def transform(self, frame: Frame, aggregate_method: str = "NONE"
                  ) -> Frame:
        """Embed a one-word-per-row string frame: a vector per row (NA for
        unknown words), or with AVERAGE the mean vector of each
        NA-terminated sequence."""
        c0 = frame.col(0)
        words = c0.host_data if c0.is_string else c0.values()
        dim = self.vectors.shape[1]
        if aggregate_method.upper() == "NONE":
            out = np.full((len(words), dim), np.nan, np.float32)
            for r, w in enumerate(words):
                i = self.vocab.get(w) if w is not None else None
                if i is not None:
                    out[r] = self.vectors[i]
        else:  # AVERAGE
            rows, acc, cnt = [], np.zeros(dim), 0
            for w in words:
                if _is_break(w):
                    rows.append(acc / cnt if cnt else np.full(dim, np.nan))
                    acc, cnt = np.zeros(dim), 0
                    continue
                i = self.vocab.get(w)
                if i is not None:
                    acc = acc + self.vectors[i]
                    cnt += 1
            if cnt or not rows:
                rows.append(acc / cnt if cnt else np.full(dim, np.nan))
            out = np.asarray(rows, np.float32)
        fr = Frame()
        for j in range(dim):
            fr.add(f"C{j+1}", Column.from_numpy(out[:, j]))
        return fr

    def to_frame(self) -> Frame:
        """The vocabulary and its vectors as a frame."""
        fr = Frame()
        fr.add("Word", Column.from_numpy(np.asarray(list(self.vocab),
                                                    object)))
        for j in range(self.vectors.shape[1]):
            fr.add(f"V{j+1}", Column.from_numpy(self.vectors[:, j]))
        return fr

    def _predict_raw(self, frame: Frame):
        from h2o3_tpu_torch.errors import CapabilityGate

        raise CapabilityGate("use transform()/find_synonyms()")

    def _make_metrics(self, frame, raw, extra_weight=None):
        return None


def _corpus(words, counts: Dict, vocab: Dict[str, int],
            keep_prob: np.ndarray, rng):
    """The subsampled corpus of vocabulary codes and its sentence
    starts: one uniform draw per in-vocabulary word in corpus order, the
    word kept when the draw is below its keep probability; an NA word
    (any word not in `counts`) ends a sentence."""
    code = {w: vocab.get(w, -1) for w in counts}
    codes = np.fromiter(map(code.get, words, itertools.repeat(-2)),
                        np.int64, len(words))
    inv = codes >= 0
    kept = np.zeros(len(codes), bool)
    kept[inv] = rng.random(int(inv.sum())) < keep_prob[codes[inv]]
    corpus = codes[kept].astype(np.int32)
    # a break lands at the count of words kept before it
    at = np.cumsum(kept)[codes == -2] - kept[codes == -2]
    breaks = [0] + [int(b) for b in np.unique(at) if b > 0]
    if len(corpus) > breaks[-1]:
        breaks.append(len(corpus))
    return corpus, breaks


@register
class Word2Vec(ModelBuilder):
    algo_name = "word2vec"
    model_class = Word2VecModel
    supervised = False

    def _score_on(self, model, frame):
        return None      # embeddings have no frame metrics

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "vec_size": 100,
            "window_size": 5,
            "epochs": 5,
            "min_word_freq": 5,
            "init_learning_rate": 0.025,
            "sent_sample_rate": 1e-3,
            "negative_samples": 5,     # in place of hierarchical softmax
            "word_model": "SkipGram",
        })
        return p

    def _fit(self, train: Frame) -> Word2VecModel:
        p = self.params
        col = train.col(0)
        words = col.host_data if col.is_string else col.values()
        seed = self._seed()
        rng = np.random.default_rng(seed)

        min_freq = int(p.get("min_word_freq", 5))
        # words in first-seen order, so count ties keep it
        counts = collections.Counter(words)
        for w in [w for w in counts if _is_break(w)]:
            del counts[w]
        vocab = {w: i for i, (w, c) in enumerate(
            sorted(counts.items(), key=lambda kv: -kv[1])) if c >= min_freq}
        if not vocab:
            raise ValueError("no words above min_word_freq")
        V = len(vocab)
        freqs = np.zeros(V)
        for w, i in vocab.items():
            freqs[i] = counts[w]
        total = freqs.sum()
        # frequent-word subsampling (word2vec's sent_sample_rate)
        t = float(p.get("sent_sample_rate", 1e-3)) or 1.0
        keep_prob = np.minimum(1.0, np.sqrt(t * total / freqs)
                               + t * total / freqs)
        corpus, breaks = _corpus(words, counts, vocab, keep_prob, rng)

        window = int(p.get("window_size", 5))
        cbow = (p.get("word_model") or "SkipGram").lower() == "cbow"
        if cbow:
            # per corpus position, the up-to-2w context codes, -1 padded
            ctx_rows, cen_rows = [], []
            for s, e in zip(breaks[:-1], breaks[1:]):
                sent = corpus[s:e]
                L = len(sent)
                if L < 2:
                    continue
                C = np.full((L, 2 * window), -1, np.int32)
                for off in range(1, window + 1):
                    if L > off:
                        C[off:, off - 1] = sent[:-off]
                        C[:-off, window + off - 1] = sent[off:]
                ctx_rows.append(C)
                cen_rows.append(sent)
            if not ctx_rows:
                raise ValueError("corpus has no CBOW windows")
            centers_a = np.concatenate(cen_rows)
            ctx_a = np.concatenate(ctx_rows, axis=0)
        else:
            centers, contexts = [], []
            for s, e in zip(breaks[:-1], breaks[1:]):
                sent = corpus[s:e]
                L = len(sent)
                for off in range(1, window + 1):
                    if L > off:
                        centers.append(sent[:-off])
                        contexts.append(sent[off:])
                        centers.append(sent[off:])
                        contexts.append(sent[:-off])
            if not centers:
                raise ValueError("corpus has no co-occurrence pairs (check "
                                 "window/min_word_freq)")
            centers_a = np.concatenate(centers)
            ctx_a = np.concatenate(contexts)

        dim = int(p.get("vec_size", 100))
        neg = int(p.get("negative_samples", 5))
        lr0 = float(p.get("init_learning_rate", 0.025))
        epochs = int(p.get("epochs", 5))
        n_pairs = len(centers_a)
        steps = max(n_pairs // BATCH, 1)

        from h2o3_tpu_torch.core.runtime import cluster

        dev = cluster().device
        ns = freqs ** 0.75
        p_cuml = torch.as_tensor(
            rnd.cumsum_f32((ns / ns.sum()).astype(np.float32)), device=dev)
        Win = torch.as_tensor(rng.uniform(-0.5 / dim, 0.5 / dim, (V, dim)),
                              dtype=torch.float32, device=dev)
        Wout = torch.zeros((V, dim), dtype=torch.float32, device=dev)
        cen_d = torch.as_tensor(centers_a, dtype=torch.int64, device=dev)
        ctx_d = torch.as_tensor(ctx_a, dtype=torch.int64, device=dev)
        labels = torch.zeros((1, 1 + neg), dtype=torch.float32, device=dev)
        labels[0, 0] = 1.0
        chunk = max(1, min(steps, CHUNK_BYTES // (BATCH * (1 + neg) * 24)))
        key = rnd.PRNGKey(seed)
        for ep in range(epochs):
            lr = np.float32(lr0 * max(1.0 - ep / max(epochs, 1), 1e-2))
            sub, key = native.split_chain(key, steps, 3)
            for c0 in range(0, steps, chunk):
                ks = sub[c0:c0 + chunk].to(dev)
                idx = rnd.randint(ks[:, 0], (BATCH,), 0, n_pairs).long()
                negs = rnd.choice_p(ks[:, 1], (BATCH, neg), p_cuml)
                for s in range(idx.shape[0]):
                    _sgd_step(Win, Wout, cen_d, ctx_d, idx[s], negs[s],
                              labels, float(lr), cbow)
            if self.job:
                self.job.update(progress=(ep + 1) / epochs,
                                msg=f"epoch {ep + 1}")

        model = Word2VecModel(parms=dict(p))
        model._output.model_category = ModelCategory.WordEmbedding
        model.vocab = vocab
        model.vectors = Win.cpu().numpy()
        return model


def _sgd_step(Win, Wout, cen_d, ctx_d, idx, negs, labels, lr: float,
              cbow: bool) -> None:
    """One negative-sampling step over a batch of pair rows `idx`, in
    place: the logistic loss's gradient on the positive target and the
    negatives, scaled by lr, subtracted from the input vectors (spread
    over CBOW's context words) and from the output vectors."""
    dim = Win.shape[1]
    if cbow:
        ctx = ctx_d[idx]                                   # (B, 2w)
        mask = (ctx >= 0).float()
        cnt = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
        h = (Win[torch.clamp_min(ctx, 0)] * mask[:, :, None]).sum(dim=1) / cnt
        pos = cen_d[idx]
    else:
        h = Win[cen_d[idx]]                                # (B, d)
        pos = ctx_d[idx]
    tgt = torch.cat([pos[:, None], negs], dim=1)           # (B, 1+neg)
    out = Wout[tgt]                                        # (B, 1+neg, d)
    scores = torch.einsum("bd,bkd->bk", h, out)
    g = (torch.sigmoid(scores) - labels) * lr
    grad_h = torch.einsum("bk,bkd->bd", g, out)
    grad_out = torch.einsum("bk,bd->bkd", g, h)
    if cbow:
        # a padded slot's weight is 0, so its row (the last) adds 0
        gctx = grad_h[:, None, :] * (mask / cnt)[:, :, None]
        rows = torch.where(ctx >= 0, ctx, Win.shape[0] - 1).reshape(-1)
        Win.index_add_(0, rows, -gctx.reshape(-1, dim))
    else:
        Win.index_add_(0, cen_d[idx], -grad_h)
    Wout.index_add_(0, tgt.reshape(-1), -grad_out.reshape(-1, dim))
