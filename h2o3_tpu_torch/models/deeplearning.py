"""DeepLearning: a multilayer perceptron trained by minibatch SGD
(counterpart of h2o3_tpu/models/deeplearning.py: `_activation_fn` :35,
`_forward` :52, `DeepLearningModel` :78-160, `DeepLearning` defaults
:173-201, `_fit` :208-505, `_init_params` :508, `_garson_importance`
:532).

The network, losses, regularisation, optimizers (ADADELTA, or SGD with
an annealed rate and optional momentum, optim/sgd.py) and every random
draw are the reference's: weights from numpy's `default_rng(seed)`, and
per minibatch `key, kidx, kdrop = split(key, 3)`, the batch's rows
`randint(kidx, (batch,), 0, n)` and the dropout masks from kdrop, in the
reference's key order (core/random.py, bit for bit with jax.random).
Gradients come from torch.autograd. The reference's rows are padded to
its mesh and it draws over the padded length (pad rows weigh 0); the
port has no padding and draws over n, so the two draw the same rows
only when n is a multiple of the reference's padding (ROADMAP C13).

The step loop. An epoch at the reference's defaults on a million rows
is 31,250 steps of tiny work (a 32-row batch through a 200-200 net), so
launching the ops of each step one by one would leave the card waiting
on the host. Instead:
- the key chain (one split a step, each key made from the one before)
  is walked on the host in C++ (native.split_chain, csrc/threefry.cpp);
- each chunk of steps' batch rows and dropout masks are drawn on the
  device in one vectorised Threefry call per draw, into fixed buffers;
- one step (gather the batch, forward, loss, backward, the optimizer
  update, advance the slot counter) is captured once in a CUDA graph and
  replayed once a step, reading its row of the buffers through a device
  counter, so no step touches the host.
On the CPU the same step function runs eagerly; on the card the two
give the same weights bit for bit (`DeepLearning._force_eager` runs the
eager loop there for that check). A graph that fails to capture raises:
there is no fallback.

Across ranks (a row-sharded cloud), both of the reference's paths:
- **Synchronous** (the default): every rank draws the same global
  batch rows from the same key chain. Once per chunk, before the
  chunk's replays, the drawn rows are fetched from the ranks that hold
  them (one all-gather of each rank's share) into fixed chunk buffers,
  and the step reads its batch from those through the same device
  counter: no exchange per step, and the graph is the one-process
  graph. The weights are one process's bit for bit; the fetched rows
  are counted in ``dl_batch_rows``.
- **Model averaging** (`train_samples_per_iteration` > batch × N, the
  reference's :377-433): each epoch's key is split once, each rank
  walks `fold_in(sub, rank)`'s chain for `avg_period` local steps on
  its own rows, then the weights and the optimizer's float moments are
  all-reduced to their mean (SGD's step count, the reference's integer
  leaf, is left alone); ceil(steps / avg_period) such rounds an epoch.
In one process the parameter is read as the reference reads it on one
device (no averaging). The training loss that scoring history and early
stopping read is the fixed-point mean over every row (the same bits in
one process and across ranks).

Durable job progress (reference :170, :457-489): every
``H2O_TPU_JOB_CKPT_ITERS`` epochs the weights, the optimizer's state,
the live key and the histories are saved as host arrays. A resumed
train copies them into the step loop's own tensors before its first
step (the CUDA graph reads those addresses, so they are never rebound)
and walks the key chain on from the saved key.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.optim.sgd import SGD, Adadelta

ACTIVATIONS = ("tanh", "tanhwithdropout", "rectifier", "rectifierwithdropout",
               "maxout", "maxoutwithdropout")

# steps run by each loop since the counts were last set to 0: graph
# replays, and eager calls of the step function
graph_replays = 0
eager_steps = 0

# bytes of per-step draws (batch rows, dropout masks) one chunk may hold
CHUNK_BYTES = 1 << 26


def _activation_fn(name: str):
    base = name.replace("withdropout", "")
    if base == "tanh":
        return torch.tanh
    if base == "rectifier":
        return torch.relu
    if base == "maxout":
        # the reference's two-piece stand-in for maxout: max(x, 0.5x)
        return lambda x: torch.maximum(x, 0.5 * x)
    raise ValueError(f"unknown activation {name!r}")


def _forward(params, X, activation: str, masks=None, input_dropout=0.0,
             hidden_dropout=()):
    """MLP forward: the last layer's linear output. masks (training
    only): [input mask or None, then one per hidden layer or None]; a
    kept unit is scaled by 1 / (1 - rate)."""
    act = _activation_fn(activation)
    h = X
    if masks is not None and masks[0] is not None:
        h = torch.where(masks[0], h / (1.0 - input_dropout), 0.0)
    for li, (W, b) in enumerate(params[:-1]):
        h = act(h @ W + b)
        if masks is not None and masks[li + 1] is not None:
            h = torch.where(masks[li + 1], h / (1.0 - hidden_dropout[li]),
                            0.0)
    W, b = params[-1]
    return h @ W + b


def _dropout_rates(widths: List[int], input_dropout: float,
                   hidden_dropout) -> List[float]:
    """The dropout rate of the input and of each hidden layer (0 past
    the end of hidden_dropout)."""
    return [input_dropout] + [hidden_dropout[i] if i < len(hidden_dropout)
                              else 0.0 for i in range(len(widths) - 1)]


def dropout_masks(kdrop: torch.Tensor, batch: int, widths: List[int],
                  input_dropout: float, hidden_dropout) -> List:
    """The masks of one step (kdrop a (2,) key) or of a chunk of steps
    (kdrop (S, 2): masks (S, batch, width)), drawn as the reference's
    `_forward` draws them: for the input and then each hidden layer whose
    rate is > 0, `key, sub = split(key)` and bernoulli(sub, 1 - rate).
    widths = [inputs, hidden...]; entries for layers without dropout are
    None."""
    out, key = [], kdrop
    for rate, width in zip(_dropout_rates(widths, input_dropout,
                                          hidden_dropout), widths):
        if rate > 0:
            ks = rnd.split(key, 2)
            key, sub = ks[..., 0, :], ks[..., 1, :]
            out.append(rnd.bernoulli(sub, 1.0 - rate, (batch, width)))
        else:
            out.append(None)
    return out


def make_loss(*, activation: str, autoencoder: bool, nclasses: int,
              loss: str, l1: float, l2: float, input_dropout: float,
              hidden_dropout, device):
    """The training objective as the reference's `loss_fn` (:328-351):
    loss_fn(flat params [W1, b1, W2, ...], xb, yb, wb, masks) -> the
    weighted mean per-row loss (reconstruction MSE, cross-entropy, or
    quadratic / absolute / huber) plus l1 · sum|W| + l2 / 2 · sum W² over
    the weight matrices. masks None means no dropout."""
    classes = torch.arange(max(nclasses, 1), device=device)

    def per_row_loss(flat, xb, yb, masks):
        pairs = list(zip(flat[0::2], flat[1::2]))
        out = _forward(pairs, xb, activation, masks, input_dropout,
                       hidden_dropout)
        if autoencoder:
            return torch.mean((out - xb) ** 2, dim=-1)
        if nclasses > 1:
            # the label's log-probability: a select and a sum, so the
            # backward has no scatter
            logp = torch.log_softmax(out, dim=-1)
            return -torch.sum(torch.where(
                yb[:, None] == classes[None, :], logp, 0.0), dim=-1)
        f = out[:, 0]
        if loss == "absolute":
            return torch.abs(yb - f)
        if loss == "huber":
            d = torch.abs(yb - f)
            return torch.where(d <= 1.0, 0.5 * d * d, d - 0.5)
        return 0.5 * (yb - f) ** 2

    def reg(flat):
        out = 0.0
        for W in flat[0::2]:
            out = (out + l1 * torch.sum(torch.abs(W))
                   + (l2 * 0.5) * torch.sum(W * W))
        return out

    def loss_fn(flat, xb, yb, wb, masks):
        per_row = per_row_loss(flat, xb, yb, masks)
        data_loss = (torch.sum(per_row * wb)
                     / torch.clamp_min(torch.sum(wb), 1.0))
        if l1 > 0 or l2 > 0:
            return data_loss + reg(flat)
        return data_loss

    loss_fn.per_row = per_row_loss
    loss_fn.reg = reg if (l1 > 0 or l2 > 0) else None
    return loss_fn


def scored_loss(loss_fn, params, X, y, w, mesh=None) -> float:
    """The training loss scoring history and early stopping read: the
    weighted mean per-row loss over every row (fixed-point sums, over
    every rank of `mesh`) plus the regularisation."""
    from h2o3_tpu_torch.core.ops import fixed_point_sums

    with torch.no_grad():
        pr = loss_fn.per_row(params, X, y, None)
        nd = fixed_point_sums(torch.stack([pr * w, w], 1), mesh)
        out = (nd[0] / torch.clamp_min(nd[1], 1.0)).float()
        if loss_fn.reg is not None:
            out = out + loss_fn.reg(params)
    return float(out)


class DeepLearningModel(Model):
    algo_name = "deeplearning"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.params_tree: Optional[List] = None     # [(W, b), ...]
        self.data_info: Optional[DataInfo] = None
        self.activation: str = "rectifier"
        self.nclasses: int = 1
        self.autoencoder: bool = False
        self.epochs_trained: int = 0

    def _params_on(self, device) -> List:
        """The weights on `device`, moved there on first use (a model
        carried across keeps them on the host until it scores)."""
        if self.params_tree[0][0].device != device:
            self.params_tree = [(W.to(device), b.to(device))
                                for W, b in self.params_tree]
        return self.params_tree

    def _forward_frame(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        return X, _forward(self._params_on(X.device), X, self.activation)

    def _predict_raw(self, frame: Frame):
        with torch.no_grad():
            X, out = self._forward_frame(frame)
            if self.autoencoder:
                err = torch.mean((out - X) ** 2, dim=-1)
                return {"reconstruction": out, "score": err, "value": err}
            if self.nclasses > 1:
                return {"probs": torch.softmax(out, dim=-1)}
            return {"value": out[:, 0]}

    def _make_metrics(self, frame, raw, extra_weight=None):
        if not self.autoencoder:
            return super()._make_metrics(frame, raw, extra_weight)
        mse = float(np.nanmean(raw["score"].cpu().numpy()[:frame.nrows]))
        return M.ModelMetricsAutoEncoder(
            mse=mse, rmse=float(np.sqrt(mse)), nobs=float(frame.nrows),
            description="autoencoder reconstruction error")

    def anomaly(self, frame: Frame) -> Frame:
        """Each row's reconstruction MSE (autoencoder anomaly detection)."""
        raw = self._predict_raw(self.adapt_test(frame))
        out = Frame()
        out.add("Reconstruction.MSE", Column(raw["score"], T_NUM,
                                             frame.nrows))
        return out

    def deepfeatures(self, frame: Frame, layer: int) -> Frame:
        """Hidden layer `layer`'s activations (0 = the first hidden
        layer), one column DF.L<layer+1>.C<j> per unit."""
        di = self.data_info
        act = _activation_fn(self.activation)
        with torch.no_grad():
            h = di.expand(*(c.data for c in di.cols(self.adapt_test(frame))))
            for W, b in self._params_on(h.device)[:layer + 1]:
                h = act(h @ W + b)
        out = Frame()
        for j in range(h.shape[1]):
            out.add(f"DF.L{layer + 1}.C{j + 1}",
                    Column(h[:, j].contiguous(), T_NUM, frame.nrows))
        return out


class _StepLoop:
    """The training steps of one fit: fixed per-chunk draw buffers, the
    step function over them, and its CUDA graph (captured on first use
    when `use_graph`)."""

    def __init__(self, X, y, w, params, opt, loss_fn, *, n: int, batch: int,
                 widths: List[int], input_dropout: float, hidden_dropout,
                 steps: int, use_graph: bool, mesh=None, lo: int = 0):
        self.params, self.opt, self.loss_fn = params, opt, loss_fn
        self.n, self.batch = n, batch
        self.widths = widths
        self.in_drop, self.hid_drop = input_dropout, hidden_dropout
        dev = X.device
        rates = _dropout_rates(widths, input_dropout, hidden_dropout)
        per_step = batch * (8 + sum(wd for r, wd in zip(rates, widths)
                                    if r > 0))
        if mesh is not None:
            # the synchronous path's chunk buffers hold each step's rows
            per_step += batch * 4 * (X.shape[1] + 2)
        self.chunk = max(1, min(steps, CHUNK_BYTES // per_step))
        # the synchronous path across ranks: this rank's rows, and the
        # buffers each chunk's drawn rows are fetched into
        self.mesh, self.lo = mesh, lo
        if mesh is None:
            self.X, self.y, self.w = X, y, w
        else:
            self.src = (X, y, w)
            rows = self.chunk * batch
            self.X = torch.zeros(rows, X.shape[1], dtype=X.dtype, device=dev)
            self.y = torch.zeros(rows, dtype=y.dtype, device=dev)
            self.w = torch.zeros(rows, dtype=w.dtype, device=dev)
        self.idx = torch.zeros(self.chunk, batch, dtype=torch.int64,
                               device=dev)
        self.masks = [torch.zeros(self.chunk, batch, wd, dtype=torch.bool,
                                  device=dev) if r > 0 else None
                      for r, wd in zip(rates, widths)]
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.use_graph = use_graph
        self.graph = None

    def _step(self, params, opt, slot) -> None:
        idx = self.idx.index_select(0, slot)[0]
        xb = self.X.index_select(0, idx)
        yb = self.y.index_select(0, idx)
        wb = self.w.index_select(0, idx)
        masks = [None if m is None else m.index_select(0, slot)[0]
                 for m in self.masks]
        loss = self.loss_fn(params, xb, yb, wb, masks)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            opt.step(params, list(grads))
            slot.add_(1)

    def _capture(self) -> None:
        """Warm the step up on copies of the state on a side stream, then
        capture it on the real state."""
        params_c = [p.detach().clone().requires_grad_(True)
                    for p in self.params]
        opt_c = copy.deepcopy(self.opt)
        slot_c = self.slot.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                slot_c.zero_()
                self._step(params_c, opt_c, slot_c)
        torch.cuda.current_stream().wait_stream(side)
        from h2o3_tpu_torch.core.runtime import CAPTURE_LOCK
        from h2o3_tpu_torch.obs import compiles

        # thread_local: a REST server's other threads keep launching work
        # (predictions, Rapids) while this captures, and in the default
        # global mode their allocations or syncs would invalidate the
        # capture; an error in this thread's own capture still raises
        g = torch.cuda.CUDAGraph()
        with compiles.timed("train", (tuple(self.X.shape), self.chunk),
                            program="deeplearning_step"):
            with CAPTURE_LOCK:
                with torch.cuda.graph(g, capture_error_mode="thread_local"):
                    self._step(self.params, self.opt, self.slot)
        self.graph = g

    def _fetch(self, ids: torch.Tensor) -> None:
        """The synchronous path: the rows `ids` (global, the same on every
        rank) from the ranks that hold them, into the chunk buffers; the
        chunk's steps then read rows 0, 1, ... of them."""
        from h2o3_tpu_torch.core import sharded_frame as SF

        X, y, w = self.src
        flat = ids.reshape(-1)
        owner = SF.owner_of(flat, self.n, self.mesh.size)
        order = torch.argsort(owner, stable=True)
        mine = flat[order][owner[order] == self.mesh.rank] - self.lo
        part = torch.cat([X.index_select(0, mine),
                          y.index_select(0, mine).float()[:, None],
                          w.index_select(0, mine)[:, None]], 1)
        got = self.mesh.all_gather(part)
        rows = torch.empty_like(got)
        rows[order] = got
        k = len(flat)
        self.X[:k] = rows[:, :-2]
        self.y[:k] = rows[:, -2].to(self.y.dtype)
        self.w[:k] = rows[:, -1]
        self.idx[: len(ids)] = torch.arange(
            k, device=self.idx.device).view(len(ids), self.batch)
        SF.note_dl_batch_rows(k - len(mine))

    def epoch(self, key: torch.Tensor, steps: int) -> torch.Tensor:
        """`steps` steps from `key`; returns the key after them."""
        global graph_replays, eager_steps
        from h2o3_tpu_torch import native

        sub, key_out = native.split_chain(key, steps, 3)
        dev = self.X.device
        for c0 in range(0, steps, self.chunk):
            m = min(self.chunk, steps - c0)
            keys = sub[c0:c0 + m].to(dev)
            drawn = rnd.randint(keys[:, 0], (self.batch,), 0, self.n).long()
            if self.mesh is not None:
                self._fetch(drawn)
            else:
                self.idx[:m] = drawn
            if any(mk is not None for mk in self.masks):
                drawn = dropout_masks(keys[:, 1], self.batch, self.widths,
                                      self.in_drop, self.hid_drop)
                for buf, mk in zip(self.masks, drawn):
                    if buf is not None:
                        buf[:m] = mk
            self.slot.zero_()
            if self.use_graph:
                if self.graph is None:
                    self._capture()
                for _ in range(m):
                    self.graph.replay()
                graph_replays += m
            else:
                for _ in range(m):
                    self._step(self.params, self.opt, self.slot)
                eager_steps += m
        return key_out


@register
class DeepLearning(ModelBuilder):
    algo_name = "deeplearning"
    model_class = DeepLearningModel
    row_sharded = True
    supports_checkpoint = True
    supports_iteration_resume = True
    # the eager loop on the card too, to hold the graph loop against it
    _force_eager = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "hidden": [200, 200],
            "activation": "Rectifier",
            "epochs": 10.0,
            "mini_batch_size": 32,
            "adaptive_rate": True,
            "rho": 0.99, "epsilon": 1e-8,   # ADADELTA
            "rate": 0.005, "rate_annealing": 1e-6, "rate_decay": 1.0,
            "momentum_start": 0.0, "momentum_ramp": 1e6,
            "momentum_stable": 0.0,
            "l1": 0.0, "l2": 0.0,
            "input_dropout_ratio": 0.0,
            "hidden_dropout_ratios": None,
            # Automatic / CrossEntropy / Quadratic / Absolute / Huber
            "loss": "Automatic",
            "distribution": "AUTO",
            "standardize": True,
            "autoencoder": False,
            "train_samples_per_iteration": 0,
            "use_all_factor_levels": True,
            "initial_weight_distribution": "UniformAdaptive",
            "initial_weight_scale": 1.0,
            "score_each_iteration": False,
            "variable_importances": True,
        })
        return p

    def __init__(self, **params):
        self.supervised = not bool(params.get("autoencoder"))
        super().__init__(**params)

    def _fit(self, train: Frame) -> DeepLearningModel:
        p = self.params
        autoencoder = bool(p.get("autoencoder"))
        resp = p.get("response_column") if not autoencoder else None
        # a continuation keeps the original run's DataInfo: its
        # standardisation is what the resumed weights were trained on
        prev = self._resolve_checkpoint()
        if prev is not None:
            if prev.params_tree is None:
                raise ValueError("checkpoint model has no weights to continue")
            skip = {resp, p.get("weights_column"), p.get("offset_column"),
                    p.get("fold_column")} | set(p.get("ignored_columns") or [])
            names = [c for c in train.names
                     if c not in skip and not train.col(c).is_string]
            doms = {c: list(train.col(c).domain) for c in names
                    if train.col(c).is_categorical}
            if names != prev._output.names or doms != prev._output.domains:
                raise ValueError(
                    "checkpoint: training frame columns/domains differ from "
                    f"the original run ({prev._output.names} vs {names})")
            di = prev.data_info
        else:
            di = DataInfo(train, response=resp,
                          ignored=p.get("ignored_columns") or (),
                          weights=p.get("weights_column"),
                          standardize=bool(p.get("standardize", True)),
                          use_all_factor_levels=bool(
                              p.get("use_all_factor_levels", True)),
                          exact=True)
        n = train.nrows
        activation = (p.get("activation") or "Rectifier").lower()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {p['activation']!r}")
        hidden = [int(h) for h in (p.get("hidden") or [200, 200])]
        seed = self._seed()
        from h2o3_tpu_torch.core import sharded_frame as SF

        mesh = SF.mesh_of(train) if SF._is_sharded(train) else None
        if mesh is not None:
            if autoencoder:
                SF.refuse(train, "a DeepLearning autoencoder")
            seed = SF.agreed_int(mesh, seed)

        nclasses = 1
        X = di.expand(*(c.data for c in di.cols(train)))
        dev = X.device
        wc = p.get("weights_column")
        if autoencoder:
            y = torch.zeros(len(X), dtype=torch.float32, device=dev)
            row_w = torch.ones(len(X), dtype=torch.float32, device=dev)
        else:
            y_col = train.col(resp)
            if y_col.is_categorical:
                nclasses = max(y_col.cardinality, 2)
            row_w = DataInfo.response_weight(
                y_col.data, train.col(wc).data if wc else None)
            y = DataInfo.clean_response(y_col.data)
            y = y.long() if nclasses > 1 else y.float()

        out_dim = di.fullN if autoencoder else (nclasses if nclasses > 1
                                                else 1)
        if prev is not None:
            params0 = [(W.detach().to(dev), b.detach().to(dev))
                       for W, b in prev.params_tree]
            if params0[-1][0].shape[1] != out_dim:
                raise ValueError(
                    "checkpoint: response cardinality changed "
                    f"({params0[-1][0].shape[1]} vs {out_dim})")
        else:
            params0 = _init_params(
                di.fullN, hidden, out_dim, seed,
                p.get("initial_weight_distribution", "UniformAdaptive"),
                float(p.get("initial_weight_scale", 1.0)), dev)

        loss_name = (p.get("loss") or "Automatic").lower()
        if loss_name == "automatic" or nclasses > 1:
            loss_name = "crossentropy" if nclasses > 1 else "quadratic"
        l1 = float(p.get("l1", 0.0))
        l2 = float(p.get("l2", 0.0))
        in_drop = float(p.get("input_dropout_ratio", 0.0))
        hid_drop = p.get("hidden_dropout_ratios")
        if hid_drop is None and "withdropout" in activation:
            hid_drop = [0.5] * len(hidden)
        hid_drop = tuple(float(h) for h in (hid_drop or []))

        batch = max(int(p.get("mini_batch_size", 32)), 1)
        epochs = float(p.get("epochs", 10.0))
        steps_per_epoch = max(int(math.ceil(n / batch)), 1)
        n_epochs = max(int(math.ceil(epochs)), 1)
        ep_start = 0
        if prev is not None:
            # epochs is the total, and must exceed the checkpoint's
            ep_start = int(getattr(prev, "epochs_trained", 0) or 0)
            if n_epochs <= ep_start:
                raise ValueError(
                    f"checkpoint model already trained {ep_start} epochs; "
                    f"epochs ({n_epochs}) must be greater")

        params = [t.clone().requires_grad_(True)
                  for W, b in params0 for t in (W, b)]
        if p.get("adaptive_rate", True):
            opt = Adadelta(params, rho=float(p.get("rho", 0.99)),
                           eps=float(p.get("epsilon", 1e-8)))
        else:
            mom = max(float(p.get("momentum_start", 0.0)),
                      float(p.get("momentum_stable", 0.0)))
            opt = SGD(params, rate=float(p.get("rate", 0.005)),
                      rate_annealing=float(p.get("rate_annealing", 1e-6)),
                      batch=batch, momentum=mom)

        loss_fn = make_loss(activation=activation, autoencoder=autoencoder,
                            nclasses=nclasses, loss=loss_name, l1=l1, l2=l2,
                            input_dropout=in_drop, hidden_dropout=hid_drop,
                            device=dev)

        # model averaging across ranks (the reference's :377-433)
        tspi = int(p.get("train_samples_per_iteration", 0) or 0)
        n_dev = mesh.size if mesh is not None else 1
        avg_period = (max(1, tspi // max(batch * n_dev, 1)) if tspi > 0
                      else 1)
        averaging = avg_period > 1 and n_dev > 1
        sync = mesh is not None and not averaging
        loop = _StepLoop(X, y, row_w, params, opt, loss_fn,
                         n=len(X) if averaging else n, batch=batch,
                         widths=[di.fullN] + hidden, input_dropout=in_drop,
                         hidden_dropout=hid_drop,
                         steps=avg_period if averaging else steps_per_epoch,
                         use_graph=dev.type == "cuda"
                         and not self._force_eager,
                         mesh=mesh if sync else None,
                         lo=train.shard[0] if sync else 0)
        moments = (opt.e_g + opt.e_x if isinstance(opt, Adadelta)
                   else opt.trace)

        def run_epoch(key):
            if not averaging:
                return loop.epoch(key, steps_per_epoch)
            ks = rnd.split(key, 2)
            key, key_l = ks[0], rnd.fold_in(ks[1], mesh.rank)
            for _ in range(max(int(math.ceil(steps_per_epoch
                                             / avg_period)), 1)):
                key_l = loop.epoch(key_l, avg_period)
                with torch.no_grad():
                    for t in params + moments:
                        t.copy_(mesh.all_reduce(t.detach().clone()
                                                .contiguous(), "sum")
                                / mesh.size)
            return key

        key = rnd.PRNGKey(seed)
        if ep_start:
            # a continuation must not replay the original epochs' draws
            key = rnd.fold_in(key, ep_start)

        model = DeepLearningModel(parms=dict(p))
        self._init_output(model, train)
        if autoencoder:
            model._output.model_category = ModelCategory.AutoEncoder
            model._output.response_name = None
        model.data_info = di
        model.activation = activation
        model.nclasses = nclasses
        model.autoencoder = autoencoder

        stop_rounds = int(p.get("stopping_rounds", 0) or 0)
        tol = float(p.get("stopping_tolerance", 1e-3))
        history: List[float] = []
        ep_done = ep_start
        rs = self._take_resume_state("dl_epochs")
        if rs is not None:
            # the saved weights and optimizer state go into the loop's own
            # tensors, the key chain resumes at the saved key
            ep_start = ep_done = int(rs["epoch"])
            with torch.no_grad():
                for t, a in zip(params + opt.state(),
                                rs["params"] + rs["opt_state"]):
                    t.copy_(torch.from_numpy(np.asarray(a)))
            key = torch.from_numpy(np.array(rs["key"]))
            history = [float(v) for v in rs["history"]]
            model._output.scoring_history = [dict(h) for h in
                                             rs["scoring_history"]]
        every = self._job_ckpt_every()
        for ep in range(ep_start, n_epochs):
            key = run_epoch(key)
            ep_done = ep + 1
            tr_loss = scored_loss(loss_fn, params, X, y, row_w, mesh)
            model._output.scoring_history.append(
                {"epoch": ep + 1, "training_loss": tr_loss})
            history.append(tr_loss)
            if self.job:
                # tr_loss is already on the host: the tick adds no sync
                self.job.update(progress=(ep + 1) / n_epochs,
                                msg=f"epoch {ep + 1}/{n_epochs} "
                                    f"loss={tr_loss:.5f}")
            if every and (ep + 1) % every == 0:
                self._tick_job_progress(ep + 1, lambda: {
                    "phase": "dl_epochs", "epoch": ep_done,
                    "params": [t.detach().cpu().numpy() for t in params],
                    "opt_state": [t.cpu().numpy() for t in opt.state()],
                    "key": key.numpy(), "history": list(history),
                    "scoring_history": [dict(h) for h in
                                        model._output.scoring_history]})
            if stop_rounds > 0 and len(history) > stop_rounds:
                best_recent = min(history[-stop_rounds:])
                best_before = min(history[:-stop_rounds])
                if best_recent > best_before * (1.0 - tol):
                    break
            if self._out_of_time():
                break

        model.epochs_trained = ep_done
        model.params_tree = [(W.detach().clone(), b.detach().clone())
                             for W, b in zip(params[0::2], params[1::2])]
        if p.get("variable_importances", True) and not autoencoder:
            model._output.variable_importances = _garson_importance(
                model.params_tree, di)
        return model


def _init_params(in_dim: int, hidden: List[int], out_dim: int, seed: int,
                 dist: str, scale: float, device) -> List:
    """Weights from numpy's default_rng(seed), layer by layer:
    UniformAdaptive U(±sqrt(6 / (fan_in + fan_out))), Uniform U(±scale) or
    Normal(0, scale); biases 0."""
    rng = np.random.default_rng(seed)
    dims = [in_dim] + hidden + [out_dim]
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        d = (dist or "UniformAdaptive").lower()
        if d == "uniformadaptive":
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            W = rng.uniform(-lim, lim, size=(fan_in, fan_out))
        elif d == "uniform":
            W = rng.uniform(-scale, scale, size=(fan_in, fan_out))
        elif d == "normal":
            W = rng.normal(0.0, scale, size=(fan_in, fan_out))
        else:
            raise ValueError(f"unknown initial_weight_distribution {dist!r}")
        params.append((torch.as_tensor(W.astype(np.float32), device=device),
                       torch.zeros(fan_out, dtype=torch.float32,
                                   device=device)))
    return params


def _garson_importance(params, di: DataInfo) -> Dict[str, float]:
    """First-layer |weight| mass per original column (a categorical's
    one-hot columns fold back onto it), normalised to a maximum of 1."""
    W1 = np.abs(params[0][0].detach().cpu().numpy()).sum(axis=1)  # (fullN,)
    imp: Dict[str, float] = {}
    for i, cname in enumerate(di.cat_names):
        s, e = di.cat_offsets[i], di.cat_offsets[i + 1]
        imp[cname] = float(W1[s:e].sum())
    for j, nname in enumerate(di.num_names):
        imp[nname] = float(W1[di.num_offset + j])
    mx = max(imp.values()) if imp else 1.0
    return {k: v / mx for k, v in sorted(imp.items(), key=lambda kv: -kv[1])}
