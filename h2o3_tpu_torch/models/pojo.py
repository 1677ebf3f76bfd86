"""POJO export: a self-contained Java scoring class for a trained model
(counterpart of h2o3_tpu/models/pojo.py: `pojo_source` :48, `_tree_pojo`
:59, `_glm_pojo` :233).

Reference: the POJO writers under hex/schemas/../ModelBuilder.havePojo
(h2o-core water/util/JCodeGen.java, hex/tree/SharedTreeModel.java
toJava). Reference POJOs embed the forest as Java code; these embed the
same flat CompressedForest arrays the MOJO carries, and the bin edges,
and walk them in a score0 loop: the numerics of h2o3_genmodel's
TreeScorer, in dependency-free Java. The source is the JAX package's,
character for character, for the same model and key.

Contract (GenModel.java): `double[] score0(double[] row, double[] preds)`
where categorical cells hold the training-domain code (NaN = NA).
Supported: gbm / drf / isolationforest (forest walk) and glm (linear +
link). Others raise, as in the reference, where XGBoost, for one, is
MOJO-only. Host string generation only: tensors are copied to the host.
"""

from __future__ import annotations

from typing import List

import numpy as np

from h2o3_tpu_torch.models.mojo import _default_threshold

_TREE_ALGOS = {"gbm", "drf", "isolationforest"}


def _jarr_d(a) -> str:
    return "{" + ",".join(f"{float(x)!r}" for x in np.asarray(a).ravel()) + "}"


def _jarr_i(a) -> str:
    return "{" + ",".join(str(int(x)) for x in np.asarray(a).ravel()) + "}"


def _jarr_b(a) -> str:
    return "{" + ",".join("true" if x else "false"
                          for x in np.asarray(a).ravel()) + "}"


def _jarr2(rows, fmt) -> str:
    return "{" + ",".join(fmt(r) for r in rows) + "}"


def _class_name(model) -> str:
    import re

    return re.sub(r"\W", "_", str(model.key))


def pojo_source(model) -> str:
    algo = model.algo_name
    if algo in _TREE_ALGOS:
        return _tree_pojo(model)
    if algo == "glm":
        return _glm_pojo(model)
    raise ValueError(
        f"POJO export not supported for algo {algo!r} (MOJO covers it); "
        "reference parity: XGBoost & friends are MOJO-only too")


def _tree_pojo(model) -> str:
    fo = model.forest
    spec = model.spec
    o = model._output
    cname = _class_name(model)
    F = spec.F
    # per-class trees also occur at nclasses==2 (DRF binomial_double_trees)
    K = fo.nclasses if fo.per_class_trees else 1
    dist = getattr(model, "_distribution", None)
    dname = getattr(dist, "name", "gaussian") or "gaussian"
    category = str(o.model_category)
    dom = o.response_domain or []
    edges = [np.asarray(e, np.float64) for e in spec.edges]
    init_class = (np.asarray(fo.init_class, np.float64)
                  if getattr(fo, "init_class", None) is not None
                  else np.zeros(K))
    cat_w = fo.cat_table.shape[1] if fo.cat_table.size else 1

    lines: List[str] = [
        f"// Generated by h2o3_tpu — scoring POJO for model {model.key}"
        f" (algo={model.algo_name}).",
        "// Contract: double[] score0(double[] row, double[] preds); "
        "categorical cells carry the",
        "// training-domain code (Double.NaN = missing). See NAMES/DOMAINS "
        "for the column order.",
        f"public class {cname} {{",
        "  public static final String[] NAMES = {"
        + ",".join(f'"{n}"' for n in spec.names) + "};",
        "  public static final String[][] DOMAINS = {"
        + ",".join("null" if not spec.is_cat[i] else
                   "{" + ",".join(f'"{v}"' for v in
                                  o.domains.get(spec.names[i], [])) + "}"
                   for i in range(F)) + "};",
        "  public static final String[] RESPONSE_DOMAIN = {"
        + ",".join(f'"{v}"' for v in dom) + "};",
        f"  static final int NCLASSES = {K};",
        f"  static final double INIT_F = {float(fo.init_f)!r};",
        "  static final double[] INIT_CLASS = " + _jarr_d(init_class) + ";",
        "  static final int[] NBINS = " + _jarr_i(spec.nbins) + ";",
        "  static final double[][] EDGES = "
        + _jarr2(edges, _jarr_d) + ";",
        "  static final boolean[] IS_CAT = " + _jarr_b(spec.is_cat) + ";",
        "  static final int[][] FEAT = " + _jarr2(fo.feat, _jarr_i) + ";",
        "  static final int[][] THRESH = " + _jarr2(fo.thresh_bin, _jarr_i) + ";",
        "  static final boolean[][] NA_LEFT = "
        + _jarr2(fo.na_left, _jarr_b) + ";",
        "  static final int[][] LEFT = " + _jarr2(fo.left, _jarr_i) + ";",
        "  static final int[][] RIGHT = " + _jarr2(fo.right, _jarr_i) + ";",
        "  static final double[][] LEAF = "
        + _jarr2(fo.leaf_val, _jarr_d) + ";",
        "  static final int[][] CAT_SPLIT = "
        + _jarr2(fo.cat_split, _jarr_i) + ";",
        "  static final boolean[][] CAT_TABLE = "
        + (_jarr2(fo.cat_table, _jarr_b) if fo.cat_table.size else "{}") + ";",
        f"  static final int CAT_W = {cat_w};",
        "  static final int[] TREE_CLASS = " + _jarr_i(fo.tree_class) + ";",
        "  static final int[] NA_BINS = " + _jarr_i(fo.na_bins) + ";",
        f"  static final int MAX_DEPTH = {int(fo.max_depth)};",
        "",
        "  static int bin(int f, double x) {",
        "    int naBin = NBINS[f] - 1;",
        "    if (Double.isNaN(x)) return naBin;",
        "    if (IS_CAT[f]) { int c = (int) x; "
        "return (c < 0 || c >= naBin) ? naBin : c; }",
        "    double[] e = EDGES[f];",
        "    int lo = 0, hi = e.length;           // searchsorted(side=left)",
        "    while (lo < hi) { int mid = (lo + hi) >>> 1; "
        "if (e[mid] < (float) x) lo = mid + 1; else hi = mid; }",
        "    return lo;",
        "  }",
        "",
        "  static double walk(int t, int[] bins) {",
        "    int node = 0;",
        "    for (int d = 0; d <= MAX_DEPTH; d++) {",
        "      int f = FEAT[t][node];",
        "      if (f < 0) break;",
        "      int b = bins[f];",
        "      boolean goLeft;",
        "      int cs = CAT_SPLIT[t][node];",
        "      if (b == NA_BINS[f]) goLeft = NA_LEFT[t][node];",
        "      else if (cs >= 0) goLeft = "
        "CAT_TABLE[cs][Math.min(b, CAT_W - 1)];",
        "      else goLeft = b <= THRESH[t][node];",
        "      node = goLeft ? LEFT[t][node] : RIGHT[t][node];",
        "    }",
        "    return LEAF[t][node];",
        "  }",
        "",
        "  public static double[] score0(double[] row, double[] preds) {",
        "    int[] bins = new int[NAMES.length];",
        "    for (int f = 0; f < NAMES.length; f++) bins[f] = bin(f, row[f]);",
    ]
    if K > 1:
        lines += [
            "    double[] acc = new double[NCLASSES];",
            "    for (int k = 0; k < NCLASSES; k++) acc[k] = INIT_CLASS[k];",
            "    for (int t = 0; t < FEAT.length; t++) "
            "acc[TREE_CLASS[t]] += walk(t, bins);",
        ]
        if model.algo_name == "drf":
            lines += [
                "    double tot = 0;",
                "    for (int k = 0; k < NCLASSES; k++) { acc[k] = "
                "Math.min(Math.max(acc[k], 0.0), 1.0); tot += acc[k]; }",
                "    for (int k = 0; k < NCLASSES; k++) "
                "preds[1 + k] = acc[k] / Math.max(tot, 1e-12);",
            ]
        else:
            lines += [
                "    double mx = acc[0];",
                "    for (int k = 1; k < NCLASSES; k++) "
                "mx = Math.max(mx, acc[k]);",
                "    double tot = 0;",
                "    for (int k = 0; k < NCLASSES; k++) "
                "{ preds[1 + k] = Math.exp(acc[k] - mx); tot += preds[1 + k]; }",
                "    for (int k = 0; k < NCLASSES; k++) preds[1 + k] /= tot;",
            ]
        if K == 2 and category == "Binomial":
            # double-trees binomial labels with the model threshold, like
            # the server and genmodel (not multinomial argmax)
            thr2 = _default_threshold(model)
            lines += [
                f"    preds[0] = preds[2] >= {thr2!r} ? 1 : 0;  "
                "// model default (max-F1) threshold",
                "    return preds;",
                "  }",
            ]
        else:
            lines += [
                "    int best = 0;",
                "    for (int k = 1; k < NCLASSES; k++) "
                "if (preds[1 + k] > preds[1 + best]) best = k;",
                "    preds[0] = best;",
                "    return preds;",
                "  }",
            ]
    else:
        lines += [
            "    double f = INIT_F;",
            "    for (int t = 0; t < FEAT.length; t++) f += walk(t, bins);",
        ]
        if model.algo_name == "isolationforest":
            cnorm = float(model._parms.get("_cnorm", 1.0) or 1.0)
            lines += [
                f"    double meanLen = f / FEAT.length;",
                f"    preds[0] = Math.pow(2.0, -meanLen / {cnorm!r});",
                "    if (preds.length > 1) preds[1] = meanLen;",
            ]
        elif category == "Binomial":
            if model.algo_name == "drf" or dname not in ("bernoulli",
                                                         "quasibinomial"):
                # DRF votes are already probabilities: clip, don't sigmoid
                # (DRFModel._predict_raw / genmodel TreeScorer parity)
                lines += ["    double p = Math.min(Math.max(f, 0.0), 1.0);"]
            else:
                lines += ["    double p = 1.0 / (1.0 + Math.exp(-f));"]
            thr = _default_threshold(model)
            lines += [
                "    preds[1] = 1.0 - p; preds[2] = p;",
                f"    preds[0] = p >= {thr!r} ? 1 : 0;  "
                "// model default (max-F1) threshold, GenModel parity",
            ]
        else:
            if dname in ("poisson", "gamma", "tweedie"):
                lines += ["    preds[0] = Math.exp(f);"]
            else:
                lines += ["    preds[0] = f;"]
        lines += ["    return preds;", "  }"]
    lines += ["}", ""]
    return "\n".join(lines)


def _glm_pojo(model) -> str:
    o = model._output
    cname = _class_name(model)
    di = model.dinfo
    beta = model.beta.detach().cpu().numpy().astype(np.float64)
    K = o.nclasses
    dom = o.response_domain or []
    base = 0 if di.use_all_factor_levels else 1
    multi = beta.ndim == 2
    lines: List[str] = [
        f"// Generated by h2o3_tpu — scoring POJO for GLM model {model.key}.",
        "// Contract: double[] score0(double[] row, double[] preds); "
        "categorical cells carry the",
        "// training-domain code (Double.NaN = missing), columns ordered "
        "cats-first as in NAMES.",
        f"public class {cname} {{",
        "  public static final String[] NAMES = {"
        + ",".join(f'"{n}"' for n in di.predictor_names) + "};",
        "  public static final String[] RESPONSE_DOMAIN = {"
        + ",".join(f'"{v}"' for v in dom) + "};",
        f"  static final int NCAT = {len(di.cat_names)};",
        "  static final int[] CARDS = " + _jarr_i(di.cards) + ";",
        f"  static final int BASE = {base};",
        "  static final int[] CAT_MODES = " + _jarr_i(di.cat_modes) + ";",
        "  static final int[] CAT_OFF = " + _jarr_i(di.cat_offsets) + ";",
        f"  static final boolean STANDARDIZE = "
        f"{'true' if di.standardize else 'false'};",
        "  static final double[] NUM_MEANS = " + _jarr_d(di.num_means) + ";",
        "  static final double[] NUM_SIGMAS = " + _jarr_d(di.num_sigmas) + ";",
        "  static final double[] IMPUTE = " + _jarr_d(di.impute_values) + ";",
    ]
    if multi:
        lines += ["  static final double[][] BETA = "
                  + _jarr2(beta.T, _jarr_d) + ";  // (K, fullN+1)"]
    else:
        lines += ["  static final double[] BETA = " + _jarr_d(beta) + ";"]
    lines += [
        "",
        "  static double expand(double[] row, double[] x) {",
        "    for (int i = 0; i < NCAT; i++) {",
        "      double v = row[i];",
        "      int c = Double.isNaN(v) ? CAT_MODES[i] : (int) v;",
        "      if (c < 0 || c >= CARDS[i]) c = CAT_MODES[i];",
        "      if (c - BASE >= 0) x[CAT_OFF[i] + c - BASE] = 1.0;",
        "    }",
        "    int numOff = CAT_OFF[NCAT];",
        "    for (int j = 0; j < NUM_MEANS.length; j++) {",
        "      double v = row[NCAT + j];",
        "      if (Double.isNaN(v)) v = IMPUTE[j];",
        "      if (STANDARDIZE) v = (v - NUM_MEANS[j]) / NUM_SIGMAS[j];",
        "      x[numOff + j] = v;",
        "    }",
        "    return 0;",
        "  }",
        "",
        "  public static double[] score0(double[] row, double[] preds) {",
        "    int fullN = CAT_OFF[NCAT] + NUM_MEANS.length;",
        "    double[] x = new double[fullN];",
        "    expand(row, x);",
    ]
    if multi:
        lines += [
            "    double[] eta = new double[BETA.length];",
            "    double mx = -1e300;",
            "    for (int k = 0; k < BETA.length; k++) {",
            "      double s = BETA[k][fullN];",
            "      for (int j = 0; j < fullN; j++) s += BETA[k][j] * x[j];",
            "      eta[k] = s; mx = Math.max(mx, s);",
            "    }",
            "    double tot = 0;",
            "    for (int k = 0; k < BETA.length; k++) "
            "{ preds[1 + k] = Math.exp(eta[k] - mx); tot += preds[1 + k]; }",
            "    int best = 0;",
            "    for (int k = 0; k < BETA.length; k++) { preds[1 + k] /= tot; "
            "if (preds[1 + k] > preds[1 + best]) best = k; }",
            "    preds[0] = best;",
            "    return preds;",
            "  }", "}", ""]
        return "\n".join(lines)
    link = model.linkname
    lines += [
        "    double eta = BETA[fullN];",
        "    for (int j = 0; j < fullN; j++) eta += BETA[j] * x[j];",
    ]
    if link == "logit":
        thr = _default_threshold(model)
        lines += [
            "    double mu = 1.0 / (1.0 + Math.exp(-eta));",
            "    preds[1] = 1.0 - mu; preds[2] = mu;",
            f"    preds[0] = mu >= {thr!r} ? 1 : 0;  "
            "// model default (max-F1) threshold",
        ]
    elif link == "log":
        lines += ["    preds[0] = Math.exp(eta);"]
    elif link == "inverse":
        lines += ["    preds[0] = 1.0 / (Math.abs(eta) < 1e-10 ? 1e-10 : eta);"]
    elif link == "tweedie":
        lp = float(model.link_power)
        if lp == 0.0:
            lines += ["    preds[0] = Math.exp(eta);"]
        else:
            lines += [f"    preds[0] = Math.pow(Math.max(eta, 1e-10), "
                      f"{1.0 / lp!r});"]
    else:
        lines += ["    preds[0] = eta;"]
    lines += ["    return preds;", "  }", "}", ""]
    return "\n".join(lines)
