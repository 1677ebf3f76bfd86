"""The port's histogram (h2o3_tpu_torch/models/tree/hist_gather.py): its
plain version against the JAX package's Pallas kernel (interpret mode)
and XLA twin on the reference's five kernel-test geometries, against the
float64 ground truth, dead/zero-weight rows, the shared-memory tile
planner, the int64 fixed-point convention (order-free, exponents by
hand, extreme magnitudes, non-finite rows, ties), and (on a CUDA card
only) the hand-written kernel against the plain version, bit for bit."""

import math

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models.tree import hist_gather as hg

from test_pallas_hist import _case, _f64_reference

GEOMETRIES = [  # tests/test_pallas_hist.py:70-76
    (0, 1000, 5, 8, 12, None, 256, False),
    (1, 512, 3, 6, 7, 2, 128, True),
    (2, 768, 8, 16, 16, 4, 256, False),
    (3, 300, 2, 4, 3, 1, 128, True),
    (4, 256, 1, 32, 5, None, 256, False),
]


def _port(binned, node, w, y, offsets, TB, S, device="cpu", bins=np.uint8,
          tile_S=None):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return hg.hist_gather(t(binned.astype(bins)), t(node), t(w), t(y),
                          offsets=t(offsets), TB=TB, S=S, tile_S=tile_S)


@pytest.mark.parametrize("seed,n,F,maxB,S,tile_S,blk,ragged", GEOMETRIES)
def test_plain_version_vs_jax_kernel_and_xla_twin(cl, seed, n, F, maxB, S,
                                                  tile_S, blk, ragged):
    import jax.numpy as jnp

    from h2o3_tpu.models.tree import pallas_hist

    binned, node, w, y, offsets, TB = _case(seed, n, F, maxB, S,
                                            ragged_bins=ragged)
    args = tuple(jnp.asarray(a) for a in (binned, node, w, y))
    kw = dict(offsets=offsets, TB=TB, S=S, tile_S=tile_S, blk=blk)
    kern = np.asarray(pallas_hist.hist_gather(*args, **kw))
    twin = np.asarray(pallas_hist.hist_gather_xla(*args, **kw))
    got = _port(binned, node, w, y, offsets, TB, S).numpy()
    assert got.shape == (S * TB, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, twin, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bins", [np.uint8, np.int16, np.int32])
def test_plain_version_vs_float64_ground_truth(bins):
    n, F, maxB, S = 600, 4, 8, 6
    binned, node, w, y, offsets, TB = _case(10, n, F, maxB, S,
                                            ragged_bins=True)
    got = _port(binned, node, w, y, offsets, TB, S, bins=bins).numpy()
    expect = _f64_reference(binned, node, w, y, offsets, TB, S)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_dead_and_zero_weight_rows_drop():
    n, F, maxB, S = 256, 3, 8, 4
    binned, node, w, y, offsets, TB = _case(12, n, F, maxB, S)
    dead = (node < 0) | (w == 0.0)
    out = _port(binned, node, w, y, offsets, TB, S).numpy()
    live_w = np.sort(w[~dead].astype(np.float64))
    assert out[:, 0].sum() == pytest.approx(F * live_w.sum(), rel=1e-6)
    # nodes >= S are outside the histogram too, like node -1
    out_hi = _port(binned, np.where(node < 0, S + 3, node), w, y, offsets,
                   TB, S).numpy()
    np.testing.assert_array_equal(out_hi, out)
    out0 = _port(binned, np.full(n, -1, np.int32), w, y, offsets, TB,
                 S).numpy()
    assert np.all(out0 == 0)


def test_shared_memory_tile_planner():
    budget = hg.SMEM_PER_BLOCK
    for TB, S in [(210, 1), (210, 16), (210, 64), (40, 12), (512, 64),
                  (96, 1), (1024, 4096), (4000, 3)]:
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        assert 24 * TB * tile_S <= budget              # fits shared memory
        assert tile_S * n_tiles >= S > tile_S * (n_tiles - 1)   # covers S
        assert tile_S <= S
    # the flagship's widest level (S=16, TB=210) is one tile of ~80 KB
    assert hg.plan_tiles(210, 16) == (16, 1)
    # one slot over the budget: no plan, and the kernel accumulates in
    # global memory
    assert hg.plan_tiles(budget // 24 + 1, 2) is None
    assert hg.plan_tiles(100, 8, budget=2399) is None


def test_row_grid_depends_on_n_only():
    for n in (1, 31, 4096, 4097, 1_000_000, 3_000_001):
        rows, G = hg.row_grid(n)
        assert rows % 32 == 0 and rows >= hg.ROWS_PER_CTA_MIN
        assert G <= hg.MAX_CTAS and rows * G >= n > rows * (G - 1)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    binned, node, w, y, offsets, TB = _case(5, 300, 3, 8, 4)
    before = hg.launches
    got = _port(binned, node, w, y, offsets, TB, 4)
    ref = hg.hist_gather_ref(*(torch.as_tensor(a) for a in
                               (binned, node, w, y)),
                             offsets=offsets, TB=TB, S=4)
    assert torch.equal(got, ref)
    assert hg.launches == before          # no kernel launch on the CPU


def _bits(t):
    """int32 view of a float tensor with every NaN as one pattern."""
    return torch.where(torch.isnan(t), torch.nan, t).view(torch.int32)


def _permuted(seed, *arrays):
    perm = np.random.default_rng(seed).permutation(arrays[0].shape[0])
    return tuple(a[perm] for a in arrays)


@pytest.mark.parametrize("seed,n,F,maxB,S,tile_S,blk,ragged", GEOMETRIES)
def test_plain_version_is_order_free(seed, n, F, maxB, S, tile_S, blk,
                                     ragged):
    binned, node, w, y, offsets, TB = _case(seed, n, F, maxB, S,
                                            ragged_bins=ragged)
    got = _port(binned, node, w, y, offsets, TB, S)
    shuffled = _port(*_permuted(seed, binned, node, w, y), offsets, TB, S)
    assert torch.equal(_bits(got), _bits(shuffled))


# b = ceil(log2(n)) and e = frexp exponent of the maximum, by hand:
# 1e-30 lies in [2**-100, 2**-99), 1e30 in [2**99, 2**100).
_B = {1: 0, 31: 5, 4097: 13, 1_000_000: 20}
_E = {0.0: 0, 1e-30: -99, 1.0: 1, 1e30: 100}


@pytest.mark.parametrize("n", sorted(_B))
def test_fixed_point_exponent_by_hand(n):
    for m, e in _E.items():
        for mf in (m, float(np.float32(m))):
            k = hg.fixed_point_exponent(mf, n)
            assert k == 62 - e - _B[n], (mf, n)
            # no sum of n rows of magnitude <= m reaches 2**62
            assert n * math.ldexp(mf, k) < 2.0 ** 62
    for bad in (math.inf, -math.inf, math.nan):
        assert hg.fixed_point_exponent(bad, n) is None


def _row_values(w, y):
    """The per-row f32 triples, as the kernel and _f64_reference form
    them."""
    with np.errstate(over="ignore", invalid="ignore"):
        wy = w * y
        return np.stack([w, wy, wy * y], axis=1)


@pytest.mark.parametrize("magnitude", ["1e20", "1e-20", "1e-20..1e20"])
def test_extreme_magnitudes_within_the_fixed_point_bound(magnitude):
    """Each bucket is within rows * 2**-k_c (the quantum of the channel's
    fixed point) plus one f32 rounding of the float64 sum of the rows'
    f32 values. A channel whose f32 values overflow is NaN throughout."""
    n, F, maxB, S = 800, 3, 8, 4
    binned, node, w, y, offsets, TB = _case(20, n, F, maxB, S,
                                            ragged_bins=True)
    rng = np.random.default_rng(21)
    if magnitude == "1e20":
        y = (y * 1e20).astype(np.float32)
    elif magnitude == "1e-20":
        y = (y * 1e-20).astype(np.float32)
    else:
        y = (y * 10.0 ** rng.uniform(-20, 20, n)).astype(np.float32)
    got = _port(binned, node, w, y, offsets, TB, S).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        expect = _f64_reference(binned, node, w, y, offsets, TB, S)
    vals = _row_values(w, y)
    for c in range(3):
        m = float(np.abs(vals[:, c]).max())
        k = hg.fixed_point_exponent(m, n)
        if k is None:
            assert np.isnan(got[:, c]).all(), c
            continue
        np.testing.assert_allclose(got[:, c], expect[:, c], rtol=1e-6,
                                   atol=n * math.ldexp(1.0, -k),
                                   err_msg=f"channel {c}")
    assert magnitude != "1e20" or np.isnan(got[:, 2]).all()


@pytest.mark.parametrize("w_bad,y_bad,nan_channels,live", [
    (np.nan, 1.0, (0, 1, 2), True),
    (np.inf, 1.0, (0, 1, 2), True),
    (1.0, np.inf, (1, 2), True),
    (0.0, np.inf, (1, 2), True),          # 0 * inf is NaN
    (1.0, 1e30, (2,), True),              # only (w*y)*y overflows
    (1.0, np.nan, (1, 2), False),         # a dead row counts too
])
def test_non_finite_row_turns_exactly_its_channels_nan(w_bad, y_bad,
                                                       nan_channels, live):
    n, F, maxB, S = 300, 3, 8, 4
    binned, node, w, y, offsets, TB = _case(22, n, F, maxB, S)
    w, y, node = w.copy(), y.copy(), node.copy()
    w[7], y[7] = w_bad, y_bad
    node[7] = 1 if live else -1
    got = _port(binned, node, w, y, offsets, TB, S).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        expect = _f64_reference(binned, node, w, y, offsets, TB, S)
    vals = _row_values(w, y)
    for c in range(3):
        if c in nan_channels:
            assert np.isnan(got[:, c]).all(), c
        else:
            m = float(np.abs(vals[:, c]).max())
            atol = n * math.ldexp(1.0, -hg.fixed_point_exponent(m, n))
            np.testing.assert_allclose(got[:, c], expect[:, c], rtol=1e-6,
                                       atol=atol, err_msg=f"channel {c}")


def test_exact_ties_round_half_to_even():
    # 4 rows (b = 2), largest value 1.0 (e = 1): k = 62 - 1 - 2 = 59, so a
    # value of j * 2**-59 quantises to round_half_even(j)
    q = math.ldexp(1.0, -59)
    w = np.array([1.0, 2.5 * q, 0.5 * q, 3.5 * q], np.float32)
    y = np.array([1.0, 1.0, -1.0, -1.0], np.float32)
    binned = np.arange(4, dtype=np.int32)[:, None]
    node = np.zeros(4, np.int32)
    got = _port(binned, node, w, y, np.zeros(1, np.int32), 4, 1).numpy()
    expect = np.array([[1.0, 1.0, 1.0],
                       [2 * q, 2 * q, 2 * q],      # 2.5 -> 2, not 3
                       [0.0, 0.0, 0.0],            # +-0.5 -> 0, not +-1
                       [4 * q, -4 * q, 4 * q]],    # 3.5 -> 4
                      np.float32)
    np.testing.assert_array_equal(got, expect)


def test_over_budget_slot_has_no_tile_plan_and_the_plain_version_runs():
    n, F, S, TB = 500, 4, 3, 12_000
    assert hg.plan_tiles(TB, S) is None
    binned, node, w, y, offsets, _ = _case(23, n, F, 3000, S)
    got = _port(binned, node, w, y, offsets, TB, S, bins=np.int16).numpy()
    expect = _f64_reference(binned, node, w, y, offsets, TB, S)
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,F,maxB,S,tile_S,blk,ragged", GEOMETRIES)
def test_cuda_kernel_vs_plain_version(seed, n, F, maxB, S, tile_S, blk,
                                      ragged):
    _cuda()
    binned, node, w, y, offsets, TB = _case(seed, n, F, maxB, S,
                                            ragged_bins=ragged)
    got = _port(binned, node, w, y, offsets, TB, S, device="cuda")
    again = _port(binned, node, w, y, offsets, TB, S, device="cuda",
                  tile_S=1)
    shuffled = _port(*_permuted(seed, binned, node, w, y), offsets, TB, S,
                     device="cuda")
    ref = _port(binned, node, w, y, offsets, TB, S)
    assert torch.equal(_bits(got.cpu()), _bits(ref)), "kernel != plain"
    assert torch.equal(_bits(got), _bits(again)), "tiling moved a bit"
    assert torch.equal(_bits(got), _bits(shuffled)), "row order moved a bit"


@pytest.mark.gpu
def test_cuda_kernel_over_budget_slot_vs_plain_version():
    _cuda()
    n, F, S, TB = 20_000, 4, 3, 12_000
    binned, node, w, y, offsets, _ = _case(23, n, F, 3000, S)
    got = _port(binned, node, w, y, offsets, TB, S, device="cuda",
                bins=np.int16)
    ref = _port(binned, node, w, y, offsets, TB, S, bins=np.int16)
    assert torch.equal(_bits(got.cpu()), _bits(ref))


# level shapes of the paths that run the kernel at new widths: XGBoost
# (the flagship's 10 features at 257 bins, int16 bins, every row live,
# tile_S 2 from the planner) and IsolationForest (ragged offsets of a
# 64-bin uniform spec: 8 numerics of 65 bins and categoricals of 5 and 4,
# TB = 529; 256 live rows of n, the rest at node -1, w = 1, y = 0)
NEW_LEVELS = ([("xgboost", 2 ** d) for d in range(6)]
              + [("isofor", 2 ** d) for d in range(9)])


def _new_level(kind, seed, n, S):
    rng = np.random.default_rng(seed)
    if kind == "xgboost":
        nbins = np.full(10, 257)
        live = np.ones(n, bool)
    else:
        nbins = np.array([65] * 8 + [5, 4])
        live = np.zeros(n, bool)
        live[rng.choice(n, min(256, n), replace=False)] = True
    offsets = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    binned = np.stack([rng.integers(0, b, n) for b in nbins], axis=1)
    node = np.where(live, rng.integers(0, S, n), -1).astype(np.int32)
    if kind == "xgboost":
        w = (rng.random(n) + 0.25).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
    else:
        w, y = live.astype(np.float32), np.zeros(n, np.float32)
    return binned, node, w, y, offsets, int(nbins.sum())


def test_new_level_layouts_plan():
    """One 257-bin XGBoost slot is 61,680 B of shared memory: two slots a
    tile, 16 tiles at S = 32. An IsolationForest slot is 12,696 B:
    sixteen a tile, 16 tiles at S = 256."""
    assert hg.plan_tiles(10 * 257, 32) == (2, 16)
    assert hg.plan_tiles(529, 256) == (16, 16)


@pytest.mark.parametrize("kind,S", [("xgboost", 4), ("xgboost", 32),
                                    ("isofor", 16), ("isofor", 256)])
def test_plain_version_at_new_levels_vs_float64(kind, S):
    binned, node, w, y, offsets, TB = _new_level(kind, S, 3000, S)
    bins = np.int16 if kind == "xgboost" else np.uint8
    got = _port(binned, node, w, y, offsets, TB, S, bins=bins).numpy()
    expect = _f64_reference(binned, node, w, y, offsets, TB, S)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    if kind == "isofor":       # integral counts are exact
        np.testing.assert_array_equal(got[:, 0], expect[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,S", NEW_LEVELS)
def test_cuda_kernel_at_new_levels_vs_plain_version(kind, S):
    _cuda()
    n = 1_000_000
    binned, node, w, y, offsets, TB = _new_level(kind, S, n, S)
    bins = np.int16 if kind == "xgboost" else np.uint8
    args = (binned, node, w, y, offsets, TB, S)
    got = _port(*args, device="cuda", bins=bins)
    ref = _port(*args, bins=bins)
    assert torch.equal(_bits(got.cpu()), _bits(ref)), "kernel != plain"
    for tile_S in (0, 1, 2):
        again = _port(*args, device="cuda", bins=bins, tile_S=tile_S)
        assert torch.equal(_bits(got), _bits(again)), f"tile_S={tile_S}"
    shuffled = _port(*_permuted(S, binned, node, w, y), offsets, TB, S,
                     device="cuda", bins=bins)
    assert torch.equal(_bits(got), _bits(shuffled)), "row order moved a bit"
