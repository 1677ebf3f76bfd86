"""The port's histogram (h2o3_tpu_torch/models/tree/hist_gather.py): its
plain version against the JAX package's Pallas kernel (interpret mode)
and XLA twin on the reference's five kernel-test geometries, against the
float64 ground truth, dead/zero-weight rows, the shared-memory tile
planner, and (on a CUDA card only) the hand-written kernel against the
plain version."""

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
    budget = hg.SMEM_PER_BLOCK - hg.STAGE_BYTES
    for TB, S in [(210, 1), (210, 16), (210, 64), (40, 12), (512, 64),
                  (96, 1), (1024, 4096), (4000, 3)]:
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        assert 12 * TB * tile_S <= budget              # fits shared memory
        assert tile_S * n_tiles >= S > tile_S * (n_tiles - 1)   # covers S
        assert tile_S <= S
    # the flagship's widest level (S=16, TB=210) is one tile of ~40 KB
    assert hg.plan_tiles(210, 16) == (16, 1)
    # one slot over the budget: no plan, and the CUDA wrapper raises
    assert hg.plan_tiles(budget // 12 + 1, 2) is None
    assert hg.plan_tiles(100, 8, budget=1199) is None


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


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n,F,maxB,S,tile_S,blk,ragged", GEOMETRIES)
def test_cuda_kernel_vs_plain_version(seed, n, F, maxB, S, tile_S, blk,
                                      ragged):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    binned, node, w, y, offsets, TB = _case(seed, n, F, maxB, S,
                                            ragged_bins=ragged)
    got = _port(binned, node, w, y, offsets, TB, S, device="cuda")
    again = _port(binned, node, w, y, offsets, TB, S, device="cuda",
                  tile_S=1)
    ref = _port(binned, node, w, y, offsets, TB, S)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got, again), "tiling moved a bit"
