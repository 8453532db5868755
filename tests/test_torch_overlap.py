"""PyTorch port: everything that overlapped block grids add — the blend
windows and the overlap-add (ops/overlap.py), degrain's block extraction,
the hierarchical prediction's overlap branch and the dense evaluator's
per-block sums — against the JAX package on the CPU, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers)."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu  # noqa: F401  (enables x64)
import mvtools_tpu.analyse  # noqa: F401
from mvtools_tpu import degrain as jax_degrain
from mvtools_tpu.ops import overlap as jax_overlap

import mvtools_tpu_torch.analyse  # noqa: F401
from mvtools_tpu_torch import degrain as port_degrain
from mvtools_tpu_torch.ops import overlap as overlap_ops

# the package exports the FUNCTIONS analyse, which shadow the submodules
port_analyse = sys.modules["mvtools_tpu_torch.analyse"]
jax_analyse = sys.modules["mvtools_tpu.analyse"]


@pytest.mark.parametrize("nx,ny,ox,oy", [(16, 16, 8, 8), (8, 8, 4, 4),
                                         (16, 8, 4, 2), (8, 8, 2, 0)])
def test_overlap_windows_match_jax(nx, ny, ox, oy):
    got = overlap_ops.overlap_windows(nx, ny, ox, oy)
    want = jax_overlap.overlap_windows(nx, ny, ox, oy)
    assert got.dtype == want.dtype and got.shape == (9, ny, nx)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbx,nby", [(1, 1), (2, 1), (1, 2), (2, 3), (7, 5)])
def test_window_indices_match_jax(nbx, nby):
    np.testing.assert_array_equal(overlap_ops.window_indices(nbx, nby),
                                  jax_overlap.window_indices(nbx, nby))


@pytest.mark.parametrize("nbx,nby,bs,ov", [
    (7, 5, (16, 16), (8, 8)),       # the luma grid of the YUV slice
    (6, 4, (8, 8), (4, 4)),         # its chroma grid, even counts
    (5, 3, (16, 8), (4, 0)),        # overlap on one axis only
    (1, 2, (8, 8), (2, 4)),         # a single block column
])
def test_overlap_add_and_to_pixels_match_jax(nbx, nby, bs, ov):
    """Batched overlap-add == the JAX one per frame; to_pixels saturates
    alike on values past both ends."""
    rng = np.random.default_rng(sum(bs) + nbx)
    blocks = rng.integers(0, 256, (3, nby, nbx, bs[1], bs[0])).astype(np.int32)
    wins = overlap_ops.overlap_windows(bs[0], bs[1], ov[0], ov[1])
    got = overlap_ops.overlap_add(torch.from_numpy(blocks), nbx, nby, bs, ov,
                                  wins)
    assert got.dtype == torch.int32
    for f in range(3):
        want = jax_overlap.overlap_add(jnp.asarray(blocks[f]), nbx, nby, bs,
                                       ov, wins)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))
    acc = np.concatenate([got[0].numpy().reshape(-1), [-40, -17, -16, 8175,
                                                       8176, 70000]])
    np.testing.assert_array_equal(
        overlap_ops.to_pixels(torch.from_numpy(acc), 8).numpy(),
        np.asarray(jax_overlap.to_pixels(jnp.asarray(acc), 8)))


@pytest.mark.parametrize("h,w,nby,nbx,bs,pitch", [
    (48, 64, 5, 7, (16, 16), (8, 8)),     # overlapped, grid inside the plane
    (24, 32, 5, 7, (8, 8), (4, 4)),
    (40, 50, 3, 3, (16, 16), (16, 16)),   # no overlap
    (30, 41, 3, 4, (16, 16), (8, 12)),    # grid runs past the plane
])
def test_extract_grid_blocks_matches_jax(h, w, nby, nbx, bs, pitch):
    rng = np.random.default_rng(h + w)
    planes = rng.integers(0, 256, (2, h, w)).astype(np.int32)
    got = port_degrain.extract_grid_blocks(
        torch.from_numpy(planes), nby, nbx, bs[0], bs[1], pitch[0], pitch[1])
    assert tuple(got.shape) == (2, nby, nbx, bs[0], bs[1])
    for f in range(2):
        want = jax_degrain.extract_grid_blocks(
            jnp.asarray(planes[f]), nby, nbx, bs[0], bs[1], pitch[0],
            pitch[1])
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))


@pytest.mark.parametrize("nb2,nb,bs,ov,logp", [
    ((3, 2), (7, 5), (16, 16), (8, 8), 0),     # coarse -> coarse, overlap 8
    ((15, 11), (31, 23), (16, 16), (8, 8), 1),  # -> the pel-2 finest level
    ((4, 3), (8, 6), (16, 16), (4, 4), 0),     # overlap of a quarter block
    ((4, 3), (9, 7), (8, 8), (4, 2), 1),       # fine grid past 2x the coarse
    ((4, 3), (8, 6), (16, 16), (0, 0), 1),     # no overlap (the 9/3/3/1 mix)
])
def test_interpolate_prediction_overlap_matches_jax(nb2, nb, bs, ov, logp):
    """Negative vectors and large SADs: the overlap branch multiplies by
    1.0 / normov in float64 and truncates toward zero."""
    rng = np.random.default_rng(nb[0] * 31 + ov[0])
    nbx2, nby2 = nb2
    nbx, nby = nb
    nj = 3
    vx = rng.integers(-90, 91, (nj, nby2 * nbx2)).astype(np.int32)
    vy = rng.integers(-70, 71, (nj, nby2 * nbx2)).astype(np.int32)
    vs = rng.integers(0, 80000, (nj, nby2 * nbx2)).astype(np.int64)
    got = port_analyse.interpolate_prediction(
        tuple(torch.from_numpy(a) for a in (vx, vy, vs)), nbx2, nby2, nbx,
        nby, bs, ov, logp)
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.int64]
    for j in range(nj):
        want = jax_analyse.interpolate_prediction(
            tuple(jnp.asarray(a[j]) for a in (vx, vy, vs)), nbx2, nby2, nbx,
            nby, bs, ov, logp)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g[j].numpy(), np.asarray(w_))


@pytest.mark.parametrize("nb,bs,ov", [
    ((7, 5), (16, 16), (8, 8)),      # pitch divides the block: cell sums
    ((6, 4), (8, 8), (4, 4)),
    ((5, 4), (16, 16), (0, 0)),
    ((5, 4), (16, 16), (4, 4)),      # pitch 12: integral image
    ((4, 3), (16, 8), (6, 2)),
])
def test_dense_block_sums_match_jax(nb, bs, ov):
    """Both routes of DenseEvaluator._block_sums give the JAX package's
    integral-image sums, which are the blocks' plain sums."""
    rng = np.random.default_rng(nb[0] + bs[0] + ov[0])
    nbx, nby = nb
    hr = (nby - 1) * (bs[1] - ov[1]) + bs[1]
    wr = (nbx - 1) * (bs[0] - ov[0]) + bs[0]
    diff = rng.integers(0, 256, (2, hr, wr)).astype(np.int16)
    got = port_analyse.DenseEvaluator._block_sums(
        torch.from_numpy(diff), bs, ov, nb)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, nbx * nby)
    for j in range(2):
        want = jax_analyse.DenseEvaluator._block_sums(
            None, jnp.asarray(diff[j].astype(np.int32)), bs, ov, nb, None,
            None)
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))
    sy, sx = bs[1] - ov[1], bs[0] - ov[0]
    blk = diff[1, 2 * sy:2 * sy + bs[1], 3 * sx:3 * sx + bs[0]]
    assert int(got[1, 2 * nbx + 3]) == int(blk.astype(np.int64).sum())


def test_blocks_of_overlapped_grid():
    """Source blocks of an overlapped grid are the strided windows of the
    plane, in raster order."""
    rng = np.random.default_rng(9)
    plane = rng.integers(0, 256, (2, 60, 70), np.uint8)
    got = port_analyse._blocks_of(torch.from_numpy(plane), 4, 6, 5, 7, 16, 16,
                                  8, 8)
    assert tuple(got.shape) == (2, 35, 16, 16) and got.dtype == torch.uint8
    for j, by, bx in ((0, 0, 0), (1, 4, 6), (1, 2, 3)):
        np.testing.assert_array_equal(
            got[j, by * 7 + bx].numpy(),
            plane[j, 4 + 8 * by:20 + 8 * by, 6 + 8 * bx:22 + 8 * bx])
    plain = port_analyse._blocks_of(torch.from_numpy(plane), 4, 6, 3, 4, 16,
                                    16)
    np.testing.assert_array_equal(plain[0, 5].numpy(),
                                  plane[0, 20:36, 22:38])
