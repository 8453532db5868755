"""PyTorch port: everything that overlapped block grids add — the blend
windows and the overlap-add (ops/overlap.py), degrain's block extraction,
the hierarchical prediction's overlap branch and the dense evaluator's
per-block sums — against the JAX package on the CPU, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers).

Some of its checks live in
test_torch_overlap_{indices,add,grid,interp,sums}.py, files of at most six
tests that pytest-xdist's loadfile scheduling hands out after the suite's
longest file."""
import os
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu  # noqa: F401  (enables x64)
import mvtools_tpu.analyse  # noqa: F401
from mvtools_tpu.ops import overlap as jax_overlap

import mvtools_tpu_torch.analyse  # noqa: F401
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
