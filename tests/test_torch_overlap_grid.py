"""PyTorch port: the blocks of an overlapped grid against the JAX package;
split from test_torch_overlap.py (whose docstring says how the inputs are
made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
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
from mvtools_tpu import degrain as jax_degrain
from mvtools_tpu_torch import degrain as port_degrain


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

