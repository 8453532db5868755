"""PyTorch port: one pyramid level's dense DCT map through MapProber, modes
1-4, split from test_torch_dct.py (whose docstring says how its inputs are
made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
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
import mvtools_tpu as mvt  # (enables x64)
from test_torch_dct import _probers, level  # noqa: E402


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_map_prober_dct_map_matches_jax(level, mode):
    """MapProber's dense DCT map [J, nblk, 2r+1, 2r+1] int32 (one
    _dct_cost row per grid dy, the rows fetched through the tiled fetch)
    and its anchors."""
    jax_probers, port = _probers(level, mode, True)
    r = port.r
    assert port._m_l.dtype == torch.int32
    assert tuple(port._m_l.shape) == (2, port.ctx.nblk[0] * port.ctx.nblk[1],
                                      2 * r + 1, 2 * r + 1)
    for j, p in enumerate(jax_probers):
        np.testing.assert_array_equal(port._av_x[j].numpy(),
                                      np.asarray(p._av_x))
        np.testing.assert_array_equal(port._av_y[j].numpy(),
                                      np.asarray(p._av_y))
        np.testing.assert_array_equal(port._m_l[j].numpy(),
                                      np.asarray(p._m_l))

