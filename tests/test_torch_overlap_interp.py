"""PyTorch port: the overlapped prediction's interpolation against the JAX
package; split from test_torch_overlap.py (whose docstring says how the
inputs are made) into a file of at most six tests, which pytest-xdist's
loadfile scheduling hands out after the suite's longest file."""
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
from test_torch_overlap import jax_analyse, port_analyse  # noqa: E402


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

