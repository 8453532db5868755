"""PyTorch port: the dense block sums against the JAX package; split from
test_torch_overlap.py (whose docstring says how the inputs are made) into a
file of at most six tests, which pytest-xdist's loadfile scheduling hands
out after the suite's longest file."""
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

