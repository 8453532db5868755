"""PyTorch port: overlap-add and the conversion to pixels against the JAX
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
from mvtools_tpu.ops import overlap as jax_overlap
from mvtools_tpu_torch.ops import overlap as overlap_ops


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

