"""PyTorch port: the plain version of the dense SAD map (kernel K1)
against the JAX package's reference semantics (sadmap.sad_map_xla), bit
for bit.  The CUDA kernel itself is held against this plain version on
the card by chip_smoke.py.

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
from mvtools_tpu.ops import probe as jax_probe, sadmap as jax_sadmap

from mvtools_tpu_torch.ops import probe as probe_ops, sadmap


@pytest.mark.parametrize("pel,r_y,r_x,nbx,tile", [
    (2, 3, 4, 5, 4),     # ragged tail tile (one block)
    (1, 2, 3, 4, 2),
    (2, 7, 7, 3, 3),     # the finest level's radius
])
def test_sad_map_plain_matches_jax(pel, r_y, r_x, nbx, tile):
    rng = np.random.default_rng(10 + pel)
    bs, nby, pad, hpad = 16, 2, 16, 8
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad
    nj = 2
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, ph, pw), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    hp, wp = stack.shape[-2:]
    args = (r_y, r_x, bs, bs, pel, tile, bs)
    assert sadmap.map_geom(*args) == jax_sadmap.map_geom(*args)
    bounds = sadmap.anchor_bounds(*args, hp, wp)
    assert bounds == jax_sadmap.anchor_bounds(*args, hp, wp)
    (lo_y, hi_y), (lo_x, hi_x) = bounds
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (nj, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (nj, nby * ntx)).astype(np.int32)
    # both clamp ends
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    got = sadmap.sad_map(stack, torch.from_numpy(src),
                         torch.from_numpy(afy), torch.from_numpy(afx),
                         r_y, r_x, bs, bs, pel, tile, bs, bs, nbx, nby,
                         hpad, hpad).numpy()
    assert got.shape == (nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1)
    assert got.dtype == np.int32

    # JAX side: per-block anchors in pel units, per-block source blocks
    bx = np.arange(nbx)
    logp = pel.bit_length() - 1
    for j in range(nj):
        cy = np.repeat(afy[j].reshape(nby, ntx)[:, bx // tile], 1, 1)
        cx = afx[j].reshape(nby, ntx)[:, bx // tile] + (bx % tile) * bs
        blocks = (src[j, hpad:hpad + nby * bs, hpad:hpad + nbx * bs]
                  .reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3)
                  .reshape(nby * nbx, bs, bs))
        want = jax_sadmap.sad_map_xla(
            jnp.asarray(stack[j].numpy()),
            jnp.asarray((cy << logp).reshape(-1).astype(np.int32)),
            jnp.asarray((cx << logp).reshape(-1).astype(np.int32)),
            jnp.asarray(blocks.astype(np.int32)), r_y, r_x, bs, bs, pel)
        np.testing.assert_array_equal(
            got[j].reshape(nby * nbx, -1), np.asarray(want))


def test_grid_offsets_match_jax():
    assert sadmap.grid_offsets(2, 3) == jax_sadmap.grid_offsets(2, 3)
    assert probe_ops.INVALID_SAD == int(jax_probe.INVALID_SAD)
    assert (probe_ops.ALIGN_SLACK_Y, probe_ops.ALIGN_SLACK_X) == (
        jax_probe.ALIGN_SLACK_Y, jax_probe.ALIGN_SLACK_X)
