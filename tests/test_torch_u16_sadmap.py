"""PyTorch port: the uint16 form of K1's plain version (the dense SAD map)
on 10- and 16-bit stacks against the JAX package's sad_map_xla on the CPU,
bit for bit, a ragged tail tile and blocks of 0 against the pixel maximum
included.  The CUDA kernel itself is held against this plain version on the
card by chip_smoke.py.

Five tests (each compiles sad_map_xla for its shape, a few seconds): a file
of at most six, which pytest-xdist's loadfile scheduling hands out after
the larger files.  Tolerance 0 (integers)."""
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
from mvtools_tpu.ops import sadmap as jax_sadmap

from mvtools_tpu_torch.ops import probe as probe_ops, sadmap
from test_torch_u16_kernels import _extremes, _pixels  # noqa: E402


@pytest.mark.parametrize("bits,bs,data,tile", [
    (16, 16, "random", 3), (16, 16, "extremes", 2), (16, 8, "random", 4),
    (10, 32, "random", 2), (10, 8, "extremes", 3)])
def test_sad_map_plain_u16_matches_jax(bits, bs, data, tile):
    """K1's plain version on a uint16 stack == sad_map_xla, a ragged tail
    tile included; with 0 against the maximum every entry is bs^2 * (2^bits
    - 1) (16 776 960 for 16x16 at 16 bits)."""
    rng = np.random.default_rng(100 + bits + bs)
    pel, r_y, r_x, nbx, nby, pad, hpad = 2, 4, 5, 5, 2, 16, 8
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad
    nj = 2
    ref = _pixels(rng, (nj, pel * pel, ph, pw), bits)
    src = _pixels(rng, (nj, ph, pw), bits)
    if data == "extremes":
        ref, src = _extremes(ref, src, bits)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    assert stack.dtype == torch.uint16
    hp, wp = stack.shape[-2:]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r_y, r_x, bs, bs, pel, tile, bs, hp, wp)
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (nj, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (nj, nby * ntx)).astype(np.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    got = sadmap.sad_map(stack, torch.from_numpy(src), torch.from_numpy(afy),
                         torch.from_numpy(afx), r_y, r_x, bs, bs, pel, tile,
                         bs, bs, nbx, nby, hpad, hpad).numpy()
    assert got.shape == (nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1)
    if data == "extremes":
        assert (got == bs * bs * ((1 << bits) - 1)).all()
    bx = np.arange(nbx)
    logp = pel.bit_length() - 1
    for j in range(nj):
        cy = afy[j].reshape(nby, ntx)[:, bx // tile]
        cx = afx[j].reshape(nby, ntx)[:, bx // tile] + (bx % tile) * bs
        blocks = (src[j, hpad:hpad + nby * bs, hpad:hpad + nbx * bs]
                  .reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3)
                  .reshape(nby * nbx, bs, bs))
        want = jax_sadmap.sad_map_xla(
            jnp.asarray(stack[j].numpy()),
            jnp.asarray((cy << logp).reshape(-1).astype(np.int32)),
            jnp.asarray((cx << logp).reshape(-1).astype(np.int32)),
            jnp.asarray(blocks.astype(np.int32)), r_y, r_x, bs, bs, pel)
        np.testing.assert_array_equal(got[j].reshape(nby * nbx, -1),
                                      np.asarray(want))
