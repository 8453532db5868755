"""PyTorch port: K2's plain version on uint16 stacks against the JAX package's
tiled probe; split from test_torch_u16_kernels.py (whose docstring says how
the inputs are made) into a file of at most six tests, which pytest-xdist's
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
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_u16_kernels import (GRID16, HEXAGON, RING,  # noqa: E402
                                    _extremes, _pixels)


@pytest.mark.parametrize("bits,pel,kk,offsets,data", [
    (16, 2, 1, HEXAGON, "random"), (16, 2, 1, RING, "extremes"),
    (10, 1, 6, ((0, 0),), "random"), (10, 2, 1, HEXAGON, "extremes"),
    (16, 2, 1, GRID16, "random 8x8"), (10, 1, 1, GRID16, "extremes 8x8")])
def test_probe_sads_tiled_plain_u16_matches_jax(bits, pel, kk, offsets, data):
    """K2's plain version on a uint16 stack == the JAX package's tiled
    probe: a tenth of the candidates thrown off its tile comes back
    INVALID_SAD on both sides, and an `active` mask leaves about 40 % of
    the entries live, the others INVALID_SAD.  Blocks are 16x16, or 8x8
    (the YUV420 path's chroma shape, with its 16 offsets) where `data`
    says so."""
    rng = np.random.default_rng(200 + bits + pel + kk)
    data, _, size = data.partition(" ")
    bs = int(size.split("x")[0]) if size else 16
    nbx, nby, pad, hpad = 6, 3, 16, 16
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad + 64
    nj = 2
    logp = pel.bit_length() - 1
    ref = _pixels(rng, (nj, pel * pel, ph, pw), bits)
    src = _pixels(rng, (nj, nby * nbx, bs, bs), bits)
    if data == "extremes":
        ref, src = _extremes(ref, src, bits)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    idx = np.arange(nby * nbx)
    base_y = (hpad + bs * (idx // nbx) + pad) << logp
    base_x = (hpad + bs * (idx % nbx) + pad) << logp
    vy = rng.integers(-5, 6, (nj, nby * nbx, kk))
    vx = rng.integers(-5, 6, (nj, nby * nbx, kk))
    far = rng.random((nj, nby * nbx, kk)) < 0.1
    far[0, 0, 0] = far[1, -1, -1] = True
    # past the tile window's extent (an 8x8 block's reaches further out)
    throw_x, throw_y = (140, 30) if bs == 16 else (260, 60)
    vx = np.where(far, vx + throw_x * pel, vx)
    vy = np.where(far, vy + throw_y * pel, vy)
    cy = (base_y[None, :, None] + vy).astype(np.int32)
    cx = (base_x[None, :, None] + vx).astype(np.int32)
    active = rng.random((nj, nby * nbx, kk, len(offsets))) < 0.4
    args = (stack, torch.from_numpy(cy), torch.from_numpy(cx),
            torch.from_numpy(src), offsets, bs, bs, pel)
    got = probe_ops.probe_sads_tiled(*args, row_len=nbx, pitch_x=bs).numpy()
    masked = probe_ops.probe_sads_tiled(
        *args, row_len=nbx, pitch_x=bs,
        active=torch.from_numpy(active)).numpy()
    n_invalid = 0
    for j in range(nj):
        want = np.asarray(jax_probe.probe_sads_tiled(
            jnp.asarray(stack[j].numpy()), jnp.asarray(cy[j]),
            jnp.asarray(cx[j]), jnp.asarray(src[j].astype(np.int32)),
            offsets, bs, bs, pel, row_len=nbx, pitch_x=bs))
        np.testing.assert_array_equal(got[j], want)
        n_invalid += int((want == probe_ops.INVALID_SAD).sum())
    assert 0 < n_invalid < got.size
    np.testing.assert_array_equal(masked[active], got[active])
    assert (masked[~active] == probe_ops.INVALID_SAD).all()
    if data == "extremes":
        assert (got[got != probe_ops.INVALID_SAD]
                == bs * bs * ((1 << bits) - 1)).all()

