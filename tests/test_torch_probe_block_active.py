"""PyTorch port: the per-block probe (kernel K4) with an `active` mask, and
the tiled probe's hand-over of small planes, which passes its mask to it,
against the JAX package's probe_sads_xla on the CPU with INVALID_SAD written
where the mask is false (tolerance 0 — integers).

On CPU tensors the wrappers take the plain version; on the card the kernel
applies the mask itself (an inactive entry reads no pixel), and
chip_smoke.py holds it to this plain version.  Stacks of 8, 10 and 16 bits,
masks with every entry, about 30 % and about 3 % of them live, and none;
candidates past the stack's bottom and right edges, where the window of the
offset set is shifted in.  Inputs come from numpy with a seed."""
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
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch.ops import probe as probe_ops

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
LIVE_SHARES = (1.0, 0.3, 0.03, 0.0)


def _inputs(seed, bits, pel, bs, kk, nj=2, nbx=3, nby=2, pad=6):
    """A small stack of `bits`-bit pixels (uint8 for 8) over the whole range
    of the depth, candidates a few pixels round each block, three of them
    past the bottom, the right or both edges, and the source blocks."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if bits == 8 else np.uint16
    top = (1 << bits) - 1
    ph = nby * bs + 2 * pad
    pw = nbx * bs + 2 * pad + 4
    stack = rng.integers(0, top + 1, (nj, pel * pel, ph, pw)).astype(dtype)
    src = rng.integers(0, top + 1, (nj, nby * nbx, bs, bs)).astype(dtype)
    idx = np.arange(nby * nbx)
    base_y = (pad + bs * (idx // nbx)) * pel
    base_x = (pad + bs * (idx % nbx)) * pel
    lim = (pad - 2) * pel
    cy = base_y[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    cx = base_x[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    far_y, far_x = (ph - bs) * pel, (pw - bs) * pel
    cy[0, -1, 0], cx[0, -1, 0] = far_y + 3 * pel, far_x + 5 * pel + 1
    cy[1, 1, -1] = far_y + 4 * pel + 1                  # past the bottom
    cx[1, 2, 0] = far_x + 2 * pel                       # past the right
    return stack, cy.astype(np.int32), cx.astype(np.int32), src


def _masks(seed, shape):
    """The `active` masks of LIVE_SHARES (all-live, ~30 %, ~3 %, none)."""
    rng = np.random.default_rng(seed)
    return [rng.random(shape) < s for s in LIVE_SHARES]


def _jax_sads(stack, cy, cx, src, offsets, bs, pel):
    """[J, nblk, K, D] of probe_sads_xla, job by job."""
    return np.stack([np.asarray(jax_probe.probe_sads_xla(
        jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
        jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel))
        for j in range(stack.shape[0])])


def _check_masked(got, want, mask):
    """got is want where the mask is live and INVALID_SAD elsewhere."""
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(
        got, np.where(mask, want, probe_ops.INVALID_SAD))


@pytest.mark.parametrize("bits,pel,bs,kk,offsets", [
    (8, 2, 8, 1, GRID16),
    (10, 1, 16, 6, ((0, 0),)),
    (16, 2, 16, 1, HEXAGON),
], ids=["u8", "10-bit", "16-bit"])
def test_probe_sads_with_a_mask_matches_jax(bits, pel, bs, kk, offsets):
    """probe_sads(..., active=mask) is probe_sads_xla where the mask is
    live and INVALID_SAD elsewhere, for every mask of LIVE_SHARES."""
    stack, cy, cx, src = _inputs(20 + bits, bits, pel, bs, kk)
    want = _jax_sads(stack, cy, cx, src, offsets, bs, pel)
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs, bs, pel)
    for mask in _masks(bits, want.shape):
        got = probe_ops.probe_sads(*args, active=torch.from_numpy(mask))
        _check_masked(got.numpy(), want, mask)
    np.testing.assert_array_equal(probe_ops.probe_sads(*args).numpy(), want)


@pytest.mark.parametrize("bits,pel,bs,kk,offsets", [
    (8, 1, 16, 1, HEXAGON),
    (16, 2, 8, 6, ((0, 0),)),
], ids=["u8", "16-bit"])
def test_tiled_probe_hands_its_mask_to_the_block_probe(bits, pel, bs, kk,
                                                       offsets):
    """A plane under the tile window goes to probe_sads with the mask: the
    tiled probe's output is probe_sads_xla where live, INVALID_SAD elsewhere
    (no entry is off-tile there), and equals probe_sads's."""
    stack, cy, cx, src = _inputs(30 + bits, bits, pel, bs, kk)
    tile = 8 if kk <= 2 else 4
    assert stack.shape[-1] < probe_ops.tile_params(offsets, bs, bs, pel,
                                                   tile, bs)[1]
    want = _jax_sads(stack, cy, cx, src, offsets, bs, pel)
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs, bs, pel)
    for mask in _masks(40 + bits, want.shape):
        active = torch.from_numpy(mask)
        got = probe_ops.probe_sads_tiled(*args, row_len=3, pitch_x=bs,
                                         active=active)
        _check_masked(got.numpy(), want, mask)
        assert torch.equal(got, probe_ops.probe_sads(*args, active=active))


def test_probe_sads_takes_a_broadcast_mask():
    """A mask that broadcasts to [J, nblk, K, D] (a block's whole grid, as
    the chroma probes pass it; one offset for every block) acts as its
    broadcast; a mask of another dtype or device raises."""
    bits, pel, bs, kk = 10, 2, 8, 2
    stack, cy, cx, src = _inputs(50, bits, pel, bs, kk)
    want = _jax_sads(stack, cy, cx, src, HEXAGON, bs, pel)
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), HEXAGON, bs, bs, pel)
    rng = np.random.default_rng(51)
    for shape in ((2, 6, 1, 1), (1, 1, 1, 6)):
        mask = rng.random(shape) < 0.5
        got = probe_ops.probe_sads(*args, active=torch.from_numpy(mask))
        _check_masked(got.numpy(), want, np.broadcast_to(mask, want.shape))
    with pytest.raises(ValueError, match="bool"):
        probe_ops.probe_sads(*args, active=torch.ones(want.shape))
