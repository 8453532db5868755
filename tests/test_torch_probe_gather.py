"""PyTorch port: the probes' refusal of a plane under the window, degrain's
block gather and the per-block fetch at the plane's edges against the JAX
package; split from test_torch_probe.py (whose docstring says how the inputs
are made) into a file of at most six tests, which pytest-xdist's loadfile
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
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_probe import (HEXAGON, _gather_inputs,  # noqa: E402
                              _port_gather)


def test_probe_too_small_plane_raises():
    """A plane smaller than the tile window goes to the per-block probe
    (every candidate valid); one smaller than the offset set's own window
    cannot be probed at all and raises."""
    z = torch.zeros((1, 4, 1), dtype=torch.int32)
    src = torch.zeros((1, 4, 16, 16), dtype=torch.uint8)
    out = probe_ops.probe_sads_tiled(
        torch.full((1, 1, 40, 40), 3, dtype=torch.uint8), z, z, src, HEXAGON,
        16, 16, 1, row_len=4, pitch_x=16)
    assert out.shape == (1, 4, 1, 6) and bool((out == 3 * 256).all())
    with pytest.raises(ValueError, match="smaller than the window"):
        probe_ops.probe_sads_tiled(
            torch.zeros((1, 1, 18, 18), dtype=torch.uint8), z, z, src,
            HEXAGON, 16, 16, 1, row_len=4, pitch_x=16)


@pytest.mark.parametrize("pel", [1, 2])
def test_gather_blocks_matches_jax(pel):
    """degrain.gather_blocks (kernel K3's caller) == the JAX package's
    CPU path, including vectors pointing past the bottom/right edge of
    the padded plane (both sides clamp the full-pel origin so the patch
    stays inside) and down to the top/left edge."""
    stack, pos_x, pos_y, mvx, mvy, bs, hpad = _gather_inputs(pel, False)
    got = _port_gather(stack, pos_x, pos_y, mvx, mvy, bs, hpad, pel)
    assert got.dtype == np.int32
    for b in range(stack.shape[0]):
        want = jax_degrain.gather_blocks(
            jnp.asarray(stack[b]), jnp.asarray(pos_x), jnp.asarray(pos_y),
            jnp.asarray(mvx[b]), jnp.asarray(mvy[b]), bs, bs,
            pel.bit_length() - 1, hpad * pel, hpad * pel, pitch_fp=bs)
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("pel", [1, 2])
def test_gather_blocks_clamps_past_the_top_left_edge(pel):
    """A vector pointing past the TOP/LEFT edge: the port takes the
    full-pel origin the way the JAX package's CPU path (a window slice)
    takes it, and so does the JAX package's Pallas fetch kernel run in
    interpret mode: a negative start wraps once round the plane, then the
    patch is clamped inside it; the subplane follows the position's own
    parity.  (The JAX package's TPU path clamps the pel position to 0
    before its kernel instead.  The search never emits such vectors — its
    bounds keep every block inside the padded plane.)"""
    stack, pos_x, pos_y, mvx, mvy, bs, hpad = _gather_inputs(pel, True)
    got = _port_gather(stack, pos_x, pos_y, mvx, mvy, bs, hpad, pel)
    lp = pel.bit_length() - 1
    nb, _, ph, pw = stack.shape
    xa = (pos_x << lp) + mvx + hpad * pel
    ya = (pos_y << lp) + mvy + hpad * pel
    assert (xa < 0).any() and (ya < 0).any()
    sub = (xa & (pel - 1)) | ((ya & (pel - 1)) << lp)
    fy, fx = ya >> lp, xa >> lp
    fy = np.clip(np.where(fy < 0, fy + ph, fy), 0, ph - bs)
    fx = np.clip(np.where(fx < 0, fx + pw, fx), 0, pw - bs)
    for b in range(nb):
        want = jax_degrain.gather_blocks(
            jnp.asarray(stack[b]), jnp.asarray(pos_x), jnp.asarray(pos_y),
            jnp.asarray(mvx[b]), jnp.asarray(mvy[b]), bs, bs, lp,
            hpad * pel, hpad * pel, pitch_fp=bs)
        np.testing.assert_array_equal(got[b], np.asarray(want))
        for j in range(pos_x.shape[0]):
            for i in range(pos_x.shape[1]):
                want = stack[b, sub[b, j, i], fy[b, j, i]:fy[b, j, i] + bs,
                             fx[b, j, i]:fx[b, j, i] + bs]
                np.testing.assert_array_equal(got[b, j, i], want)


def test_fetch_blocks_reads_edge_pixels_outside_the_plane():
    """The fetches themselves clamp, so no position can fault: both the
    tiled fetch and the per-block fetch (which the tiled one hands a plane
    this small to) take the block's origin as a whole, the way a window
    slice takes it (a negative start wraps once round the plane first:
    probe.wrap_clamp), so every block is a window of the plane."""
    stack = torch.arange(2 * 6 * 8, dtype=torch.uint8).reshape(1, 2, 6, 8)[
        :, :1].contiguous()
    cy = torch.tensor([[[-2], [4]]], dtype=torch.int32)
    cx = torch.tensor([[[-3], [6]]], dtype=torch.int32)
    p = stack[0, 0].to(torch.int32)
    out = probe_ops.fetch_blocks_tiled_plain(stack, cy, cx, 4, 4, 1)
    assert torch.equal(out[0, 0, 0], p[2:6, 4:8])     # -2 -> 4, -3 -> 5
    assert torch.equal(out[0, 1, 0], p[2:6, 4:8])     # 4 -> 2, 6 -> 4
    out = probe_ops.fetch_blocks_tiled(stack, cy, cx, 4, 4, 1, row_len=2,
                                       pitch_x=4)
    assert torch.equal(out[0, 0, 0], p[2:6, 4:8])
    assert torch.equal(out[0, 1, 0], p[2:6, 4:8])

