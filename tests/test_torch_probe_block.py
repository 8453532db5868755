"""PyTorch port: the plain version of the per-block probe (kernel K4)
against the JAX package's probe_sads_xla on the CPU, bit for bit, with
candidates at and past the edges of the padded stack; plus the wrapper's
argument checks and the tiled probe's hand-over of small planes.  The CUDA
kernel itself is held against this plain version on the card by
chip_smoke.py.

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
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch.ops import probe as probe_ops

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
RING = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
WALK = ((-1, -2), (-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2),
        (-2, 0))
# the chroma delta grid that goes with the 8-entry walk at 2x subsampling
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))


def _inputs(seed, pel, bs, kk, nj=2, nbx=3, nby=2, pad=8, hpad=8):
    """Stack, candidates and source blocks of a small level.  Candidates
    spread a few pixels round each block; four of them sit at the corners
    of the stack or past its bottom/right edges, where the window has to be
    shifted in.  (Window starts left of or above the stack are left out:
    there the JAX slice wraps round Python-style while the port clamps, and
    the search bounds keep every candidate away from it.)"""
    rng = np.random.default_rng(seed)
    logp = pel.bit_length() - 1
    ph = nby * bs + 2 * (hpad + pad)
    pw = nbx * bs + 2 * (hpad + pad) + 24
    stack = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, nby * nbx, bs, bs), np.uint8)
    idx = np.arange(nby * nbx)
    base_y = (hpad + pad + bs * (idx // nbx)) << logp
    base_x = (hpad + pad + bs * (idx % nbx)) << logp
    lim = (hpad + pad) * pel
    cy = base_y[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    cx = base_x[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    far_y, far_x = (ph - bs) << logp, (pw - bs) << logp
    cy = np.maximum(cy, 2 * pel)      # the offset sets reach 2 pel up/left
    cx = np.maximum(cx, 2 * pel)
    cy[0, 0, 0], cx[0, 0, 0] = 2 * pel, 2 * pel       # window at the origin
    cy[0, 1, 0], cx[0, 1, 0] = far_y, far_x           # bottom-right corner
    cy[1, 0, 0], cx[1, 0, 0] = 2 * pel, far_x + 5 * pel    # past the right
    cy[1, 1, 0], cx[1, 1, 0] = far_y + 4 * pel, 3 * pel    # past the bottom
    return stack, cy.astype(np.int32), cx.astype(np.int32), src


@pytest.mark.parametrize("pel,bs,kk,offsets", [
    (1, 16, 1, HEXAGON),
    (1, 16, 1, RING),
    (1, 16, 6, ((0, 0),)),
    (1, 8, 1, GRID16),
    (1, 8, 6, ((0, 0),)),
    (2, 16, 1, WALK),
    (2, 8, 1, HEXAGON),
    (2, 16, 6, ((0, 0),)),
], ids=["p1-b16-hex", "p1-b16-ring", "p1-b16-k6", "p1-b8-grid16", "p1-b8-k6",
        "p2-b16-walk", "p2-b8-hex", "p2-b16-k6"])
def test_probe_sads_plain_matches_jax(pel, bs, kk, offsets):
    stack, cy, cx, src = _inputs(40 + pel + bs + kk, pel, bs, kk)
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs, bs, pel).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets),)
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel))
        np.testing.assert_array_equal(got[j], want)


def test_probe_sads_inside_the_stack_is_the_plain_block_sad():
    """Away from the edges the window rule is the identity: the SAD is that
    of the block at the candidate's own subplane and full-pel origin."""
    pel, bs = 2, 8
    stack, cy, cx, src = _inputs(3, pel, bs, 1)
    cy, cx = cy[:, 2:], cx[:, 2:]                     # drop the edge cases
    src = src[:, 2:]
    cy = np.clip(cy, 4 * pel, None)
    cx = np.clip(cx, 4 * pel, None)
    got = probe_ops.probe_sads_plain(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), HEXAGON, bs, bs, pel).numpy()
    for j, b, d in ((0, 0, 0), (1, 3, 5), (0, 2, 2)):
        ay, ax = cy[j, b, 0] + HEXAGON[d][1], cx[j, b, 0] + HEXAGON[d][0]
        sub = (ax & 1) | ((ay & 1) << 1)
        blk = stack[j, sub, ay >> 1:(ay >> 1) + bs, ax >> 1:(ax >> 1) + bs]
        want = np.abs(blk.astype(np.int64) - src[j, b].astype(np.int64)).sum()
        assert got[j, b, 0, d] == want


def test_tiled_probe_hands_small_planes_to_the_block_probe():
    """Same condition as the JAX package: a stack under the tile window
    goes to the per-block probe, so no entry is INVALID_SAD."""
    pel, bs, kk = 1, 8, 1
    stack, cy, cx, src = _inputs(5, pel, bs, kk)
    wy_t, wx_t, _, _ = probe_ops.tile_params(RING, bs, bs, pel, 8, 4)
    assert stack.shape[-1] < wx_t
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), RING, bs, bs, pel)
    got = probe_ops.probe_sads_tiled(*args, row_len=3, pitch_x=4)
    assert torch.equal(got, probe_ops.probe_sads_plain(*args))
    assert int((got == probe_ops.INVALID_SAD).sum()) == 0
    want = np.asarray(jax_probe.probe_sads_tiled(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        jnp.asarray(src[0].astype(np.int32)), RING, bs, bs, pel, row_len=3,
        pitch_x=4))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_probe_sads_checks_its_arguments():
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _inputs(6, 1, 8, 1))
    ok = (stack, cy, cx, src, RING, 8, 8, 1)
    assert probe_ops.probe_sads(*ok).shape == (2, 6, 1, 8)
    with pytest.raises(NotImplementedError, match="8-bit"):
        probe_ops.probe_sads(stack.to(torch.int16), *ok[1:])
    with pytest.raises(ValueError, match="pel"):
        probe_ops.probe_sads(*ok[:7], 3)
    with pytest.raises(ValueError, match="cand_y"):
        probe_ops.probe_sads(stack, cy.to(torch.int64), *ok[2:])
    with pytest.raises(ValueError, match="inconsistent"):
        probe_ops.probe_sads(stack, cy, cx, src[:, :5].contiguous(),
                             *ok[4:])
    with pytest.raises(ValueError, match="inconsistent"):
        probe_ops.probe_sads(*ok[:7], 2)              # stack has 1 subplane


def test_probe_sads_counts_launches_only_on_the_card():
    """On the CPU the wrapper takes the plain version and counts no launch;
    the plain version counts itself only when it is run on a CUDA tensor."""
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _inputs(7, 1, 8, 1))
    before = dict(probe_ops.launches), probe_ops.plain_calls_on_cuda
    probe_ops.probe_sads(stack, cy, cx, src, RING, 8, 8, 1)
    assert (dict(probe_ops.launches), probe_ops.plain_calls_on_cuda) == before
    assert "probe_sads" in probe_ops.launches


@pytest.mark.parametrize("pel", [1, 2])
def test_probe_sads_window_before_the_stack_matches_jax(pel):
    """Windows that start left of or above the stack: the port takes the
    start the way the JAX package's window slice does (it wraps once round
    the plane, then the window is clamped inside it), bit for bit with
    probe_sads_xla, the JAX package's CPU path.  (The search bounds keep
    every candidate inside the padded stack; the JAX Pallas kernel run in
    interpret mode agrees as well: see
    test_torch_dct.py::test_fetch_and_probe_before_the_stack_match_pallas.)"""
    stack, cy, cx, src = _inputs(60 + pel, pel, 16, 2)
    cy[:, :, 0] = np.array([[-3, 5, -40, 2, 7, -1]])[:, :6] * pel + 1
    cx[:, :, 1] = np.array([[4, -9, -2, -35, 1, -1]])[:, :6] * pel
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), HEXAGON, 16, 16, pel).numpy()
    logp = pel.bit_length() - 1
    assert ((cy - 2 * pel) >> logp < 0).any() and ((cx - 2 * pel) >> logp < 0).any()
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), HEXAGON, 16, 16, pel))
        np.testing.assert_array_equal(got[j], want)
