"""PyTorch port: the plain three-stat versions (stats="sad_satd_luma") of
the SAD map (kernel K1'), the tiled probe (K2') and the per-block probe
(K4') against the JAX package's reference semantics on the CPU, bit for bit.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.

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

STATS = "sad_satd_luma"
HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
RING = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
INVALID = probe_ops.INVALID_SAD


@pytest.mark.parametrize("pel,bs,r_y,r_x,nbx,tile", [
    (2, 16, 2, 3, 5, 4),     # ragged tail tile (one block)
    (1, 16, 2, 2, 4, 2),
    (2, 8, 3, 2, 6, 4),
    (1, 8, 1, 3, 3, 3),
])
def test_sad_map_stats_plain_matches_jax(pel, bs, r_y, r_x, nbx, tile):
    rng = np.random.default_rng(50 + pel + bs)
    nby, pad, hpad = 2, 16, 8
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad
    nj = 2
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, ph, pw), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    hp, wp = stack.shape[-2:]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r_y, r_x, bs, bs, pel, tile, bs, hp, wp)
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (nj, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (nj, nby * ntx)).astype(np.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    args = (stack, torch.from_numpy(src), torch.from_numpy(afy),
            torch.from_numpy(afx), r_y, r_x, bs, bs, pel, tile, bs, bs, nbx,
            nby, hpad, hpad)
    got = sadmap.sad_map(*args, stats=STATS).numpy()
    assert got.shape == (nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1, 3)
    assert got.dtype == np.int32
    # the first of the three is the plain map
    np.testing.assert_array_equal(got[..., 0], sadmap.sad_map(*args).numpy())

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
            jnp.asarray(blocks.astype(np.int32)), r_y, r_x, bs, bs, pel,
            stats=STATS)
        np.testing.assert_array_equal(
            got[j].reshape(nby * nbx, -1, 3), np.asarray(want))


@pytest.mark.parametrize("pel,bs,kk,offsets", [
    (2, 16, 1, HEXAGON),        # the rescue's hexagon, tile 8
    (2, 16, 1, ((0, 0),)),      # Recalculate's predictor cost
    (1, 16, 6, ((0, 0),)),      # six predictor candidates, tile 4
    (1, 8, 1, RING),
])
def test_probe_sads_tiled_stats_plain_matches_jax(pel, bs, kk, offsets):
    """Row length 6 is no multiple of the tile, so block rows are
    edge-padded; a tenth of the candidates is thrown off its tile and must
    come back as INVALID_SAD in all three stats on both sides."""
    rng = np.random.default_rng(60 + pel + kk + bs)
    nbx, nby, pad, hpad = 6, 3, 16, 16
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad + 160
    nj = 2
    logp = pel.bit_length() - 1
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, nby * nbx, bs, bs), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    idx = np.arange(nby * nbx)
    base_y = (hpad + bs * (idx // nbx) + pad) << logp
    base_x = (hpad + bs * (idx % nbx) + pad) << logp
    vy = rng.integers(-5, 6, (nj, nby * nbx, kk))
    vx = rng.integers(-5, 6, (nj, nby * nbx, kk))
    far = rng.random((nj, nby * nbx, kk)) < 0.1
    vx = np.where(far, vx + 140 * pel, vx)
    vy = np.where(far, vy + 30 * pel, vy)
    cy = (base_y[None, :, None] + vy).astype(np.int32)
    cx = (base_x[None, :, None] + vx).astype(np.int32)
    args = (stack, torch.from_numpy(cy), torch.from_numpy(cx),
            torch.from_numpy(src), offsets, bs, bs, pel)
    got = probe_ops.probe_sads_tiled(*args, row_len=nbx, pitch_x=bs,
                                     stats=STATS).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets), 3)
    np.testing.assert_array_equal(
        got[..., 0],
        probe_ops.probe_sads_tiled(*args, row_len=nbx, pitch_x=bs).numpy())
    invalid = got[..., 0] == INVALID
    assert 0 < invalid.sum() < invalid.size
    assert (got[invalid] == INVALID).all()
    assert (got[~invalid] != INVALID).all()
    for j in range(nj):
        want = np.asarray(jax_probe.probe_sads_tiled(
            jnp.asarray(stack[j].numpy()), jnp.asarray(cy[j]),
            jnp.asarray(cx[j]), jnp.asarray(src[j].astype(np.int32)),
            offsets, bs, bs, pel, row_len=nbx, pitch_x=bs, stats=STATS))
        np.testing.assert_array_equal(got[j], want)


def _block_probe_inputs(seed, pel, bs, kk, nj=2, nbx=3, nby=2, pad=8, hpad=8):
    """A small level whose stack is under the tile window; four candidates
    sit at the corners of the stack or past its bottom/right edges."""
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
    (1, 16, 6, ((0, 0),)),
    (2, 8, 1, RING),
    (2, 16, 1, ((0, 0),)),
], ids=["p1-b16-hex", "p1-b16-k6", "p2-b8-ring", "p2-b16-one"])
def test_probe_sads_stats_plain_matches_jax(pel, bs, kk, offsets):
    stack, cy, cx, src = _block_probe_inputs(70 + pel + bs + kk, pel, bs, kk)
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs, bs, pel)
    got = probe_ops.probe_sads(*args, stats=STATS).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets), 3)
    np.testing.assert_array_equal(got[..., 0],
                                  probe_ops.probe_sads(*args).numpy())
    assert (got != INVALID).all()
    # the tiled wrapper hands a stack under its window to this probe
    np.testing.assert_array_equal(
        probe_ops.probe_sads_tiled(*args, row_len=3, pitch_x=bs,
                                   stats=STATS).numpy(), got)
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel,
            stats=STATS))
        np.testing.assert_array_equal(got[j], want)


def test_stats_guards_raise_value_errors():
    """The three-stat forms take 8-bit stacks only; the map also needs the
    grid to line up with the 8x4 SATD partitions."""
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _block_probe_inputs(6, 1, 8, 1))
    ok = (stack, cy, cx, src, RING, 8, 8, 1)
    assert probe_ops.probe_sads(*ok, stats=STATS).shape == (2, 6, 1, 8, 3)
    with pytest.raises(ValueError, match="8-bit"):
        probe_ops.probe_sads(stack.to(torch.int16), *ok[1:], stats=STATS)
    with pytest.raises(ValueError, match="8-bit"):
        probe_ops.probe_sads_tiled(stack.to(torch.int16), *ok[1:], row_len=3,
                                   pitch_x=8, stats=STATS)
    with pytest.raises(ValueError, match="stats must be"):
        probe_ops.probe_sads(*ok, stats="satd")
    with pytest.raises(ValueError, match="no SATD"):
        probe_ops.probe_sads(stack, cy, cx, src[:, :, :2].contiguous(), RING,
                             2, 8, 1, stats=STATS)
    z = torch.zeros((1, 2), dtype=torch.int32)
    plane = torch.zeros((1, 64, 64), dtype=torch.uint8)
    big = torch.zeros((1, 1, 200, 600), dtype=torch.uint8)
    geom = dict(r_y=1, r_x=1, pel=1, tile=1, nbx=2, nby=1, src_y0=0, src_x0=0)
    for kw, dtype in ((dict(bs_y=8, bs_x=8, pitch_x=4, pitch_y=8), None),
                      (dict(bs_y=8, bs_x=4, pitch_x=8, pitch_y=8), None),
                      (dict(bs_y=2, bs_x=16, pitch_x=16, pitch_y=2), None),
                      (dict(bs_y=8, bs_x=8, pitch_x=8, pitch_y=8),
                       torch.int16)):
        st = big if dtype is None else big.to(dtype)
        with pytest.raises(ValueError, match="satd map"):
            sadmap.sad_map(st, plane, z, z, stats=STATS, **geom, **kw)
    with pytest.raises(ValueError, match="stats must be"):
        sadmap.sad_map(big, plane, z, z, stats="luma", **geom, bs_y=8, bs_x=8,
                       pitch_x=8, pitch_y=8)


def test_stats_forms_count_launches_of_their_own():
    """The three-stat forms are kernels of their own: their launches are
    counted apart from the plain forms', and on the CPU nothing counts."""
    for key in ("probe_sads", "probe_sads_tiled", "probe_sads[stats3]",
                "probe_sads_tiled[stats3]"):
        assert key in probe_ops.launches
    assert set(sadmap.launches) == {"sad_map", "sad_map[stats3]"}
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _block_probe_inputs(7, 1, 8, 1))
    before = dict(probe_ops.launches), probe_ops.plain_calls_on_cuda
    probe_ops.probe_sads(stack, cy, cx, src, RING, 8, 8, 1, stats=STATS)
    assert (dict(probe_ops.launches), probe_ops.plain_calls_on_cuda) == before
