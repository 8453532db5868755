"""PyTorch port: the plain versions of the tiled probe (kernel K2) and the
block fetch (kernel K3) against the JAX package on the CPU, bit for bit.
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
from mvtools_tpu import degrain as jax_degrain
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch import degrain as port_degrain
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
RING = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))


@pytest.mark.parametrize("offsets,bs,pel,tile,pitch", [
    (HEXAGON, 16, 2, 8, 16), (RING, 16, 1, 4, 16), (((0, 0),), 8, 2, 4, 8)])
def test_tile_params_match_jax(offsets, bs, pel, tile, pitch):
    assert (probe_ops.tile_params(offsets, bs, bs, pel, tile, pitch)
            == jax_probe.tile_params(offsets, bs, bs, pel, tile, pitch))
    assert (probe_ops._tile_geom(offsets, bs, bs, pel)
            == jax_probe._tile_geom(offsets, bs, bs, pel))


@pytest.mark.parametrize("pel,kk,offsets", [
    (2, 1, HEXAGON),        # the rescue's hexagon, tile 8
    (2, 1, RING),           # the rescue's final ring
    (1, 6, ((0, 0),)),      # six predictor candidates, tile 4
])
def test_probe_sads_tiled_plain_matches_jax(pel, kk, offsets):
    """Row length 6 is no multiple of the tile, so block rows are
    edge-padded; a tenth of the candidates is thrown off its tile and
    must come back as INVALID_SAD on both sides."""
    rng = np.random.default_rng(20 + pel + kk)
    bs, nbx, nby, pad, hpad = 16, 6, 3, 16, 16
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad + 64
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
    got = probe_ops.probe_sads_tiled(
        stack, torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs, bs, pel, row_len=nbx,
        pitch_x=bs).numpy()
    assert got.dtype == np.int32
    n_invalid = 0
    for j in range(nj):
        want = np.asarray(jax_probe.probe_sads_tiled(
            jnp.asarray(stack[j].numpy()), jnp.asarray(cy[j]),
            jnp.asarray(cx[j]), jnp.asarray(src[j].astype(np.int32)),
            offsets, bs, bs, pel, row_len=nbx, pitch_x=bs))
        np.testing.assert_array_equal(got[j], want)
        n_invalid += int((want == int(jax_probe.INVALID_SAD)).sum())
    assert 0 < n_invalid < got.size


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


def _gather_inputs(pel, lo_scale):
    rng = np.random.default_rng(30 + pel)
    bs, nbx, nby, hpad = 16, 5, 3, 8
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad
    nb = 2
    stack = rng.integers(0, 256, (nb, pel * pel, ph, pw), np.uint8)
    lim = (hpad + 20) * pel
    lo = -lim if lo_scale else -hpad * pel
    mvx = rng.integers(lo, lim + 1, (nb, nby, nbx)).astype(np.int32)
    mvy = rng.integers(lo, lim + 1, (nb, nby, nbx)).astype(np.int32)
    mvx[:, 0, 0], mvy[:, 0, 0] = lo, lo              # the top-left limit
    mvx[:, -1, -1], mvy[:, -1, -1] = lim - 1, lim    # past bottom-right
    pos_y, pos_x = np.meshgrid(np.arange(nby, dtype=np.int32) * bs,
                               np.arange(nbx, dtype=np.int32) * bs,
                               indexing="ij")
    return stack, pos_x, pos_y, mvx, mvy, bs, hpad


def _port_gather(stack, pos_x, pos_y, mvx, mvy, bs, hpad, pel):
    return port_degrain.gather_blocks(
        torch.from_numpy(stack), torch.from_numpy(pos_x),
        torch.from_numpy(pos_y), torch.from_numpy(mvx),
        torch.from_numpy(mvy), bs, bs, pel.bit_length() - 1, hpad * pel,
        hpad * pel, pitch_fp=bs).numpy()


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
    """The fetches themselves clamp, so no position can fault: the tiled
    fetch's rows/columns one by one, the per-block fetch (which the tiled
    one hands a plane this small to) the block's origin as a whole, the way
    a window slice takes it (a negative start wraps once round the plane
    first: probe.wrap_clamp)."""
    stack = torch.arange(2 * 6 * 8, dtype=torch.uint8).reshape(1, 2, 6, 8)[
        :, :1].contiguous()
    cy = torch.tensor([[[-2], [4]]], dtype=torch.int32)
    cx = torch.tensor([[[-3], [6]]], dtype=torch.int32)
    p = stack[0, 0].to(torch.int32)
    iy = torch.arange(4)
    out = probe_ops.fetch_blocks_tiled_plain(stack, cy, cx, 4, 4, 1)
    want0 = p[(iy - 2).clamp(0, 5)][:, (iy - 3).clamp(0, 7)]
    want1 = p[(iy + 4).clamp(0, 5)][:, (iy + 6).clamp(0, 7)]
    assert torch.equal(out[0, 0, 0], want0)
    assert torch.equal(out[0, 1, 0], want1)
    out = probe_ops.fetch_blocks_tiled(stack, cy, cx, 4, 4, 1, row_len=2,
                                       pitch_x=4)
    assert torch.equal(out[0, 0, 0], p[2:6, 4:8])     # -2 -> 4, -3 -> 5
    assert torch.equal(out[0, 1, 0], p[2:6, 4:8])


def _masked_probe_inputs(stats, pel, kk, handover):
    """Stack, candidates (a tenth thrown off their tile), source blocks and
    an `active` mask with whole (job, block, candidate) rows dead; with
    `handover` the stack is narrower than the tile window, so the call
    goes to the per-block probe."""
    rng = np.random.default_rng(70 + 8 * (stats != "sad") + 4 * pel + kk
                                + 2 * handover)
    bs, nbx, nby, pad, hpad = 16, 6, 3, 16, 16
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad + (0 if handover else 64)
    nj, logp = 2, pel.bit_length() - 1
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    if handover:
        stack = stack[..., :pw + 2 * pad].contiguous()
    idx = np.arange(nby * nbx)
    base_y = (hpad + bs * (idx // nbx) + pad) << logp
    base_x = (hpad + bs * (idx % nbx) + pad) << logp
    shape = (nj, nby * nbx, kk)
    vy, vx = rng.integers(-5, 6, shape), rng.integers(-5, 6, shape)
    far = rng.random(shape) < 0.1
    vx = np.where(far, vx + 140 * pel, vx)
    vy = np.where(far, vy + 30 * pel, vy)
    cy = torch.from_numpy((base_y[None, :, None] + vy).astype(np.int32))
    cx = torch.from_numpy((base_x[None, :, None] + vx).astype(np.int32))
    if handover:           # the per-block probe needs its window in the plane
        cx = cx.clamp(max=(stack.shape[-1] - bs - 3) << logp)
    src = torch.from_numpy(rng.integers(0, 256, (nj, nby * nbx, bs, bs),
                                        np.uint8))
    offsets = HEXAGON[:4] if kk == 1 else ((0, 0),)
    active = (torch.from_numpy(rng.random(shape + (len(offsets),)) < 0.6)
              & torch.from_numpy(rng.random(shape + (1,)) < 0.7))
    return stack, cy, cx, src, offsets, bs, nbx, active


@pytest.mark.parametrize("handover", [False, True], ids=["tiled", "handover"])
@pytest.mark.parametrize("kk", [1, 6])
@pytest.mark.parametrize("pel", [1, 2])
@pytest.mark.parametrize("stats", ["sad", "sad_satd_luma"])
def test_probe_sads_tiled_active_mask(stats, pel, kk, handover):
    """With `active`, probe_sads_tiled (its plain version here; the kernel
    on the card) equals the unmasked output where active and is INVALID_SAD
    (in all three stats) elsewhere, through the tiled probe and through its
    hand-over to the per-block probe."""
    stack, cy, cx, src, offsets, bs, nbx, active = _masked_probe_inputs(
        stats, pel, kk, handover)
    wy_total, wx_total = probe_ops.tile_params(
        offsets, bs, bs, pel, 8 if kk <= 2 else 4, bs)[:2]
    assert (stack.shape[-1] < wx_total) == handover
    assert stack.shape[-2] >= wy_total
    args = (stack, cy, cx, src, offsets, bs, bs, pel)
    kw = dict(row_len=nbx, pitch_x=bs, stats=stats)
    full = probe_ops.probe_sads_tiled(*args, **kw)
    got = probe_ops.probe_sads_tiled(*args, **kw, active=active)
    keep = active if stats == "sad" else active[..., None]
    assert got.dtype == torch.int32 and got.shape == full.shape
    assert torch.equal(got, torch.where(keep, full,
                                        probe_ops.INVALID_SAD).to(torch.int32))
    assert 0 < int(active.sum()) < active.numel()
    assert bool((~active).flatten(2).all(dim=-1).any())    # dead rows
    sads = full if stats == "sad" else full[..., 0]
    assert bool((sads[active] != probe_ops.INVALID_SAD).any())
    if handover:
        assert not bool((sads == probe_ops.INVALID_SAD).any())
    else:
        assert bool((sads == probe_ops.INVALID_SAD).any())


@pytest.mark.parametrize("family,offsets,mask_of", [
    ("GRAY", tpr.WALK, tpr.entry_mask),     # the hexagon walk's 8 entries
    ("YUV420", HEXAGON, tpr.entry_mask),    # the chroma delta grid
    ("YUV420", ((1, -1),), tpr.block_mask), # one offset: chroma probed as is
], ids=["gray-walk", "yuv-hexagon", "yuv-one-offset"])
def test_field_prober_check_with_a_mask_keeps_the_state(family, offsets,
                                                        mask_of):
    """FieldProber.check hands its extra_mask to the probes, which then skip
    the masked entries; the state it returns is the one the unmasked probes
    give (_update costs every masked entry _INF)."""
    tpr.check_masked_state(family, 0, offsets, mask_of)
