"""PyTorch port: the uint16 forms of the plain versions of K2 (tiled
probe), K4 (per-block probe), K3 and K5 (fetches) on 10- and 16-bit data
against the JAX package's CPU functions, bit for bit; the uint16 helpers;
and what stays refused at deep bits.  K1 (the SAD map) has its uint16 file
in test_torch_u16_sadmap.py, the checks against the JAX package's Pallas
kernels in interpret mode and the Super pyramid in test_torch_u16_pallas.py
(files of at most six tests, which pytest-xdist's loadfile scheduling hands
out after the larger ones).  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.

No JAX lockstep run: the whole file takes about ten seconds.  Inputs are
made with numpy from a seed and handed to both sides, with blocks of 0
against the pixel maximum where the sums are largest; every comparison is
assert_array_equal (tolerance 0 — integers).

Some of its checks live in test_torch_u16_kernels_{tiled,refusals,fetch}.py,
files of at most six tests that pytest-xdist's loadfile scheduling hands out
after the suite's longest file."""
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

from mvtools_tpu_torch import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.analyse import batch_supported
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.models.denoise import make_test_clip_yuv
from mvtools_tpu_torch.ops import pixels, probe as probe_ops
from mvtools_tpu_torch.super import build_super

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
RING = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))


def _pixels(rng, shape, bits):
    """uint16 samples of a `bits`-bit clip, full range."""
    return rng.integers(0, 1 << bits, shape).astype(np.uint16)


def _extremes(stack, src, bits):
    """Every reference pixel the maximum, every source pixel 0: each SAD is
    the largest a block of that size can have."""
    return (np.full_like(stack, (1 << bits) - 1), np.zeros_like(src))


def test_pixel_helpers_keep_the_full_range():
    """widen / narrow / gather carry uint16 pixels through int32 and their
    int16 view without losing a bit, 0 and 65 535 included."""
    v = torch.tensor([0, 1, 255, 256, 32767, 32768, 65534, 65535],
                     dtype=torch.int32)
    p = pixels.narrow(v, torch.uint16)
    assert p.dtype == torch.uint16
    assert torch.equal(pixels.widen(p), v)
    idx = torch.tensor([[7, 0], [5, 5]])
    assert torch.equal(pixels.widen(pixels.gather(p, idx)), v[idx])
    assert pixels.dtype_of(8) == torch.uint8
    assert pixels.dtype_of(10) == pixels.dtype_of(16) == torch.uint16
    u8 = pixels.narrow(torch.tensor([0, 255]), torch.uint8)
    assert torch.equal(pixels.widen(u8), torch.tensor([0, 255],
                                                      dtype=torch.int32))


@pytest.mark.parametrize("bits,pel,bs,kk,offsets,data", [
    (16, 2, 16, 1, HEXAGON, "random"), (16, 1, 8, 6, ((0, 0),), "extremes"),
    (10, 2, 8, 1, RING, "random"), (10, 1, 16, 1, HEXAGON, "extremes")])
def test_probe_sads_plain_u16_matches_jax(bits, pel, bs, kk, offsets, data):
    """K4's plain version on a uint16 stack == probe_sads_xla, with
    candidates at the corners of the stack and past its bottom/right
    edges, where the window is shifted in."""
    rng = np.random.default_rng(300 + bits + pel + bs)
    nj, nbx, nby, pad, hpad = 2, 3, 2, 8, 8
    logp = pel.bit_length() - 1
    ph = nby * bs + 2 * (hpad + pad)
    pw = nbx * bs + 2 * (hpad + pad) + 24
    stack = _pixels(rng, (nj, pel * pel, ph, pw), bits)
    src = _pixels(rng, (nj, nby * nbx, bs, bs), bits)
    if data == "extremes":
        stack, src = _extremes(stack, src, bits)
    idx = np.arange(nby * nbx)
    base_y = (hpad + pad + bs * (idx // nbx)) << logp
    base_x = (hpad + pad + bs * (idx % nbx)) << logp
    lim = (hpad + pad) * pel
    cy = base_y[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    cx = base_x[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    cy, cx = np.maximum(cy, 2 * pel), np.maximum(cx, 2 * pel)
    far_y, far_x = (ph - bs) << logp, (pw - bs) << logp
    cy[0, 1, 0], cx[0, 1, 0] = far_y, far_x                # bottom-right
    cy[1, 0, 0], cx[1, 0, 0] = 2 * pel, far_x + 5 * pel    # past the right
    cy[1, 1, 0], cx[1, 1, 0] = far_y + 4 * pel, 3 * pel    # past the bottom
    cy, cx = cy.astype(np.int32), cx.astype(np.int32)
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs, bs, pel).numpy()
    for j in range(nj):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel))
        np.testing.assert_array_equal(got[j], want)
    if data == "extremes":
        assert (got == bs * bs * ((1 << bits) - 1)).all()


PEL, BS, FH, FW = 2, 16, 96, 640
# full-pel origins (row, column) of a row of 16 blocks: the tile anchors
# (blocks 0, 4, 7 and 8, 12, 15) lie in the tiled fetch's window, blocks 6
# and 9 off it but inside the plane, the rest before the stack, past its
# end or at its corners
_ORIGINS = ((30, 20), (-3, 36), (30, -5), (101, 68), (30, 84), (30, 630),
            (2, 116), (30, 132), (30, 300), (30, 40), (75, 332), (-20, -30),
            (30, 364), (30, 600), (85, 630), (30, 412))
_PALLAS_AGREES = (0, 4, 6, 7, 8, 9, 12, 15)


def _fetch_inputs(bits):
    rng = np.random.default_rng(400 + bits)
    stack = _pixels(rng, (1, PEL * PEL, FH, FW), bits)
    stack[0, :, 30:46, 84:100] = 0                     # block 4
    stack[0, :, 30:46, 132:148] = (1 << bits) - 1      # block 7
    fy = np.array([o[0] for o in _ORIGINS])
    fx = np.array([o[1] for o in _ORIGINS])
    cy = (fy * PEL + rng.integers(0, PEL, 16)).astype(np.int32)
    cx = (fx * PEL + rng.integers(0, PEL, 16)).astype(np.int32)
    return stack, cy[None, :, None], cx[None, :, None]


def _deep_supers(bits=16, w=64, h=48, blksize=16, **acfg):
    """Supers of a tiny gray clip of `bits` bits, two jobs, and the
    AnalyseSpec of blk `blksize` with the given options."""
    clip = make_test_clip_yuv(3, w, h, noise=4, pan=(1, 1), bits=bits,
                              device="cpu")[0]
    sspec = SuperConfig(pel=2, levels=0, chroma=False).validate(
        VideoFormat(w, h, bits, ColorFamily.GRAY))
    aspec = AnalyseConfig(blksize=blksize, levels=0, chroma=False,
                          **acfg).validate(sspec)
    sups = build_super([clip], sspec)
    return (sups.take(torch.tensor([1, 1])), sups.take(torch.tensor([2, 0])),
            sspec, aspec)


def test_10bit_large_blocks_ride_the_map():
    """At 10 bits a 32x32 block's SAD stays under 2^24, so every level rides
    the dense map as in the JAX package off the TPU (its sum bound, 1023 *
    32 * 32, against 65 535 * 32 * 32 at 16 bits)."""
    _, _, sspec, aspec = _deep_supers(10, 128, 96, blksize=32)
    assert batch_supported(aspec, sspec)
