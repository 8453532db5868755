"""PyTorch port: the plain versions of the tiled probe (kernel K2) and the
block fetch (kernel K3) against the JAX package on the CPU, bit for bit.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers).

Some of its checks live in test_torch_probe_{gather,mask}.py and
test_torch_probe_active_*.py, files of at most six tests that pytest-xdist's
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
import mvtools_tpu  # noqa: F401  (enables x64)
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch import degrain as port_degrain
from mvtools_tpu_torch.ops import probe as probe_ops


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


