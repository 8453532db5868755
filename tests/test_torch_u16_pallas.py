"""PyTorch port against the JAX package's Pallas kernels on 16-bit data,
run in interpret mode the way the JAX package's own tests run Pallas off the
TPU: the plain versions of K5 and K3 (fetches) and of K4 (per-block probe,
whose Pallas kernel takes a two-pass sum for uint16); and the Super pyramid
at 10 and 16 bits against mvtools_tpu.build_super.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.

Four tests, tens of seconds of JAX compiling and interpreting: a file of at
most six, which pytest-xdist's loadfile scheduling hands out after the
larger files.  Tolerance 0 (integers)."""
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
import mvtools_tpu as mvt
from mvtools_tpu.core.config import SuperConfig as JaxSuperConfig
from mvtools_tpu.core.types import (ColorFamily as JaxColorFamily,
                                    VideoFormat as JaxVideoFormat)
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch import SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super
from test_torch_u16_kernels import (  # noqa: E402
    BS, FH, FW, PEL, _PALLAS_AGREES, _fetch_inputs, _pixels)


@pytest.fixture(scope="module")
def pallas_fetches():
    """The JAX package's two Pallas fetches in interpret mode on a 16-bit
    stack: (stack, cy, cx, tiled, per-block)."""
    from jax.experimental import pallas as pl
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call
    mp.setattr(jax_probe.pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    try:
        stack, cy, cx = _fetch_inputs(16)
        wy_total, wx_total, center_y, center_x = jax_probe.tile_params(
            ((0, 0),), BS, BS, PEL, probe_ops.FETCH_TILE, BS)
        assert FH >= wy_total and FW > wx_total
        tiled = np.asarray(jax_probe.fetch_blocks_tiled_pallas(
            jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
            BS, BS, PEL, probe_ops.FETCH_TILE, wy_total, wx_total,
            center_y, center_x))
        per_block = np.asarray(jax_probe.fetch_blocks(
            jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
            BS, BS, PEL))
    finally:
        mp.undo()
    return stack, cy, cx, tiled, per_block


def test_fetches_u16_match_pallas(pallas_fetches):
    """At 16 bits, K5's and K3's plain versions == the JAX package's Pallas
    per-block and tiled fetches at every origin in the tile window, or off
    it inside the plane away from the bottom/right edge.  (At the other
    origins, before the stack, past its end or within one fallback window
    of its bottom/right edge, both Pallas fetches place a block by an
    8-row / 128-column aligned fallback window, the same blocks at 8 bits
    as at 16: ROADMAP Q3-9.  test_torch_u16_kernels.py::
    test_fetches_u16_take_the_window_slice_everywhere holds both port
    fetches to the JAX CPU path, a window slice, there.)"""
    stack, cy, cx, tiled, per_block = pallas_fetches
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), BS, BS, PEL)
    k5 = probe_ops.fetch_blocks(*args)[0]
    k3 = probe_ops.fetch_blocks_tiled(*args, row_len=16, pitch_x=BS)[0]
    for b in _PALLAS_AGREES:
        np.testing.assert_array_equal(k5[b].numpy(), per_block[b],
                                      err_msg=f"K5 block {b}")
        np.testing.assert_array_equal(k3[b].numpy(), tiled[b],
                                      err_msg=f"K3 block {b}")
    assert (k3[4] == 0).all() and (k3[7] == 65535).all()

def test_probe_sads_u16_matches_pallas(monkeypatch):
    """K4's plain version on a 16-bit stack == the JAX package's Pallas
    per-block probe run in interpret mode, the u16 branch of its kernel (the
    two-pass sum): windows that start left of or above the stack (a
    negative start wraps once round the plane, then the window is clamped
    inside it), and a block of 0 against a region of 65 535, whose every
    SAD is 256 * 65 535 = 16 776 960, exact."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(46)
    pel, bs, top = 2, 16, 65535
    stack = _pixels(rng, (1, pel * pel, 96, 160), 16)
    stack[0, :, 20:60, 20:70] = top
    stack = np.pad(stack, ((0, 0), (0, 0), (16, 16 + 64), (16, 16 + 384)),
                   mode="edge")
    # pel-unit origins: five that start left of or above the stack, one
    # whose window lies in the region of the maximum (padded rows and
    # columns from 36; the block at full-pel (45, 45))
    cy = np.array([[-2], [-5], [-17], [40], [-1], [90]], np.int32)[None]
    cx = np.array([[40], [-3], [-17], [-6], [-1], [90]], np.int32)[None]
    src = _pixels(rng, (1, 6, bs, bs), 16)
    src[0, 5] = 0
    offsets = ((0, 0), (1, -2), (-2, 3))
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs, bs, pel)[0].numpy()
    want = np.asarray(jax_probe.probe_sads_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        jnp.asarray(src[0].astype(np.int32)), offsets, bs, bs, pel,
        chunk=2))
    np.testing.assert_array_equal(got, want)
    assert (want[5] == bs * bs * top).all()


@pytest.mark.parametrize("bits", [10, 16])
def test_super_u16_matches_jax(bits):
    """The three-plane pyramid of a uint16 YUV420 frame (pel 2, Wiener
    subplanes clamped to 2^bits - 1, bilinear reduce) == the JAX package's,
    every plane and level; without a format a uint16 frame is taken as
    16-bit on both sides."""
    rng = np.random.default_rng(500 + bits)
    w, h = 96, 64
    planes = [_pixels(rng, (h, w), bits)] + [
        _pixels(rng, (h // 2, w // 2), bits) for _ in range(2)]
    planes[0][:8, :16] = (1 << bits) - 1
    planes[0][8:16, :16] = 0
    cfg = dict(pel=2, levels=3, chroma=True)
    want = mvt.build_super([jnp.asarray(p) for p in planes],
                           JaxSuperConfig(**cfg),
                           JaxVideoFormat(w, h, bits, JaxColorFamily.YUV420))
    got = build_super([torch.from_numpy(p) for p in planes],
                      SuperConfig(**cfg),
                      VideoFormat(w, h, bits, ColorFamily.YUV420))
    assert got.spec.bits == bits == want.spec.bits
    for p in range(3):
        for lv in range(3):
            assert got.planes[p][lv].dtype == torch.uint16
            np.testing.assert_array_equal(got.planes[p][lv].numpy(),
                                          np.asarray(want.planes[p][lv]),
                                          err_msg=f"plane {p} level {lv}")
    auto = build_super([torch.from_numpy(p) for p in planes],
                       SuperConfig(**cfg))
    jax_auto = mvt.build_super([jnp.asarray(p) for p in planes],
                               JaxSuperConfig(**cfg))
    assert auto.spec.bits == jax_auto.spec.bits == 16
    with pytest.raises(ValueError, match="uint16"):
        build_super([torch.from_numpy(planes[0]).to(torch.uint8)],
                    SuperConfig(pel=2, chroma=False),
                    VideoFormat(w, h, bits, ColorFamily.GRAY))
