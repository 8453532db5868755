"""PyTorch port: the modules of the DCT-cost slice (dct 1-4) against the JAX
package on the CPU, bit for bit: the block DCT, the DCT cost mix, the
per-block fetch (K5's plain version) against both JAX references (the
Pallas kernel in interpret mode and the window slices of the JAX CPU path),
the tiled fetch's hand-over, and one pyramid level's DCT costs through
FieldProber, MapProber's dense DCT map and DenseEvaluator, for each of modes
1-4.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the DCT's float64 sums are
written out in the order XLA:CPU takes them).

Some of its checks live in
test_torch_dct_{mix,mix16,fetch,probers,map,dense}.py, files of at most six
tests that pytest-xdist's loadfile scheduling hands out after the suite's
longest file."""
import importlib
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu as mvt  # (enables x64)
from mvtools_tpu import field_engine as jax_fe
from mvtools_tpu.core import config as jax_config, types as jax_types
from mvtools_tpu.ops import dct as jax_dct
from mvtools_tpu.ops import sad as jax_sad

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.ops import dct as dct_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr

# the packages export the FUNCTION analyse, which shadows the module
jax_analyse = importlib.import_module("mvtools_tpu.analyse")
port_analyse = importlib.import_module("mvtools_tpu_torch.analyse")


def special_blocks(rng, n, bh, bw):
    """[n, bh, bw] uint8: half noise, the rest flat 0, flat 255, flat at any
    level, nearly flat, steps across a row or column, checkerboards of
    period 1, 2 and 4, ramps and half-flat blocks — AC coefficients near or
    at 0, DC coefficients at both ends of the range."""
    yy = np.arange(bh)[None, :, None]
    xx = np.arange(bw)[None, None, :]
    a = rng.integers(0, 256, (n, 1, 1))
    b = rng.integers(0, 256, (n, 1, 1))
    t = rng.integers(1, min(bh, bw), (n, 1, 1))
    per = 1 << rng.integers(0, 3, (n, 1, 1))
    horiz = rng.random((n, 1, 1)) < 0.5
    noise = rng.integers(0, 256, (n, bh, bw))
    kinds = [
        np.zeros_like(noise), np.full_like(noise, 255),
        np.broadcast_to(a, noise.shape),
        np.clip(a + rng.integers(0, 2, noise.shape), 0, 255),
        np.where(np.where(horiz, yy < t, xx < t), a, b),
        np.where(((yy // per + xx // per) % 2) == 0, a, b),
        np.clip(a + (yy + xx) * (b % 9 - 4), 0, 255),
        np.where(np.where(horiz, yy < bh // 2, xx < bw // 2), a, noise),
    ]
    out = noise.copy()
    k = np.arange(n) % (2 * len(kinds))
    for i, blk in enumerate(kinds):
        sel = k == len(kinds) + i
        out[sel] = np.broadcast_to(blk, noise.shape)[sel]
    return out.astype(np.uint8)


@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 4), (8, 8), (16, 8), (16, 16),
                                   (32, 32)])
def test_dct_block_matches_jax(bw, bh):
    """Noise and the special blocks, [2, n] leading axes."""
    rng = np.random.default_rng(200 + bw * bh)
    blocks = special_blocks(rng, 2 * 1600, bh, bw).reshape(2, 1600, bh, bw)
    got = dct_ops.dct_block(torch.from_numpy(blocks), 8)
    want = np.asarray(jax_dct.dct_block(jnp.asarray(blocks), 8))
    assert got.dtype == torch.int32 and tuple(got.shape) == blocks.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= 255
    assert (got[..., 0, 0] == 255).any() and (got[..., 0, 0] == 128).any()
    assert dct_ops.dct_shift(bw, bh) == jax_dct.dct_shift(bw, bh)


def _mix_inputs(mode, rng, nj=2, n=500):
    bh = bw = 8
    dct_src = rng.integers(0, 256, (nj, n, bh, bw)).astype(np.int32)
    dct_ref = np.clip(dct_src + rng.integers(-20, 21, dct_src.shape), 0, 255)
    dct_ref[:, :20] = dct_src[:, :20]                     # equal blocks
    s = rng.integers(0, 16000, (nj, n))
    src_l = rng.integers(0, 16321, (nj, n))
    # differences from well under to well over a 32nd of the sum
    ref_l = np.clip(src_l + rng.integers(-1, 2, (nj, n))
                    * (src_l >> rng.integers(2, 8, (nj, n))), 0, 16320)
    return s, dct_src, dct_ref.astype(np.int32), src_l, ref_l


# ---------------------------------------------------------------------------
# K5: the per-block fetch


def _fetch_inputs(rng, pel, nj=2, nblk=24, kk=3, ph=96, pw=160, edge=False):
    """A padded stack [J, pel^2, Hp, Wp] and candidates [J, nblk, K] inside
    it, or with `edge` reaching past its bottom and right edges."""
    stack = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    stack = np.pad(stack, ((0, 0), (0, 0), (16, 16 + 64), (16, 16 + 384)),
                   mode="edge")
    hp, wp = stack.shape[-2:]
    hi_y, hi_x = (hp + 20 if edge else ph) * pel, (wp + 20 if edge else pw) * pel
    cy = rng.integers(16 * pel, hi_y, (nj, nblk, kk)).astype(np.int32)
    cx = rng.integers(16 * pel, hi_x, (nj, nblk, kk)).astype(np.int32)
    if edge:
        cy[:, 0, 0], cx[:, 0, 1] = hp * pel + 3, wp * pel + 1
    return stack, cy, cx


# ---------------------------------------------------------------------------
# One pyramid level through the probers, for each DCT mode

W, H = 128, 96


@pytest.fixture(scope="module")
def level():
    """Two jobs of a 3-frame clip at 128x96 (pel 2, blk 16, level 0) in both
    packages: the JAX package's per-job contexts and the port's batched one,
    with per-block candidates for the probes and predictor fields for the
    map."""
    frames = tpr.make_yuv_frames(3, W, H, seed=31, flash=(8, 8, 48, 64),
                                 noise=4, pan=(1, 1))[0]

    def specs(config, types):
        fmt = types.VideoFormat(W, H, 8, types.ColorFamily.GRAY)
        sspec = config.SuperConfig(pel=2, levels=2, chroma=False).validate(fmt)
        return sspec, config.AnalyseConfig(blksize=16, levels=2, chroma=False,
                                           dct=1).validate(sspec)

    sspec_j, aspec_j = specs(jax_config, jax_types)
    sups_j = [mvt.build_super([jnp.asarray(f)], sspec_j) for f in frames]
    pairs = ((1, 2), (1, 0))
    ctx_j = [jax_analyse._level_ctx(sups_j[s], sups_j[r], aspec_j, 0)
             for s, r in pairs]
    sspec, aspec = specs(port_config, port_types)
    sups = build_super([torch.from_numpy(frames)], sspec)
    ctx = _level_ctx(sspec, aspec, 0, sups.map(lambda a: a[[1, 1]]),
                     sups.map(lambda a: a[[2, 0]]))
    nbx, nby = ctx.nblk
    nblk = nbx * nby
    rng = np.random.default_rng(32)
    idx = np.arange(nblk)
    x0 = (ctx.hpad[0] + 16 * (idx % nbx)).astype(np.int32)
    y0 = (ctx.vpad[0] + 16 * (idx // nbx)).astype(np.int32)
    vx = rng.integers(-12, 13, (2, nblk, 5)).astype(np.int32)
    vy = rng.integers(-12, 13, (2, nblk, 5)).astype(np.int32)
    pred_x = rng.integers(-6, 7, (2, nblk)).astype(np.int32)
    pred_y = rng.integers(-6, 7, (2, nblk)).astype(np.int32)
    big = np.full(nblk, 1 << 20, np.int32)
    return dict(ctx_j=ctx_j, ctx=ctx, x0=x0, y0=y0, cy=((y0 + 16) * 2)[:, None]
                + vy, cx=((x0 + 16) * 2)[:, None] + vx, pred=(pred_x, pred_y),
                bounds=(-big, big, -big, big), w16=np.array([16, 3], np.int32))


def _probers(level, mode, map_prober):
    """(JAX probers of both jobs, the port's prober of the two)."""
    ctx, ctx_j = level["ctx"], level["ctx_j"]
    nbx, nby = ctx.nblk
    src = _blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0], nby, nbx,
                     16, 16)
    cost = fe.cost_keywords(mode, src, torch.from_numpy(level["w16"]), 8)
    x0, y0 = torch.from_numpy(level["x0"]), torch.from_numpy(level["y0"])
    bounds = tuple(torch.from_numpy(b) for b in level["bounds"])
    args = (ctx, [src], x0, y0, x0, y0, bounds, 50)
    pred = [torch.from_numpy(p) for p in level["pred"]]
    port = (fe.MapProber(*args, pred_vx=pred[0], pred_vy=pred[1], **cost)
            if map_prober else fe.FieldProber(*args, **cost))
    jax_probers = []
    for j, cj in enumerate(ctx_j):
        src_j = jnp.asarray(src[j].numpy())
        x0j, y0j = jnp.asarray(level["x0"]), jnp.asarray(level["y0"])
        kw = dict(dctmode=mode,
                  src_luma=jax.vmap(jax_sad.luma)(src_j) if mode >= 3
                  else jnp.zeros((src_j.shape[0],), jnp.int64),
                  dctweight16=jnp.int32(level["w16"][j]),
                  dct_src=jax.vmap(lambda b: jax_dct.dct_block(b, 8))(src_j))
        jargs = (cj, src_j, None, None, x0j, y0j, x0j, y0j,
                 tuple(jnp.asarray(b) for b in level["bounds"]), 50)
        if map_prober:
            jax_probers.append(jax_fe.MapProber(
                *jargs, pred_vx=jnp.asarray(level["pred"][0][j]),
                pred_vy=jnp.asarray(level["pred"][1][j]), **kw))
        else:
            jax_probers.append(jax_fe.FieldProber(*jargs, **kw))
    return jax_probers, port


def _gray_specs(**kw):
    fmt = port_types.VideoFormat(W, H, 8, port_types.ColorFamily.GRAY)
    sspec = port_config.SuperConfig(pel=2, levels=2, chroma=False).validate(fmt)
    return sspec, port_config.AnalyseConfig(blksize=16, levels=2, chroma=False,
                                            **kw).validate(sspec)


