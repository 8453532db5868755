"""PyTorch port: the modules of the DCT-cost slice (dct 1-4) against the JAX
package on the CPU, bit for bit: the block DCT, the DCT cost mix, the
per-block fetch (K5's plain version) against both JAX references (the
Pallas kernel in interpret mode and the window slices of the JAX CPU path),
the tiled fetch's hand-over, and one pyramid level's DCT costs through
FieldProber, MapProber's dense DCT map and DenseEvaluator, for each of modes
1-4.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the DCT's float64 sums are
written out in the order XLA:CPU takes them)."""
import importlib
import os
import sys
from types import SimpleNamespace

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
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu.ops import sad as jax_sad

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import (DenseEvaluator, _blocks_of, _level_ctx,
                                       mix_dct_cost, mix_dct_cost_sums)
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.ops import dct as dct_ops
from mvtools_tpu_torch.ops import probe as probe_ops
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


@pytest.mark.parametrize("w16", [0, 16])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_mix_dct_cost_matches_jax(mode, w16):
    """mix_dct_cost and mix_dct_cost_sums against the JAX package, per job
    weight [J] (the second job's one lower); modes 3 and 4 with their switch
    both on and off."""
    rng = np.random.default_rng(10 * mode + w16)
    s, dct_src, dct_ref, src_l, ref_l = _mix_inputs(mode, rng)
    w = np.array([w16, max(w16 - 1, 0)], np.int32)
    t = torch.from_numpy
    got = mix_dct_cost(mode, t(s), t(dct_src), t(dct_ref), t(src_l), t(ref_l),
                       t(w)[:, None], 8)
    ds = np.abs(dct_src - dct_ref).sum(axis=(-2, -1))
    dc = np.abs(dct_src[..., 0, 0] - dct_ref[..., 0, 0])
    got_sums = mix_dct_cost_sums(mode, t(s), t(ds), t(dc), t(src_l), t(ref_l),
                                 t(w)[:, None], 8)
    assert got.dtype == got_sums.dtype == torch.int64
    for j in range(2):
        want = np.asarray(jax_analyse.mix_dct_cost(
            mode, jnp.asarray(s[j]), jnp.asarray(dct_src[j]),
            jnp.asarray(dct_ref[j]), jnp.asarray(src_l[j]),
            jnp.asarray(ref_l[j]), jnp.int32(w[j]), 8))
        np.testing.assert_array_equal(got[j].numpy(), want)
        want_sums = np.asarray(jax_analyse.mix_dct_cost_sums(
            mode, jnp.asarray(s[j]), jnp.asarray(ds[j]), jnp.asarray(dc[j]),
            jnp.asarray(src_l[j]), jnp.asarray(ref_l[j]), jnp.int32(w[j]), 8))
        np.testing.assert_array_equal(got_sums[j].numpy(), want_sums)
    if mode in (3, 4):
        adapt = np.abs(src_l - ref_l) > ((src_l + ref_l) >> 5)
        assert adapt.any() and not adapt.all()
        np.testing.assert_array_equal(got.numpy()[~adapt], s[~adapt])
    if mode == 2 and w16 == 0:
        np.testing.assert_array_equal(got[0].numpy(), s[0])
    with pytest.raises(ValueError, match="dctmode"):
        mix_dct_cost_sums(5, t(s), t(ds), t(dc), None, None, None, 8)


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


def test_fetch_blocks_plain_matches_jax_fetch_kernel(monkeypatch):
    """K5's plain version == the JAX package's Pallas fetch kernel run in
    interpret mode (a frame-batched launch, pel 2: the subplane follows each
    candidate's parity) on candidates whose window lies inside the stack."""
    pel = 2
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(40 + pel)
    stack, cy, cx = _fetch_inputs(rng, pel, nblk=6, kk=2)
    got = probe_ops.fetch_blocks(torch.from_numpy(stack), torch.from_numpy(cy),
                                 torch.from_numpy(cx), 16, 16, pel)
    want = np.asarray(jax_probe.fetch_blocks_pallas(
        jnp.asarray(stack), jnp.asarray(cy), jnp.asarray(cx), 16, 16, pel))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("edge", [False, True], ids=["inside", "past_edge"])
@pytest.mark.parametrize("pel", [1, 2])
def test_fetch_blocks_plain_matches_jax_cpu_path(pel, edge):
    """K5's plain version == the window slices of the JAX package's CPU
    path (FieldProber._fetch_ref_blocks), origins past the bottom or right
    edge included: both clamp the full-pel origin as a whole."""
    rng = np.random.default_rng(50 + pel + 2 * edge)
    stack, cy, cx = _fetch_inputs(rng, pel, edge=edge)
    got = probe_ops.fetch_blocks(torch.from_numpy(stack), torch.from_numpy(cy),
                                 torch.from_numpy(cx), 16, 8, pel)
    assert tuple(got.shape) == cy.shape + (16, 8)
    for j in range(stack.shape[0]):
        prober = SimpleNamespace(bs=(8, 16), pel=pel, logp=pel.bit_length() - 1,
                                 stack=jnp.asarray(stack[j]))
        want = jax_fe.FieldProber._fetch_ref_blocks(
            prober, jnp.asarray(cy[j]), jnp.asarray(cx[j]))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))
    if edge:
        hp, wp = stack.shape[-2:]
        logp = pel.bit_length() - 1
        assert ((cy >> logp) > hp - 16).any() and ((cx >> logp) > wp - 8).any()


def test_fetch_blocks_tiled_hands_small_stacks_to_fetch_blocks():
    """A stack under the tiled fetch's window goes to fetch_blocks (the
    origin clamped as a whole); a wide one stays with the tiled fetch."""
    rng = np.random.default_rng(60)
    calls = []
    plain = probe_ops.fetch_blocks_plain
    try:
        probe_ops.fetch_blocks_plain = lambda *a: calls.append(1) or plain(*a)
        for pw, handed in ((40, True), (160, False)):
            stack, cy, cx = _fetch_inputs(rng, 2, nblk=6, ph=40, pw=pw)
            calls.clear()
            args = (torch.from_numpy(stack), torch.from_numpy(cy),
                    torch.from_numpy(cx), 16, 16, 2)
            got = probe_ops.fetch_blocks_tiled(*args, row_len=3, pitch_x=16)
            assert bool(calls) == handed
            assert torch.equal(got, plain(*args))
        wy, wx = probe_ops.tile_params(((0, 0),), 16, 16, 2,
                                       probe_ops.FETCH_TILE, 16)[:2]
        assert (wy, wx) == jax_probe.tile_params(((0, 0),), 16, 16, 2, 8,
                                                 16)[:2]
        assert stack.shape[-1] >= wx > 40 + 32 + 384
    finally:
        probe_ops.fetch_blocks_plain = plain


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


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_field_prober_dct_cost_matches_jax(level, mode):
    """FieldProber._dct_cost (fetch -> DCT -> mix) at five candidates per
    block, job weights 16 and 3."""
    jax_probers, port = _probers(level, mode, False)
    got = port._dct_cost(torch.from_numpy(level["cy"]),
                         torch.from_numpy(level["cx"]))
    assert got.dtype == torch.int64 and tuple(got.shape) == level["cy"].shape
    for j, p in enumerate(jax_probers):
        want = p._dct_cost(jnp.asarray(level["cy"][j]),
                           jnp.asarray(level["cx"][j]))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_map_prober_dct_map_matches_jax(level, mode):
    """MapProber's dense DCT map [J, nblk, 2r+1, 2r+1] int32 (one
    _dct_cost row per grid dy, the rows fetched through the tiled fetch)
    and its anchors."""
    jax_probers, port = _probers(level, mode, True)
    r = port.r
    assert port._m_l.dtype == torch.int32
    assert tuple(port._m_l.shape) == (2, port.ctx.nblk[0] * port.ctx.nblk[1],
                                      2 * r + 1, 2 * r + 1)
    for j, p in enumerate(jax_probers):
        np.testing.assert_array_equal(port._av_x[j].numpy(),
                                      np.asarray(p._av_x))
        np.testing.assert_array_equal(port._av_y[j].numpy(),
                                      np.asarray(p._av_y))
        np.testing.assert_array_equal(port._m_l[j].numpy(),
                                      np.asarray(p._m_l))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_dense_evaluator_dct_matches_jax(level, mode):
    """DenseEvaluator.luma_sads (the rescue's uniform displacements) with a
    DCT cost, at four displacements of both pel parities."""
    ctx, ctx_j = level["ctx"], level["ctx_j"]
    nbx, nby = ctx.nblk
    src = _blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0], nby, nbx,
                     16, 16)
    cost = fe.cost_keywords(mode, src, torch.from_numpy(level["w16"]), 8)
    dense = DenseEvaluator(ctx, 6, **cost)
    x0, y0 = jnp.asarray(level["x0"]), jnp.asarray(level["y0"])
    for j, cj in enumerate(ctx_j):
        src_j = jnp.asarray(src[j].numpy())
        jd = jax_analyse.DenseEvaluator(
            cj, x0, y0, x0, y0, 6, dctmode=mode,
            src_luma=jax.vmap(jax_sad.luma)(src_j),
            dctweight16=jnp.int32(level["w16"][j]),
            dct_src=jax.vmap(lambda b: jax_dct.dct_block(b, 8))(src_j))
        for vx, vy in ((0, 0), (3, -2), (-8, 5), (12, 12)):
            want = jd.luma_sads(jnp.int32(vx), jnp.int32(vy))
            np.testing.assert_array_equal(
                dense.luma_sads(vx, vy)[j].numpy(), np.asarray(want))


def test_cost_keywords_cover_every_mode():
    """cost_keywords builds what each cost mode reads: the DCT of the
    source blocks for 1-4 only, their sums for the adaptive modes."""
    rng = np.random.default_rng(70)
    src = torch.from_numpy(rng.integers(0, 256, (2, 6, 8, 8), np.uint8))
    w16 = torch.zeros(2, dtype=torch.int32)
    for mode in range(11):
        kw = fe.cost_keywords(mode, src, w16, 8)
        assert kw["dctmode"] == mode and kw["dctweight16"] is w16
        assert (kw["dct_src"] is not None) == (1 <= mode <= 4)
        if mode in (3, 4, 7, 8, 10):
            assert torch.equal(kw["src_luma"], src.to(torch.int64).sum((-2, -1)))
        elif mode:
            assert not kw["src_luma"].any()
        else:
            assert kw["src_luma"] is None
    assert fe.map_supported(port_analyse._level_ctx(
        *_gray_specs(dct=2), 0), 7, 2)


def _gray_specs(**kw):
    fmt = port_types.VideoFormat(W, H, 8, port_types.ColorFamily.GRAY)
    sspec = port_config.SuperConfig(pel=2, levels=2, chroma=False).validate(fmt)
    return sspec, port_config.AnalyseConfig(blksize=16, levels=2, chroma=False,
                                            **kw).validate(sspec)


def test_fetch_and_probe_before_the_stack_match_pallas(monkeypatch):
    """Origins and windows that start left of or above the stack: the
    port's per-block fetch (K5) and per-block probe (K4) take such a start
    the way the JAX package's Pallas kernels do when run in interpret mode,
    and the way its CPU path's window slice does: a negative start wraps
    once round the plane, then the window is clamped inside it."""
    pel = 2
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(45)
    stack, cy, cx = _fetch_inputs(rng, pel, nj=1, nblk=6, kk=1)
    cy[0, :, 0] = np.array([-2, -5, -17, 40, -1, 60], np.int32)
    cx[0, :, 0] = np.array([40, -3, -17, -6, -1, -19], np.int32)
    st, y, x = (torch.from_numpy(a) for a in (stack, cy, cx))
    got = probe_ops.fetch_blocks(st, y, x, 16, 16, pel)[0].numpy()
    want = np.asarray(jax_probe.fetch_blocks_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]), 16,
        16, pel, chunk=2))
    np.testing.assert_array_equal(got, want)
    offsets = ((0, 0), (1, -2), (-2, 3))
    src = rng.integers(0, 256, (1, 6, 16, 16), np.uint8)
    got = probe_ops.probe_sads(st, y, x, torch.from_numpy(src), offsets, 16,
                               16, pel)[0].numpy()
    want = np.asarray(jax_probe.probe_sads_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        jnp.asarray(src[0].astype(np.int32)), offsets, 16, 16, pel, chunk=2))
    np.testing.assert_array_equal(got, want)
