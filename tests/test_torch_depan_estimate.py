"""PyTorch port: depan_estimate and depan_analyse (depan.py) against the
JAX package's on the CPU, on the same inputs.

depan_estimate correlates through torch.fft (pocketfft here) where the
JAX package uses jnp.fft (XLA:CPU's), so the surfaces differ in their last
bits (measured: 1.4e-7 to 2.3e-7 of the peak).  The correlation peak's
integer position is held equal frame by frame; the sub-pixel fraction and
the trust within EST_TOL and TRUST_TOL (measured on this box: dx/dy at
most 1.1e-6 px, trust at most 3.8e-5 on values of 2-18).  The clip keeps
every frame's trust at least 0.5 away from the trust limits, so that the
float32 noise cannot flip a decision and the tolerance stays meaningful.

depan_analyse sums float32 over the blocks: XLA compiles its loops and
orders (and fuses) the sums its own way, torch another, so the fitted
motion is held within ANALYSE_TOL (measured: at most 1.6e-5 over pans,
zooms and rotations of synthetic fields with 10 % outliers).  Fields are
made with numpy from a known global motion; no JAX analysis runs here."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import depan as jd
from mvtools_tpu_torch import depan as td

import torch_flow_cases as tfc

EST_TOL = 1e-4
TRUST_TOL = 1e-4       # relative
ANALYSE_TOL = 1e-4
TRUST_MARGIN = 0.5


def pan_clip(seed, n, w, h, cut=None, step=3.0):
    """n gray frames of a noise texture under a random-walk pan with
    fractional steps (bilinear resampling), a new texture from frame `cut`
    on."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float64)
    pos = np.zeros(2)
    frames = []
    for i in range(n):
        if i:
            pos += rng.uniform(-step, step, 2)
        if cut is not None and i == cut:
            big = rng.permutation(big.reshape(-1)).reshape(big.shape)
        y0, x0 = 32 + pos
        iy, ix = int(np.floor(y0)), int(np.floor(x0))
        fy, fx = y0 - iy, x0 - ix
        p = (big[iy:iy + h, ix:ix + w] * (1 - fy) * (1 - fx)
             + big[iy + 1:iy + 1 + h, ix:ix + w] * fy * (1 - fx)
             + big[iy:iy + h, ix + 1:ix + 1 + w] * (1 - fy) * fx
             + big[iy + 1:iy + 1 + h, ix + 1:ix + 1 + w] * fy * fx)
        frames.append(np.clip(p + rng.normal(0, 1, p.shape), 0,
                              255).astype(np.uint8))
    return np.stack(frames)


def _estimate_both(frames, **kw):
    want = jd.depan_estimate(jnp.asarray(frames.astype(np.float32)),
                             jd.DepanEstimateConfig(**kw),
                             return_correl=True)
    got = td.depan_estimate(torch.from_numpy(frames).float(),
                            td.DepanEstimateConfig(**kw), return_correl=True)
    return got, want


@pytest.mark.parametrize("zoommax", [1.0, 1.1])
def test_estimate_matches_jax(zoommax):
    """One window (zoommax 1) and the left/right zoom split, 160x96 and
    128x96, a scene cut at frame 5: equal peak positions on every surface,
    dx/dy/zoom within EST_TOL, trust within TRUST_TOL."""
    for seed, (w, h) in ((0, (160, 96)), (1, (128, 96))):
        frames = pan_clip(seed, 8, w, h, cut=5)
        got, want = _estimate_both(frames, zoommax=zoommax)
        assert len(got[4]) == len(want[4]) == (1 if zoommax == 1.0 else 2)
        for g, c in zip(got[4], want[4]):
            g, c = g.numpy(), np.asarray(c)
            assert g.shape == c.shape
            for k in range(1, len(frames)):
                assert np.argmax(g[k]) == np.argmax(c[k]), (seed, k)
        trust = np.asarray(want[3])
        assert (np.abs(trust[1:] - 4.0) > TRUST_MARGIN).all(), trust
        for name, g, c in zip(("dx", "dy", "zoom"), got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(c), rtol=0,
                                       atol=EST_TOL, err_msg=name)
        np.testing.assert_allclose(got[3].numpy(), trust, rtol=TRUST_TOL,
                                   atol=0)
        assert (got[0].numpy()[5] == 0.0) == (np.asarray(want[0])[5] == 0.0)


def test_estimate_show_matches_jax():
    """The `show` surface painted into the frames: equal outside the
    window; inside, the min-max normalised surface truncated to an integer
    may move by one level where the surfaces' last bits differ."""
    frames = pan_clip(2, 5, 128, 96)
    cfg = dict(zoommax=1.1)
    want = jd.depan_estimate_show(jnp.asarray(frames), jd.DepanEstimateConfig(
        **cfg))
    got = td.depan_estimate_show(torch.from_numpy(frames),
                                 td.DepanEstimateConfig(**cfg))
    shown, jshown = got[0].numpy(), np.asarray(want[0])
    assert shown.dtype == jshown.dtype == np.uint8
    diff = np.abs(shown.astype(int) - jshown.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    winx, winy, wleft, wtop, _, _ = td.DepanEstimateConfig(**cfg).resolve(
        128, 96)
    outside = np.ones(shown.shape[1:], bool)
    for off in (wleft, wleft + 64):
        outside[wtop:wtop + winy, off:off + winx] = False
    np.testing.assert_array_equal(shown[:, outside], jshown[:, outside])
    assert td.depan_estimate_info(1, *(float(v[1]) for v in got[1:])) == \
        jd.depan_estimate_info(1, *(float(v[1]) for v in want[1:]))


def _field(rng, meta, motion, outliers=0.1, sad_hi=False):
    """vx, vy, sad arrays of a global motion (dx, dy, rot degrees, zoom)
    about the frame centre, in pel units, with outliers."""
    nbx, nby = meta.blk_x, meta.blk_y
    bsz, ov, pel = meta.blk_size_x, meta.overlap_x, meta.pel
    jj, ii = np.mgrid[0:nby, 0:nbx]
    bx = ii * (bsz - ov) + bsz // 2
    by = jj * (bsz - ov) + bsz // 2
    dx, dy, rot, zoom = motion
    c = np.cos(np.radians(rot)) * zoom
    s = np.sin(np.radians(rot)) * zoom
    xc, yc = meta.width / 2, meta.height / 2
    x = xc + c * (bx - xc) - s * (by - yc) + dx
    y = yc + s * (bx - xc) + c * (by - yc) + dy
    vx = np.round((x - bx) * pel).astype(np.int32)
    vy = np.round((y - by) * pel).astype(np.int32)
    out = rng.random(vx.shape) < outliers
    vx[out] += rng.integers(-20, 20, int(out.sum())).astype(np.int32)
    vy[out] += rng.integers(-20, 20, int(out.sum())).astype(np.int32)
    sad = rng.integers(0, 4 * bsz * bsz, vx.shape).astype(np.int64)
    if sad_hi:
        sad[:] = 100 * bsz * bsz
    return vx, vy, sad


def _analyse_both(jf, tf, meta, tmeta, top=None, mask=None, **kw):
    want = jd.depan_analyse(jf, meta, jd.DepanAnalyseConfig(**kw),
                            None if mask is None else jnp.asarray(mask),
                            top_field=top)
    got = td.depan_analyse(tf, tmeta, td.DepanAnalyseConfig(**kw),
                           None if mask is None else torch.from_numpy(mask),
                           top_field=top)
    return np.array([float(v) for v in got]), \
        np.array([float(v) for v in want])


@pytest.mark.parametrize("grid", ["blk8_pel2", "blk16_overlap8"])
def test_analyse_matches_jax(grid):
    """Pans, zooms and rotations, forward and backward fields, with zoom
    and rotation fitted or not: (dx, dy, zoom, rot) within ANALYSE_TOL;
    the port's host reads a frame are counted (one a phase-2 step and
    one for the result)."""
    w, h, pel, blk, ov = {"blk8_pel2": (160, 96, 2, 8, 0),
                          "blk16_overlap8": (160, 96, 1, 16, 8)}[grid]
    _, aspec, _, _ = tfc.specs(w, h, pel=pel, blksize=blk, overlap=ov)
    rng = np.random.default_rng(blk)
    for backward in (False, True):
        meta, tmeta = tfc.meta_pair(aspec, backward)
        for _ in range(3):
            motion = (rng.uniform(-4, 4), rng.uniform(-4, 4),
                      rng.uniform(-1, 1), rng.uniform(0.97, 1.03))
            jf, tf = tfc.fields(_field(rng, meta, motion), meta, tmeta)
            for zoom, rot in ((True, True), (False, False), (True, False)):
                syncs = td.host_syncs
                got, want = _analyse_both(jf, tf, meta, tmeta, zoom=zoom,
                                          rot=rot)
                assert 2 <= td.host_syncs - syncs <= 96
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=ANALYSE_TOL,
                                           err_msg=f"{motion} {zoom} {rot}")
                if not rot:
                    assert got[3] == want[3] == 0.0


def test_analyse_fields_scene_change_and_mask_match_jax():
    """fields=True with both top_field values (the half-line dy and the
    halved pixaspect), a scene-change field and an invalid one (both give
    the null motion (0, 0, 1, 0) in each package), and a mask plane that
    weights the blocks (no ignored border)."""
    _, aspec, _, _ = tfc.specs(160, 96, pel=2, blksize=8)
    meta, tmeta = tfc.meta_pair(aspec, False)
    rng = np.random.default_rng(21)
    motion = (2.6, -1.7, 0.4, 1.01)
    jf, tf = tfc.fields(_field(rng, meta, motion), meta, tmeta)
    for top in (True, False):
        got, want = _analyse_both(jf, tf, meta, tmeta, top=top, fields=True)
        np.testing.assert_allclose(got, want, rtol=0, atol=ANALYSE_TOL)
    mask = rng.integers(0, 256, (96, 160)).astype(np.uint8)
    got, want = _analyse_both(jf, tf, meta, tmeta, mask=mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ANALYSE_TOL)
    for sad_hi, validity in ((True, 1), (False, 0)):
        jf, tf = tfc.fields(_field(rng, meta, motion, sad_hi=sad_hi), meta,
                            tmeta, validity)
        got, want = _analyse_both(jf, tf, meta, tmeta)
        np.testing.assert_array_equal(got, [0.0, 0.0, 1.0, 0.0])
        np.testing.assert_array_equal(want, [0.0, 0.0, 1.0, 0.0])
