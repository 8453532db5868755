"""PyTorch port: depan_compensate and depan_stabilise (depan.py) against the
JAX package's on the CPU, given the same motions, bit for bit (tolerance
0).

The motions are made with numpy (pans with fractional steps, zoom 1 and
rotation 0, as depan_estimate gives them, and MOTION_BAD scene cuts), so
the transform algebra is exact in both packages (tests/test_torch_warp.py
states where it is not).  Covered: DepanCompensate at positive, negative
and fractional offsets with each subpixel mode, mirror and blur, a cut
inside the accumulated interval, fields with and without matchfields;
DepanStabilise method 0 (inertial) and 1 (average) with prev/next border
filling, mirrors, cuts, fitlast, fields and the soft limits; the
per-frame transforms of stabilise_transforms, also with addzoom and
initzoom != 1, where motion2transform takes a zoom other than 1 and the
float32 exp/log of numpy and XLA:CPU differ by an ulp or two, which the
inertial filter's recursion and the windowed sums carry on from frame to
frame: held within STAB_ABS_TOL absolute on each of the six numbers
(measured on four seeds of this 40-frame record: at most 2.5e-5, on
offsets of up to ~60)."""
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

from test_torch_warp import _ulps

H, W, T = 48, 64, 6
STAB_ABS_TOL = 1e-4


def _clip(seed, sub=(1, 1), bits=8):
    """T frames of a textured scene under a random-walk pan, [Y, U, V]
    numpy planes (4:2:0 or 4:2:2)."""
    rng = np.random.default_rng(seed)
    pm = (1 << bits) - 1
    dt = np.uint8 if bits == 8 else np.uint16
    big = rng.integers(0, pm + 1, (H + 32, W + 32))
    pos = np.cumsum(rng.integers(-3, 4, (T, 2)), axis=0) + 16
    frames = []
    for y0, x0 in pos:
        luma = big[y0:y0 + H, x0:x0 + W]
        ch = [luma[::1 << sub[1], ::1 << sub[0]] // 2 + k * 7
              for k in (1, 2)]
        frames.append([np.ascontiguousarray(p).astype(dt)
                       for p in [luma] + ch])
    return frames


def _motions(seed, cuts=()):
    rng = np.random.default_rng(seed)
    m = np.zeros((T, 4), np.float32)
    m[:, 0] = rng.uniform(-3, 3, T)
    m[:, 1] = rng.uniform(-2, 2, T)
    m[:, 2] = 1.0
    m[0] = (0.0, 0.0, 1.0, 0.0)
    for c in cuts:
        m[c] = (0.0, 0.0, 1.0, 0.0)
    return m


def _jax(frames):
    return [[jnp.asarray(p) for p in f] for f in frames]


def _torch(frames):
    return [[torch.from_numpy(p) for p in f] for f in frames]


def _equal(got, want, msg):
    assert len(got) == len(want), msg
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      f"{msg} plane {k}")


@pytest.mark.parametrize("kind", ["offsets", "fields"])
def test_compensate_matches_jax(kind):
    """Every frame of the clip compensated from its source frame: offsets
    -1, 1, -2.5 and 0.4 (fractional parts: fractoffset != 1), each
    subpixel mode, mirror 15 with blur 4 and mirror 0, a cut inside the
    interval (the transform resets); with fields, matchfields on and off
    and both field parities, at 8 bits 4:2:0 and 10 bits 4:2:2."""
    if kind == "offsets":
        runs = [(dict(offset=off, subpixel=sp, mirror=mir, blur=blur), None,
                 (1, 1), 8)
                for off, sp, mir, blur in ((-1.0, 2, 15, 4), (1.0, 1, 0, 0),
                                           (-2.5, 0, 15, 4), (0.4, 2, 0, 0))]
    else:
        runs = [(dict(offset=-1.0, fields=True, matchfields=mf,
                      pixaspect=1.09), top, (1, 0), 10)
                for mf in (True, False) for top in (True, False)]
    motions = _motions(3, cuts=(4,))
    for kw, top, sub, bits in runs:
        frames = _clip(5, sub, bits)
        jf, tf = _jax(frames), _torch(frames)
        jcfg = jd.DepanCompensateConfig(**kw)
        tcfg = td.DepanCompensateConfig(**kw)
        for ndest in range(T):
            nsrc = min(max(ndest - jcfg.intoffset, 0), T - 1)
            want = jd.depan_compensate(jf[nsrc], motions, ndest, T, jcfg,
                                       sub_w=sub[0], sub_h=sub[1], bits=bits,
                                       top_field=top)
            got = td.depan_compensate(tf[nsrc], motions, ndest, T, tcfg,
                                      sub_w=sub[0], sub_h=sub[1], bits=bits,
                                      top_field=top)
            _equal(got, want, f"{kw} top {top} frame {ndest}")


@pytest.mark.parametrize("method", [0, 1])
def test_stabilise_matches_jax(method):
    """A whole clip stabilised with prev/next border filling and mirrors,
    a cut at frame 4 (the base restarts there), fitlast at the end."""
    frames = _clip(7)
    motions = _motions(9, cuts=(4,))
    kw = dict(method=method, prev=1, next=1, mirror=15, blur=2, fitlast=2,
              cutoff=2.0, fps=12.0)
    want = jd.depan_stabilise(_jax(frames), motions,
                              jd.DepanStabiliseConfig(**kw), 1, 1)
    got = td.depan_stabilise(_torch(frames), motions,
                             td.DepanStabiliseConfig(**kw), 1, 1)
    for n, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"method {method} frame {n}")


def test_stabilise_fields_and_limits_match_jax():
    """Fields (pixaspect halved), the soft limits (dxmax / dymax below
    the accumulated pan), subpixel 0 and 1, prev filling only, and next
    filling only into a cut; 10-bit 4:2:2."""
    frames = _clip(11, (1, 0), 10)
    motions = _motions(12, cuts=(3,))
    motions[:, 0] *= 3
    for kw in (dict(method=0, fields=True, dxmax=2.0, dymax=1.0,
                    subpixel=0, prev=2),
               dict(method=1, fields=True, subpixel=1, next=2, mirror=5),
               dict(method=0, dxmax=-2.0, subpixel=1, next=2)):
        want = jd.depan_stabilise(_jax(frames), motions,
                                  jd.DepanStabiliseConfig(**kw), 1, 0, 10)
        got = td.depan_stabilise(_torch(frames), motions,
                                 td.DepanStabiliseConfig(**kw), 1, 0, 10)
        for n, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{kw} frame {n}")


def test_stabilise_transforms_match_jax():
    """The per-frame transforms alone on a 40-frame record: tolerance 0
    with zoom 1 motions for both methods; with addzoom, initzoom 1.05 and
    motions that zoom, within STAB_ABS_TOL."""
    n = 40
    rng = np.random.default_rng(13)
    motions = np.zeros((n, 4), np.float32)
    motions[1:, 0] = rng.uniform(-4, 4, n - 1)
    motions[1:, 1] = rng.uniform(-4, 4, n - 1)
    motions[:, 2] = 1.0
    motions[17] = (0.0, 0.0, 1.0, 0.0)
    zooming = motions.copy()
    zooming[1:, 2] = rng.uniform(0.98, 1.02, n - 1)
    zooming[17] = (0.0, 0.0, 1.0, 0.0)
    cases = [(motions, dict(method=m, fitlast=3), True) for m in (0, 1)]
    cases += [(zooming, dict(method=m, addzoom=True, initzoom=1.05), False)
              for m in (0, 1)]
    for mot, kw, exact in cases:
        want = jd.stabilise_transforms(mot, jd.DepanStabiliseConfig(**kw),
                                       W, H, n)
        got = td.stabilise_transforms(mot, td.DepanStabiliseConfig(**kw),
                                      W, H, n)
        for k, (g, w) in enumerate(zip(got, want)):
            ulps, absdiff = _ulps(g, w)
            if exact:
                assert ulps.max() == 0, (kw, k, g, w)
            else:
                assert absdiff.max() <= STAB_ABS_TOL, (kw, k, absdiff)
