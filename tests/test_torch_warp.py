"""PyTorch port: ops/warp.py against the JAX package's ops/warp.py on the
CPU.

The transform algebra is compared with tolerance 0 where rot = 0 and
zoom = 1 (every operation is a float32 add, multiply, divide or a
transcendental at an exact point: log 1, exp 0, sin 0, cos 0, arctan 0).
Elsewhere the port's numpy float32 exp/log/sin/cos/arctan/sqrt and
XLA:CPU's differ by a few ulp (measured on this box: at most 1 ulp for
sin/cos/arctan, 2-3 for exp/log; XLA:CPU's float32 sqrt is not correctly
rounded, 1 ulp); after the chains of motion2transform / transform2motion
(up to ~20 roundings) each output is held within MAX_ULPS ulp or
ABS_TOL absolute: the offsets dxc/dyc are differences of terms the size
of the frame's centre (32 here, whose ulp is 3.8e-6), so near zero their
ulp distance is large while the absolute one is not (measured on 400
motions: at most 7.6e-6 absolute; 32 ulp where above 3.8e-6).

warp_plane is compared with tolerance 0, fed the same float32 transform
numbers in both packages: nearest, bilinear and bicubic on the
translation, zoom and rotation branches, each mirror bit on and off, edge
blur, constant borders and `base`, at 8 and 10 bits, luma and the 4:2:0
and 4:2:2 chroma transforms.  The JAX warp is called eagerly, as its
callers (depan_compensate, depan_stabilise, the CLI) call it: under
jax.jit XLA:CPU contracts `dxc + dxx*x` into a fused multiply-add, which
moved 7 959 of 32 000 zoom-branch coordinates by an ulp in a check on
this box, and 1 pixel of 60 warps."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu.ops import warp as jw
from mvtools_tpu_torch.ops import warp as tw

F32 = np.float32
H, W = 48, 64
MAX_ULPS = 16
ABS_TOL = 1e-5


def _jtr(tr):
    return jw.Transform(*(jnp.float32(v) for v in tr))


def _f32(values):
    return np.array([float(v) for v in values], np.float32)


def _ulps(a, b):
    a, b = _f32(a), _f32(b)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)   # ordered ints
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return np.abs(ia - ib), np.abs(a.astype(np.float64) - b)


def _motions(rng, n, exact):
    for k in range(n):
        dx, dy = rng.uniform(-12, 12, 2)
        rot = 0.0 if exact else rng.uniform(-4, 4)
        zoom = 1.0 if exact else rng.uniform(0.9, 1.1)
        yield (dx, dy, rot, zoom, rng.choice([1.0, 0.5, 1.09]), W / 2, H / 2,
               bool(k % 2), rng.choice([1.0, -0.5, 0.25, -1.0]))


@pytest.mark.parametrize("exact", [True, False])
def test_transform_algebra_matches_jax(exact):
    """motion2transform, transform2motion, sumtransform, inversetransform
    and transform_for_plane: equal where rot = 0 and zoom = 1, within
    MAX_ULPS (or ABS_TOL) elsewhere."""
    rng = np.random.default_rng(7 if exact else 8)
    worst = 0
    prev_t = None
    for args in _motions(rng, 40, exact):
        pa, xc, yc, fwd = args[4], args[5], args[6], args[7]
        got = tw.motion2transform(*args)
        want = jw.motion2transform(*args)
        outs = [(got, want)]
        outs.append((tw.transform2motion(got, fwd, xc, yc, pa),
                     jw.transform2motion(_jtr(got), fwd, xc, yc, pa)))
        outs.append((tw.inversetransform(got),
                     jw.inversetransform(_jtr(got))))
        for sub in ((1, 1), (1, 0), (0, 0)):
            outs.append((tw.transform_for_plane(got, *sub),
                         jw.transform_for_plane(_jtr(got), *sub)))
        if prev_t is not None:
            outs.append((tw.sumtransform(prev_t, got),
                         jw.sumtransform(_jtr(prev_t), _jtr(got))))
        prev_t = got
        for g, w in outs:
            ulps, absdiff = _ulps(g, w)
            if exact:
                np.testing.assert_array_equal(_f32(g), _f32(w), str(args))
            else:
                assert ((ulps <= MAX_ULPS) | (absdiff <= ABS_TOL)).all(), \
                    (args, ulps, absdiff)
                worst = max(worst, int(ulps.max()))
    assert tw.null_transform() == tuple(_f32(jw.null_transform()))
    print(f"largest ulp distance: {worst}")


def _planes(rng, bits):
    pm = (1 << bits) - 1
    dt = np.uint8 if bits == 8 else np.uint16
    luma = rng.integers(0, pm + 1, (H, W)).astype(dt)
    base = rng.integers(0, pm + 1, (H, W)).astype(dt)
    return luma, base, pm


def _warp_both(plane, tr, subpixel, mirror, border, blur, pm, base=None):
    want = np.asarray(jw.warp_plane(
        jnp.asarray(plane), _jtr(tr), subpixel, mirror, border, blur, pm,
        None if base is None else jnp.asarray(base)))
    got = tw.warp_plane(torch.from_numpy(plane), tr, subpixel, mirror, border,
                        blur, pm,
                        None if base is None else torch.from_numpy(base))
    return got.numpy(), want


# (border, blur, use base): keep the source, the constant fill, keep a base
# with edge blur, a constant with a long blur
BORDERS = ((-1, 0, False), (0, 0, False), (-1, 3, True), (17, 5, False))


@pytest.mark.parametrize("branch", ["translation", "zoom", "rotation"])
def test_warp_plane_matches_jax(branch):
    """Every subpixel mode, mirror combination and border policy on one
    branch of the reference's dispatch, at 8 and 10 bits; the transform
    walks the whole plane off its edges (shifts up to 12 pixels) so the
    mirrors, blurs and fallbacks all fire."""
    rng = np.random.default_rng({"translation": 1, "zoom": 2,
                                 "rotation": 3}[branch])
    checked = 0
    for bits in (8, 10):
        plane, base, pm = _planes(rng, bits)
        for k in range(2):
            dx, dy = rng.uniform(-12, 12, 2)
            if branch == "translation" and k == 0:
                dx, dy = float(rng.integers(-12, 12)), 0.0
            rot = rng.uniform(-4, 4) if branch == "rotation" else 0.0
            zoom = 1.0 if branch == "translation" else rng.uniform(0.85, 1.15)
            tr = tw.motion2transform(dx, dy, rot, zoom, 1.0, W / 2, H / 2,
                                     bool(k % 2), 1.0)
            assert tw.is_rotation(tr) == (branch == "rotation")
            for subpixel in (0, 1, 2):
                for mirror in (0, 15, 5, 10):
                    for border, blur, use_base in BORDERS:
                        got, want = _warp_both(
                            plane, tr, subpixel, mirror, border, blur, pm,
                            base if use_base else None)
                        np.testing.assert_array_equal(
                            got, want, f"{branch} bits {bits} tr {tr} "
                            f"subpixel {subpixel} mirror {mirror} border "
                            f"{border} blur {blur}")
                        checked += 1
    assert checked == 2 * 2 * 3 * 4 * len(BORDERS)


def test_warp_chroma_planes_match_jax():
    """The chroma transform of 4:2:0 and 4:2:2 (transform_for_plane) on a
    chroma-sized plane, with the chroma border (1 << (bits - 1)) and the
    halved blur, at 8 and 10 bits, for each branch."""
    rng = np.random.default_rng(4)
    for sub, bits in ((s, b) for s in ((1, 1), (1, 0)) for b in (8, 10)):
        ch, cw = H >> sub[1], W >> sub[0]
        pm = (1 << bits) - 1
        dt = np.uint8 if bits == 8 else np.uint16
        plane = rng.integers(0, pm + 1, (ch, cw)).astype(dt)
        for rot, zoom in ((0.0, 1.0), (0.0, 1.07), (2.5, 0.96)):
            tr = tw.motion2transform(rng.uniform(-9, 9), rng.uniform(-9, 9),
                                     rot, zoom, 1.0, W / 2, H / 2, True, 1.0)
            trc = tw.transform_for_plane(tr, *sub)
            for subpixel in (0, 1, 2):
                for mirror in (0, 15):
                    got, want = _warp_both(plane, trc, subpixel, mirror,
                                           1 << (bits - 1), 2, pm)
                    np.testing.assert_array_equal(
                        got, want, f"sub {sub} bits {bits} rot {rot} zoom "
                        f"{zoom} subpixel {subpixel} mirror {mirror}")
