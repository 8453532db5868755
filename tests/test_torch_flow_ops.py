"""PyTorch port: the flow toolbox (ops/resize.py, ops/maskfun.py, finest.py)
against the JAX package on the same numpy inputs, bit for bit (tolerance
0): SimpleResize with and without the int16 path's limiting, the occlusion
and SAD masks, blend, the grid padding, and the three per-pixel flow
interpolation kernels."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu.finest import finest as jax_finest
from mvtools_tpu.ops import maskfun as jmf, resize as jrs
from mvtools_tpu_torch.finest import finest
from mvtools_tpu_torch.ops import maskfun, resize

import torch_flow_cases as tfc


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["u8", "limit"])
def test_simple_resize_matches_jax(kind):
    """(6,8)->(48,64) and (5,7)->(37,53); with the int16 path's limiting
    also (9,4)->(72,32), for horizontal and vertical vectors."""
    for (sh, sw), (dh, dw) in (((6, 8), (48, 64)), ((5, 7), (37, 53)),
                               ((9, 4), (72, 32))):
        rng = np.random.default_rng(sh * 10 + sw)
        if kind == "u8":
            src = rng.integers(0, 256, (sh, sw), np.int32)
            tfc.equal(resize.simple_resize(t(src), dh, dw),
                      jrs.simple_resize(jnp.asarray(src), dh, dw))
        else:
            src = rng.integers(-50, 50, (sh, sw), np.int32)
            for horiz in (True, False):
                kw = dict(limit=True, limit_width=dw, limit_height=dh,
                          pel=2, horizontal_vectors=horiz)
                tfc.equal(resize.simple_resize(t(src), dh, dw, **kw),
                          jrs.simple_resize(jnp.asarray(src), dh, dw, **kw),
                          f"{(sh, sw)} horizontal={horiz}")
        off, w = resize.init_tables(dh, sh)
        joff, jw = jrs.init_tables(dh, sh)
        np.testing.assert_array_equal(off, joff)
        np.testing.assert_array_equal(w, jw)


def test_occlusion_mask_matches_jax():
    """Over is_backward x gamma (1.0, 2.0), three grid shapes and times."""
    rng = np.random.default_rng(2)
    for is_backward, gamma, shape, time256, step in (
            (b, g, sh, tt, st) for b in (False, True) for g in (1.0, 2.0)
            for sh, tt, st in (((7, 9), 100, (8, 8)),
                               ((12, 15), 200, (16, 8)),
                               ((5, 4), 37, (4, 4)))):
        vx = rng.integers(-20, 20, shape, np.int32)
        vy = rng.integers(-20, 20, shape, np.int32)
        args = (is_backward, 100.0, gamma, 2, time256) + step
        tfc.equal(maskfun.make_vector_occlusion_mask_time(t(vx), t(vy),
                                                          *args),
                  jmf.make_vector_occlusion_mask_time(jnp.asarray(vx),
                                                      jnp.asarray(vy), *args),
                  f"backward {is_backward} gamma {gamma} {shape} "
                  f"t{time256}")


def test_flow_inter_kernels_match_jax():
    for time256 in (64, 128, 200):
        _flow_inter_case(time256)


def _flow_inter_case(time256):
    rng = np.random.default_rng(3)
    h, w, pel = 24, 32, 2
    fine_b = rng.integers(0, 256, ((h + 8) * pel, (w + 8) * pel), np.int32)
    fine_f = rng.integers(0, 256, ((h + 8) * pel, (w + 8) * pel), np.int32)
    oy = ox = 4 * pel
    # vectors up to 14 pel: some samples land off the plane and clamp
    v = [rng.integers(-14, 14, (h, w), np.int32) for _ in range(8)]
    mb = rng.integers(0, 256, (h, w), np.int32)
    mf = rng.integers(0, 256, (h, w), np.int32)
    args = [fine_b, fine_f, oy, ox] + v[:4] + [mb, mf, time256, pel]

    def conv(fn, a):
        return [fn(x) if isinstance(x, np.ndarray) else x for x in a]

    ta, ja = conv(t, args), conv(jnp.asarray, args)
    tfc.equal(maskfun.flow_inter(*ta), jmf.flow_inter(*ja), "flow_inter")
    tfc.equal(maskfun.flow_inter_simple(*ta), jmf.flow_inter_simple(*ja),
              "flow_inter_simple")
    tfc.equal(maskfun.flow_inter_extra(*ta, *conv(t, v[4:])),
              jmf.flow_inter_extra(*ja, *conv(jnp.asarray, v[4:])),
              "flow_inter_extra")


def test_masks_blend_and_padding_match_jax():
    for bits in (8, 10):
        _masks_case(bits)


def _masks_case(bits):
    rng = np.random.default_rng(4 + bits)
    nby, nbx = 6, 9
    vx = rng.integers(-30, 30, (nby, nbx), np.int32)
    vy = rng.integers(-30, 30, (nby, nbx), np.int32)
    sad = rng.integers(0, 64 * ((1 << bits) - 1), (nby, nbx)).astype(np.int64)
    for gamma, time256 in ((1.0, 64), (2.0, 200), (1.0, 0)):
        args = (4.0 / (100.0 * 64), gamma, 2, time256, 8, 8, bits)
        tfc.equal(maskfun.make_sad_mask_time(t(vx), t(vy), t(sad), *args),
                  jmf.make_sad_mask_time(jnp.asarray(vx), jnp.asarray(vy),
                                         jnp.asarray(sad), *args),
                  f"sad mask {gamma} {time256}")
        tfc.equal(maskfun.byte_norm(t(sad), 1.0 / 4000, gamma),
                  jmf.byte_norm(jnp.asarray(sad), 1.0 / 4000, gamma))
    tfc.equal(maskfun.sad_to_mask(t(sad), 37),
              jmf.sad_to_mask(jnp.asarray(sad), 37))
    a = rng.integers(0, 1 << bits, (20, 30), np.int32)
    b = rng.integers(0, 1 << bits, (20, 30), np.int32)
    for time256 in (1, 100, 255):
        tfc.equal(maskfun.blend(t(a), t(b), time256, bits),
                  jmf.blend(jnp.asarray(a), jnp.asarray(b), time256, bits))
    for px, py in ((nbx, nby), (nbx + 2, nby), (nbx, nby + 3),
                   (nbx + 1, nby + 1)):
        tfc.equal(list(maskfun.check_and_pad_small(t(vx), t(vy), px, py)),
                  list(jmf.check_and_pad_small(jnp.asarray(vx),
                                               jnp.asarray(vy), px, py)))
        tfc.equal(maskfun.check_and_pad_mask(t(vx), px, py),
                  jmf.check_and_pad_mask(jnp.asarray(vx), px, py))
    for r in (1, 2):
        tfc.equal(maskfun.vector_small_mask_y_to_half_uv(t(vx), r),
                  jmf.vector_small_mask_y_to_half_uv(jnp.asarray(vx), r))


def test_finest_matches_jax():
    for pel, family, bits in ((1, "GRAY", 8), (2, "YUV420", 8),
                              (2, "GRAY", 16)):
        _finest_case(pel, family, bits)


def _finest_case(pel, family, bits):
    rng = np.random.default_rng(5)
    sspec, _, tsspec, _ = tfc.specs(64, 48, pel=pel, family=family,
                                    bits=bits)
    planes = tfc.frames(rng, 1, 64, 48, bits, family)[0]
    jsup, tsup = tfc.supers(planes, sspec, tsspec)
    got = finest(tsup)
    want = jax_finest(jsup)
    tfc.equal(got, want)
    # a batch of two frames: each is the frame's own
    both = tsup.map(lambda a: torch.stack([a, a]))
    for g, w in zip(finest(both), want):
        tfc.equal(g[1], w)
