"""PyTorch port: FlowFPS (flowfps.py, flowutils.py) against the JAX package
on the same inputs, bit for bit (tolerance 0): supers from build_super in
each package, synthetic seeded fields (smooth vectors with noise, SADs over
and under the scene-change thresholds), maskmode 0, 1 and 2, the usable and
the scene-change branch, maskmode 2's choice between the extra-field
kernel and the plain one, gray and YUV420 with a block grid padded to the
frame."""
import dataclasses
import os
import sys
from fractions import Fraction

import numpy as np
import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import flowfps as jfps
from mvtools_tpu import flowutils as jfu
from mvtools_tpu_torch import flowfps, flowutils
from mvtools_tpu_torch.models.frc import frame_plan

import torch_flow_cases as tfc

CONFIGS = tfc.CONFIGS


@pytest.fixture(scope="module")
def setups():
    return [tfc.setup(c) for c in CONFIGS]


def _fields(s, is_backward, sad_hi, validity=1):
    return tfc.make_fields(s, is_backward, sad_hi, validity)


def _run(s, cfg, time256, fields):
    import jax.numpy as jnp
    meta, tmeta = tfc.meta_pair(s["aspec"], True)
    src, ref = s["planes"]
    jf = {k: v[0] for k, v in fields.items()}
    tf = {k: v[1] for k, v in fields.items()}
    want = jfps.flowfps_frame([jnp.asarray(p) for p in src],
                              [jnp.asarray(p) for p in ref], *s["jsups"],
                              jf.pop("mv_b"), jf.pop("mv_f"), meta,
                              jfps.FlowFPSConfig(**cfg), time256, **jf)
    got = flowfps.flowfps_frame([torch.from_numpy(p) for p in src],
                                [torch.from_numpy(p) for p in ref],
                                *s["tsups"], tf.pop("mv_b"), tf.pop("mv_f"),
                                tmeta, flowfps.FlowFPSConfig(**cfg), time256,
                                **tf)
    tfc.equal(got, want, f"{cfg} t{time256}")
    return got


@pytest.mark.parametrize("maskmode", [0, 1, 2])
def test_flowfps_frame_matches_jax(setups, maskmode):
    """Each maskmode at time256 64, 128 and 200: fields that are usable,
    and a pair with a scene change (blend, and with blend=False the source
    frame); for maskmode 2 also the extra fields, usable or not."""
    for s in setups:
        usable = dict(mv_b=_fields(s, True, 0.0), mv_f=_fields(s, False, 0.0))
        cut = dict(mv_b=_fields(s, True, 0.9), mv_f=_fields(s, False, 0.0))
        cases = [(usable, {}), (cut, {}), (cut, dict(blend=False))]
        if maskmode == 2:
            extra = dict(usable, mv_bb=_fields(s, True, 0.0),
                         mv_ff=_fields(s, False, 0.0))
            torn = dict(usable, mv_bb=_fields(s, True, 0.0),
                        mv_ff=_fields(s, False, 0.0, validity=0))
            cases += [(extra, {}), (torn, {})]
        for fields, kw in cases:
            for time256 in (64, 128, 200):
                _run(s, dict(maskmode=maskmode, **kw), time256, fields)
        # the passthrough positions
        for time256 in (0, 256):
            got = _run(s, dict(maskmode=maskmode), time256, usable)
            want = s["planes"][time256 // 256]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


def test_flow_geometry_and_fields_match_jax(setups):
    """FlowGeometry, the padded small grids, the upsized vectors and masks
    (luma and chroma) and the small occlusion masks."""
    for s in setups:
        meta, tmeta = tfc.meta_pair(s["aspec"], False)
        geo = flowutils.FlowGeometry.from_meta(tmeta)
        jgeo = jfu.FlowGeometry.from_meta(meta)
        assert dataclasses.astuple(geo) == dataclasses.astuple(jgeo)
        jf, tf = _fields(s, False, 0.0)
        for shift in (0, 2):
            tv = flowutils.small_vector_fields(tf, tmeta, geo, shift)
            jv = jfu.small_vector_fields(jf, meta, jgeo, shift)
            tfc.equal(list(tv), list(jv), f"small fields shift {shift}")
        for chroma in (False, True):
            tfc.equal(list(flowutils.upsize_vectors(*tv, tmeta, geo,
                                                    chroma)),
                      list(jfu.upsize_vectors(*jv, meta, jgeo, chroma)),
                      f"upsized chroma={chroma}")
        for backward, time256 in ((True, 56), (False, 200)):
            tm = flowutils.occlusion_mask_small(tf, tmeta, backward, 100.0,
                                                time256)
            jm = jfu.occlusion_mask_small(jf, meta, backward, 100.0, time256)
            tfc.equal(tm, jm, f"occlusion {backward}")
            for chroma in (False, True):
                tfc.equal(flowutils.upsize_mask(tm, tmeta, geo, chroma),
                          jfu.upsize_mask(jm, meta, jgeo, chroma))


def test_output_frame_mapping_and_plan():
    """output_frame_mapping against the JAX package's, and frame_plan
    against the JAX model's loop (frc.py:76-95): clamps, passthroughs and
    maskmode 2's extra fields."""
    for num, den in ((60, 30), (50, 25), (60000, 24000), (24, 25), (90, 30)):
        fa = Fraction(den) / Fraction(num)
        for off in (1, 2):
            for n in range(40):
                assert (flowfps.output_frame_mapping(n, fa, off)
                        == jfps.output_frame_mapping(n, fa, off))
        for t_in in (1, 2, 4, 9):
            num_out = max(int(np.floor(t_in / float(fa))) - 1, 0)
            for maskmode in (0, 2):
                plan, keys_b, keys_f = frame_plan(t_in, fa, num_out,
                                                  maskmode)
                want_b, want_f = set(), set()
                for n, (nl, nr, tt, extra) in enumerate(plan):
                    wl, wr, wt = jfps.output_frame_mapping(n, fa, 1)
                    wl, wr = min(wl, t_in - 1), min(wr, t_in - 1)
                    if wt == 0 or wl == wr:
                        assert (nl, tt) == (wl, 0)
                        continue
                    assert (nl, nr, tt) == (wl, wr, wt)
                    assert extra == (maskmode == 2 and wl > 0
                                     and wr + 1 < t_in)
                    want_b.add(wl)
                    want_f.add(wl)
                    if extra:
                        want_b.add(wr)
                        want_f.add(wl - 1)
                assert (keys_b, keys_f) == (sorted(want_b), sorted(want_f))
