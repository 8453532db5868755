"""PyTorch port: Compensate, SCDetection and Mask (compensate.py,
scdetect.py, mask.py) against the JAX package on the same inputs, bit for
bit (tolerance 0): supers from build_super in each package, synthetic
seeded fields (smooth vectors with noise, a pure translation, SADs over and
under the scene-change thresholds and thsad), gray and YUV420 with overlap
and a block grid padded to the frame."""
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import compensate as jcomp
from mvtools_tpu import mask as jmask
from mvtools_tpu import scdetect as jscd
from mvtools_tpu_torch import compensate, mask, scdetect

import torch_flow_cases as tfc


@pytest.fixture(scope="module")
def setups():
    return [tfc.setup(c) for c in tfc.CONFIGS]


def _translation(s, dx, dy):
    """A field of one vector (dx, dy) pel everywhere, small SADs."""
    meta, tmeta = tfc.meta_pair(s["aspec"], False)
    vx, vy, sad = tfc.field_arrays(s["rng"], meta, spread=0, base=(0, 0))
    return tfc.fields((np.full_like(vx, dx), np.full_like(vy, dy), sad),
                      meta, tmeta)


@pytest.mark.parametrize("kind", ["translation", "fields", "scene_change"])
def test_compensate_matches_jax(setups, kind):
    """A pure translation (the compensated frame is the reference moved);
    noisy fields with SADs on both sides of thsad, at time 100 and 50, with
    a field shift; a scene change with scbehavior True and False."""
    for s in setups:
        meta, tmeta = tfc.meta_pair(s["aspec"], False)
        if kind == "translation":
            runs = [(_translation(s, 2, -3), dict(thscd1=1000, thscd2=255),
                     0)]
        elif kind == "fields":
            f = tfc.make_fields(s, False, 0.0, spread=5)
            runs = [(f, dict(thsad=150), 0), (f, dict(time=50.0), 0),
                    (f, dict(thsad=100, time=70.0), 1)]
        else:
            f = tfc.make_fields(s, False, 0.9)
            runs = [(f, {}, 0), (f, dict(scbehavior=False), 0)]
        for (jf, tf), kw, shift in runs:
            want = jcomp.compensate(*s["jsups"], jf, meta,
                                    jcomp.CompensateConfig(**kw), shift)
            got = compensate.compensate(*s["tsups"], tf, tmeta,
                                        compensate.CompensateConfig(**kw),
                                        shift)
            tfc.equal(got, want, f"{s['cfg']} {kind} {kw} shift {shift}")
            if kind == "scene_change":
                frame = s["planes"][0 if kw.get("scbehavior", True) else 1]
                for g, w in zip(got, frame):
                    np.testing.assert_array_equal(g.numpy(), w)


def test_scdetect_matches_jax(setups):
    """The scene-change flag over fields with 0 to 90 % of their blocks
    over thscd1, at the default thresholds and others; a default (invalid)
    field."""
    for s in setups:
        for backward in (False, True):
            for share in (0.0, 0.2, 0.5, 0.9):
                for validity in (1, 0):
                    meta, _ = tfc.meta_pair(s["aspec"], backward)
                    jf, tf = tfc.make_fields(s, backward, share, validity)
                    for th in ({}, dict(thscd1=200, thscd2=50),
                               dict(thscd1=3000, thscd2=10)):
                        want = jscd.scdetect(
                            jf, meta, jscd.SCDetectionConfig(**th))
                        got = scdetect.scdetect(
                            tf, tf.meta, scdetect.SCDetectionConfig(**th))
                        assert got.dtype == torch.bool and got.dim() == 0
                        assert bool(got) == bool(want), (s["cfg"], share, th)


@pytest.mark.parametrize("kinds", [(0, 1, 2), (3, 4, 5)],
                         ids=["kinds0-2", "kinds3-5"])
def test_mask_matches_jax(setups, kinds):
    """Every mask kind at gamma 1, 2 and 0.5, ml 50 and 100, time 100 and
    40, both directions; and a scene change (the ysc frame, or the luma
    passthrough of kind 5)."""
    for s in setups:
        jsrc = [jnp.asarray(p) for p in s["planes"][0]]
        tsrc = [torch.from_numpy(p) for p in s["planes"][0]]
        for backward in (False, True):
            meta, tmeta = tfc.meta_pair(s["aspec"], backward)
            fields = [tfc.make_fields(s, backward, 0.0, spread=8),
                      tfc.make_fields(s, backward, 0.9)]
            for kind in kinds:
                for (jf, tf), kw in (
                        (fields[0], dict(gamma=1.0, ml=50.0)),
                        (fields[0], dict(gamma=2.0, ml=100.0, time=40.0)),
                        (fields[0], dict(gamma=0.5, ml=70.0)),
                        (fields[1], dict(ysc=200))):
                    want = jmask.mask(jsrc, jf, meta,
                                      jmask.MaskConfig(kind=kind, **kw))
                    got = mask.mask(tsrc, tf, tmeta,
                                    mask.MaskConfig(kind=kind, **kw))
                    tfc.equal(got, want, f"{s['cfg']} kind {kind} {kw} "
                              f"backward {backward}")
