"""PyTorch port: the denoise entry points on the exact engine against the
JAX package on CPU, bit for bit (inputs and JAX side:
tests/torch_port_reference.py, load_exact): degrain_clip with its defaults
(engine "exact" in both packages) on a 64x48 YUV420 clip at radius 2;
degrain_n_frame with engine="exact" and the clip-edge flags, frame by
frame, against the same output; degrain1_frame and degrain1_clip with
engine="exact" on the gray clip against the JAX package's Degrain on its
exact fields."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_reference as tpr  # noqa: E402
from mvtools_tpu_torch.core import config, types  # noqa: E402
from mvtools_tpu_torch.degrain import DegrainConfig  # noqa: E402
from mvtools_tpu_torch.models.denoise import (  # noqa: E402
    degrain1_clip, degrain1_frame, degrain_clip, degrain_n_frame)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


def test_degrain_clip_defaults_match_jax(ref):
    """Called with their defaults, both packages' degrain_clip run the
    exact engine and give the same planes."""
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "YUV420",
                                            tpr.EX_DC_ACFG)
    clip = [torch.from_numpy(p) for p in tpr.make_exact_yuv()]
    got = degrain_clip(clip, fmt, scfg, acfg, DegrainConfig(**tpr.EX_DEGRAIN),
                       tpr.EX_RADIUS)
    for i, p in enumerate(got):
        np.testing.assert_array_equal(p.numpy(), ref[f"dc_{i}"],
                                      err_msg=f"plane {i}")


def test_degrain_n_frame_exact_matches_jax(ref):
    """Each frame of the YUV clip through degrain_n_frame(engine="exact"),
    neighbours past the clip's edge replicated and flagged invalid: the
    JAX package's degrain_clip output, frame by frame."""
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "YUV420",
                                            tpr.EX_DC_ACFG)
    sspec = scfg.validate(fmt)
    aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
    clip = [torch.from_numpy(p) for p in tpr.make_exact_yuv()]
    total, r = clip[0].shape[0], tpr.EX_RADIUS

    def frame(t):
        return [p[min(max(t, 0), total - 1)] for p in clip]

    for t in range(total):
        got = degrain_n_frame(
            frame(t), [frame(t - k) for k in range(1, r + 1)],
            [frame(t + k) for k in range(1, r + 1)], sspec, aspec_b, aspec_f,
            DegrainConfig(**tpr.EX_DEGRAIN), engine="exact",
            valid_b=[t + k < total for k in range(1, r + 1)],
            valid_f=[t - k >= 0 for k in range(1, r + 1)])
        for i, p in enumerate(got):
            np.testing.assert_array_equal(p.numpy(), ref[f"dc_{i}"][t],
                                          err_msg=f"frame {t} plane {i}")


def _gray_specs():
    """(SuperSpec, backward AnalyseSpec, forward AnalyseSpec) of gray_b's
    configuration."""
    _, skw, akw, _, _ = tpr.EX_ANALYSES["gray_b"]
    fmt = types.VideoFormat(tpr.EX_W, tpr.EX_H, 8, types.ColorFamily.GRAY)
    sspec = config.SuperConfig(**dict(skw, chroma=False)).validate(fmt)
    acfg = config.AnalyseConfig(**dict(akw, chroma=False))
    return (sspec, dataclasses.replace(acfg, isb=True).validate(sspec),
            dataclasses.replace(acfg, isb=False).validate(sspec))


def test_degrain1_frame_exact_matches_jax(ref):
    sspec, aspec_b, aspec_f = _gray_specs()
    gray = torch.from_numpy(tpr.make_exact_gray())
    for c in (1, 2):
        got = degrain1_frame([gray[c]], [gray[c - 1]], [gray[c + 1]], sspec,
                             aspec_b, aspec_f,
                             DegrainConfig(**tpr.EX_DEGRAIN), engine="exact")
        np.testing.assert_array_equal(got[0].numpy(), ref[f"dg1_{c}"])


def test_degrain1_clip_exact_matches_jax(ref):
    """Frames 0-3 at radius 1: the inner frames are the JAX package's
    Degrain1 on its exact fields, the edge frames degrain_n_frame's with
    the missing neighbour invalid."""
    sspec, aspec_b, aspec_f = _gray_specs()
    gray = torch.from_numpy(tpr.make_exact_gray()[:4])
    fmt = types.VideoFormat(tpr.EX_W, tpr.EX_H, 8, types.ColorFamily.GRAY)
    _, skw, akw, _, _ = tpr.EX_ANALYSES["gray_b"]
    dcfg = DegrainConfig(**tpr.EX_DEGRAIN)
    got = degrain1_clip([gray], fmt,
                        config.SuperConfig(**dict(skw, chroma=False)),
                        config.AnalyseConfig(**dict(akw, chroma=False)),
                        dcfg, engine="exact")[0]
    for c in (1, 2):
        np.testing.assert_array_equal(got[c].numpy(), ref[f"dg1_{c}"])
    for t, nb, pv, ok_b, ok_f in ((0, 1, 0, True, False),
                                  (3, 3, 2, False, True)):
        want = degrain_n_frame([gray[t]], [[gray[pv]]], [[gray[nb]]], sspec,
                               aspec_b, aspec_f, dcfg, engine="exact",
                               valid_b=[ok_b], valid_f=[ok_f])[0]
        assert torch.equal(got[t], want), f"frame {t}"
