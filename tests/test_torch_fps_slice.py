"""PyTorch port: the frame-rate conversion slice — models/frc.py::
flowfps_clip (Super -> batched lockstep Analyse in both directions ->
FlowFPS maskmode 2, 30 -> 60 fps) on the shared gray reference clip
(torch_port_reference.load(): 256x192, blk 16, pel 2, 3 levels,
truemotion; frame 1 flashes).  load()'s four analysed jobs are exactly the
four fields maskmode 2 needs for the interval of frames (1, 2): (1, 2) is
mv_b, (2, 1) mv_f, (2, 3) mv_bb and (1, 0) mv_ff.  The port's fields of
those jobs are held to load()'s, its output frame of that interval to the
JAX package's flowfps_frame on load()'s fields, its other interpolated
frames to flowfps_frame on the port's own fields, and its passthrough
frames to the sources (tolerance 0).  No JAX analysis runs here."""
import dataclasses
import os
import sys
from fractions import Fraction

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu import flowfps as jfps
from mvtools_tpu.core.config import AnalyseConfig as JAnalyseConfig
from mvtools_tpu.core.config import SuperConfig as JSuperConfig
from mvtools_tpu.core.types import ColorFamily as JColorFamily
from mvtools_tpu.core.types import MVField, MVPlaneField
from mvtools_tpu.core.types import VideoFormat as JVideoFormat
from mvtools_tpu.super import Super as JSuper
from mvtools_tpu_torch import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.thscd import is_usable, scale_thscd
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.flowfps import FlowFPSConfig
from mvtools_tpu_torch.models.frc import flowfps_clip

import torch_port_reference as tpr

# the ref job of each interval field: load()'s job order is (1, 2), (1, 0),
# (2, 3), (2, 1) (torch_port_reference.job_indices)
JOB_B = {1: 0, 2: 2}        # backward field of interval k: frame k vs k + 1
JOB_F = {1: 3, 0: 1}        # forward field of interval k: frame k + 1 vs k


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


def _jax_specs():
    fmt = JVideoFormat(tpr.W, tpr.H, 8, JColorFamily.GRAY)
    sspec = JSuperConfig(pel=2, levels=tpr.LEVELS, chroma=False).validate(fmt)
    acfg = JAnalyseConfig(blksize=tpr.BLK, levels=tpr.LEVELS,
                          truemotion=True, chroma=False)
    return (sspec, dataclasses.replace(acfg, isb=True).validate(sspec),
            dataclasses.replace(acfg, isb=False).validate(sspec))


def _jax_field(levels, meta):
    return MVField(tuple(MVPlaneField(*(jnp.asarray(a) for a in lv))
                         for lv in levels), jnp.asarray(1, jnp.int32), meta)


def _ref_field(ref, job, meta):
    return _jax_field([tuple(ref[f"mv_{k}{lv}"][job] for k in ("x", "y", "sad"))
                       for lv in range(tpr.LEVELS)], meta)


def _port_field(mv, job, meta):
    return _jax_field([(l.x[job].numpy(), l.y[job].numpy(),
                        l.sad[job].numpy()) for l in mv.levels], meta)


def _run(ref, thscd):
    fmt = VideoFormat(tpr.W, tpr.H, 8, ColorFamily.GRAY)
    scfg = SuperConfig(pel=2, levels=tpr.LEVELS, chroma=False)
    acfg = AnalyseConfig(blksize=tpr.BLK, levels=tpr.LEVELS, truemotion=True,
                         chroma=False)
    fcfg = FlowFPSConfig(maskmode=2, **thscd)
    info = {}
    out = flowfps_clip([ref["frames"]], fmt, Fraction(30), Fraction(60),
                       scfg, acfg, fcfg, device="cpu", info=info)
    return out, info, fcfg


# thscd1 / thscd2 so high that every pair is usable (the interpolation),
# the defaults, and thscd2 so low that the flash pairs are scene changes
# (the blend)
@pytest.mark.parametrize("thscd", [dict(thscd1=16320, thscd2=255), {},
                                   dict(thscd2=20)],
                         ids=["usable", "defaults", "scene_change"])
def test_flowfps_clip_matches_jax(ref, thscd):
    out, info, fcfg = _run(ref, thscd)
    frames = ref["frames"]
    assert len(out) == 2 * tpr.N_FRAMES - 1
    assert info["keys_b"] == [0, 1, 2] and info["keys_f"] == [0, 1, 2]
    # the port's fields of load()'s four jobs are load()'s
    for name, jobs in (("fields_b", JOB_B), ("fields_f", JOB_F)):
        for key, job in jobs.items():
            for lv, l in enumerate(info[name].levels):
                for k in ("x", "y", "sad"):
                    np.testing.assert_array_equal(
                        getattr(l, k)[key].numpy(), ref[f"mv_{k}{lv}"][job],
                        err_msg=f"{name} interval {key} level {lv} {k}")
    # even output frames pass the sources through
    for n in range(0, len(out), 2):
        np.testing.assert_array_equal(out[n][0].numpy(), frames[n // 2])
    sspec, aspec_b, aspec_f = _jax_specs()
    sups = [JSuper(((tuple(jnp.asarray(ref[f"super{lv}"][i])
                           for lv in range(tpr.LEVELS)),)), sspec)
            for i in range(tpr.N_FRAMES)]
    jcfg = jfps.FlowFPSConfig(maskmode=2, **thscd)
    mb, mf = aspec_b.meta, aspec_f.meta

    def jax_frame(n, fb, ff):
        return np.asarray(jfps.flowfps_frame(
            [jnp.asarray(frames[n])], [jnp.asarray(frames[n + 1])], sups[n],
            sups[n + 1], fb, ff, aspec_b.meta, jcfg, 128)[0])

    # the interval (1, 2) from load()'s fields, with mv_bb and mv_ff
    want = jfps.flowfps_frame(
        [jnp.asarray(frames[1])], [jnp.asarray(frames[2])], sups[1], sups[2],
        _ref_field(ref, JOB_B[1], mb), _ref_field(ref, JOB_F[1], mf),
        aspec_b.meta, jcfg, 128, mv_bb=_ref_field(ref, JOB_B[2], mb),
        mv_ff=_ref_field(ref, JOB_F[0], mf))
    np.testing.assert_array_equal(out[3][0].numpy(), np.asarray(want[0]))
    # the intervals (0, 1) and (2, 3) (no extra fields: frame 0 has no
    # predecessor, frame 3 no successor) from the port's own fields
    for n, key in ((1, 0), (5, 2)):
        np.testing.assert_array_equal(
            out[n][0].numpy(),
            jax_frame(key, _port_field(info["fields_b"], key, mb),
                      _port_field(info["fields_f"], key, mf)))
    # which branch the flash interval took
    meta = info["fields_b"].meta
    n1, n2 = scale_thscd(fcfg.thscd1, fcfg.thscd2, meta)
    usable = bool(is_usable(info["fields_b"], n1, n2)[1]
                  & is_usable(info["fields_f"], n1, n2)[1])
    if "thscd1" in thscd:
        assert usable
    if thscd.get("thscd2") == 20:
        assert not usable
        blend = ((frames[1].astype(np.int32) * 128
                  + frames[2].astype(np.int32) * 128) >> 8).astype(np.uint8)
        np.testing.assert_array_equal(out[3][0].numpy(), blend)
