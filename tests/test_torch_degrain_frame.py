"""PyTorch port: the per-frame denoise entry points of models/denoise.py
(degrain1_frame, degrain_n_frame) and degrain1_clip, on the shared gray
reference clip (torch_port_reference.load(): 256x192, blk 16, pel 2, 3
levels, truemotion; frame 1 flashes).  Frames 1 and 2 are held to load()'s
denoised frames (the JAX package's degrain on its own analysis), the clip's
edge frames to the JAX package's degrain on the port's fields with the
missing neighbour marked invalid (tolerance 0).  No JAX analysis runs
here."""
import dataclasses
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mvtools_tpu.core.types import MVField, MVPlaneField
from mvtools_tpu.degrain import DegrainConfig as JDegrainConfig
from mvtools_tpu.degrain import degrain as jdegrain
from mvtools_tpu.super import Super as JSuper
from mvtools_tpu_torch.analyse import analyse_batch
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.degrain import DegrainConfig
from mvtools_tpu_torch.models.denoise import (degrain1_clip, degrain1_frame,
                                              degrain_n_frame)
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


def _specs(ref):
    sspec, aspec_b = tpr.specs(ref)
    aspec_f = dataclasses.replace(aspec_b, meta=dataclasses.replace(
        aspec_b.meta, is_backward=False))
    return sspec, aspec_b, aspec_f


def _frame(ref, i):
    return [torch.from_numpy(ref["frames"][i])]


def _jax_edge(ref, sspec, aspec_b, i, nb, pv, ok_b, ok_f):
    """The JAX package's degrain of frame i from neighbours nb (backward)
    and pv (forward) on the port's fields of those pairs."""
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src = torch.tensor([i, i])
    mv = analyse_batch(sups.take(src), sups.take(torch.tensor([nb, pv])),
                       aspec_b)
    jspec = _jax_sspec(ref)
    jsups = [JSuper(((tuple(jnp.asarray(ref[f"super{lv}"][k])
                            for lv in range(tpr.LEVELS)),)), jspec)
             for k in (nb, pv)]
    meta_b = _jax_meta(ref, True)
    meta_f = _jax_meta(ref, False)
    mvs = [MVField(tuple(MVPlaneField(jnp.asarray(l.x[j].numpy()),
                                      jnp.asarray(l.y[j].numpy()),
                                      jnp.asarray(l.sad[j].numpy()))
                         for l in mv.levels), jnp.asarray(1, jnp.int32), m)
           for j, m in ((0, meta_b), (1, meta_f))]
    return np.asarray(jdegrain([jnp.asarray(ref["frames"][i])], jsups, mvs,
                               meta_b, JDegrainConfig(thsad=400),
                               valid=[jnp.asarray(ok_b),
                                      jnp.asarray(ok_f)])[0])


def _jax_sspec(ref):
    import json
    from mvtools_tpu.core.config import SuperSpec
    from mvtools_tpu.core.types import ColorFamily as JCF
    d = json.loads(str(ref["sspec_json"]))
    return SuperSpec(**dict(d, family=JCF(int(d["family"]))))


def _jax_meta(ref, is_backward):
    import json
    from mvtools_tpu.core.types import AnalysisMeta
    d = json.loads(str(ref["aspec_json"]))["meta"]
    return AnalysisMeta(**dict(d, is_backward=is_backward))


def test_degrain1_frame_matches_jax(ref):
    """Frames 1 and 2, each from its two neighbours: load()'s denoised
    frames."""
    sspec, aspec_b, aspec_f = _specs(ref)
    for c in (1, 2):
        out = degrain1_frame(_frame(ref, c), _frame(ref, c - 1),
                             _frame(ref, c + 1), sspec, aspec_b, aspec_f,
                             DegrainConfig(thsad=400))
        assert len(out) == 1 and out[0].dtype == torch.uint8
        np.testing.assert_array_equal(out[0].numpy(), ref["degrain"][c - 1])


def test_degrain_n_frame_edges_match_jax(ref):
    """Frame 0 (no previous frame: its forward neighbour is itself and
    invalid) and frame 3 (no next frame) through degrain_n_frame with
    valid_b / valid_f; and frame 1 with both flags set, which is
    degrain1_frame's output."""
    sspec, aspec_b, aspec_f = _specs(ref)
    dcfg = DegrainConfig(thsad=400)
    for i, nb, pv, ok_b, ok_f in ((0, 1, 0, True, False),
                                  (3, 3, 2, False, True)):
        got = degrain_n_frame(_frame(ref, i), [_frame(ref, pv)],
                              [_frame(ref, nb)], sspec, aspec_b, aspec_f,
                              dcfg, valid_b=[ok_b], valid_f=[ok_f])[0]
        want = _jax_edge(ref, sspec, aspec_b, i, nb, pv, ok_b, ok_f)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"frame {i}")
    got = degrain_n_frame(_frame(ref, 1), [_frame(ref, 0)], [_frame(ref, 2)],
                          sspec, aspec_b, aspec_f, dcfg, valid_b=[True],
                          valid_f=[True])[0]
    np.testing.assert_array_equal(got.numpy(), ref["degrain"][0])
    # the exact engine is ported for dct 0; with dct 1-10 it names itself
    with pytest.raises(NotImplementedError, match="engine"):
        degrain1_frame(_frame(ref, 1), _frame(ref, 0), _frame(ref, 2), sspec,
                       dataclasses.replace(aspec_b, dct=1),
                       dataclasses.replace(aspec_f, dct=1), dcfg,
                       engine="exact")


def test_degrain1_clip_matches_jax(ref):
    """The whole 4-frame clip at radius 1: the inner frames are load()'s
    denoised frames, the edge frames degrain_n_frame's with the missing
    neighbour invalid."""
    from mvtools_tpu_torch import AnalyseConfig, SuperConfig
    fmt = VideoFormat(tpr.W, tpr.H, 8, ColorFamily.GRAY)
    info = {}
    out = degrain1_clip([torch.from_numpy(ref["frames"])], fmt,
                        SuperConfig(pel=2, levels=tpr.LEVELS, chroma=False),
                        AnalyseConfig(blksize=tpr.BLK, levels=tpr.LEVELS,
                                      truemotion=True, chroma=False),
                        DegrainConfig(thsad=400), info=info,
                        engine="lockstep")[0]
    np.testing.assert_array_equal(out[1:3].numpy(), ref["degrain"])
    sspec, aspec_b, _ = _specs(ref)
    for i, nb, pv, ok_b, ok_f in ((0, 1, 0, True, False),
                                  (3, 3, 2, False, True)):
        np.testing.assert_array_equal(
            out[i].numpy(), _jax_edge(ref, sspec, aspec_b, i, nb, pv, ok_b,
                                      ok_f), err_msg=f"frame {i}")
    assert set(info) >= {"fields_b", "fields_f"}
