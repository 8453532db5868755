"""PyTorch port: the YUV420 slice against one cached run of the JAX package
(torch_port_reference.load_yuv): the specs of the slice, the three-plane
supers, the rescue's probes on the small planes, and the state's round trip
through convert.py (split out of test_torch_yuv_slice.py: files that wait for
a JAX reference hold at most six tests, so that pytest-xdist hands them out
after the suite's longest file).

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from mvtools_tpu_torch import convert
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx, batch_supported
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.degrain import DegrainConfig
from mvtools_tpu_torch.models.denoise import flagship_configs
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr

FMT = VideoFormat(tpr.YUV_W, tpr.YUV_H, 8, ColorFamily.YUV420)
T, R = tpr.YUV_FRAMES, tpr.YUV_RADIUS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_yuv(tmp_path_factory)


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's own supers and its analyse_batch over the jobs of both
    directions, with every per-block probe call noted."""
    return tpr.yuv_port_run(ref)


def test_specs_of_the_slice_match_jax(ref):
    """levels=0 resolves to the same pyramid on both sides, every level
    rides the dense map, and at this size the level-2 chroma stacks and all
    level-3 stacks are narrower than the tiled probe's window."""
    sspec, aspec = tpr.specs(ref)
    scfg, acfg, dcfg, radius = flagship_configs()
    mine = scfg.validate(FMT)
    assert mine == sspec and sspec.levels == 7
    assert dataclasses.replace(acfg, isb=True).validate(mine) == aspec
    assert aspec.meta.lv_count == tpr.YUV_LEVELS
    assert (aspec.meta.blk_x, aspec.meta.blk_y) == (31, 23)
    assert (dcfg, radius) == (DegrainConfig(thsad=400), 3)
    assert batch_supported(aspec, sspec)
    assert [fe.map_radius(_level_ctx(sspec, aspec, lv))
            for lv in range(4)] == [8, 7, 7, 7]
    assert fe._map_tile(_level_ctx(sspec, aspec, 0)) == 31
    hexagon = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
    narrow = []
    for lv in range(tpr.YUV_LEVELS):
        ctx = _level_ctx(sspec, aspec, lv)
        padc = fe.chroma_pad(ctx)
        wl = ctx.padded[0] + 2 * fe.FieldProber.PAD + probe_ops.ALIGN_SLACK_X
        wc = (ctx.padded[0] >> 1) + 2 * padc + probe_ops.ALIGN_SLACK_X
        need_l = probe_ops.tile_params(hexagon, 16, 16, ctx.pel, 8, 8)[1]
        need_c = probe_ops.tile_params(hexagon, 8, 8, ctx.pel, 8, 4)[1]
        narrow.append((wl < need_l, wc < need_c))
    assert narrow == [(False, False), (False, True), (False, True),
                      (True, True)]


@pytest.mark.parametrize("plane", range(3))
def test_super_planes_match_jax(ref, port_run, plane):
    """Frame-batched three-plane pyramid == per-frame JAX, every level."""
    sups = port_run[0]
    assert sups.num_planes == 3
    for lv in range(sups.spec.levels):
        got = sups.planes[plane][lv]
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref[f"super{plane}_{lv}"])


def test_rescue_ran_on_levels_the_block_probe_serves(ref, port_run):
    """Jobs that pair the bright frame with a dark one stay bad at every
    level, and the rescue's probes of the small planes went through the
    per-block probe: level 3 luma (6 blocks, stack 480 wide) and the chroma
    of levels 3, 2 and 1."""
    sspec, aspec = tpr.specs(ref)
    src, rf = tpr.yuv_job_indices()
    flash = [j for j, (s, r) in enumerate(zip(src, rf)) if (s == 1) != (r == 1)]
    for lv in range(tpr.YUV_LEVELS):
        sad = ref[f"mv_sad{lv}"].reshape(len(src), -1)
        assert (sad[flash].max(axis=1) > aspec.badsad).all()
    seen = set(port_run[2])
    assert ((152, 480), 6) in seen              # level 3 luma
    assert ((108, 432), 6) in seen              # level 3 chroma
    assert ((120, 448), 35) in seen             # level 2 chroma
    assert ((144, 480), 165) in seen            # level 1 chroma
    assert all(w < 512 for (_, w), _ in seen)


def test_yuv_state_roundtrips_through_convert(ref):
    """Three-plane pyramids and fields cross as numpy arrays / dicts."""
    sspec, aspec = tpr.specs(ref)
    planes = [[ref[f"super{p}_{lv}"] for lv in range(sspec.levels)]
              for p in range(3)]
    sup = convert.super_from_numpy(planes, sspec, device="cpu")
    assert sup.num_planes == 3 and sup.batched
    back = convert.super_to_numpy(sup)
    for p in range(3):
        for lv in range(sspec.levels):
            np.testing.assert_array_equal(back[p][lv], planes[p][lv])
    clip = convert.clip_from_numpy([ref[k] for k in "yuv"], device="cpu")
    for a, b in zip(convert.clip_to_numpy(clip), "yuv"):
        np.testing.assert_array_equal(a, ref[b])
    levels, meta, validity = convert.mvfield_to_numpy(tpr.yuv_jax_fields(ref))
    assert meta == json.loads(str(ref["aspec_json"]))["meta"]
    np.testing.assert_array_equal(levels[2][2], ref["mv_sad2"])
    assert validity.shape == (2 * T * R,)
