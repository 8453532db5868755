"""PyTorch port: the YUV420 slice at 16 bits — uint16 supers, batched
lockstep Analyse (dct 0) with chroma and overlap 8 over the full pyramid,
and the whole-clip denoise degrain_clip (radius 1) — against the JAX
package, bit for bit.

The JAX side is ONE cached run (torch_port_reference.load_deep): load_yuv's
clip with every sample v as (v << 8) | r (r a fresh seeded byte, so the low
byte carries data), supers per frame, one analyse_batch call holding the
jobs of both directions, degrain per frame with the clip-edge validity.
The clip flashes over most of the frame, so blocks are bad at every level
and the rescue runs, through the per-block probe on the planes narrower
than the tiled probe's window.

This file holds few tests on purpose: pytest-xdist hands files out by their
number of tests, most first, so that it starts after the JAX package's own
longest file, which its JAX run then overlaps instead of delaying.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mvtools_tpu_torch import analyse_batch, convert
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx, batch_supported
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.degrain import DegrainConfig
from mvtools_tpu_torch.models.denoise import degrain_clip, flagship_configs
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr

BITS = tpr.DEEP_BITS
FMT = VideoFormat(tpr.YUV_W, tpr.YUV_H, BITS, ColorFamily.YUV420)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_deep(tmp_path_factory)


def _clip(ref):
    return [torch.from_numpy(ref[k]) for k in "yuv"]


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's own supers and its analyse_batch over the jobs of both
    directions, with every probe call noted (plane shape, blocks) and the
    rescued blocks counted."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super(_clip(ref), sspec)
    src, rf = tpr.yuv_job_indices(tpr.YUV_FRAMES, tpr.DEEP_RADIUS)
    calls = {"block": [], "tiled": []}
    plain_block = probe_ops.probe_sads_plain
    plain_tiled = probe_ops.probe_sads_tiled_plain

    def spy_block(stack, cand_y, *args):
        calls["block"].append((tuple(stack.shape[-2:]), stack.dtype))
        return plain_block(stack, cand_y, *args)

    def spy_tiled(stack, cand_y, *args):
        calls["tiled"].append((tuple(stack.shape[-2:]), stack.dtype))
        return plain_tiled(stack, cand_y, *args)

    probe_ops.probe_sads_plain = spy_block
    probe_ops.probe_sads_tiled_plain = spy_tiled
    rescued = fe.rescued_blocks
    try:
        mvb = analyse_batch(sups.take(torch.tensor(src)),
                            sups.take(torch.tensor(rf)), aspec)
    finally:
        probe_ops.probe_sads_plain = plain_block
        probe_ops.probe_sads_tiled_plain = plain_tiled
    return sups, mvb, calls, fe.rescued_blocks - rescued


def test_deep_specs_and_supers_match_jax(ref, port_run):
    """levels=0 resolves to the same 16-bit pyramid on both sides, every
    level rides the dense map (16x16 blocks: a block's SAD stays under
    2^24), and the frame-batched uint16 pyramid equals the JAX package's,
    every plane and level."""
    sspec, aspec = tpr.specs(ref)
    scfg, acfg, _, _ = flagship_configs()
    mine = scfg.validate(FMT)
    assert mine == sspec and sspec.bits == BITS and sspec.levels == 7
    assert dataclasses.replace(acfg, isb=True).validate(mine) == aspec
    assert aspec.meta.lv_count == tpr.YUV_LEVELS
    assert batch_supported(aspec, sspec)
    assert all(fe.map_supported(_level_ctx(sspec, aspec, lv),
                                fe.map_radius(_level_ctx(sspec, aspec, lv)))
               for lv in range(tpr.YUV_LEVELS))
    sups = port_run[0]
    assert sups.num_planes == 3
    for plane in range(3):
        for lv in range(sups.spec.levels):
            got = sups.planes[plane][lv]
            assert got.dtype == torch.uint16, (plane, lv)
            np.testing.assert_array_equal(got.numpy(),
                                          ref[f"super{plane}_{lv}"],
                                          err_msg=f"plane {plane} level {lv}")


def test_deep_fields_match_jax(ref, port_run):
    """Every level's vectors and SADs of the 16-bit analyse_batch equal the
    JAX package's (the SADs reach 16-bit sizes: a flash block's cost lies
    far over 2^16)."""
    mvb = port_run[1]
    for lv in range(tpr.YUV_LEVELS):
        for key in ("x", "y", "sad"):
            np.testing.assert_array_equal(
                getattr(mvb.levels[lv], key).numpy(), ref[f"mv_{key}{lv}"],
                err_msg=f"level {lv} {key}")
    assert int(ref["mv_sad0"].max()) > 1 << 20


def test_deep_rescue_ran_through_both_probes(ref, port_run):
    """The flash made blocks bad, the rescue took them, and its probes ran
    on uint16 stacks through the tiled probe on the wide planes and the
    per-block probe on the planes narrower than the tiled window (the
    level-1 and level-2 chroma planes and all of level 3 at this size)."""
    _, _, calls, rescued = port_run
    assert rescued > 0
    assert calls["tiled"] and calls["block"]
    assert {dt for _, dt in calls["tiled"] + calls["block"]} == {
        torch.uint16}
    narrow = {shape for shape, _ in calls["block"]}
    wide = {shape for shape, _ in calls["tiled"]}
    assert narrow.isdisjoint(wide)
    assert min(w for _, w in narrow) < min(w for _, w in wide)


@pytest.fixture(scope="module")
def clip_run(ref):
    """degrain_clip, the port's entry point, over the 16-bit clip at radius
    1 with the reference's Degrain settings."""
    scfg, acfg, _, _ = flagship_configs()
    info = {}
    out = degrain_clip(_clip(ref), FMT, scfg, acfg,
                       DegrainConfig(**tpr.DEEP_DEGRAIN), tpr.DEEP_RADIUS,
                       info=info, engine="lockstep")
    return out, info


def test_deep_degrain_clip_matches_jax(ref, clip_run):
    """degrain_clip's uint16 output == the JAX package's per-frame degrain
    in every plane, and the blocks outside the flash were averaged (every
    plane changed)."""
    for plane in range(3):
        got = clip_run[0][plane]
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(got.numpy(), ref[f"degrain{plane}"],
                                      err_msg=f"plane {plane}")
        assert not np.array_equal(ref[f"degrain{plane}"], ref["yuv"[plane]])


def test_deep_state_roundtrips_through_convert(ref, clip_run):
    """uint16 planes, supers and fields cross between the packages through
    convert as they are."""
    planes = convert.clip_from_numpy([ref[k] for k in "yuv"], device="cpu")
    assert [p.dtype for p in planes] == [torch.uint16] * 3
    back = convert.clip_to_numpy(planes)
    for a, k in zip(back, "yuv"):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, ref[k])
    sspec, _ = tpr.specs(ref)
    sup = convert.super_from_numpy(
        [[ref[f"super{p}_{lv}"][0] for lv in range(sspec.levels)]
         for p in range(3)], sspec, device="cpu")
    for p in range(3):
        for lv in range(sspec.levels):
            np.testing.assert_array_equal(convert.super_to_numpy(sup)[p][lv],
                                          ref[f"super{p}_{lv}"][0])
    meta = json.loads(str(ref["aspec_json"]))["meta"]
    mv = convert.mvfield_from_numpy(
        [(ref[f"mv_x{lv}"], ref[f"mv_y{lv}"], ref[f"mv_sad{lv}"])
         for lv in range(tpr.YUV_LEVELS)], meta, device="cpu")
    assert mv.meta.bits_per_sample == BITS
    levels, meta2, _ = convert.mvfield_to_numpy(mv)
    assert meta2 == meta
    np.testing.assert_array_equal(levels[0][2], ref["mv_sad0"])
    assert clip_run[1]["fields_b"].meta.bits_per_sample == BITS
