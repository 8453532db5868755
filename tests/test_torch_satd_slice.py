"""PyTorch port: the SATD slice as a whole against one cached run of the
JAX package (tests/torch_port_reference.py::load_satd): Analyse with dct 5
at every level, Recalculate with dct 5 fed the JAX package's own field, the
chain Analyse -> Recalculate -> Degrain1 down to the pixels.

The clip's flash makes blocks bad at every level, so the rescue runs on SATD
costs, at level 3 through the per-block probe (the stack there is narrower
than the tiled probe's window).  Inputs are made with numpy from a seed and
handed to both sides; every comparison is assert_array_equal (tolerance 0 —
the pipeline is integer)."""
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

import mvtools_tpu_torch as port
from mvtools_tpu_torch import convert
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx, batch_supported
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.core.types import MVField, MVPlaneField
from mvtools_tpu_torch.degrain import DegrainConfig, degrain
from mvtools_tpu_torch.models.denoise import make_test_clip_yuv
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_satd(tmp_path_factory)


def _configs():
    return tpr.satd_configs(port_config, port_types, port)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, host
    syncs of Analyse, refined field, denoised frames)."""
    sspec, aspec, rcfg, rspec = _configs()
    frames = torch.from_numpy(ref["frames"])
    sups = build_super([frames], sspec)
    src, rf = tpr.satd_job_indices()
    sup_s, sup_r = sups.map(lambda a: a[src]), sups.map(lambda a: a[rf])
    before = fe.host_syncs
    mvb = port.analyse_batch(sup_s, sup_r, aspec)
    syncs = fe.host_syncs - before
    refined = port.recalculate(sup_s, sup_r, mvb, rspec, rcfg)
    n_out = tpr.SATD_FRAMES - 2 * tpr.SATD_RADIUS

    def job(t, j):
        return t.reshape((n_out, 2) + t.shape[1:])[:, j]

    lv = refined.levels[0]
    mvs = [MVField((MVPlaneField(job(lv.x, j), job(lv.y, j),
                                 job(lv.sad, j)),),
                   job(refined.validity, j), refined.meta) for j in (0, 1)]
    sups_r = [sup_r.map(lambda a, j=j: job(a, j).contiguous())
              for j in (0, 1)]
    out = degrain([frames[tpr.SATD_RADIUS:tpr.SATD_RADIUS + n_out]], sups_r,
                  mvs, rspec.meta, DegrainConfig(thsad=400))[0]
    return mvb, syncs, refined, out


def test_specs_and_clip_are_the_reference_ones(ref):
    sspec, aspec, rcfg, rspec = _configs()
    assert aspec.meta.lv_count == tpr.SATD_LEVELS and aspec.dct == 5
    assert batch_supported(aspec, sspec)
    assert (rspec.meta.blk_x, rspec.meta.blk_y) == ref["rc_x"].shape[:0:-1]
    mine = make_test_clip_yuv(
        tpr.SATD_FRAMES, tpr.SATD_W, tpr.SATD_H, seed=tpr.SATD_SEED,
        flash=tpr.SATD_FLASH, noise=tpr.YUV_NOISE, pan=tpr.YUV_PAN,
        clean=tpr.SATD_CLEAN, device="cpu")[0]
    np.testing.assert_array_equal(mine.numpy(), ref["frames"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", range(tpr.SATD_LEVELS))
def test_analyse_dct5_matches_jax(ref, run, level, key):
    got = getattr(run[0].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])


def test_rescue_ran_on_satd_costs_down_to_the_block_probe(ref, run):
    """Three jobs are bad at every level (their best SATD exceeds badsad),
    the fourth at none; more host reads than one per level show that the
    rescue walked; and at level 3 the stack is under the tiled probe's
    window, so the walk there went through probe_sads."""
    sspec, aspec, _, _ = _configs()
    for lv in range(tpr.SATD_LEVELS):
        worst = ref[f"mv_sad{lv}"].reshape(4, -1)[:, 2:].max(axis=1)
        assert (worst[[0, 1, 3]] > aspec.badsad).all()
        assert worst[2] <= aspec.badsad
    assert run[1] > tpr.SATD_LEVELS
    widths = []
    for lv in range(tpr.SATD_LEVELS):
        ctx = _level_ctx(sspec, aspec, lv)
        widths.append(ctx.padded[0] + 2 * fe.FieldProber.PAD
                      + probe_ops.ALIGN_SLACK_X)
    wx_total = probe_ops.tile_params(fe._HEXP, 16, 16, 1, 8, 8)[1]
    assert widths[3] < wx_total <= widths[2]


@pytest.fixture(scope="module")
def recalc_on_jax_field(ref):
    """Recalculate held alone: fed the JAX package's pyramids and the JAX
    package's analysed field through convert.py."""
    sspec, aspec, rcfg, rspec = _configs()
    sups = convert.super_from_numpy(
        [[ref[f"super{lv}"] for lv in range(sspec.levels)]], sspec,
        device="cpu")
    old = convert.mvfield_from_numpy(
        [tuple(ref[f"mv_{k}{lv}"] for k in ("x", "y", "sad"))
         for lv in range(tpr.SATD_LEVELS)],
        convert.spec_to_dict(aspec.meta), device="cpu")
    src, rf = tpr.satd_job_indices()
    return port.recalculate(sups.map(lambda a: a[src]),
                            sups.map(lambda a: a[rf]), old, rspec, rcfg)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_dct5_on_the_jax_field_matches_jax(ref, recalc_on_jax_field,
                                                        key):
    np.testing.assert_array_equal(
        getattr(recalc_on_jax_field.levels[0], key).numpy(), ref[f"rc_{key}"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_chain_recalculate_matches_jax(ref, run, key):
    np.testing.assert_array_equal(getattr(run[2].levels[0], key).numpy(),
                                  ref[f"rc_{key}"])


def test_recalculate_left_blocks_on_both_sides_of_thsad(ref):
    sad = ref["rc_sad"][2]                       # the calm job
    thsad = tpr.SATD_THSAD * 16 * 16 // 64
    assert (sad <= thsad).sum() > 50 and (sad > thsad).sum() > 50


def test_slice_pixels_match_jax(ref, run):
    out = run[3]
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref["degrain"])
    assert (ref["degrain"] != ref["frames"][1:3]).any()
