"""PyTorch port: the DCT slice as a whole against one cached run of the JAX
package (tests/torch_port_reference.py::load_dct): Analyse with the block
DCT cost dct 1 at both levels, Recalculate with the mixed cost dct 2, fed
the JAX package's own field and in the chain Analyse -> Recalculate.

The clip's flash makes the two jobs that pair frame 1 bad at both levels,
so the rescue runs on DCT costs; the third job stays calm.  Inputs are made
with numpy from a seed and handed to both sides; every comparison is
assert_array_equal (tolerance 0 — the DCT's float64 sums are written out in
the order XLA:CPU takes them, the rest is integer)."""
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
from mvtools_tpu_torch.models.denoise import make_test_clip_yuv
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr

SRC, REF = list(tpr.DCT_SRC), list(tpr.DCT_REF)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_dct(tmp_path_factory)


def _configs():
    return tpr.dct_configs(port_config, port_types, port)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, refined
    field, blocks the rescue took, the fetch calls by plain version)."""
    sspec, aspec, rcfg, rspec = _configs()
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    sup_s, sup_r = sups.map(lambda a: a[SRC]), sups.map(lambda a: a[REF])
    calls = {"fetch_blocks_plain": [], "fetch_blocks_tiled_plain": []}
    plain = {k: getattr(probe_ops, k) for k in calls}

    def spy(name):
        def call(stack, cand_y, *args):
            calls[name].append(tuple(stack.shape[-2:]))
            return plain[name](stack, cand_y, *args)
        return call

    before = fe.rescued_blocks
    for k in calls:
        setattr(probe_ops, k, spy(k))
    try:
        mvb = port.analyse_batch(sup_s, sup_r, aspec)
        rescued = fe.rescued_blocks - before
        refined = port.recalculate(sup_s, sup_r, mvb, rspec, rcfg)
    finally:
        for k, fn in plain.items():
            setattr(probe_ops, k, fn)
    return mvb, refined, rescued, calls


def test_specs_and_clip_are_the_reference_ones(ref):
    """Two levels on the dense map, the DCT clip recipe, and the level-1
    stack narrower than the tiled fetch's window (the dense DCT map there is
    fetched block by block) while level 0's is not."""
    sspec, aspec, rcfg, rspec = _configs()
    assert aspec.meta.lv_count == tpr.DCT_LEVELS and aspec.dct == 1
    assert rspec.dct == 2 and batch_supported(aspec, sspec)
    assert (rspec.meta.blk_x, rspec.meta.blk_y) == ref["rc_x"].shape[:0:-1]
    mine = make_test_clip_yuv(tpr.DCT_FRAMES, tpr.DCT_W, tpr.DCT_H,
                              seed=tpr.DCT_SEED, flash=tpr.DCT_FLASH,
                              noise=tpr.YUV_NOISE, pan=tpr.YUV_PAN,
                              device="cpu")[0]
    np.testing.assert_array_equal(mine.numpy(), ref["frames"])
    wy, wx = probe_ops.tile_params(((0, 0),), 16, 16, 1,
                                   probe_ops.FETCH_TILE, 16)[:2]
    widths = [_level_ctx(sspec, aspec, lv).padded[0] + 2 * fe.FieldProber.PAD
              + probe_ops.ALIGN_SLACK_X for lv in range(tpr.DCT_LEVELS)]
    assert widths[1] < wx <= widths[0]


@pytest.mark.parametrize("level", range(tpr.DCT_LEVELS))
def test_super_matches_jax(ref, level):
    sspec = _configs()[0]
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    np.testing.assert_array_equal(sups.planes[0][level].numpy(),
                                  ref[f"super{level}"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", range(tpr.DCT_LEVELS))
def test_analyse_dct1_matches_jax(ref, run, level, key):
    got = getattr(run[0].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])


def test_validity_matches_jax(ref, run):
    np.testing.assert_array_equal(run[0].validity.numpy(), ref["mv_validity"])
    np.testing.assert_array_equal(run[1].validity.numpy(), ref["rc_validity"])


def test_rescue_ran_on_dct_costs(ref, run):
    """The two flash jobs keep blocks over badsad at both levels, the calm
    job has none; the rescue took blocks; its walk and the DCT costs of the
    predictor trials fetched through the per-block fetch, at both levels."""
    _, aspec, _, _ = _configs()
    for lv in range(tpr.DCT_LEVELS):
        worst = ref[f"mv_sad{lv}"].reshape(3, -1)[:, 2:].max(axis=1)
        assert (worst[:2] > aspec.badsad).all() and worst[2] <= aspec.badsad
    assert run[2] > 0
    sspec = _configs()[0]
    stacks = {(_level_ctx(sspec, aspec, lv).padded[1] + 2 * fe.FieldProber.PAD
               + probe_ops.ALIGN_SLACK_Y,
               _level_ctx(sspec, aspec, lv).padded[0] + 2 * fe.FieldProber.PAD
               + probe_ops.ALIGN_SLACK_X) for lv in range(tpr.DCT_LEVELS)}
    assert set(run[3]["fetch_blocks_plain"]) == stacks
    # the dense map of level 0 through the tiled fetch, of level 1 not
    assert len(set(run[3]["fetch_blocks_tiled_plain"])) == 1


@pytest.fixture(scope="module")
def recalc_on_jax_field(ref):
    """Recalculate held alone: fed the JAX package's pyramids and the JAX
    package's analysed field through convert.py."""
    sspec, aspec, rcfg, rspec = _configs()
    sups = convert.super_from_numpy(
        [[ref[f"super{lv}"] for lv in range(tpr.DCT_LEVELS)]], sspec,
        device="cpu")
    old = convert.mvfield_from_numpy(
        [tuple(ref[f"mv_{k}{lv}"] for k in ("x", "y", "sad"))
         for lv in range(tpr.DCT_LEVELS)],
        convert.spec_to_dict(aspec.meta), device="cpu")
    return port.recalculate(sups.map(lambda a: a[SRC]),
                            sups.map(lambda a: a[REF]), old, rspec, rcfg)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_dct2_on_the_jax_field_matches_jax(ref, recalc_on_jax_field,
                                                        key):
    np.testing.assert_array_equal(
        getattr(recalc_on_jax_field.levels[0], key).numpy(), ref[f"rc_{key}"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_chain_recalculate_matches_jax(ref, run, key):
    np.testing.assert_array_equal(getattr(run[1].levels[0], key).numpy(),
                                  ref[f"rc_{key}"])


def test_recalculate_left_blocks_on_both_sides_of_thsad(ref):
    sad = ref["rc_sad"]
    thsad = tpr.DCT_THSAD * 16 * 16 // 64
    assert (sad <= thsad).sum() > 10 and (sad > thsad).sum() > 10
