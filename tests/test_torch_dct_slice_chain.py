"""PyTorch port: the DCT slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_dct): the specs and clip, the chain
Analyse dct 1 -> Recalculate dct 2, and the rescue on DCT costs (the slice's
tests are split over test_torch_dct_slice_*.py, files of at most six tests, so
that pytest-xdist hands them out after the suite's longest file).

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
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

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx, batch_supported
from mvtools_tpu_torch.models.denoise import make_test_clip_yuv
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_dct(tmp_path_factory)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, refined
    field, blocks the rescue took, the fetch calls by plain version)."""
    return tpr.dct_run(ref)


def test_specs_and_clip_are_the_reference_ones(ref):
    """Two levels on the dense map, the DCT clip recipe, and the level-1
    stack narrower than the tiled fetch's window (the dense DCT map there is
    fetched block by block) while level 0's is not."""
    sspec, aspec, rcfg, rspec = tpr.dct_port_configs()
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


def test_validity_matches_jax(ref, run):
    np.testing.assert_array_equal(run[0].validity.numpy(), ref["mv_validity"])
    np.testing.assert_array_equal(run[1].validity.numpy(), ref["rc_validity"])


def test_rescue_ran_on_dct_costs(ref, run):
    """The two flash jobs keep blocks over badsad at both levels, the calm
    job has none; the rescue took blocks; its walk and the DCT costs of the
    predictor trials fetched through the per-block fetch, at both levels."""
    _, aspec, _, _ = tpr.dct_port_configs()
    for lv in range(tpr.DCT_LEVELS):
        worst = ref[f"mv_sad{lv}"].reshape(3, -1)[:, 2:].max(axis=1)
        assert (worst[:2] > aspec.badsad).all() and worst[2] <= aspec.badsad
    assert run[2] > 0
    sspec = tpr.dct_port_configs()[0]
    stacks = {(_level_ctx(sspec, aspec, lv).padded[1] + 2 * fe.FieldProber.PAD
               + probe_ops.ALIGN_SLACK_Y,
               _level_ctx(sspec, aspec, lv).padded[0] + 2 * fe.FieldProber.PAD
               + probe_ops.ALIGN_SLACK_X) for lv in range(tpr.DCT_LEVELS)}
    assert set(run[3]["fetch_blocks_plain"]) == stacks
    # the dense map of level 0 through the tiled fetch, of level 1 not
    assert len(set(run[3]["fetch_blocks_tiled_plain"])) == 1


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_chain_recalculate_matches_jax(ref, run, key):
    np.testing.assert_array_equal(getattr(run[1].levels[0], key).numpy(),
                                  ref[f"rc_{key}"])
