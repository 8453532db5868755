"""PyTorch port: the SATD slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_satd): the specs and clip, and
Recalculate with dct 5 fed the JAX package's own field (the slice's tests are
split over test_torch_satd_slice_*.py, files of at most six tests, so that
pytest-xdist hands them out after the suite's longest file).

The clip's flash makes blocks bad at every level, so the rescue runs on SATD
costs, at level 3 through the per-block probe (the stack there is narrower
than the tiled probe's window). Inputs are made with numpy from a seed and
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

from mvtools_tpu_torch.analyse import batch_supported
from mvtools_tpu_torch.models.denoise import make_test_clip_yuv

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_satd(tmp_path_factory)


@pytest.fixture(scope="module")
def recalc_on_jax_field(ref):
    """Recalculate held alone: fed the JAX package's pyramids and the JAX
    package's analysed field through convert.py."""
    return tpr.satd_recalc_on_jax_field(ref)


def test_specs_and_clip_are_the_reference_ones(ref):
    sspec, aspec, rcfg, rspec = tpr.satd_port_configs()
    assert aspec.meta.lv_count == tpr.SATD_LEVELS and aspec.dct == 5
    assert batch_supported(aspec, sspec)
    assert (rspec.meta.blk_x, rspec.meta.blk_y) == ref["rc_x"].shape[:0:-1]
    mine = make_test_clip_yuv(
        tpr.SATD_FRAMES, tpr.SATD_W, tpr.SATD_H, seed=tpr.SATD_SEED,
        flash=tpr.SATD_FLASH, noise=tpr.YUV_NOISE, pan=tpr.YUV_PAN,
        clean=tpr.SATD_CLEAN, device="cpu")[0]
    np.testing.assert_array_equal(mine.numpy(), ref["frames"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_dct5_on_the_jax_field_matches_jax(ref, recalc_on_jax_field,
                                                        key):
    np.testing.assert_array_equal(
        getattr(recalc_on_jax_field.levels[0], key).numpy(), ref[f"rc_{key}"])


def test_recalculate_left_blocks_on_both_sides_of_thsad(ref):
    sad = ref["rc_sad"][2]                       # the calm job
    thsad = tpr.SATD_THSAD * 16 * 16 // 64
    assert (sad <= thsad).sum() > 50 and (sad > thsad).sum() > 50
