"""PyTorch port: the SATD slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_satd): the chain Analyse -> Recalculate
-> Degrain1 down to the pixels, and the rescue on SATD costs (the slice's
tests are split over test_torch_satd_slice_*.py, files of at most six tests,
so that pytest-xdist hands them out after the suite's longest file).

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

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_satd(tmp_path_factory)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, host
    syncs of Analyse, refined field, denoised frames)."""
    return tpr.satd_run(ref)


def test_rescue_ran_on_satd_costs_down_to_the_block_probe(ref, run):
    """Three jobs are bad at every level (their best SATD exceeds badsad),
    the fourth at none; more host reads than one per level show that the
    rescue walked; and at level 3 the stack is under the tiled probe's
    window, so the walk there went through probe_sads."""
    sspec, aspec, _, _ = tpr.satd_port_configs()
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


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_chain_recalculate_matches_jax(ref, run, key):
    np.testing.assert_array_equal(getattr(run[2].levels[0], key).numpy(),
                                  ref[f"rc_{key}"])


def test_slice_pixels_match_jax(ref, run):
    out = run[3]
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref["degrain"])
    assert (ref["degrain"] != ref["frames"][1:3]).any()
