"""PyTorch port: the DCT slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_dct): the supers, and Recalculate with
dct 2 fed the JAX package's own field (the slice's tests are split over
test_torch_dct_slice_*.py, files of at most six tests, so that pytest-xdist
hands them out after the suite's longest file).

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

from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_dct(tmp_path_factory)


@pytest.fixture(scope="module")
def recalc_on_jax_field(ref):
    """Recalculate held alone: fed the JAX package's pyramids and the JAX
    package's analysed field through convert.py."""
    return tpr.dct_recalc_on_jax_field(ref)


@pytest.mark.parametrize("level", range(tpr.DCT_LEVELS))
def test_super_matches_jax(ref, level):
    sspec = tpr.dct_port_configs()[0]
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    np.testing.assert_array_equal(sups.planes[0][level].numpy(),
                                  ref[f"super{level}"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_dct2_on_the_jax_field_matches_jax(ref, recalc_on_jax_field,
                                                        key):
    np.testing.assert_array_equal(
        getattr(recalc_on_jax_field.levels[0], key).numpy(), ref[f"rc_{key}"])


def test_recalculate_left_blocks_on_both_sides_of_thsad(ref):
    sad = ref["rc_sad"]
    thsad = tpr.DCT_THSAD * 16 * 16 // 64
    assert (sad <= thsad).sum() > 10 and (sad > thsad).sum() > 10
