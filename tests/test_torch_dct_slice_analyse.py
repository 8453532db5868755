"""PyTorch port: the DCT slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_dct): Analyse with the block DCT cost dct
1 at both levels (the slice's tests are split over test_torch_dct_slice_*.py,
files of at most six tests, so that pytest-xdist hands them out after the
suite's longest file).

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

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_dct(tmp_path_factory)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, refined
    field, blocks the rescue took, the fetch calls by plain version)."""
    return tpr.dct_run(ref)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", range(tpr.DCT_LEVELS))
def test_analyse_dct1_matches_jax(ref, run, level, key):
    got = getattr(run[0].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])
