"""PyTorch port: the SATD slice against one cached run of the JAX package
(tests/torch_port_reference.py::load_satd): Analyse with dct 5 at the two
finest levels (the slice's tests are split over test_torch_satd_slice_*.py,
files of at most six tests, so that pytest-xdist hands them out after the
suite's longest file).

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

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_satd(tmp_path_factory)


@pytest.fixture(scope="module")
def run(ref):
    """The port's chain on the port's own supers: (analysed field, host
    syncs of Analyse, refined field, denoised frames)."""
    return tpr.satd_run(ref)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", [0, 1])
def test_analyse_dct5_matches_jax(ref, run, level, key):
    got = getattr(run[0].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])
