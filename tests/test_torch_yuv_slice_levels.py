"""PyTorch port: the YUV420 slice against one cached run of the JAX package
(torch_port_reference.load_yuv): batched lockstep Analyse with chroma and
overlap 8 at the two finest levels (split out of test_torch_yuv_slice.py:
files that wait for a JAX reference hold at most six tests, so that
pytest-xdist hands them out after the suite's longest file).

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
    return tpr.load_yuv(tmp_path_factory)


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's own supers and its analyse_batch over the jobs of both
    directions, with every per-block probe call noted."""
    return tpr.yuv_port_run(ref)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", [0, 1])
def test_analyse_batch_yuv_matches_jax(ref, port_run, level, key):
    got = getattr(port_run[1].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    assert tuple(got.shape) == ref[f"mv_{key}{level}"].shape
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])
