"""PyTorch port: batched lockstep Analyse against the JAX package's
analyse_batch at the two finest levels, x / y / sad, bit for bit, on
torch_port_reference.load()'s clip, whose flashing region drives the
bad-SAD rescue (the coarsest level: test_torch_analyse_coarse.py; the
torch-only tests: test_torch_analyse.py).  Files that wait for a JAX
reference hold at most six tests, so that pytest-xdist hands them out
after the suite's longest file.

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
    return tpr.load(tmp_path_factory)


@pytest.fixture(scope="module")
def port_fields(ref):
    """The port's analyse_batch on the port's own supers."""
    return tpr.gray_port_fields(ref)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", [0, 1])
def test_analyse_batch_matches_jax(ref, port_fields, level, key):
    got = getattr(port_fields[0].levels[level], key)
    want = ref[f"mv_{key}{level}"]
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
