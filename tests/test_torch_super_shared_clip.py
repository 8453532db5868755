"""PyTorch port: the super pyramid against the JAX package's on the clip
of torch_port_reference.load(), and its round trip through convert.py
(split out of test_torch_super.py: files that wait for a JAX reference hold
at most six tests, so that pytest-xdist hands them out after the suite's
longest file).

Every comparison is assert_array_equal (tolerance 0)."""
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

from mvtools_tpu_torch import convert
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


@pytest.mark.parametrize("level", range(tpr.LEVELS))
def test_super_matches_jax_on_shared_clip(ref, level):
    """Frame-batched pyramid + pel-2 Wiener subplanes == per-frame JAX."""
    sspec, _ = tpr.specs(ref)
    sup = build_super([torch.from_numpy(ref["frames"])], sspec)
    np.testing.assert_array_equal(sup.planes[0][level].numpy(),
                                  ref[f"super{level}"])


def test_super_roundtrips_through_convert(ref):
    sspec, _ = tpr.specs(ref)
    planes = [[ref[f"super{lv}"] for lv in range(tpr.LEVELS)]]
    sup = convert.super_from_numpy(planes, sspec, device="cpu")
    back = convert.super_to_numpy(sup)
    for lv in range(tpr.LEVELS):
        np.testing.assert_array_equal(back[0][lv], planes[0][lv])
    assert convert.super_spec_from_dict(convert.spec_to_dict(sspec)) == sspec
