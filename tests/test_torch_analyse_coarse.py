"""PyTorch port: batched lockstep Analyse against the JAX package's
analyse_batch at the coarsest level of torch_port_reference.load()'s clip,
that the rescue ran, and analyse_batch fed the JAX package's pyramids
(split out of test_torch_analyse.py: files that wait for a JAX reference
hold at most six tests, so that pytest-xdist hands them out after the
suite's longest file).

Every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer)."""
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

from mvtools_tpu_torch import analyse_batch, convert

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


@pytest.fixture(scope="module")
def port_fields(ref):
    """The port's analyse_batch on the port's own supers."""
    return tpr.gray_port_fields(ref)


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", [2])
def test_analyse_batch_matches_jax(ref, port_fields, level, key):
    got = getattr(port_fields[0].levels[level], key)
    want = ref[f"mv_{key}{level}"]
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rescue_branch_was_taken(ref, port_fields):
    """The flashing region leaves finest-level SADs above badsad, so the
    rescue ran (more host reads than one per level) — and on a clip
    without the region it does not."""
    _, aspec = tpr.specs(ref)
    assert int(ref["mv_sad0"].max()) > aspec.badsad
    assert port_fields[1] > tpr.LEVELS


def test_analyse_batch_on_jax_built_supers(ref, port_fields):
    """analyse_batch held alone: fed the JAX package's pyramids through
    convert.py it gives the same field."""
    sspec, aspec = tpr.specs(ref)
    sups = convert.super_from_numpy(
        [[ref[f"super{lv}"] for lv in range(tpr.LEVELS)]], sspec,
        device="cpu")
    src, rf = tpr.job_indices()
    mvb = analyse_batch(sups.map(lambda a: a[src]),
                        sups.map(lambda a: a[rf]), aspec)
    for lv in range(tpr.LEVELS):
        for key in ("x", "y", "sad"):
            np.testing.assert_array_equal(
                getattr(mvb.levels[lv], key).numpy(), ref[f"mv_{key}{lv}"])
