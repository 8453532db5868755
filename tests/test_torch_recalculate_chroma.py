"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: chroma in the search
(YUV420, dct 5; the chroma cost stays plain SAD). Both packages are fed the
SAME old field and the same pyramids (made once by the JAX package and carried
across through convert.py), so that only Recalculate is compared; the JAX side
is one cached run (torch_port_reference.load_recalc). Split out of
test_torch_recalculate.py: files that wait for a JAX reference hold at most
six tests, so that pytest-xdist hands them out after the suite's longest file.

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

import mvtools_tpu_torch as port
from mvtools_tpu_torch import convert
from mvtools_tpu_torch.core import config as port_config, types as port_types

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The JAX package's level-0 pyramids of three frames, the old field of
    the two jobs (frame 1 against frame 2 and frame 0) and the JAX package's
    refined fields."""
    return tpr.recalc_clip(tpr.load_recalc(tmp_path_factory))


@pytest.fixture(scope="module")
def chroma_results(clip):
    """Recalculate with chroma=True and dct 5 on a YUV420 pair, one job, fed
    the JAX package's pyramids: the luma cost is the SATD, U and V add their
    SADs."""
    sspec, old_p = tpr.recalc_specs(port_config, port_types, "YUV420")
    rcfg = port.RecalculateConfig(**tpr.RC_CHROMA)
    rspec = rcfg.to_analyse_config().validate(sspec)
    assert rspec.chroma
    src, ref = (convert.super_from_numpy(
        [[clip[f"chroma_planes{p}"][i][None]] for p in range(3)], sspec,
        device="cpu") for i in (0, 1))
    old = tuple(clip[f"chroma_old_{k}"] for k in ("x", "y", "sad"))
    got = port.recalculate(
        src, ref, convert.mvfield_from_numpy(
            [old], convert.spec_to_dict(old_p.meta), device="cpu"),
        rspec, rcfg).levels[0]
    return got, {k: clip[f"chroma_{k}"] for k in ("x", "y", "sad")}


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_with_chroma_matches_jax(chroma_results, key):
    got, want = chroma_results
    np.testing.assert_array_equal(getattr(got, key)[0].numpy(), want[key])
