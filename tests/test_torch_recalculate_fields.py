"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: the refined field's x
/ y / sad with dct 0 and dct 5, blk 16 overlap 8. Both packages are fed the
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

import torch_port_reference as tpr

CONFIGS = tpr.RC_CONFIGS


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The JAX package's level-0 pyramids of three frames, the old field of
    the two jobs (frame 1 against frame 2 and frame 0) and the JAX package's
    refined fields."""
    return tpr.recalc_clip(tpr.load_recalc(tmp_path_factory))


@pytest.fixture(scope="module")
def results(clip):
    """Per configuration: the port's batched [J = 2] result and the JAX
    package's result of each job."""
    return tpr.recalc_results(clip, ["dct0-16ov8", "dct5-16ov8"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("name", ["dct0-16ov8", "dct5-16ov8"])
def test_recalculate_matches_jax(results, name, key):
    got, want, _ = results[name]
    g = getattr(got.levels[0], key)
    assert g.dtype == (torch.int64 if key == "sad" else torch.int32)
    assert len(got.levels) == 1 and got.validity.tolist() == [1, 1]
    k = ("x", "y", "sad").index(key)
    for j in (0, 1):
        np.testing.assert_array_equal(g[j].numpy(), want[j][k])
