"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: blocks on both sides
of thsad, and the batch against single calls. Both packages are fed the SAME
old field and the same pyramids (made once by the JAX package and carried
across through convert.py), so that only Recalculate is compared; the JAX side
is one cached run (torch_port_reference.load_recalc). Split out of
test_torch_recalculate.py: files that wait for a JAX reference hold at most
six tests, so that pytest-xdist hands them out after the suite's longest file.

Every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer)."""
import os
import sys

import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import mvtools_tpu_torch as port
from mvtools_tpu_torch.core.types import MVField, MVPlaneField
from mvtools_tpu_torch.recalculate import _interpolate_old_vectors

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
    return tpr.recalc_results(clip, ["dct0-16ov8", "dct5-16ov8", "dct5-8ov0-exh"])


@pytest.mark.parametrize("name", ["dct0-16ov8", "dct5-16ov8"])
def test_blocks_on_both_sides_of_thsad(clip, results, name):
    """The clean region with a true old vector stays under thsad and keeps
    its predictor; noisy or mispredicted blocks refine and move."""
    got, _, (src, ref, old, rspec, rcfg) = results[name]
    px, py, _ = _interpolate_old_vectors(
        old.levels[0], old.meta, rspec.meta, rcfg.smooth, 1)
    thsad = rcfg.thsad * 16 * 16 // 64
    sad = got.levels[0].sad
    moved = (got.levels[0].x != px) | (got.levels[0].y != py)
    assert int((sad <= thsad).sum()) > 10 and int((sad > thsad).sum()) > 10
    assert bool(moved.any()) and not bool(moved.all())


@pytest.mark.parametrize("name", ["dct5-16ov8", "dct5-8ov0-exh"])
def test_batched_equals_single_calls(clip, results, name):
    """[J = 2] gives each job what a call on that job alone gives, with or
    without the leading job axis."""
    got, _, _ = results[name]
    kw = tpr.recalc_kw(port, CONFIGS[name])
    for j in (0, 1):
        src, ref, old, rspec, rcfg = tpr.recalc_port_inputs(clip, (j,), kw)
        one = port.recalculate(src, ref, old, rspec, rcfg)
        bare = port.recalculate(
            src.map(lambda a: a[0]), ref.map(lambda a: a[0]),
            MVField(tuple(MVPlaneField(l.x[0], l.y[0], l.sad[0])
                          for l in old.levels), old.validity[0], old.meta),
            rspec, rcfg)
        for key in ("x", "y", "sad"):
            want = getattr(got.levels[0], key)[j]
            assert torch.equal(getattr(one.levels[0], key)[0], want)
            assert getattr(bare.levels[0], key).ndim == 2
            assert torch.equal(getattr(bare.levels[0], key), want)
        assert bare.validity.ndim == 0
