"""PyTorch port: analyse() as the single-job case of the batch, the deferred
rescue, and the port's own validation of the specs, against
torch_port_reference.load() (split out of test_torch_analyse.py: files
that wait for a JAX reference hold at most six tests, so that pytest-xdist
hands them out after the suite's longest file).

Every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer)."""
import dataclasses
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

from mvtools_tpu_torch import analyse, convert
from mvtools_tpu_torch.analyse import (_level_ctx, _level_plan,
                                       batch_supported,
                                       search_level_lockstep)
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


@pytest.fixture(scope="module")
def port_fields(ref):
    """The port's analyse_batch on the port's own supers."""
    return tpr.gray_port_fields(ref)


@pytest.mark.parametrize("job", [0, 2])
def test_analyse_is_the_single_job_case(ref, port_fields, job):
    """analyse(engine="lockstep") == that job of the batch (job 0 takes
    the rescue, job 2 does not)."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src, rf = tpr.job_indices()
    mv = analyse(sups.map(lambda a: a[src[job]]),
                 sups.map(lambda a: a[rf[job]]), aspec, engine="lockstep")
    for lv in range(tpr.LEVELS):
        for key in ("x", "y", "sad"):
            got = getattr(mv.levels[lv], key)
            assert got.ndim == 2
            np.testing.assert_array_equal(got.numpy(),
                                          ref[f"mv_{key}{lv}"][job])


def test_deferred_rescue_equals_inline(ref):
    """rescue_mode "defer" then "apply" == "inline" at the finest level,
    where the rescue changes vectors."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src, rf = tpr.job_indices()
    ctx = _level_ctx(sspec, aspec, 0, sups.map(lambda a: a[src]),
                     sups.map(lambda a: a[rf]))
    plan = _level_plan(aspec, 0)
    nj, nblk = len(src), ctx.nblk[0] * ctx.nblk[1]
    rng = np.random.default_rng(5)
    vin = (torch.from_numpy(rng.integers(-4, 5, (nj, nblk)).astype(np.int32)),
           torch.from_numpy(rng.integers(-4, 5, (nj, nblk)).astype(np.int32)),
           torch.from_numpy(rng.integers(0, 9000, (nj, nblk))))
    g = (torch.zeros(nj, dtype=torch.int32), torch.zeros(nj, dtype=torch.int32))
    mlc = torch.zeros(nj, dtype=torch.int32)
    inline, _ = search_level_lockstep(ctx, plan, vin, g, mlc)
    deferred, _, resc = search_level_lockstep(ctx, plan, vin, g, mlc,
                                              rescue_mode="defer")
    applied, _ = search_level_lockstep(ctx, plan, vin, g, mlc,
                                       rescue_mode="apply", resc_state=resc)
    assert not all(torch.equal(a, b) for a, b in zip(deferred, inline))
    for a, b in zip(applied, inline):
        assert torch.equal(a, b)


def test_specs_match_jax_through_convert(ref):
    """The port's own validation (truemotion cascade included) resolves to
    the spec the JAX package resolved."""
    sspec, aspec = tpr.specs(ref)
    fmt = VideoFormat(tpr.W, tpr.H, 8, ColorFamily.GRAY)
    mine = SuperConfig(pel=2, levels=tpr.LEVELS, chroma=False).validate(fmt)
    assert mine == sspec
    mine_a = dataclasses.replace(
        AnalyseConfig(blksize=tpr.BLK, levels=tpr.LEVELS, truemotion=True,
                      chroma=False), isb=True).validate(mine)
    assert mine_a == aspec
    assert batch_supported(aspec, sspec)
    assert convert.analyse_spec_from_dict(convert.spec_to_dict(aspec)) \
        == aspec
