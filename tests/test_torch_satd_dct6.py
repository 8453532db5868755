"""PyTorch port: Analyse with dct 6 on a pair whose brightness changes, so
that the SATD mix's per-job weight (dctweight16) is not 0, against one
cached run of the JAX package (torch_port_reference.load_dct6; split out of
test_torch_satd.py: files that wait for a JAX reference hold at most six
tests, so that pytest-xdist hands them out after the suite's longest file).

Every comparison is assert_array_equal (tolerance 0 — integers)."""
import os
import sys

import numpy as np

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from mvtools_tpu_torch import analyse_batch
from mvtools_tpu_torch.analyse import (_level_ctx, _level_plan,
                                       search_level_lockstep)
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


def test_analyse_dct6_with_a_brightness_change_matches_jax(tmp_path_factory):
    """Mode 6 mixes SATD into the SAD by dctweight16 = min(16, |mean luma
    change of the coarsest level| / block area), which is 0 on a calm pair.
    Job 0's reference frame is 6 brighter than its source, job 1's is not:
    the weight is per job, and both jobs must come out as the JAX package's
    analyse_batch gives them (torch_port_reference.load_dct6), which by its
    contract is each job's analyse(engine="lockstep") alone."""
    ref = tpr.load_dct6(tmp_path_factory)
    levels = tpr.DCT6_LEVELS
    frames = ref["frames"]
    np.testing.assert_array_equal(frames, tpr.make_dct6_frames())
    sspec, aspec = tpr.dct6_specs(port_config, port_types)
    sups = build_super([torch.from_numpy(frames)], sspec)
    got = analyse_batch(sups.map(lambda a: a[[0, 0]]),
                        sups.map(lambda a: a[[1, 2]]), aspec)
    for lv in range(levels):
        for key in ("x", "y", "sad"):
            np.testing.assert_array_equal(
                getattr(got.levels[lv], key).numpy(), ref[f"mv_{key}{lv}"])
    # the weight the finest level saw: 5 or 6 for job 0, 0 for job 1
    ctx = _level_ctx(sspec, aspec, 1, sups.map(lambda a: a[[0, 0]]),
                     sups.map(lambda a: a[[1, 2]]))
    nblk = ctx.nblk[0] * ctx.nblk[1]
    zero = torch.zeros((2, nblk), dtype=torch.int32)
    _, mlc = search_level_lockstep(
        ctx, _level_plan(aspec, 1), (zero, zero, zero.to(torch.int64)),
        (torch.zeros(2, dtype=torch.int32),) * 2,
        torch.zeros(2, dtype=torch.int32))
    w16 = (mlc.abs() // 256).tolist()
    assert w16[0] in (5, 6) and w16[1] == 0
    # and the mix changed job 0's costs: its SADs are not the dct 0 ones
    plain = analyse_batch(
        sups.map(lambda a: a[[0, 0]]), sups.map(lambda a: a[[1, 2]]),
        tpr.dct6_specs(port_config, port_types, dct=0)[1])
    assert not torch.equal(plain.levels[0].sad[0], got.levels[0].sad[0])
    assert torch.equal(plain.levels[0].sad[1], got.levels[0].sad[1])
