"""PyTorch port: interlaced input in Analyse against the JAX package on
CPU, bit for bit (inputs and JAX side: tests/torch_port_reference.py,
load_exact): the exact engine with field shifts of +pel/2 and -pel/2 (one
per job), and core/fields.py against the JAX package's helpers.
analyse_batch (the lockstep engine) with a shift per job is held to the
JAX package through degrain_clip(fields=True) (test_torch_fields_models.py,
whose analyse_batch calls mix shifted and unshifted jobs); here each job of
such a batch is held to the job searched alone with its shift."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_reference as tpr  # noqa: E402
from mvtools_tpu_torch import analyse_batch  # noqa: E402
from mvtools_tpu_torch.core import config, types  # noqa: E402
from mvtools_tpu_torch.core import fields  # noqa: E402
from mvtools_tpu_torch.super import build_super  # noqa: E402
from test_torch_exact_analyse import assert_field, port_analysis  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


def test_exact_analyse_field_shift_matches_jax(ref):
    """The shift is the zero trial's y, a missing neighbour's y and part of
    the global predictor at the finest level; it changes the result."""
    got = port_analysis("gray_b", list(tpr.EX_FS_JOBS))
    assert_field(ref, "gray_b_fs_", got)
    assert not np.array_equal(ref["gray_b_fs_y0"], ref["gray_b_y0"])


def test_analyse_batch_field_shift_per_job():
    """A [J] shift (a tensor or a list) gives each job what the job
    searched alone with its shift gives; a shift changes the result."""
    fmt, scfg, acfg = tpr.exact_model_specs(config, types, "GRAY",
                                            tpr.EX_FIELDS_ACFG)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    sups = build_super([torch.from_numpy(tpr.make_exact_gray(frames=4))],
                       sspec)
    jobs = ((1, 0, 1), (1, 2, -1), (2, 1, 0))      # (src, ref, shift)
    src = sups.take(torch.tensor([a for a, _, _ in jobs]))
    rs = sups.take(torch.tensor([b for _, b, _ in jobs]))
    shifts = torch.tensor([f for _, _, f in jobs], dtype=torch.int32)
    for fs in (shifts, [int(f) for f in shifts]):
        mv = analyse_batch(src, rs, aspec, field_shift=fs)
        for j, (_, _, f) in enumerate(jobs):
            one = analyse_batch(src.take(torch.tensor([j])),
                                rs.take(torch.tensor([j])), aspec,
                                field_shift=f)
            for key in ("x", "y", "sad"):
                assert torch.equal(getattr(mv.levels[0], key)[j],
                                   getattr(one.levels[0], key)[0]), (j, key)
    zero = analyse_batch(src, rs, aspec)
    assert not torch.equal(zero.levels[0].y[0], mv.levels[0].y[0])


def test_field_helpers_match_jax():
    from mvtools_tpu.core import fields as jfields
    for n in range(4):
        for nref in range(-1, 6):
            for pel in (1, 2, 4):
                for on in (False, True):
                    for tff in (False, True, None):
                        kw = dict(src_top_field=n % 2 == 0,
                                  ref_top_field=nref % 2 == 1)
                        assert fields.field_shift(n, nref, pel, on, tff,
                                                  **kw) == \
                            jfields.field_shift(n, nref, pel, on, tff, **kw)
                assert fields.frame_top_field(n, True) == \
                    jfields.frame_top_field(n, True)
    g = torch.arange(6)
    for k in (-3, -2, -1, 1, 2, 3):
        for pel in (1, 2, 4):
            for tff in (False, True):
                got = fields.field_shift_frames(g, k, pel, True, tff)
                want = [jfields.field_shift(int(n), int(n) + k, pel, True,
                                            tff) for n in g]
                assert got.dtype == torch.int32 and got.tolist() == want
    with pytest.raises(ValueError, match="tff"):
        fields.field_shift(0, 1, 2, True, None)
