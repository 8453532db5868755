"""PyTorch port: batched lockstep Analyse against the JAX package's
analyse_batch, every level, x / y / sad, bit for bit — on a clip whose
flashing region drives the bad-SAD rescue.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
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

from mvtools_tpu_torch import analyse, analyse_batch, convert
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import (_level_ctx, _level_plan,
                                       batch_supported,
                                       estimate_global_mv_doubled,
                                       search_level_lockstep)
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import (ColorFamily, SearchType,
                                          VideoFormat)
from mvtools_tpu_torch.super import Super, build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


@pytest.fixture(scope="module")
def port_fields(ref):
    """The port's analyse_batch on the port's own supers."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src, rf = tpr.job_indices()
    before = fe.host_syncs
    mvb = analyse_batch(sups.map(lambda a: a[src]),
                        sups.map(lambda a: a[rf]), aspec)
    return mvb, fe.host_syncs - before


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", range(tpr.LEVELS))
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


@pytest.mark.parametrize("job", [0, 2])
def test_analyse_is_the_single_job_case(ref, port_fields, job):
    """analyse(engine="lockstep") == that job of the batch (job 0 takes
    the rescue, job 2 does not)."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src, rf = tpr.job_indices()
    mv = analyse(sups.map(lambda a: a[src[job]]),
                 sups.map(lambda a: a[rf[job]]), aspec)
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


def test_first_minimum_wins_ties():
    cost = torch.tensor([[5, 3, 3, 9], [7, 7, 7, 7], [4, 2, 8, 2]])
    m, k = fe._first_min(cost)
    assert m.tolist() == [3, 7, 2] and k.tolist() == [1, 0, 1]


def test_global_mv_first_mode_wins():
    """Two equally frequent values: the smaller is the mode, as in the
    reference histogram's first argmax."""
    vx = torch.tensor([[4, 4, -2, -2, 9, 30]], dtype=torch.int32)
    vy = torch.tensor([[1, 1, 1, 0, 0, 0]], dtype=torch.int32)
    gx, gy = estimate_global_mv_doubled(vx, vy)
    # modes -2 / 0; inliers |vx+2| < 6 & |vy| < 6 are the two -2 blocks:
    # 2 * (-4) / 2 = -4 and 2 * (1 + 0) / 2 = 1
    assert gx.tolist() == [-4] and gy.tolist() == [1]


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


def _spec(**kw):
    fmt = VideoFormat(kw.pop("w", 256), kw.pop("h", 192), kw.pop("bits", 8),
                      kw.pop("family", ColorFamily.GRAY))
    sspec = SuperConfig(pel=kw.pop("pel", 2), levels=3,
                        chroma=kw.pop("schroma", False)).validate(fmt)
    base = dict(blksize=16, levels=3, chroma=False)
    base.update(kw)
    return sspec, AnalyseConfig(**base).validate(sspec)


@pytest.mark.parametrize("kw,what", [
    (dict(bits=16), "16-bit"),
    (dict(dct=1), "dct"),
    (dict(pel=4), "pel=4"),
    (dict(trymany=True), "trymany"),
    (dict(divide=1), "divide"),
    (dict(search=SearchType.UMH), "search=UMH"),
    (dict(search_coarse=SearchType.NSTEP), "search=NSTEP"),
    (dict(search=SearchType.ONETIME), "search=ONETIME"),
])
def test_unported_options_raise(kw, what):
    """Nothing falls back silently: every option outside the slice names
    itself in a NotImplementedError before any work is done."""
    sspec, aspec = _spec(**kw)
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match=what):
        analyse_batch(dummy, dummy, aspec)


def test_field_shift_and_exact_engine_raise():
    sspec, aspec = _spec()
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match="field_shift"):
        analyse_batch(dummy, dummy, aspec, field_shift=1)
    one = Super(((torch.zeros((4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match="exact"):
        analyse(one, one, aspec, engine="exact")
    # chroma in the search needs a super clip that carries chroma planes
    _, aspec_c = _spec(family=ColorFamily.YUV420, schroma=True, chroma=True)
    with pytest.raises(ValueError, match="chroma"):
        analyse_batch(dummy, dummy, aspec_c)
