"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: the interpolation
of the old field onto the new grid, and the refined field's x / y / sad with
dct 0 and dct 5 on a clip that leaves blocks on both sides of thsad.

Both packages are fed the SAME old field and the same pyramids (made once
by the JAX package and carried across through convert.py), so that only
Recalculate is compared; the JAX side is one cached run
(torch_port_reference.load_recalc).  Inputs are made with numpy from a
seed; every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer)."""
import dataclasses
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu as mvt
from mvtools_tpu import recalculate as jax_recalc
from mvtools_tpu.core import config as jax_config, types as jax_types

import mvtools_tpu_torch as port
from mvtools_tpu_torch import convert
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import (ColorFamily, MVField, MVPlaneField,
                                          SearchType, VideoFormat)
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.recalculate import _interpolate_old_vectors
from mvtools_tpu_torch.super import Super

import torch_port_reference as tpr

W, H, PEL = tpr.RC_W, tpr.RC_H, tpr.RC_PEL
CONFIGS = tpr.RC_CONFIGS


def _specs(pkg_config, pkg_types):
    """(sspec, old 16x16 overlap-0 AnalyseSpec) in either package."""
    return tpr.recalc_specs(pkg_config, pkg_types)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The JAX package's level-0 pyramids of three frames, the old field of
    the two jobs (frame 1 against frame 2 and frame 0) and the JAX package's
    refined fields."""
    ref = tpr.load_recalc(tmp_path_factory)
    return dict(ref, planes=list(ref["planes"]),
                old=(ref["old_x"], ref["old_y"], ref["old_sad"]))


def _port_inputs(clip, jobs, rcfg_kw):
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=PEL, levels=1, chroma=False).validate(fmt)
    old_spec = AnalyseConfig(blksize=16, levels=1, chroma=False,
                             truemotion=True).validate(sspec)
    rcfg = port.RecalculateConfig(**rcfg_kw)
    rspec = rcfg.to_analyse_config().validate(sspec)
    p = clip["planes"]
    src = convert.super_from_numpy(
        [[np.stack([p[1]] * len(jobs))]], sspec, device="cpu")
    ref = convert.super_from_numpy(
        [[np.stack([p[2 if j == 0 else 0] for j in jobs])]], sspec,
        device="cpu")
    old = convert.mvfield_from_numpy(
        [tuple(a[list(jobs)] for a in clip["old"])],
        convert.spec_to_dict(old_spec.meta), device="cpu")
    return src, ref, old, rspec, rcfg


def _kw(pkg_types, kw):
    return tpr.recalc_kw(pkg_types, kw)


@pytest.fixture(scope="module")
def results(clip):
    """Per configuration: the port's batched [J = 2] result and the JAX
    package's result of each job."""
    out = {}
    for name, kw in CONFIGS.items():
        args = _port_inputs(clip, (0, 1), _kw(port, kw))
        before = dict(probe_ops.launches)
        got = port.recalculate(*args)
        assert dict(probe_ops.launches) == before      # CPU: no launch
        want = [tuple(clip[f"{name}_{k}"][j] for k in ("x", "y", "sad"))
                for j in (0, 1)]
        out[name] = (got, want, args)
    return out


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_recalculate_matches_jax(results, name, key):
    got, want, _ = results[name]
    g = getattr(got.levels[0], key)
    assert g.dtype == (torch.int64 if key == "sad" else torch.int32)
    assert len(got.levels) == 1 and got.validity.tolist() == [1, 1]
    k = ("x", "y", "sad").index(key)
    for j in (0, 1):
        np.testing.assert_array_equal(g[j].numpy(), want[j][k])


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
    kw = _kw(port, CONFIGS[name])
    for j in (0, 1):
        src, ref, old, rspec, rcfg = _port_inputs(clip, (j,), kw)
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


@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("new", [dict(blksize=16, overlap=8),
                                 dict(blksize=8, overlap=0),
                                 dict(blksize=32, blksizev=16, overlap=8,
                                      overlapv=4)],
                         ids=["16ov8", "8ov0", "32x16ov8x4"])
def test_interpolate_old_vectors_matches_jax(new, smooth):
    """Old 16x16 overlap 0 at pel 2 onto three new grids: negative and large
    vectors, SADs up to 2^40 (the bilinear form's SAD runs in 64 bits),
    indices clamped at the old grid's edge."""
    rng = np.random.default_rng(30 + smooth)
    sspec_j, old_j = _specs(jax_config, jax_types)
    new_j = jax_config.AnalyseConfig(levels=1, chroma=False,
                                     **new).validate(sspec_j)
    nby, nbx = old_j.meta.blk_y, old_j.meta.blk_x
    x = rng.integers(-300, 301, (2, nby, nbx)).astype(np.int32)
    y = rng.integers(-300, 301, (2, nby, nbx)).astype(np.int32)
    sad = rng.integers(0, 2 ** 40, (2, nby, nbx)).astype(np.int64)
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=PEL, levels=1, chroma=False).validate(fmt)
    old_meta = AnalyseConfig(blksize=16, levels=1,
                             chroma=False).validate(sspec).meta
    new_meta = AnalyseConfig(levels=1, chroma=False,
                             **new).validate(sspec).meta
    for log_pel in (1, 0):
        got = _interpolate_old_vectors(
            MVPlaneField(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(sad)), old_meta, new_meta, smooth,
            log_pel)
        assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                          torch.int64]
        for j in range(2):
            want = jax_recalc._interpolate_old_vectors(
                jax_types.MVPlaneField(jnp.asarray(x[j]), jnp.asarray(y[j]),
                                       jnp.asarray(sad[j])),
                old_j.meta, new_j.meta, smooth, log_pel)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[j].numpy(), np.asarray(w))


def test_recalculate_config_matches_jax():
    a = port.RecalculateConfig(blksize=16, overlap=8, thsad=200, chroma=False,
                               truemotion=True, dct=5)
    b = jax_recalc.RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                     chroma=False, truemotion=True, dct=5)
    da, db = (dataclasses.asdict(c.to_analyse_config()) for c in (a, b))
    assert {k: int(v) if isinstance(v, SearchType) else v
            for k, v in da.items()} == \
        {k: int(v) if hasattr(v, "value") else v for k, v in db.items()}
    assert dataclasses.asdict(port.RecalculateConfig()) == {
        k: (int(v) if hasattr(v, "value") else v)
        for k, v in dataclasses.asdict(jax_recalc.RecalculateConfig()).items()}


@pytest.mark.parametrize("kw,what", [
    (dict(dct=1, pel=4), "dct=1"),
    (dict(dct=4, pel=4), "dct=4"),
    (dict(divide=1), "divide"),
    (dict(fields=True), "fields"),
    (dict(search=SearchType.UMH), "search=UMH"),
    (dict(search=SearchType.NSTEP), "search=NSTEP"),
    (dict(field_shift=1), "field_shift"),
    (dict(engine="exact"), "exact"),
])
def test_unported_options_raise(kw, what):
    """Nothing falls back silently: every option outside the slice names
    itself in a NotImplementedError before any work is done."""
    kw = dict(kw)
    call = {k: kw.pop(k) for k in ("field_shift", "engine") if k in kw}
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=kw.pop("pel", PEL), levels=1,
                        chroma=False).validate(fmt)
    rcfg = port.RecalculateConfig(blksize=16, overlap=8, chroma=False, **kw)
    rspec = rcfg.to_analyse_config().validate(sspec)
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    z = torch.zeros((1, 2, 2), dtype=torch.int32)
    old = MVField((MVPlaneField(z, z, z.to(torch.int64)),),
                  torch.ones((1,), dtype=torch.int32), rspec.meta)
    with pytest.raises(NotImplementedError, match=what):
        port.recalculate(dummy, dummy, old, rspec, rcfg, **call)
    with pytest.raises(ValueError, match="unknown engine"):
        port.recalculate(dummy, dummy, old, rspec, rcfg, engine="fast")


# ---------------------------------------------------------------------------
# Chroma in the search: YUV420, the chroma cost stays plain SAD


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
