"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: the interpolation
of the old field onto the new grid, and the refined field's x / y / sad with
dct 0 and dct 5 on a clip that leaves blocks on both sides of thsad.

Both packages are fed the SAME old field and the same pyramids (made once
by the JAX package and carried across through convert.py), so that only
Recalculate is compared.  Inputs are made with numpy from a seed; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
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

W, H, PEL = 160, 128, 2
PAN = (1, 2)                       # pixels down / right per frame
CLEAN = (32, 48, 64, 80)           # y, x, h, w free of fresh noise


def _specs(pkg_config, pkg_types, **rkw):
    """(sspec, old 16x16 overlap-0 AnalyseSpec) in either package."""
    fmt = pkg_types.VideoFormat(W, H, 8, pkg_types.ColorFamily.GRAY)
    sspec = pkg_config.SuperConfig(pel=PEL, levels=1,
                                   chroma=False).validate(fmt)
    old = pkg_config.AnalyseConfig(blksize=16, levels=1, chroma=False,
                                   truemotion=True).validate(sspec)
    return sspec, old


def _old_field(old_meta, rng, nj):
    """[J, nby, nbx] old vectors: the clip's true pan, off by up to two pel
    in a third of the blocks and far off in a few, with SADs to match."""
    nby, nbx = old_meta.blk_y, old_meta.blk_x
    x = np.full((nj, nby, nbx), -PAN[1] * PEL, np.int32)
    y = np.full((nj, nby, nbx), -PAN[0] * PEL, np.int32)
    off = rng.random((nj, nby, nbx)) < 0.33
    x += np.where(off, rng.integers(-2, 3, x.shape), 0).astype(np.int32)
    y += np.where(off, rng.integers(-2, 3, y.shape), 0).astype(np.int32)
    far = rng.random((nj, nby, nbx)) < 0.05
    x += np.where(far, rng.integers(-60, 61, x.shape), 0).astype(np.int32)
    y += np.where(far, rng.integers(-60, 61, y.shape), 0).astype(np.int32)
    sad = rng.integers(0, 9000, (nj, nby, nbx)).astype(np.int64)
    return x, y, sad


@pytest.fixture(scope="module")
def clip():
    """Three frames -> two jobs (frame 1 against frame 2 and frame 0), the
    JAX package's pyramids as numpy, and the old field."""
    frames = tpr.make_yuv_frames(3, W, H, seed=21, flash=None, noise=6,
                                 pan=PAN, clean=CLEAN)[0]
    sspec_j, old_j = _specs(jax_config, jax_types)
    sups = [mvt.build_super([jnp.asarray(f)], sspec_j) for f in frames]
    planes = [np.asarray(s.planes[0][0]) for s in sups]
    rng = np.random.default_rng(22)
    # job 0: frame 1 -> frame 2 (content moves by -PAN), job 1: 1 -> 0
    x, y, sad = _old_field(old_j.meta, rng, 2)
    x[1], y[1] = -x[1], -y[1]
    return dict(frames=frames, sups=sups, planes=planes, old=(x, y, sad))


def _jax_recalculate(clip, job, rcfg_kw):
    sspec, old_spec = _specs(jax_config, jax_types)
    rcfg = jax_recalc.RecalculateConfig(**rcfg_kw)
    rspec = rcfg.to_analyse_config().validate(sspec)
    x, y, sad = (a[job] for a in clip["old"])
    old = jax_types.MVField(
        (jax_types.MVPlaneField(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(sad)),),
        jnp.ones((), jnp.int32), old_spec.meta)
    ref = clip["sups"][2 if job == 0 else 0]
    out = jax_recalc.recalculate(clip["sups"][1], ref, old, rspec, rcfg,
                                 engine="lockstep")
    lv = out.levels[0]
    return np.asarray(lv.x), np.asarray(lv.y), np.asarray(lv.sad)


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


CONFIGS = {
    "dct0-16ov8": dict(blksize=16, overlap=8, thsad=200, chroma=False, dct=0),
    "dct5-16ov8": dict(blksize=16, overlap=8, thsad=200, chroma=False, dct=5),
    "dct5-8ov0-exh": dict(blksize=8, overlap=0, thsad=200, chroma=False,
                          dct=5, search=3, searchparam=2, smooth=0),
    "dct7-16ov8": dict(blksize=16, overlap=8, thsad=100, chroma=False, dct=7),
}


def _kw(pkg_types, kw):
    kw = dict(kw)
    if "search" in kw:
        kw["search"] = pkg_types.SearchType(kw["search"])
    return kw


@pytest.fixture(scope="module")
def results(clip):
    """Per configuration: the port's batched [J = 2] result and the JAX
    package's two single-job results."""
    out = {}
    for name, kw in CONFIGS.items():
        args = _port_inputs(clip, (0, 1), _kw(port, kw))
        before = dict(probe_ops.launches)
        got = port.recalculate(*args)
        assert dict(probe_ops.launches) == before      # CPU: no launch
        want = [_jax_recalculate(clip, j, _kw(jax_types, kw))
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
    (dict(dct=1), "dct=1"),
    (dict(dct=4), "dct=4"),
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
    sspec = SuperConfig(pel=PEL, levels=1, chroma=False).validate(fmt)
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
def chroma_results():
    """Recalculate with chroma=True and dct 5 on a YUV420 pair, one job, in
    both packages: the luma cost is the SATD, U and V add their SADs."""
    planes = tpr.make_yuv_frames(2, W, H, seed=23, flash=None, noise=6,
                                 pan=PAN, clean=CLEAN)
    kw = dict(blksize=16, overlap=8, thsad=200, chroma=True, dct=5)

    def specs(config, types, recalc):
        fmt = types.VideoFormat(W, H, 8, types.ColorFamily.YUV420)
        sspec = config.SuperConfig(pel=PEL, levels=1,
                                   chroma=True).validate(fmt)
        old = config.AnalyseConfig(blksize=16, levels=1, chroma=True,
                                   truemotion=True).validate(sspec)
        rcfg = recalc.RecalculateConfig(**kw)
        return sspec, old, rcfg, rcfg.to_analyse_config().validate(sspec)

    sspec_j, old_j, rcfg_j, rspec_j = specs(jax_config, jax_types, jax_recalc)
    sups = [mvt.build_super([jnp.asarray(p[i]) for p in planes], sspec_j)
            for i in range(2)]
    x, y, sad = _old_field(old_j.meta, np.random.default_rng(24), 1)
    old = jax_types.MVField(
        (jax_types.MVPlaneField(jnp.asarray(x[0]), jnp.asarray(y[0]),
                                jnp.asarray(sad[0])),),
        jnp.ones((), jnp.int32), old_j.meta)
    want = jax_recalc.recalculate(sups[0], sups[1], old, rspec_j, rcfg_j,
                                  engine="lockstep").levels[0]

    sspec, old_p, rcfg, rspec = specs(port_config, port_types, port)
    assert rspec.chroma
    src, ref = (convert.super_from_numpy(
        [[np.array(s.planes[p][0])[None]] for p in range(3)], sspec,
        device="cpu") for s in sups)
    got = port.recalculate(
        src, ref, convert.mvfield_from_numpy(
            [(x, y, sad)], convert.spec_to_dict(old_p.meta), device="cpu"),
        rspec, rcfg).levels[0]
    return got, want


@pytest.mark.parametrize("key", ["x", "y", "sad"])
def test_recalculate_with_chroma_matches_jax(chroma_results, key):
    got, want = chroma_results
    np.testing.assert_array_equal(getattr(got, key)[0].numpy(),
                                  np.asarray(getattr(want, key)))
