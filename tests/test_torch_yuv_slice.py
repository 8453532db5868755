"""PyTorch port: the YUV420 slice — three-plane supers, batched lockstep
Analyse with chroma and overlap 8 over the full pyramid, overlapped
three-plane Degrain and the whole-clip denoise degrain_clip (radius 2,
clip-edge frames included) — against the JAX package, bit for bit.

The JAX side is ONE cached run (torch_port_reference.load_yuv): supers per
frame, one analyse_batch call holding the jobs of both directions, degrain
per frame with the clip-edge validity — the composition that the JAX
package's staged degrain_clip is.  The clip flashes over most of the frame,
so blocks are bad at every level and the rescue's probes on the small
coarse planes go through the per-block probe.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mvtools_tpu_torch import analyse_batch, convert
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx, batch_supported
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import (ColorFamily, MVField, MVPlaneField,
                                          VideoFormat)
from mvtools_tpu_torch.degrain import DegrainConfig, degrain
from mvtools_tpu_torch.models.denoise import (degrain_clip, edge_validity,
                                              flagship_configs,
                                              make_test_clip_yuv,
                                              neighbour_index)
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr

FMT = VideoFormat(tpr.YUV_W, tpr.YUV_H, 8, ColorFamily.YUV420)
T, R = tpr.YUV_FRAMES, tpr.YUV_RADIUS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_yuv(tmp_path_factory)


def _clip(ref):
    return [torch.from_numpy(ref[k]) for k in "yuv"]


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's own supers and its analyse_batch over the jobs of both
    directions, with every per-block probe call noted."""
    sspec, aspec = tpr.specs(ref)
    sups = build_super(_clip(ref), sspec)
    src, rf = tpr.yuv_job_indices()
    calls = []
    plain = probe_ops.probe_sads_plain

    def spy(stack, cand_y, *args):
        calls.append((tuple(stack.shape[-2:]), cand_y.shape[1]))
        return plain(stack, cand_y, *args)

    probe_ops.probe_sads_plain = spy
    try:
        mvb = analyse_batch(sups.map(lambda a: a[src]),
                            sups.map(lambda a: a[rf]), aspec)
    finally:
        probe_ops.probe_sads_plain = plain
    return sups, mvb, calls


def _jax_fields(ref, device="cpu"):
    meta = json.loads(str(ref["aspec_json"]))["meta"]
    return convert.mvfield_from_numpy(
        [(ref[f"mv_x{lv}"], ref[f"mv_y{lv}"], ref[f"mv_sad{lv}"])
         for lv in range(tpr.YUV_LEVELS)], meta, device)


def _jobs(mvb, sl):
    return MVField(tuple(MVPlaneField(l.x[sl], l.y[sl], l.sad[sl])
                         for l in mvb.levels), mvb.validity[sl], mvb.meta)


def test_specs_of_the_slice_match_jax(ref):
    """levels=0 resolves to the same pyramid on both sides, every level
    rides the dense map, and at this size the level-2 chroma stacks and all
    level-3 stacks are narrower than the tiled probe's window."""
    sspec, aspec = tpr.specs(ref)
    scfg, acfg, dcfg, radius = flagship_configs()
    mine = scfg.validate(FMT)
    assert mine == sspec and sspec.levels == 7
    assert dataclasses.replace(acfg, isb=True).validate(mine) == aspec
    assert aspec.meta.lv_count == tpr.YUV_LEVELS
    assert (aspec.meta.blk_x, aspec.meta.blk_y) == (31, 23)
    assert (dcfg, radius) == (DegrainConfig(thsad=400), 3)
    assert batch_supported(aspec, sspec)
    assert [fe.map_radius(_level_ctx(sspec, aspec, lv))
            for lv in range(4)] == [8, 7, 7, 7]
    assert fe._map_tile(_level_ctx(sspec, aspec, 0)) == 31
    hexagon = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
    narrow = []
    for lv in range(tpr.YUV_LEVELS):
        ctx = _level_ctx(sspec, aspec, lv)
        padc = fe.chroma_pad(ctx)
        wl = ctx.padded[0] + 2 * fe.FieldProber.PAD + probe_ops.ALIGN_SLACK_X
        wc = (ctx.padded[0] >> 1) + 2 * padc + probe_ops.ALIGN_SLACK_X
        need_l = probe_ops.tile_params(hexagon, 16, 16, ctx.pel, 8, 8)[1]
        need_c = probe_ops.tile_params(hexagon, 8, 8, ctx.pel, 8, 4)[1]
        narrow.append((wl < need_l, wc < need_c))
    assert narrow == [(False, False), (False, True), (False, True),
                      (True, True)]


@pytest.mark.parametrize("plane", range(3))
def test_super_planes_match_jax(ref, port_run, plane):
    """Frame-batched three-plane pyramid == per-frame JAX, every level."""
    sups = port_run[0]
    assert sups.num_planes == 3
    for lv in range(sups.spec.levels):
        got = sups.planes[plane][lv]
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref[f"super{plane}_{lv}"])


@pytest.mark.parametrize("key", ["x", "y", "sad"])
@pytest.mark.parametrize("level", range(tpr.YUV_LEVELS))
def test_analyse_batch_yuv_matches_jax(ref, port_run, level, key):
    got = getattr(port_run[1].levels[level], key)
    assert got.dtype == (torch.int64 if key == "sad" else torch.int32)
    assert tuple(got.shape) == ref[f"mv_{key}{level}"].shape
    np.testing.assert_array_equal(got.numpy(), ref[f"mv_{key}{level}"])


def test_rescue_ran_on_levels_the_block_probe_serves(ref, port_run):
    """Jobs that pair the bright frame with a dark one stay bad at every
    level, and the rescue's probes of the small planes went through the
    per-block probe: level 3 luma (6 blocks, stack 480 wide) and the chroma
    of levels 3, 2 and 1."""
    sspec, aspec = tpr.specs(ref)
    src, rf = tpr.yuv_job_indices()
    flash = [j for j, (s, r) in enumerate(zip(src, rf)) if (s == 1) != (r == 1)]
    for lv in range(tpr.YUV_LEVELS):
        sad = ref[f"mv_sad{lv}"].reshape(len(src), -1)
        assert (sad[flash].max(axis=1) > aspec.badsad).all()
    seen = set(port_run[2])
    assert ((152, 480), 6) in seen              # level 3 luma
    assert ((108, 432), 6) in seen              # level 3 chroma
    assert ((120, 448), 35) in seen             # level 2 chroma
    assert ((144, 480), 165) in seen            # level 1 chroma
    assert all(w < 512 for (_, w), _ in seen)


def test_field_prober_agrees_with_the_maps(ref, port_run):
    """The probe-based prober and the map-based one return the same luma +
    chroma SADs for candidates inside the map (level 1, both directions of
    the chroma rounding)."""
    sspec, aspec = tpr.specs(ref)
    sups = port_run[0]
    src, rf = tpr.yuv_job_indices()
    ctx = _level_ctx(sspec, aspec, 1, sups.map(lambda a: a[src[:2]]),
                     sups.map(lambda a: a[rf[:2]]))
    nbx, nby = ctx.nblk
    from mvtools_tpu_torch.analyse import _blocks_of
    idx = torch.arange(nbx * nby, dtype=torch.int32)
    x0 = ctx.hpad[0] + 8 * (idx % nbx)
    y0 = ctx.vpad[0] + 8 * (idx // nbx)
    xc = ctx.hpad[1] + 4 * (idx % nbx)
    yc = ctx.vpad[1] + 4 * (idx // nbx)
    blocks = [_blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0], nby,
                         nbx, 16, 16, 8, 8)]
    blocks += [_blocks_of(ctx.src_planes[p], ctx.vpad[1], ctx.hpad[1], nby,
                          nbx, 8, 8, 4, 4) for p in (1, 2)]
    big = torch.full((nbx * nby,), 1 << 20, dtype=torch.int32)
    bounds = (-big, big, -big, big)
    zero = torch.zeros((2, nbx * nby), dtype=torch.int32)
    args = (ctx, blocks, x0, y0, xc, yc, bounds, 50)
    fp = fe.FieldProber(*args)
    mp = fe.MapProber(*args, pred_vx=zero, pred_vy=zero)
    rng = np.random.default_rng(2)
    vxs = [torch.from_numpy(rng.integers(-5, 6, (2, nbx * nby)).astype(
        np.int32)) for _ in range(3)]
    vys = [torch.from_numpy(rng.integers(-5, 6, (2, nbx * nby)).astype(
        np.int32)) for _ in range(3)]
    a = fp.plain_sads_multi(vxs, vys)
    b = mp.plain_sads_multi(vxs, vys)
    valid = a < probe_ops.INVALID_SAD
    assert valid.float().mean() > 0.9
    assert torch.equal(torch.where(valid, a, 0), torch.where(valid, b, 0))
    ring = tuple(fe._ring_offsets(1, 1))
    ca = fp.chroma_sads(vxs[0], vys[0], ring)
    cb = mp.chroma_sads(vxs[0], vys[0], ring)
    ok = ca < probe_ops.INVALID_SAD
    assert torch.equal(torch.where(ok, ca, 0), torch.where(ok, cb, 0))
    one = fp.chroma_sads(vxs[0], vys[0], ((-1, 1),))
    np.testing.assert_array_equal(
        torch.where(ok[..., 5], one[..., 0], 0).numpy(),
        torch.where(ok[..., 5], ca[..., 5], 0).numpy())


@pytest.fixture(scope="module")
def degrain_run(ref, port_run):
    """Overlapped three-plane Degrain2, batched over the clip's frames, on
    the JAX side's vectors, clip-edge validity included."""
    sspec, aspec = tpr.specs(ref)
    sups = port_run[0]
    mvb = _jax_fields(ref)
    nj = T * R
    nxt, prv = neighbour_index(T, R, +1, "cpu"), neighbour_index(T, R, -1,
                                                                 "cpu")
    prev_ok, next_ok = edge_validity(T, R, "cpu")
    sups_r, mvs, valid = [], [], []
    for k in range(R):
        sl = slice(k * T, (k + 1) * T)
        sups_r += [sups.map(lambda a: a[nxt[sl]]),
                   sups.map(lambda a: a[prv[sl]])]
        mvs += [_jobs(mvb, sl), _jobs(mvb, slice(nj + k * T, nj + (k + 1) * T))]
        valid += [next_ok[:, k], prev_ok[:, k]]
    return degrain(_clip(ref), sups_r, mvs, aspec.meta,
                   DegrainConfig(thsad=400), valid=valid)


@pytest.mark.parametrize("plane", range(3))
def test_degrain_yuv_matches_jax(ref, degrain_run, plane):
    out = degrain_run
    assert out[plane].dtype == torch.uint8
    np.testing.assert_array_equal(out[plane].numpy(), ref[f"degrain{plane}"])


@pytest.fixture(scope="module")
def clip_run(ref):
    """degrain_clip with the jobs of a direction (6) split over two
    analyse_batch calls, as a long clip's are."""
    from mvtools_tpu_torch.models import denoise
    scfg, acfg, dcfg, _ = flagship_configs()
    info = {}
    whole = denoise._MAX_JOBS
    denoise._MAX_JOBS = 4
    try:
        out = degrain_clip(_clip(ref), FMT, scfg, acfg, dcfg, radius=R,
                           info=info)
    finally:
        denoise._MAX_JOBS = whole
    return out, info


@pytest.mark.parametrize("plane", range(3))
def test_degrain_clip_matches_jax(ref, clip_run, plane):
    """The whole slice through its entry point; frames 0 and 2 are clip
    edges (two missing neighbours each), frame 1 has none at distance 2."""
    out, _ = clip_run
    assert len(out) == 3 and out[plane].dtype == torch.uint8
    np.testing.assert_array_equal(out[plane].numpy(), ref[f"degrain{plane}"])


def test_degrain_clip_fields_and_pixels(ref, clip_run):
    """degrain_clip's analyse calls (two per direction here) give the fields
    of the one JAX call (a job's result does not depend on its batch), and
    the dark frames,
    which have one usable neighbour each, come out changed while the bright
    frame, whose neighbours are all behind a scene change, does not."""
    out, info = clip_run
    nj = T * R
    for lv in range(tpr.YUV_LEVELS):
        for key in ("x", "y", "sad"):
            want = ref[f"mv_{key}{lv}"]
            np.testing.assert_array_equal(
                getattr(info["fields_b"].levels[lv], key).numpy(), want[:nj])
            np.testing.assert_array_equal(
                getattr(info["fields_f"].levels[lv], key).numpy(), want[nj:])
    assert info["fields_b"].meta.is_backward
    assert not info["fields_f"].meta.is_backward
    y = ref["y"]
    assert not np.array_equal(out[0][0].numpy(), y[0])
    assert not np.array_equal(out[0][2].numpy(), y[2])
    np.testing.assert_array_equal(out[0][1].numpy(), y[1])


def test_edge_validity_and_neighbours():
    prev_ok, next_ok = edge_validity(4, 2, "cpu")
    assert prev_ok.tolist() == [[False, False], [True, False], [True, True],
                                [True, True]]
    assert next_ok.tolist() == [[True, True], [True, True], [True, False],
                                [False, False]]
    assert neighbour_index(4, 2, +1, "cpu").tolist() == [1, 2, 3, 3,
                                                         2, 3, 3, 3]
    assert neighbour_index(4, 2, -1, "cpu").tolist() == [0, 0, 1, 2,
                                                         0, 0, 0, 1]
    src, rf = tpr.yuv_job_indices(4, 2)
    assert rf == (neighbour_index(4, 2, +1, "cpu").tolist()
                  + neighbour_index(4, 2, -1, "cpu").tolist())


def test_yuv_test_clip_recipe():
    """make_test_clip_yuv is the numpy recipe of the shared reference clip."""
    mine = make_test_clip_yuv(T, tpr.YUV_W, tpr.YUV_H, seed=tpr.YUV_SEED,
                              flash=tpr.YUV_FLASH, noise=tpr.YUV_NOISE,
                              pan=tpr.YUV_PAN, device="cpu")
    for a, b in zip(mine, tpr.make_yuv_frames()):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), b)
    calm = make_test_clip_yuv(2, 64, 48, seed=1, device="cpu")
    assert [tuple(p.shape) for p in calm] == [(2, 48, 64), (2, 24, 32),
                                              (2, 24, 32)]
    y, u, v = tpr.make_yuv_frames(2, 64, 48, 1, None, 0, (2, 3))
    np.testing.assert_array_equal(calm[2].numpy(), v)
    assert int(mine[1][1, 8:88, 8:120].min()) >= 192 - tpr.YUV_NOISE
    assert int(mine[1][0, 8:88, 8:120].max()) <= 63 + tpr.YUV_NOISE


def test_yuv_state_roundtrips_through_convert(ref):
    """Three-plane pyramids and fields cross as numpy arrays / dicts."""
    sspec, aspec = tpr.specs(ref)
    planes = [[ref[f"super{p}_{lv}"] for lv in range(sspec.levels)]
              for p in range(3)]
    sup = convert.super_from_numpy(planes, sspec, device="cpu")
    assert sup.num_planes == 3 and sup.batched
    back = convert.super_to_numpy(sup)
    for p in range(3):
        for lv in range(sspec.levels):
            np.testing.assert_array_equal(back[p][lv], planes[p][lv])
    clip = convert.clip_from_numpy([ref[k] for k in "yuv"], device="cpu")
    for a, b in zip(convert.clip_to_numpy(clip), "yuv"):
        np.testing.assert_array_equal(a, ref[b])
    levels, meta, validity = convert.mvfield_to_numpy(_jax_fields(ref))
    assert meta == json.loads(str(ref["aspec_json"]))["meta"]
    np.testing.assert_array_equal(levels[2][2], ref["mv_sad2"])
    assert validity.shape == (2 * T * R,)


def _tiny_clip(bits=8):
    dt = torch.uint8 if bits == 8 else torch.int16
    return [torch.zeros((2, 48, 64), dtype=dt),
            torch.zeros((2, 24, 32), dtype=dt),
            torch.zeros((2, 24, 32), dtype=dt)]


@pytest.mark.parametrize("kw,what", [
    (dict(engine="exact"), "exact"),
    (dict(mesh=object()), "mesh"),
    (dict(spatial="space"), "mesh"),
    (dict(acfg=AnalyseConfig(fields=True, tff=True)), "fields"),
    (dict(scfg=SuperConfig(pel=4)), "pel"),
    (dict(bits=16, acfg=AnalyseConfig(dct=5)), "16-bit"),
    (dict(acfg=AnalyseConfig(dct=1), scfg=SuperConfig(pel=4)), "dct"),
    (dict(acfg=AnalyseConfig(trymany=True)), "trymany"),
], ids=["exact", "mesh", "spatial", "fields", "pel4", "16bit", "dct",
        "trymany"])
def test_degrain_clip_refusals(kw, what):
    """Nothing outside the slice falls back silently: each option names
    itself in a NotImplementedError."""
    bits = kw.pop("bits", 8)
    fmt = VideoFormat(64, 48, bits, ColorFamily.YUV420)
    with pytest.raises(NotImplementedError, match=what):
        degrain_clip(_tiny_clip(bits), fmt, **kw)


def test_degrain_clip_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        degrain_clip(_tiny_clip(), VideoFormat(64, 48, 8, ColorFamily.YUV420),
                     engine="fast")


def test_port_imports_without_jax_installed():
    """`import mvtools_tpu_torch` and every module of the slice work in an
    interpreter where jax and triton cannot be imported, and pull in
    neither jax nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['triton'] = None; "
            "import mvtools_tpu_torch, mvtools_tpu_torch.convert, "
            "mvtools_tpu_torch.models.denoise, mvtools_tpu_torch.ops.sadmap, "
            "mvtools_tpu_torch.ops.overlap, mvtools_tpu_torch.ops.probe, "
            "mvtools_tpu_torch.degrain, mvtools_tpu_torch.field_engine; "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m == 'jax' or m.startswith('jax.') or m == 'mvtools_tpu' "
            "or m.startswith('mvtools_tpu.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_kernel_wrappers_dispatch_on_the_tensor_device_alone():
    """On a CUDA tensor the per-block probe launches its kernel or raises:
    the only dispatch is on `is_cuda`, no wrapper catches an error, and the
    tiled probe hands small planes to the wrapper, not to the plain
    version."""
    import inspect
    src = inspect.getsource(probe_ops.probe_sads)
    assert "if not stack.is_cuda:" in src
    assert "try:" not in src and "except" not in src
    # one count per kernel: the plain form's or the three-stat form's
    assert ('name = "probe_sads[stats3]" if stats3 else "probe_sads"' in src
            and "launches[name] += 1" in src)
    tiled = inspect.getsource(probe_ops.probe_sads_tiled)
    assert "return probe_sads(" in tiled
    assert "probe_sads_plain" not in tiled


@pytest.mark.slow
def test_degrain_clip_matches_jax_degrain_clip(ref, clip_run):
    """The port's entry point against the JAX package's own degrain_clip
    (engine="lockstep"), which compiles the search once more per direction:
    minutes on the CPU, so outside the default run."""
    import jax.numpy as jnp
    from mvtools_tpu.core.config import AnalyseConfig as JA, SuperConfig as JS
    from mvtools_tpu.core.types import ColorFamily as JC, VideoFormat as JV
    from mvtools_tpu.degrain import DegrainConfig as JD
    from mvtools_tpu.models.denoise import degrain_clip as jax_degrain_clip
    want = jax_degrain_clip(
        [jnp.asarray(ref[k]) for k in "yuv"],
        JV(tpr.YUV_W, tpr.YUV_H, 8, JC.YUV420),
        JS(pel=2, levels=0, chroma=True),
        JA(blksize=tpr.YUV_BLK, levels=0, overlap=tpr.YUV_OVERLAP,
           truemotion=True, chroma=True),
        JD(thsad=400), radius=R, engine="lockstep")
    for p in range(3):
        np.testing.assert_array_equal(clip_run[0][p].numpy(),
                                      np.asarray(want[p]))
