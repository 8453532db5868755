"""Shared JAX-side reference for the tests of the PyTorch port
(tests/test_torch_*.py).

The JAX lockstep engine is slow on the CPU (a minute or more per analysed
pyramid, set by the number of operations it dispatches, not by the frame
size), so each reference below is run through the JAX package once per test
run and cached as an .npz that every test file (and every pytest-xdist
worker) loads.  A reference is computed by whichever process first takes
its lock; the others wait for the file.  Under pytest-xdist a background
process a reference computes them all at once from the start of the run,
at the lowest priority (see _prefetch); each exits when the worker that
started it does.

* load(): gray, 3 levels, no overlap, radius 1 (the headline path).
* load_yuv(): YUV420, levels=0 (4 levels at this size), overlap 8, chroma,
  radius 2 over a 3-frame clip, so every clip-edge case occurs.  The clip
  flashes over most of the frame, which makes blocks bad at every level;
  the level-2 chroma stacks (448 wide) and all level-3 stacks (480 wide) are
  narrower than the tiled probe's 512-wide window, so the rescue's probes
  there go through the per-block probe.
* load_satd(): the SATD slice, gray: Analyse with dct 5 (blk 16 overlap 8,
  levels=0: 4 levels at this size) -> Recalculate with dct 5 (blk 16 overlap
  8, the jobs batched by jax.vmap) -> Degrain1, radius 1 over a 4-frame
  clip.  Frame 1 flashes over most
  of the frame, so three of the four jobs turn bad at every level and the
  rescue runs on SATD costs; the level-3 stack (480 wide) is narrower than
  the tiled probe's window, so its probes go through the per-block probe.
  badsad is 5000, not the default 10000: the SATD of a pure brightness step
  is at most 8 * 255 per 4x4 tile, 32 640 for a 16x16 block, under the
  default's 40 000, so with dct 5 no flash alone is ever "bad" at the
  default.  A region free of fresh noise leaves Recalculate blocks under
  thsad in the calm job.
* load_dct(): the DCT slice, gray 112x80: Analyse with dct 1 (blk 16, two
  levels) -> Recalculate with dct 2 (blk 16 overlap 8), three jobs.  Frame 1
  flashes over half the frame, so the two jobs that pair it are bad at both
  levels and the rescue runs on DCT costs; the third job is calm.  The
  level-1 stack (504 wide) is narrower than the tiled fetch's window (512),
  so the dense DCT map there is fetched block by block.  badsad is 1500 (6000 for a 16x16
  block): the DCT cost of a brightness step (about 8 * 3 * the DC step of
  96) is no larger than that of the fresh noise of a calm pair, so only the
  flash's mismatched blocks lie over it, and no calm block does.
* load_recalc(): Recalculate alone, 160x128 gray, on a seeded old field, in
  four configurations (dct 0, 5 and 7, blk 16 overlap 8 and blk 8 with the
  exhaustive search) and once with chroma (YUV420, dct 5).
* load_dct6(): Analyse with dct 6 on a pair whose brightness changes (two
  levels at 128x96), so that the SATD mix's per-job weight is not 0.
* load_deep(): the YUV420 slice at 16 bits: load_yuv's clip with each
  sample v as (v << 8) | r, r a fresh seeded byte (so the low byte carries
  data), radius 1 (about half of load_yuv's JAX time), the same pyramid and
  search; the rescue runs, and on the levels narrower than the tiled
  probe's window through the per-block probe.  Degrain takes thsad 2000 and
  thscd1 10000: every valid pair holds the flash frame, which at the
  default thscd1 makes each a scene change (weight 0); with these the
  blocks outside the flash are averaged in all three planes.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

W, H, LEVELS, BLK, RADIUS = 256, 192, 3, 16, 1
N_FRAMES = 4                       # window of B + 2*RADIUS frames, B = 2
FLASH = (32, 64, 96, 128)          # y, x, h, w of the flashing region
SEED = 7


def make_frames() -> np.ndarray:
    """[N_FRAMES, H, W] uint8: uniform noise panned (2, 3) px per frame,
    with a region that is dark in every frame and saturated in frame 1 —
    finest-level SADs against frame 1 exceed badsad at every candidate, so
    the search's bad-SAD rescue runs."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (H + 32, W + 32), np.uint8)
    y, x, h, w = FLASH
    out = np.empty((N_FRAMES, H, W), np.uint8)
    for i in range(N_FRAMES):
        dy, dx = (i * 2) % 16, (i * 3) % 16
        out[i] = base[dy:dy + H, dx:dx + W]
        out[i, y:y + h, x:x + w] = (255 if i % 3 == 1
                                    else out[i, y:y + h, x:x + w] >> 2)
    return out


def job_indices():
    """(src, ref) frame indices of the analyse jobs, in the order the
    batched denoise uses: per output frame backward then forward."""
    src, ref = [], []
    for c in range(RADIUS, N_FRAMES - RADIUS):
        src += [c, c]
        ref += [c + 1, c - 1]
    return src, ref


def _compute() -> dict:
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu.analyse import batch_supported
    from mvtools_tpu.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu.core.types import ColorFamily, VideoFormat
    from mvtools_tpu.degrain import DegrainConfig, degrain

    tm = jax.tree_util.tree_map
    frames = make_frames()
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=LEVELS, chroma=False).validate(fmt)
    aspec = dataclasses.replace(
        AnalyseConfig(blksize=BLK, levels=LEVELS, truemotion=True,
                      chroma=False), isb=True).validate(sspec)
    assert batch_supported(aspec, sspec)
    sups = [mvt.build_super([jnp.asarray(f)], sspec) for f in frames]
    src, ref = job_indices()
    ss = tm(lambda *a: jnp.stack(a), *[sups[i] for i in src])
    rs = tm(lambda *a: jnp.stack(a), *[sups[i] for i in ref])
    mvb = mvt.analyse_batch(ss, rs, aspec)
    out = {"frames": frames}
    for lv in range(LEVELS):
        out[f"super{lv}"] = np.stack(
            [np.asarray(s.planes[0][lv]) for s in sups])
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    deg = []
    for i, c in enumerate(range(RADIUS, N_FRAMES - RADIUS)):
        mvs = [tm(lambda a, j=2 * i + j: a[j], mvb) for j in range(2)]
        deg.append(np.asarray(degrain(
            [jnp.asarray(frames[c])], [sups[c + 1], sups[c - 1]], mvs,
            aspec.meta, DegrainConfig(thsad=400))[0]))
    out["degrain"] = np.stack(deg)

    def plain(d):
        return {k: (plain(v) if isinstance(v, dict) else
                    int(v) if isinstance(v, (int, np.integer)) and
                    not isinstance(v, bool) else v) for k, v in d.items()}

    out["sspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(sspec))))
    out["aspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(aspec))))
    return out


def _shared_dir(tmp_path_factory=None) -> Path:
    """The directory every process of one test run shares: under
    pytest-xdist one named by the run's id in the temporary directory (the
    prefetch, which starts before any fixture runs, finds it by that id),
    else the session's base temporary directory."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid:
        d = Path(tempfile.gettempdir()) / f"mvt-torch-reference-{uid}"
        d.mkdir(exist_ok=True)
        return d
    return tmp_path_factory.getbasetemp()


def _ensure(base: Path, stem: str) -> Path:
    """The reference's .npz, computed under its lock by the first process
    that needs it; a process that finds the lock held waits for it (a lock
    whose holder died is released with it, and the file is then computed
    here)."""
    final = base / f"{stem}.npz"
    if final.exists():
        return final
    with open(base / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not final.exists():
            tmp = base / f"{stem}.{os.getpid()}.tmp.npz"
            np.savez(tmp, **COMPUTE[stem]())
            os.replace(tmp, final)
    return final


def _load(tmp_path_factory, stem: str) -> dict:
    _prefetch()
    with np.load(_ensure(_shared_dir(tmp_path_factory), stem)) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# The YUV420 slice: chroma, overlap 8, full pyramid, radius 2

YUV_W, YUV_H, YUV_BLK, YUV_OVERLAP, YUV_RADIUS = 256, 192, 16, 8, 2
YUV_FRAMES = 3
YUV_LEVELS = 4                     # what levels=0 resolves to at this size
YUV_FLASH = (16, 16, 160, 224)     # y, x, h, w in luma pixels
YUV_SEED = 11
YUV_NOISE = 4                      # per-frame noise amplitude
YUV_PAN = (1, 1)                   # pixels down / right per frame


def make_yuv_frames(n=YUV_FRAMES, w=YUV_W, h=YUV_H, seed=YUV_SEED,
                    flash=YUV_FLASH, noise=YUV_NOISE, pan=YUV_PAN,
                    clean=None):
    """[Y, U, V] planes [n, h, w] / [n, h/2, w/2] uint8 of a YUV420 clip:
    per plane one uniform-noise image panned by `pan` luma pixels per frame
    (mod 16; chroma moves half as far; a small pan keeps the dark frames
    within reach of each other, so that degrain finds usable neighbours).
    Inside `flash` every frame is dark
    (pixel >> 2) and every third frame, starting with frame 1, is bright
    (192 + (pixel >> 2)): between a bright frame and its neighbours every
    pixel of the region differs by more than 100 at every candidate vector,
    at every pyramid level, the way a camera flash or a cut does.  `noise`
    adds fresh uniform noise of that amplitude to every frame, so that a
    compensated neighbour is close to the frame but not equal to it and
    degrain has something to average; `clean` = (y, x, h, w) keeps a region
    free of that noise, so that a true vector matches exactly there."""
    rng = np.random.default_rng(seed)
    planes = []
    for sub in (0, 1, 1):
        pw, ph = w >> sub, h >> sub
        base = rng.integers(0, 256, (ph + 32, pw + 32), np.uint8)
        out = np.empty((n, ph, pw), np.uint8)
        for i in range(n):
            dy, dx = ((i * pan[0]) % 16) >> sub, ((i * pan[1]) % 16) >> sub
            out[i] = base[dy:dy + ph, dx:dx + pw]
            if flash is not None:
                y, x, hh, ww = (v >> sub for v in flash)
                reg = out[i, y:y + hh, x:x + ww] >> 2
                out[i, y:y + hh, x:x + ww] = reg + (192 if i % 3 == 1 else 0)
            if noise:
                grain = rng.integers(-noise, noise + 1, (ph, pw))
                if clean is not None:
                    y, x, hh, ww = (v >> sub for v in clean)
                    grain[y:y + hh, x:x + ww] = 0
                out[i] = np.clip(out[i].astype(np.int64) + grain, 0, 255)
        planes.append(out)
    return planes


def yuv_job_indices(total=YUV_FRAMES, radius=YUV_RADIUS):
    """(src, ref) frame indices of the analyse jobs of a whole-clip denoise:
    first the backward jobs (reference = a LATER frame), then the forward
    ones; within a direction job k*total + i pairs frame i with frame
    i +- (k + 1), clamped into the clip (a neighbour past the clip edge is
    the edge frame, and is marked invalid for degrain)."""
    src, ref = [], []
    for sign in (1, -1):
        for k in range(1, radius + 1):
            for i in range(total):
                src.append(i)
                ref.append(min(max(i + sign * k, 0), total - 1))
    return src, ref


def _compute_yuv() -> dict:
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu.analyse import batch_supported
    from mvtools_tpu.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu.core.types import ColorFamily, VideoFormat
    from mvtools_tpu.degrain import DegrainConfig, degrain

    tm = jax.tree_util.tree_map
    planes = make_yuv_frames()
    total, radius = YUV_FRAMES, YUV_RADIUS
    fmt = VideoFormat(YUV_W, YUV_H, 8, ColorFamily.YUV420)
    sspec = SuperConfig(pel=2, levels=0, chroma=True).validate(fmt)
    aspec = dataclasses.replace(
        AnalyseConfig(blksize=YUV_BLK, levels=0, overlap=YUV_OVERLAP,
                      truemotion=True, chroma=True),
        isb=True).validate(sspec)
    assert aspec.meta.lv_count == YUV_LEVELS
    assert batch_supported(aspec, sspec)
    sups = [mvt.build_super([jnp.asarray(p[i]) for p in planes], sspec)
            for i in range(total)]
    src, ref = yuv_job_indices()
    ss = tm(lambda *a: jnp.stack(a), *[sups[i] for i in src])
    rs = tm(lambda *a: jnp.stack(a), *[sups[i] for i in ref])
    mvb = mvt.analyse_batch(ss, rs, aspec)
    out = {"y": planes[0], "u": planes[1], "v": planes[2]}
    for p in range(3):
        for lv in range(sspec.levels):
            out[f"super{p}_{lv}"] = np.stack(
                [np.asarray(s.planes[p][lv]) for s in sups])
    for lv in range(YUV_LEVELS):
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    deg = [[], [], []]
    nj = total * radius
    for i in range(total):
        sups_r, mvs, valid = [], [], []
        for k in range(radius):
            sups_r += [sups[min(i + k + 1, total - 1)],
                       sups[max(i - k - 1, 0)]]
            mvs += [tm(lambda a, j=k * total + i: a[j], mvb),
                    tm(lambda a, j=nj + k * total + i: a[j], mvb)]
            valid += [jnp.asarray(i + k + 1 <= total - 1),
                      jnp.asarray(i - k - 1 >= 0)]
        res = degrain([jnp.asarray(p[i]) for p in planes], sups_r, mvs,
                      aspec.meta, DegrainConfig(thsad=400), valid=valid)
        for p in range(3):
            deg[p].append(np.asarray(res[p]))
    for p in range(3):
        out[f"degrain{p}"] = np.stack(deg[p])

    def plain(d):
        return {k: (plain(v) if isinstance(v, dict) else
                    int(v) if isinstance(v, (int, np.integer)) and
                    not isinstance(v, bool) else v) for k, v in d.items()}

    out["sspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(sspec))))
    out["aspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(aspec))))
    return out


# ---------------------------------------------------------------------------
# The SATD slice: gray, Analyse dct 5 -> Recalculate dct 5 -> Degrain1

SATD_W, SATD_H, SATD_BLK, SATD_OVERLAP, SATD_RADIUS = 256, 192, 16, 8, 1
SATD_FRAMES = 4
SATD_LEVELS = 4                    # what levels=0 resolves to at this size
SATD_FLASH = (16, 16, 160, 224)    # y, x, h, w
SATD_CLEAN = (64, 96, 96, 128)     # no fresh noise here
SATD_SEED = 13
SATD_DCT = 5
SATD_BADSAD = 5000
SATD_THSAD = 200


def make_satd_frames():
    """[SATD_FRAMES, H, W] uint8: the luma plane of make_yuv_frames with the
    flash in frame 1, +-4 fresh noise outside SATD_CLEAN, pan (1, 1)."""
    return make_yuv_frames(SATD_FRAMES, SATD_W, SATD_H, SATD_SEED, SATD_FLASH,
                           YUV_NOISE, YUV_PAN, clean=SATD_CLEAN)[0]


def satd_job_indices():
    """(src, ref) frame indices, per output frame backward then forward."""
    src, ref = [], []
    for c in range(SATD_RADIUS, SATD_FRAMES - SATD_RADIUS):
        src += [c, c]
        ref += [c + 1, c - 1]
    return src, ref


def satd_configs(config, types, recalc):
    """(SuperSpec, AnalyseSpec, RecalculateConfig, its AnalyseSpec) of the
    SATD slice from either package's config / types / recalculate
    modules."""
    fmt = types.VideoFormat(SATD_W, SATD_H, 8, types.ColorFamily.GRAY)
    sspec = config.SuperConfig(pel=2, levels=0, chroma=False).validate(fmt)
    aspec = config.AnalyseConfig(
        blksize=SATD_BLK, levels=0, overlap=SATD_OVERLAP, truemotion=True,
        chroma=False, dct=SATD_DCT, badsad=SATD_BADSAD,
        isb=True).validate(sspec)
    rcfg = recalc.RecalculateConfig(
        blksize=SATD_BLK, overlap=SATD_OVERLAP, thsad=SATD_THSAD,
        chroma=False, truemotion=True, dct=SATD_DCT)
    return sspec, aspec, rcfg, rcfg.to_analyse_config().validate(sspec)


def _compute_satd() -> dict:
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu import recalculate as jax_recalc
    from mvtools_tpu.analyse import batch_supported
    from mvtools_tpu.core import config, types
    from mvtools_tpu.degrain import DegrainConfig, degrain

    tm = jax.tree_util.tree_map
    frames = make_satd_frames()
    sspec, aspec, rcfg, rspec = satd_configs(config, types, jax_recalc)
    assert aspec.meta.lv_count == SATD_LEVELS
    assert batch_supported(aspec, sspec)
    sups = [mvt.build_super([jnp.asarray(f)], sspec) for f in frames]
    src, ref = satd_job_indices()
    ss = tm(lambda *a: jnp.stack(a), *[sups[i] for i in src])
    rs = tm(lambda *a: jnp.stack(a), *[sups[i] for i in ref])
    mvb = mvt.analyse_batch(ss, rs, aspec)
    out = {"frames": frames}
    for lv in range(sspec.levels):
        out[f"super{lv}"] = np.stack(
            [np.asarray(s.planes[0][lv]) for s in sups])
    for lv in range(SATD_LEVELS):
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    # the jobs batched by vmap: one call instead of one per job, the same
    # result (a job's refinement does not depend on the others)
    rc = jax.vmap(lambda s, r, f: jax_recalc.recalculate(
        s, r, f, rspec, rcfg, engine="lockstep"))(ss, rs, mvb)
    for k in ("x", "y", "sad"):
        out[f"rc_{k}"] = np.asarray(getattr(rc.levels[0], k))
    refined = [tm(lambda a, j=j: a[j], rc) for j in range(len(src))]
    deg = []
    for i, c in enumerate(range(SATD_RADIUS, SATD_FRAMES - SATD_RADIUS)):
        deg.append(np.asarray(degrain(
            [jnp.asarray(frames[c])], [sups[c + 1], sups[c - 1]],
            refined[2 * i:2 * i + 2], rspec.meta,
            DegrainConfig(thsad=400))[0]))
    out["degrain"] = np.stack(deg)
    return out


def load(tmp_path_factory) -> dict:
    """The gray reference arrays, computed at most once per test run."""
    return _load(tmp_path_factory, "torch_port_reference")


def load_yuv(tmp_path_factory) -> dict:
    """The YUV420 reference arrays, computed at most once per test run."""
    return _load(tmp_path_factory, "torch_port_reference_yuv")


def load_satd(tmp_path_factory) -> dict:
    """The SATD slice's reference arrays, computed at most once per test
    run."""
    return _load(tmp_path_factory, "torch_port_reference_satd")


def load_dct(tmp_path_factory) -> dict:
    """The DCT slice's reference arrays, computed at most once per test
    run."""
    return _load(tmp_path_factory, "torch_port_reference_dct")


def load_recalc(tmp_path_factory) -> dict:
    """Recalculate's reference arrays, computed at most once per test run."""
    return _load(tmp_path_factory, "torch_port_reference_recalc")


def load_dct6(tmp_path_factory) -> dict:
    """The dct 6 Analyse reference arrays, computed at most once per test
    run."""
    return _load(tmp_path_factory, "torch_port_reference_dct6")


def specs(ref: dict):
    """The port's (SuperSpec, AnalyseSpec) rebuilt from the JAX specs,
    carried across as plain dicts."""
    from mvtools_tpu_torch import convert
    return (convert.super_spec_from_dict(json.loads(str(ref["sspec_json"]))),
            convert.analyse_spec_from_dict(json.loads(str(ref["aspec_json"]))))


def _stack_supers(sups, idx):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                  *[sups[i] for i in idx])


# ---------------------------------------------------------------------------
# The DCT slice: gray, Analyse dct 1 -> Recalculate dct 2

DCT_W, DCT_H, DCT_LEVELS, DCT_FRAMES = 112, 80, 2, 4
DCT_FLASH = (16, 16, 48, 80)       # y, x, h, w
DCT_SEED = 41
DCT_BADSAD = 1500
DCT_THSAD = 200
DCT_SRC, DCT_REF = (1, 1, 2), (2, 0, 3)    # two flash jobs, one calm


def make_dct_frames():
    """[DCT_FRAMES, H, W] uint8: the luma plane of make_yuv_frames, flash
    bright in frame 1, +-4 fresh noise, pan (1, 1)."""
    return make_yuv_frames(DCT_FRAMES, DCT_W, DCT_H, DCT_SEED, DCT_FLASH,
                           YUV_NOISE, YUV_PAN)[0]


def dct_configs(config, types, recalc):
    """(SuperSpec, AnalyseSpec, RecalculateConfig, its AnalyseSpec) of the
    DCT slice from either package's config / types / recalculate modules."""
    fmt = types.VideoFormat(DCT_W, DCT_H, 8, types.ColorFamily.GRAY)
    sspec = config.SuperConfig(pel=2, levels=DCT_LEVELS,
                               chroma=False).validate(fmt)
    aspec = config.AnalyseConfig(
        blksize=16, levels=DCT_LEVELS, truemotion=True, chroma=False, dct=1,
        badsad=DCT_BADSAD).validate(sspec)
    rcfg = recalc.RecalculateConfig(blksize=16, overlap=8, thsad=DCT_THSAD,
                                    chroma=False, truemotion=True, dct=2)
    return sspec, aspec, rcfg, rcfg.to_analyse_config().validate(sspec)


def _compute_dct() -> dict:
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu import recalculate as jax_recalc
    from mvtools_tpu.core import config, types

    frames = make_dct_frames()
    sspec, aspec, rcfg, rspec = dct_configs(config, types, jax_recalc)
    sups = [mvt.build_super([jnp.asarray(f)], sspec) for f in frames]
    ss, rs = _stack_supers(sups, DCT_SRC), _stack_supers(sups, DCT_REF)
    mvb = mvt.analyse_batch(ss, rs, aspec)
    rc = jax.vmap(lambda s, r, f: jax_recalc.recalculate(
        s, r, f, rspec, rcfg, engine="lockstep"))(ss, rs, mvb)
    out = {"frames": frames, "mv_validity": np.asarray(mvb.validity),
           "rc_validity": np.asarray(rc.validity)}
    for lv in range(DCT_LEVELS):
        out[f"super{lv}"] = np.stack(
            [np.asarray(s.planes[0][lv]) for s in sups])
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    for k in ("x", "y", "sad"):
        out[f"rc_{k}"] = np.asarray(getattr(rc.levels[0], k))
    return out


# ---------------------------------------------------------------------------
# Recalculate alone, on a seeded old field

RC_W, RC_H, RC_PEL = 160, 128, 2
RC_PAN = (1, 2)                    # pixels down / right per frame
RC_CLEAN = (32, 48, 64, 80)        # y, x, h, w free of fresh noise
RC_CONFIGS = {
    "dct0-16ov8": dict(blksize=16, overlap=8, thsad=200, chroma=False, dct=0),
    "dct5-16ov8": dict(blksize=16, overlap=8, thsad=200, chroma=False, dct=5),
    "dct5-8ov0-exh": dict(blksize=8, overlap=0, thsad=200, chroma=False,
                          dct=5, search=3, searchparam=2, smooth=0),
    "dct7-16ov8": dict(blksize=16, overlap=8, thsad=100, chroma=False, dct=7),
}
RC_CHROMA = dict(blksize=16, overlap=8, thsad=200, chroma=True, dct=5)


def recalc_specs(config, types, family="GRAY", pel=RC_PEL):
    """(SuperSpec, old 16x16 overlap-0 AnalyseSpec) of the Recalculate
    references in either package."""
    fmt = types.VideoFormat(RC_W, RC_H, 8, getattr(types.ColorFamily, family))
    chroma = family != "GRAY"
    sspec = config.SuperConfig(pel=pel, levels=1, chroma=chroma).validate(fmt)
    old = config.AnalyseConfig(blksize=16, levels=1, chroma=chroma,
                               truemotion=True).validate(sspec)
    return sspec, old


def recalc_kw(types, kw):
    """A RC_CONFIGS entry as RecalculateConfig keywords of either package."""
    kw = dict(kw)
    if "search" in kw:
        kw["search"] = types.SearchType(kw["search"])
    return kw


def recalc_old_field(old_meta, rng, nj):
    """[J, nby, nbx] old vectors: the clip's true pan, off by up to two pel
    in a third of the blocks and far off in a few, with SADs to match."""
    nby, nbx = old_meta.blk_y, old_meta.blk_x
    x = np.full((nj, nby, nbx), -RC_PAN[1] * RC_PEL, np.int32)
    y = np.full((nj, nby, nbx), -RC_PAN[0] * RC_PEL, np.int32)
    off = rng.random((nj, nby, nbx)) < 0.33
    x += np.where(off, rng.integers(-2, 3, x.shape), 0).astype(np.int32)
    y += np.where(off, rng.integers(-2, 3, y.shape), 0).astype(np.int32)
    far = rng.random((nj, nby, nbx)) < 0.05
    x += np.where(far, rng.integers(-60, 61, x.shape), 0).astype(np.int32)
    y += np.where(far, rng.integers(-60, 61, y.shape), 0).astype(np.int32)
    sad = rng.integers(0, 9000, (nj, nby, nbx)).astype(np.int64)
    return x, y, sad


def _compute_recalc() -> dict:
    """Three gray frames -> two jobs (frame 1 against frame 2 and frame 0)
    on the JAX package's pyramids and a seeded old field, refined in each of
    RC_CONFIGS (the two jobs batched by jax.vmap); and one YUV420 pair with
    chroma in the search."""
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu import recalculate as jax_recalc
    from mvtools_tpu.core import config, types

    frames = make_yuv_frames(3, RC_W, RC_H, seed=21, flash=None, noise=6,
                             pan=RC_PAN, clean=RC_CLEAN)[0]
    sspec, old_spec = recalc_specs(config, types)
    sups = [mvt.build_super([jnp.asarray(f)], sspec) for f in frames]
    rng = np.random.default_rng(22)
    # job 0: frame 1 -> frame 2 (content moves by -RC_PAN), job 1: 1 -> 0
    x, y, sad = recalc_old_field(old_spec.meta, rng, 2)
    x[1], y[1] = -x[1], -y[1]
    out = {"planes": np.stack([np.asarray(s.planes[0][0]) for s in sups]),
           "old_x": x, "old_y": y, "old_sad": sad}
    old = types.MVField((types.MVPlaneField(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(sad)),),
                        jnp.ones((2,), jnp.int32), old_spec.meta)
    ss, rs = _stack_supers(sups, (1, 1)), _stack_supers(sups, (2, 0))
    for name, kw in RC_CONFIGS.items():
        rcfg = jax_recalc.RecalculateConfig(**recalc_kw(types, kw))
        rspec = rcfg.to_analyse_config().validate(sspec)
        got = jax.vmap(lambda s, r, f: jax_recalc.recalculate(
            s, r, f, rspec, rcfg, engine="lockstep"))(ss, rs, old)
        for k in ("x", "y", "sad"):
            out[f"{name}_{k}"] = np.asarray(getattr(got.levels[0], k))

    planes = make_yuv_frames(2, RC_W, RC_H, seed=23, flash=None, noise=6,
                             pan=RC_PAN, clean=RC_CLEAN)
    sspec_c, old_c = recalc_specs(config, types, "YUV420")
    rcfg = jax_recalc.RecalculateConfig(**RC_CHROMA)
    rspec = rcfg.to_analyse_config().validate(sspec_c)
    sups = [mvt.build_super([jnp.asarray(p[i]) for p in planes], sspec_c)
            for i in range(2)]
    x, y, sad = recalc_old_field(old_c.meta, np.random.default_rng(24), 1)
    old = types.MVField(
        (types.MVPlaneField(jnp.asarray(x[0]), jnp.asarray(y[0]),
                            jnp.asarray(sad[0])),),
        jnp.ones((), jnp.int32), old_c.meta)
    got = jax_recalc.recalculate(sups[0], sups[1], old, rspec, rcfg,
                                 engine="lockstep").levels[0]
    for p in range(3):
        out[f"chroma_planes{p}"] = np.stack(
            [np.asarray(sup.planes[p][0]) for sup in sups])
    out.update(chroma_old_x=x, chroma_old_y=y, chroma_old_sad=sad)
    for k in ("x", "y", "sad"):
        out[f"chroma_{k}"] = np.asarray(getattr(got, k))
    return out


# ---------------------------------------------------------------------------
# Analyse with dct 6 on a pair whose brightness changes

DCT6_W, DCT6_H, DCT6_LEVELS = 128, 96, 2


def make_dct6_frames():
    """[3, H, W] uint8: frame 0, and frame 0 moved by (1, 2) px with +-3
    grain, once 6 brighter and once not."""
    w, h = DCT6_W, DCT6_H
    rng = np.random.default_rng(77)
    base = rng.integers(0, 230, (h + 8, w + 8)).astype(np.uint8)
    f1 = base[1:h + 1, 2:w + 2].astype(np.int64)
    grain = rng.integers(-3, 4, (h, w))
    return np.stack([
        base[:h, :w], np.clip(f1 + grain + 6, 0, 255).astype(np.uint8),
        np.clip(f1 + grain, 0, 255).astype(np.uint8)])


def dct6_specs(config, types, dct=6):
    fmt = types.VideoFormat(DCT6_W, DCT6_H, 8, types.ColorFamily.GRAY)
    sspec = config.SuperConfig(pel=2, levels=DCT6_LEVELS,
                               chroma=False).validate(fmt)
    return sspec, config.AnalyseConfig(
        blksize=16, levels=DCT6_LEVELS, chroma=False, truemotion=True,
        dct=dct).validate(sspec)


def _compute_dct6() -> dict:
    """Frame 0 against frames 1 and 2 as one analyse_batch call (its
    contract: each job as analyse(engine="lockstep") gives it alone)."""
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu.core import config, types

    frames = make_dct6_frames()
    sspec, aspec = dct6_specs(config, types)
    sups = [mvt.build_super([jnp.asarray(f)], sspec) for f in frames]
    mvb = mvt.analyse_batch(_stack_supers(sups, (0, 0)),
                            _stack_supers(sups, (1, 2)), aspec)
    out = {"frames": frames}
    for lv in range(DCT6_LEVELS):
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    return out


# ---------------------------------------------------------------------------
# The YUV420 slice at 16 bits: radius 1

DEEP_BITS, DEEP_RADIUS, DEEP_SEED = 16, 1, 17
DEEP_DEGRAIN = dict(thsad=2000, thscd1=10000)


def make_deep_frames():
    """[Y, U, V] uint16 planes: make_yuv_frames' clip with each sample v as
    (v << 8) | r, r a fresh byte from DEEP_SEED."""
    rng = np.random.default_rng(DEEP_SEED)
    return [(p.astype(np.uint16) << 8)
            | rng.integers(0, 256, p.shape, np.uint16)
            for p in make_yuv_frames()]


def _compute_deep() -> dict:
    """Supers per frame, one analyse_batch call holding the jobs of both
    directions, degrain per frame with the clip-edge validity: the
    composition the JAX package's degrain_clip stages."""
    import jax
    import jax.numpy as jnp
    import mvtools_tpu as mvt
    from mvtools_tpu.analyse import batch_supported
    from mvtools_tpu.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu.core.types import ColorFamily, VideoFormat
    from mvtools_tpu.degrain import DegrainConfig, degrain

    tm = jax.tree_util.tree_map
    planes = make_deep_frames()
    total, radius = YUV_FRAMES, DEEP_RADIUS
    fmt = VideoFormat(YUV_W, YUV_H, DEEP_BITS, ColorFamily.YUV420)
    sspec = SuperConfig(pel=2, levels=0, chroma=True).validate(fmt)
    aspec = dataclasses.replace(
        AnalyseConfig(blksize=YUV_BLK, levels=0, overlap=YUV_OVERLAP,
                      truemotion=True, chroma=True),
        isb=True).validate(sspec)
    assert aspec.meta.lv_count == YUV_LEVELS
    assert batch_supported(aspec, sspec)
    sups = [mvt.build_super([jnp.asarray(p[i]) for p in planes], sspec)
            for i in range(total)]
    src, ref = yuv_job_indices(total, radius)
    ss = tm(lambda *a: jnp.stack(a), *[sups[i] for i in src])
    rs = tm(lambda *a: jnp.stack(a), *[sups[i] for i in ref])
    mvb = mvt.analyse_batch(ss, rs, aspec)
    out = {"y": planes[0], "u": planes[1], "v": planes[2]}
    for p in range(3):
        for lv in range(sspec.levels):
            out[f"super{p}_{lv}"] = np.stack(
                [np.asarray(s.planes[p][lv]) for s in sups])
    for lv in range(YUV_LEVELS):
        for k in ("x", "y", "sad"):
            out[f"mv_{k}{lv}"] = np.asarray(getattr(mvb.levels[lv], k))
    deg = [[], [], []]
    nj = total * radius
    for i in range(total):
        sups_r, mvs, valid = [], [], []
        for k in range(radius):
            sups_r += [sups[min(i + k + 1, total - 1)],
                       sups[max(i - k - 1, 0)]]
            mvs += [tm(lambda a, j=k * total + i: a[j], mvb),
                    tm(lambda a, j=nj + k * total + i: a[j], mvb)]
            valid += [jnp.asarray(i + k + 1 <= total - 1),
                      jnp.asarray(i - k - 1 >= 0)]
        res = degrain([jnp.asarray(p[i]) for p in planes], sups_r, mvs,
                      aspec.meta, DegrainConfig(**DEEP_DEGRAIN), valid=valid)
        for p in range(3):
            deg[p].append(np.asarray(res[p]))
    for p in range(3):
        out[f"degrain{p}"] = np.stack(deg[p])

    def plain(d):
        return {k: (plain(v) if isinstance(v, dict) else
                    int(v) if isinstance(v, (int, np.integer)) and
                    not isinstance(v, bool) else v) for k, v in d.items()}

    out["sspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(sspec))))
    out["aspec_json"] = np.array(json.dumps(plain(dataclasses.asdict(aspec))))
    return out


def load_deep(tmp_path_factory) -> dict:
    """The 16-bit YUV420 reference arrays, computed at most once per test
    run."""
    return _load(tmp_path_factory, "torch_port_reference_deep")


# ---------------------------------------------------------------------------
# Computing the references ahead of the tests that need them

COMPUTE = {
    "torch_port_reference": _compute,
    "torch_port_reference_yuv": _compute_yuv,
    "torch_port_reference_satd": _compute_satd,
    "torch_port_reference_dct": _compute_dct,
    "torch_port_reference_recalc": _compute_recalc,
    "torch_port_reference_dct6": _compute_dct6,
    "torch_port_reference_deep": _compute_deep,
}
# the background processes, the references each computes: all of them, a
# process each, started as the run begins (test_torch_satd.py, which
# pytest-xdist hands out in its first round, starts them) at the lowest
# priority.  The test files that compare with a reference hold at most six
# tests, so pytest-xdist hands them out last, after the suite's longest
# file (tests/test_batch_engine.py), while that one runs.
PREFETCH = tuple((stem,) for stem in COMPUTE)


def _prefetch() -> None:
    """Under pytest-xdist, start the background processes that compute the
    PREFETCH references, once per test run: test_torch_satd.py starts them
    as the run begins (and the first fixture to need a reference, should it
    come first), so they are made while the workers run other tests.  Every
    reference still goes through _ensure, which waits for a process
    computing it or computes it itself.  Outside pytest-xdist nothing starts
    and each reference is made when a fixture first needs it."""
    global _prefetched
    if _prefetched or not os.environ.get("PYTEST_XDIST_TESTRUNUID"):
        return
    _prefetched = True
    base = _shared_dir()
    try:
        os.close(os.open(base / "prefetch.started",
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return
    for i, stems in enumerate(PREFETCH):
        with open(base / f"prefetch{i}.log", "w") as log:
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(base),
                 str(os.getpid()), *stems],
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                    __file__))), stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT)


_prefetched = False        # this process has tried to start the prefetch


def _exit_with_parent(parent: int) -> None:
    """Exit this process as soon as `parent` (the worker that started it)
    is gone, whatever this process is doing."""
    def watch():
        while os.getppid() == parent:
            time.sleep(1)
        os._exit(0)
    threading.Thread(target=watch, daemon=True).start()


if __name__ == "__main__":
    # a prefetch process: python torch_port_reference.py BASE PARENT STEM...
    # It runs at the lowest priority, on the cycles the test workers leave:
    # the files that need its reference come last, while the files ahead of
    # the suite's longest one (tests/test_batch_engine.py) set when that
    # one can start.
    os.nice(19)
    _exit_with_parent(int(sys.argv[2]))
    sys.path.insert(0, os.getcwd())
    import jax
    jax.config.update("jax_platforms", "cpu")
    for stem in sys.argv[3:]:
        _ensure(Path(sys.argv[1]), stem)


# ---------------------------------------------------------------------------
# A FieldProber on a small level (torch only): the masked-probe tests

WALK = ((-1, -2), (-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2),
        (-2, 0))                   # the hexagon walk's 8 entries


def field_prober(family: str = "YUV420", dctmode: int = 0, width: int = 160,
                 height: int = 96, seed: int = 7):
    """(FieldProber, state, lam, pred) on level 0 of a small two-job batch
    (pel 2, blk 16, overlap 8 with chroma), built the way
    analyse.search_level_lockstep builds its prober, with the search's own
    bounds; the state is a random field with mincosts that leave room to
    improve.  Everything is torch on the CPU: no JAX run."""
    import torch

    from mvtools_tpu_torch import AnalyseConfig, SuperConfig
    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
    from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
    from mvtools_tpu_torch.models.denoise import make_test_clip_yuv
    from mvtools_tpu_torch.super import build_super

    chroma = family != "GRAY"
    fmt = VideoFormat(width, height, 8, ColorFamily[family])
    sspec = SuperConfig(pel=2, levels=1, chroma=chroma).validate(fmt)
    aspec = AnalyseConfig(blksize=16, overlap=8 if chroma else 0, levels=1,
                          chroma=chroma, dct=dctmode).validate(sspec)
    planes = make_test_clip_yuv(3, width, height, seed=seed, noise=4,
                                pan=(1, 1), device="cpu")
    sups = build_super(planes if chroma else planes[:1], sspec)
    ctx = _level_ctx(sspec, aspec, 0, sups.map(lambda a: a[[1, 1]]),
                     sups.map(lambda a: a[[2, 0]]))
    (nbx, nby), (bsx, bsy), (ovx, ovy) = ctx.nblk, ctx.blk_size, ctx.overlap
    logx, logy = ctx.log_ratio_uv
    (hpad, hpad_c), (vpad, vpad_c), (pw, ph) = ctx.hpad, ctx.vpad, ctx.padded
    logp, i32 = ctx.log_pel, torch.int32
    idx = torch.arange(nbx * nby, dtype=i32)
    bx, by = idx % nbx, idx // nbx
    x0, y0 = hpad + (bsx - ovx) * bx, vpad + (bsy - ovy) * by
    xc = hpad_c + ((bsx - ovx) >> logx) * bx
    yc = vpad_c + ((bsy - ovy) >> logy) * by
    # level 0: the search may reach the padded plane's edges
    bounds = (-(x0 << logp), (pw - bsx - x0) << logp,
              -(y0 << logp), (ph - bsy - y0) << logp)
    src_blocks = [_blocks_of(ctx.src_planes[0], vpad, hpad, nby, nbx, bsy,
                             bsx, bsy - ovy, bsx - ovx)]
    if chroma:
        src_blocks += [_blocks_of(ctx.src_planes[p], vpad_c, hpad_c, nby,
                                  nbx, bsy >> logy, bsx >> logx,
                                  (bsy - ovy) >> logy, (bsx - ovx) >> logx)
                       for p in (1, 2)]
    cost = fe.cost_keywords(dctmode, src_blocks[0],
                            torch.tensor([3, 8], dtype=i32), ctx.bits)
    prober = fe.FieldProber(ctx, src_blocks, x0, y0, xc, yc, bounds, 16,
                            **cost)
    rng = np.random.default_rng(seed)
    shape = (2, nbx * nby)

    def ints(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    st = dict(bx=ints(-6, 7), by=ints(-6, 7), bsad=ints(0, 40000),
              mincost=ints(0, 40000).to(torch.int64),
              dir=torch.zeros(shape, dtype=i32))
    lam = torch.from_numpy(rng.integers(0, 3000, shape))
    return prober, st, lam, (ints(-4, 5), ints(-4, 5))


def check_masked_state(family, dctmode, offsets, mask_of):
    """FieldProber.check with an extra_mask (handed to the probes as their
    `active` argument) against _update run on the unmasked probes' SADs with
    the same mask: every field of the state must agree."""
    import torch

    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.ops import probe as probe_ops
    p, st, lam, pred = field_prober(family, dctmode)
    rng = np.random.default_rng(len(offsets) + 10 * dctmode)
    shape = st["bx"].shape
    cand_x = st["bx"] + torch.from_numpy(rng.integers(-3, 4, shape)
                                         .astype(np.int32))
    cand_y = st["by"] + torch.from_numpy(rng.integers(-3, 4, shape)
                                         .astype(np.int32))
    mask = mask_of(rng, shape, len(offsets))
    dir_vals = list(range(len(offsets)))
    got = p.check(st, cand_x, cand_y, offsets, update_xy=False,
                  dir_vals=dir_vals, extra_mask=mask, lam=lam, pred=pred)
    dxmin, dxmax, dymin, dymax = p.bounds
    cvx = torch.minimum(torch.maximum(cand_x, dxmin), dxmax - 1)
    cvy = torch.minimum(torch.maximum(cand_y, dymin), dymax - 1)
    ls = p.luma_sads(cvx, cvy, offsets)
    cs = p.chroma_sads(cvx, cvy, offsets) if p.chroma else None
    ox = torch.tensor([o[0] for o in offsets], dtype=torch.int32)
    oy = torch.tensor([o[1] for o in offsets], dtype=torch.int32)
    want = fe._update(p, st, ls, cs, cand_x[..., None] + ox,
                      cand_y[..., None] + oy, lam, pred, dir_vals=dir_vals,
                      mask=mask, update_xy=False)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # the mask reached the probe: skipped entries came back as sentinels
    act = torch.broadcast_to(mask, ls.shape)
    masked = p.luma_sads(cvx, cvy, offsets, act)
    assert torch.equal(masked[act], ls[act])
    if dctmode:       # the SATD mix of an INVALID_SAD triple
        assert bool((masked[~act] != ls[~act]).any())
    else:
        assert bool((masked[~act] == probe_ops.INVALID_SAD).all())
    assert bool((got["mincost"] < st["mincost"]).any())


def entry_mask(rng, shape, d):
    """A [J, nblk, D] mask, entry by entry."""
    import torch
    return torch.from_numpy(rng.random(shape + (d,)) < 0.4)


def block_mask(rng, shape, d):
    """A [J, nblk, 1] mask, block by block (the rescue's `active`)."""
    import torch
    return torch.from_numpy(rng.random(shape + (1,)) < 0.5)


# ---------------------------------------------------------------------------
# The port's side of the slices (torch only; no JAX run): what the test files
# that compare a slice with its reference share.  Each test file makes them
# in module fixtures of its own; the references above are made once per run.


def gray_port_fields(ref):
    """The port's analyse_batch on the port's own supers of load()'s clip,
    and the host reads it took."""
    import torch

    from mvtools_tpu_torch import analyse_batch
    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.super import build_super
    sspec, aspec = specs(ref)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    src, rf = job_indices()
    before = fe.host_syncs
    mvb = analyse_batch(sups.map(lambda a: a[src]),
                        sups.map(lambda a: a[rf]), aspec)
    return mvb, fe.host_syncs - before


def yuv_clip(ref):
    """load_yuv()'s clip as three uint8 planes [T, h, w]."""
    import torch
    return [torch.from_numpy(ref[k]) for k in "yuv"]


def yuv_jax_fields(ref, device="cpu"):
    """load_yuv()'s analysed fields as the port's MVField."""
    from mvtools_tpu_torch import convert
    meta = json.loads(str(ref["aspec_json"]))["meta"]
    return convert.mvfield_from_numpy(
        [(ref[f"mv_x{lv}"], ref[f"mv_y{lv}"], ref[f"mv_sad{lv}"])
         for lv in range(YUV_LEVELS)], meta, device)


def yuv_jobs(mvb, sl):
    """The jobs `sl` of a batched field."""
    from mvtools_tpu_torch.core.types import MVField, MVPlaneField
    return MVField(tuple(MVPlaneField(l.x[sl], l.y[sl], l.sad[sl])
                         for l in mvb.levels), mvb.validity[sl], mvb.meta)


def yuv_port_run(ref):
    """The port's own supers of load_yuv()'s clip and its analyse_batch over
    the jobs of both directions, with every per-block probe call noted:
    (supers, field, [(stack plane shape, blocks)])."""
    from mvtools_tpu_torch import analyse_batch
    from mvtools_tpu_torch.ops import probe as probe_ops
    from mvtools_tpu_torch.super import build_super
    sspec, aspec = specs(ref)
    sups = build_super(yuv_clip(ref), sspec)
    src, rf = yuv_job_indices()
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


def yuv_degrain_run(ref, sups):
    """Overlapped three-plane Degrain2 on the port's supers, batched over
    the clip's frames, on the JAX side's vectors, clip-edge validity
    included."""
    from mvtools_tpu_torch.degrain import DegrainConfig, degrain
    from mvtools_tpu_torch.models.denoise import (edge_validity,
                                                  neighbour_index)
    t, r = YUV_FRAMES, YUV_RADIUS
    _, aspec = specs(ref)
    mvb = yuv_jax_fields(ref)
    nj = t * r
    nxt, prv = neighbour_index(t, r, +1, "cpu"), neighbour_index(t, r, -1,
                                                                 "cpu")
    prev_ok, next_ok = edge_validity(t, r, "cpu")
    sups_r, mvs, valid = [], [], []
    for k in range(r):
        sl = slice(k * t, (k + 1) * t)
        sups_r += [sups.map(lambda a: a[nxt[sl]]),
                   sups.map(lambda a: a[prv[sl]])]
        mvs += [yuv_jobs(mvb, sl),
                yuv_jobs(mvb, slice(nj + k * t, nj + (k + 1) * t))]
        valid += [next_ok[:, k], prev_ok[:, k]]
    return degrain(yuv_clip(ref), sups_r, mvs, aspec.meta,
                   DegrainConfig(thsad=400), valid=valid)


def yuv_clip_run(ref):
    """degrain_clip on load_yuv()'s clip with the jobs of a direction (6)
    split over two analyse_batch calls, as a long clip's are: (planes,
    info)."""
    from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
    from mvtools_tpu_torch.models import denoise
    scfg, acfg, dcfg, _ = denoise.flagship_configs()
    info = {}
    whole = denoise._MAX_JOBS
    denoise._MAX_JOBS = 4
    try:
        out = denoise.degrain_clip(
            yuv_clip(ref), VideoFormat(YUV_W, YUV_H, 8, ColorFamily.YUV420),
            scfg, acfg, dcfg, radius=YUV_RADIUS, info=info)
    finally:
        denoise._MAX_JOBS = whole
    return out, info


def satd_port_configs():
    """The SATD slice's (sspec, aspec, rcfg, rspec) in the port."""
    import mvtools_tpu_torch as port
    from mvtools_tpu_torch.core import config, types
    return satd_configs(config, types, port)


def satd_run(ref):
    """The port's SATD chain on the port's own supers of load_satd()'s
    clip: (analysed field, host syncs of Analyse, refined field, denoised
    frames)."""
    import torch

    import mvtools_tpu_torch as port
    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.core.types import MVField, MVPlaneField
    from mvtools_tpu_torch.degrain import DegrainConfig, degrain
    from mvtools_tpu_torch.super import build_super
    sspec, aspec, rcfg, rspec = satd_port_configs()
    frames = torch.from_numpy(ref["frames"])
    sups = build_super([frames], sspec)
    src, rf = satd_job_indices()
    sup_s, sup_r = sups.map(lambda a: a[src]), sups.map(lambda a: a[rf])
    before = fe.host_syncs
    mvb = port.analyse_batch(sup_s, sup_r, aspec)
    syncs = fe.host_syncs - before
    refined = port.recalculate(sup_s, sup_r, mvb, rspec, rcfg)
    n_out = SATD_FRAMES - 2 * SATD_RADIUS

    def job(t, j):
        return t.reshape((n_out, 2) + t.shape[1:])[:, j]

    lv = refined.levels[0]
    mvs = [MVField((MVPlaneField(job(lv.x, j), job(lv.y, j),
                                 job(lv.sad, j)),),
                   job(refined.validity, j), refined.meta) for j in (0, 1)]
    sups_r = [sup_r.map(lambda a, j=j: job(a, j).contiguous())
              for j in (0, 1)]
    out = degrain([frames[SATD_RADIUS:SATD_RADIUS + n_out]], sups_r, mvs,
                  rspec.meta, DegrainConfig(thsad=400))[0]
    return mvb, syncs, refined, out


def _recalculate_on_jax_field(ref, configs, sup_levels, levels, src, rf):
    """Recalculate held alone: fed the JAX package's pyramids (sup_levels
    levels) and the JAX package's analysed field (levels levels) through
    convert.py."""
    import mvtools_tpu_torch as port
    from mvtools_tpu_torch import convert
    sspec, aspec, rcfg, rspec = configs
    sups = convert.super_from_numpy(
        [[ref[f"super{lv}"] for lv in range(sup_levels)]], sspec,
        device="cpu")
    old = convert.mvfield_from_numpy(
        [tuple(ref[f"mv_{k}{lv}"] for k in ("x", "y", "sad"))
         for lv in range(levels)],
        convert.spec_to_dict(aspec.meta), device="cpu")
    return port.recalculate(sups.map(lambda a: a[src]),
                            sups.map(lambda a: a[rf]), old, rspec, rcfg)


def satd_recalc_on_jax_field(ref):
    """The SATD slice's Recalculate on the JAX side's pyramids and field."""
    src, rf = satd_job_indices()
    configs = satd_port_configs()
    return _recalculate_on_jax_field(ref, configs, configs[0].levels,
                                     SATD_LEVELS, src, rf)


def dct_port_configs():
    """The DCT slice's (sspec, aspec, rcfg, rspec) in the port."""
    import mvtools_tpu_torch as port
    from mvtools_tpu_torch.core import config, types
    return dct_configs(config, types, port)


def dct_run(ref):
    """The port's DCT chain on the port's own supers of load_dct()'s clip:
    (analysed field, refined field, blocks the rescue took, the fetch calls
    by plain version)."""
    import torch

    import mvtools_tpu_torch as port
    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.ops import probe as probe_ops
    from mvtools_tpu_torch.super import build_super
    sspec, aspec, rcfg, rspec = dct_port_configs()
    src, rf = list(DCT_SRC), list(DCT_REF)
    sups = build_super([torch.from_numpy(ref["frames"])], sspec)
    sup_s, sup_r = sups.map(lambda a: a[src]), sups.map(lambda a: a[rf])
    calls = {"fetch_blocks_plain": [], "fetch_blocks_tiled_plain": []}
    plain = {k: getattr(probe_ops, k) for k in calls}

    def spy(name):
        def call(stack, cand_y, *args):
            calls[name].append(tuple(stack.shape[-2:]))
            return plain[name](stack, cand_y, *args)
        return call

    before = fe.rescued_blocks
    for k in calls:
        setattr(probe_ops, k, spy(k))
    try:
        mvb = port.analyse_batch(sup_s, sup_r, aspec)
        rescued = fe.rescued_blocks - before
        refined = port.recalculate(sup_s, sup_r, mvb, rspec, rcfg)
    finally:
        for k, fn in plain.items():
            setattr(probe_ops, k, fn)
    return mvb, refined, rescued, calls


def dct_recalc_on_jax_field(ref):
    """The DCT slice's Recalculate on the JAX side's pyramids and field."""
    return _recalculate_on_jax_field(ref, dct_port_configs(), DCT_LEVELS,
                                     DCT_LEVELS, list(DCT_SRC),
                                     list(DCT_REF))


def recalc_clip(ref):
    """load_recalc() with the pyramids as a list and the old field as a
    triple."""
    return dict(ref, planes=list(ref["planes"]),
                old=(ref["old_x"], ref["old_y"], ref["old_sad"]))


def recalc_port_inputs(clip, jobs, rcfg_kw):
    """The port's (src, ref, old field, rspec, rcfg) of load_recalc()'s
    jobs `jobs` under a Recalculate configuration."""
    import numpy as np

    import mvtools_tpu_torch as port
    from mvtools_tpu_torch import convert
    from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
    fmt = VideoFormat(RC_W, RC_H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=RC_PEL, levels=1, chroma=False).validate(fmt)
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


def recalc_results(clip, names):
    """Per configuration of RC_CONFIGS named: the port's batched [J = 2]
    result, the JAX package's result of each job and the port's inputs."""
    import mvtools_tpu_torch as port
    from mvtools_tpu_torch.ops import probe as probe_ops
    out = {}
    for name in names:
        args = recalc_port_inputs(clip, (0, 1),
                                  recalc_kw(port, RC_CONFIGS[name]))
        before = dict(probe_ops.launches)
        got = port.recalculate(*args)
        assert dict(probe_ops.launches) == before      # CPU: no launch
        want = [tuple(clip[f"{name}_{k}"][j] for k in ("x", "y", "sad"))
                for j in (0, 1)]
        out[name] = (got, want, args)
    return out
