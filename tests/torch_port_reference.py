"""Shared JAX-side reference for the tests of the PyTorch port
(tests/test_torch_*.py).

The JAX lockstep engine is slow to compile on the CPU, so each of TWO
small geometries is run through the JAX package once per test run — supers,
one analyse_batch call, degrain per output frame — and cached as an .npz
that every test file (and every pytest-xdist worker) loads.  The first
worker to take a run's lock computes it; the others wait for the file.

* load(): gray, 3 levels, no overlap, radius 1 (the headline path).
* load_yuv(): YUV420, levels=0 (4 levels at this size), overlap 8, chroma,
  radius 2 over a 3-frame clip, so every clip-edge case occurs.  The clip
  flashes over most of the frame, which makes blocks bad at every level;
  the level-2 chroma stacks (448 wide) and all level-3 stacks (480 wide) are
  narrower than the tiled probe's 512-wide window, so the rescue's probes
  there go through the per-block probe.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses
import json
import os
import time

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


def _load(tmp_path_factory, stem: str, compute) -> dict:
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent              # shared by all workers of the run
    final = base / f"{stem}.npz"
    lock = base / f"{stem}.lock"
    deadline = time.time() + 1200
    while not final.exists():
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            if time.time() > deadline:
                raise RuntimeError("timed out waiting for the JAX reference")
            time.sleep(0.5)
            continue
        os.close(fd)
        try:
            tmp = base / f"{stem}.{os.getpid()}.tmp.npz"
            np.savez(tmp, **compute())
            os.replace(tmp, final)
        finally:
            os.unlink(lock)
    with np.load(final) as z:
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
                    flash=YUV_FLASH, noise=YUV_NOISE, pan=YUV_PAN):
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
    degrain has something to average."""
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


def load(tmp_path_factory) -> dict:
    """The gray reference arrays, computed at most once per test run."""
    return _load(tmp_path_factory, "torch_port_reference", _compute)


def load_yuv(tmp_path_factory) -> dict:
    """The YUV420 reference arrays, computed at most once per test run."""
    return _load(tmp_path_factory, "torch_port_reference_yuv", _compute_yuv)


def specs(ref: dict):
    """The port's (SuperSpec, AnalyseSpec) rebuilt from the JAX specs,
    carried across as plain dicts."""
    from mvtools_tpu_torch import convert
    return (convert.super_spec_from_dict(json.loads(str(ref["sspec_json"]))),
            convert.analyse_spec_from_dict(json.loads(str(ref["aspec_json"]))))
