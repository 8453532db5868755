"""Shared JAX-side reference for the tests of the PyTorch port
(tests/test_torch_*.py).

The JAX lockstep engine is slow to compile on the CPU, so ONE small
geometry is run through the JAX package once per test run — supers,
one analyse_batch call, degrain per output frame — and cached as an .npz
that every test file (and every pytest-xdist worker) loads.  The first
worker to take the lock computes; the others wait for the file.

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


def load(tmp_path_factory) -> dict:
    """The reference arrays, computed at most once per test run."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent              # shared by all workers of the run
    final = base / "torch_port_reference.npz"
    lock = base / "torch_port_reference.lock"
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
            tmp = base / f"torch_port_reference.{os.getpid()}.tmp.npz"
            np.savez(tmp, **_compute())
            os.replace(tmp, final)
        finally:
            os.unlink(lock)
    with np.load(final) as z:
        return {k: z[k] for k in z.files}


def specs(ref: dict):
    """The port's (SuperSpec, AnalyseSpec) rebuilt from the JAX specs,
    carried across as plain dicts."""
    from mvtools_tpu_torch import convert
    return (convert.super_spec_from_dict(json.loads(str(ref["sspec_json"]))),
            convert.analyse_spec_from_dict(json.loads(str(ref["aspec_json"]))))
