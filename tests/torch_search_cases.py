"""One pyramid level searched by both packages: the field-level tests of the
searches, trymany and the ring rescue (tests/test_torch_searches*.py).

A seeded gray (or YUV420) clip of three frames, with a region that is dark in
every frame and saturated in frame 1 (so that blocks turn bad and the rescue
runs), at 16 bits each sample v as (v << 8) | r with r a fresh seeded byte, is
built into a Super by each package; two jobs pair frame 1 with frames 2 and 0.
One level is then searched from a seeded inter-level prediction and a
global vector per job by the JAX package's search_level_lockstep (one job
at a time, eager: jitted, NSTEP runs for minutes at this size; computed in
torch_port_reference.load_opts()) and by the port's (both jobs in one
batch), with the level's plan changed to the case's search, search
parameter, trymany and badrange. On a pel-1/2 level whose geometry the dense map serves, the search
runs on MapProber lookups; at pel 4 every candidate is probed."""
import dataclasses

import numpy as np

W, H, SEED = 512, 96, 43
FLASH = (16, 64, 48, 96)           # y, x, h, w
LEVELS = 2


def make_planes(family: str, bits: int = 8, seed: int = SEED):
    """[Y] or [Y, U, V] planes [3, h, w] of the case's clip, uint8 or (16
    bits) uint16."""
    rng = np.random.default_rng(seed)
    y0, x0, fh, fw = FLASH

    def plane(h, w, f):
        base = rng.integers(0, 256, (h + 32, w + 32), np.uint8)
        out = np.empty((3, h, w), np.uint8)
        fy, fx, ffh, ffw = (v // f for v in (y0, x0, fh, fw))
        for i in range(3):
            dy, dx = (i * 2) // f % 16, (i * 3) // f % 16
            out[i] = base[dy:dy + h, dx:dx + w]
            region = out[i, fy:fy + ffh, fx:fx + ffw]
            out[i, fy:fy + ffh, fx:fx + ffw] = (255 if i == 1
                                                else region >> 2)
        return out

    planes = [plane(H, W, 1)]
    if family == "YUV420":
        planes += [plane(H // 2, W // 2, 2), plane(H // 2, W // 2, 2)]
    if bits == 16:
        planes = [(p.astype(np.uint16) << 8)
                  | rng.integers(0, 256, p.shape, np.uint16) for p in planes]
    return planes


def configs(config, types, pel: int, family: str, bits: int = 8):
    """(SuperSpec, backward AnalyseSpec) of either package."""
    chroma = family != "GRAY"
    fmt = types.VideoFormat(W, H, bits, getattr(types.ColorFamily, family))
    sspec = config.SuperConfig(pel=pel, levels=LEVELS,
                               chroma=chroma).validate(fmt)
    aspec = dataclasses.replace(config.AnalyseConfig(
        blksize=16, levels=LEVELS, overlap=8 if chroma else 0,
        chroma=chroma, truemotion=True), isb=True).validate(sspec)
    return sspec, aspec


GLOBAL = (np.array([2, -1], np.int32), np.array([-1, 1], np.int32))


def prediction(nblk: int, pel: int, seed: int):
    """(x, y, sad) [2, nblk] seeded inter-level prediction: the clip's pan
    (-3, -2) px, off by a few pel in a third of the blocks."""
    rng = np.random.default_rng(seed)
    x = np.full((2, nblk), -3 * pel, np.int32)
    y = np.full((2, nblk), -2 * pel, np.int32)
    x[1], y[1] = -x[1], -y[1]
    off = rng.random((2, nblk)) < 0.33
    x += np.where(off, rng.integers(-3 * pel, 3 * pel + 1, x.shape),
                  0).astype(np.int32)
    y += np.where(off, rng.integers(-3 * pel, 3 * pel + 1, y.shape),
                  0).astype(np.int32)
    sad = rng.integers(0, 4000, (2, nblk)).astype(np.int64)
    return x, y, sad


CASES = [
    # (level, pel, family, bits, plan): plan["search"] a SearchType value
    (0, 4, "GRAY", 8, dict(search=0, param=2)),
    (0, 2, "GRAY", 8, dict(search=1, param=3, trymany=True, badrange=-4)),
    (0, 2, "GRAY", 8, dict(search=2, param=8, badrange=-3)),
    (0, 4, "GRAY", 16, dict(search=5, param=8, badrange=-2)),
    (1, 2, "GRAY", 8, dict(search=6, param=3)),
    (0, 4, "YUV420", 8, dict(search=7, param=2)),
]
IDS = ["ONETIME", "NSTEP", "LOGARITHMIC", "UMH", "HORIZONTAL", "VERTICAL"]


def _plan(types, plan):
    return dict(plan, search=types.SearchType(plan["search"]))


def jax_case(level: int, pel: int, family: str, bits: int, plan: dict,
             seed: int = 5):
    """(x, y, sad) of the JAX package for one level, each [2, nblk] numpy
    arrays.  `plan` updates the level's search plan (search, param,
    trymany, badrange, ...)."""
    import importlib

    import jax
    import jax.numpy as jnp

    import mvtools_tpu as mvt
    from mvtools_tpu.core import config as jconfig
    from mvtools_tpu.core import types as jtypes

    # the package exports the function analyse, which shadows the module
    ja = importlib.import_module("mvtools_tpu.analyse")
    planes = make_planes(family, bits)
    sspec, aspec = configs(jconfig, jtypes, pel, family, bits)
    # jitted: an eager pel-4 Super costs seconds of op dispatch a frame
    build = jax.jit(lambda *f: mvt.build_super(list(f), sspec))
    sups = [build(*(jnp.asarray(p[i]) for p in planes)) for i in range(3)]
    jplan = dict(ja._level_plan(aspec, level), **_plan(jtypes, plan))
    ctx0 = ja._level_ctx(sups[1], sups[2], aspec, level)
    x, y, sad = prediction(ctx0.nblk[0] * ctx0.nblk[1], ctx0.pel, seed)
    gx, gy = GLOBAL

    def one(src_planes, ref_stacks, vx, vy, vs, gxj, gyj):
        ctx = ctx0._replace(src_planes=src_planes, ref_stacks=ref_stacks)
        vec, _ = ja.search_level_lockstep(
            ctx, aspec, jplan, (vx, vy, vs), (gxj, gyj), jnp.int32(0),
            jnp.int32(0), iters=1)
        return vec

    want = []
    for j, r in enumerate((2, 0)):
        ctx_j = ja._level_ctx(sups[1], sups[r], aspec, level)
        want.append(one(ctx_j.src_planes, ctx_j.ref_stacks, x[j], y[j],
                        sad[j], gx[j], gy[j]))
    return tuple(np.stack([np.asarray(w[k]) for w in want])
                 for k in range(3))


def port_case(level: int, pel: int, family: str, bits: int, plan: dict,
              seed: int = 5):
    """((x, y, sad) of the port for one level, each [2, nblk] numpy arrays,
    with both jobs in one batch; the blocks its rescue took; its host
    reads)."""
    import importlib

    import torch

    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.core import config as pconfig
    from mvtools_tpu_torch.core import types as ptypes
    from mvtools_tpu_torch.super import build_super

    pa = importlib.import_module("mvtools_tpu_torch.analyse")
    planes = make_planes(family, bits)
    sspec, aspec = configs(pconfig, ptypes, pel, family, bits)
    sups = build_super([torch.from_numpy(p) for p in planes], sspec)
    pplan = dict(pa._level_plan(aspec, level), **_plan(ptypes, plan))
    ctx = pa._level_ctx(sspec, aspec, level, sups.map(lambda a: a[[1, 1]]),
                        sups.map(lambda a: a[[2, 0]]))
    x, y, sad = prediction(ctx.nblk[0] * ctx.nblk[1], ctx.pel, seed)
    rescued, syncs = fe.rescued_blocks, fe.host_syncs
    got, _ = pa.search_level_lockstep(
        ctx, pplan, tuple(torch.from_numpy(a) for a in (x, y, sad)),
        tuple(torch.from_numpy(g) for g in GLOBAL),
        torch.zeros(2, dtype=torch.int32))
    got = tuple(g.numpy() for g in got)
    return got, fe.rescued_blocks - rescued, fe.host_syncs - syncs


def assert_equal(want, got, what):
    for k, w, g in zip("xy", want[:2], got[:2]):
        assert np.array_equal(w, g), (what, k, int((w != g).sum()))
    assert np.array_equal(want[2], got[2]), (what, "sad")
