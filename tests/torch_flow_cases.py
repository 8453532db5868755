"""Shared inputs of the tests that hold the port's motion-compensated
consumers (tests/test_torch_flow*.py, test_torch_consumers*.py) to the JAX
package: seeded frames, supers from build_super in each package, and
synthetic motion-vector fields (smooth vectors with noise, SADs spread over
and under the scene-change thresholds), handed to both sides.  No JAX
analysis runs here: the fields are made with numpy.

Every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer)."""

import dataclasses
import functools

import numpy as np


def frames(rng, n, w, h, bits=8, family="GRAY"):
    """n frames as lists of numpy planes ([Y] or [Y, U, V], 4:2:0): one
    smooth-ish noise image per plane, panned one pixel per frame, with
    fresh noise of +-3."""
    subs = (0,) if family == "GRAY" else (0, 1, 1)
    out = [[] for _ in range(n)]
    for sub in subs:
        pw, ph = w >> sub, h >> sub
        base = rng.integers(0, 256, (ph + 8, pw + 8)).astype(np.int64)
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, (1, 1), (0, 1))) // 4
        for i in range(n):
            p = base[i:i + ph, i:i + pw] + rng.integers(-3, 4, (ph, pw))
            p = np.clip(p, 0, 255)
            if bits > 8:
                p = (p << (bits - 8)) | rng.integers(0, 1 << (bits - 8),
                                                      p.shape)
                out[i].append(p.astype(np.uint16))
            else:
                out[i].append(p.astype(np.uint8))
    return out


def specs(w, h, pel=2, blksize=8, overlap=0, bits=8, family="GRAY",
          isb=True):
    """(JAX SuperSpec, JAX AnalyseSpec, port SuperSpec, port AnalyseSpec)
    of one configuration."""
    from mvtools_tpu.core.config import AnalyseConfig, SuperConfig
    from mvtools_tpu.core.types import ColorFamily, VideoFormat
    from mvtools_tpu_torch import convert

    chroma = family != "GRAY"
    fmt = VideoFormat(w, h, bits, ColorFamily[family])
    sspec = SuperConfig(pel=pel, chroma=chroma).validate(fmt)
    aspec = AnalyseConfig(blksize=blksize, overlap=overlap, truemotion=True,
                          chroma=chroma, isb=isb).validate(sspec)
    return (sspec, aspec,
            convert.super_spec_from_dict(dataclasses.asdict(sspec)),
            convert.analyse_spec_from_dict(dataclasses.asdict(aspec)))


@functools.lru_cache(maxsize=None)
def _jax_build(sspec):
    import jax
    import mvtools_tpu as mvt
    return jax.jit(lambda p: mvt.build_super(list(p), sspec))


def supers(planes, sspec, tsspec):
    """(JAX Super, port Super) of one frame's numpy planes."""
    import jax.numpy as jnp
    import torch
    from mvtools_tpu_torch.super import build_super

    return (_jax_build(sspec)(tuple(jnp.asarray(p) for p in planes)),
            build_super([torch.from_numpy(p) for p in planes], tsspec))


def field_arrays(rng, meta, spread=3, base=(3, -2), sad_hi=0.0):
    """(vx, vy, sad) numpy arrays [blk_y, blk_x] of a smooth field with
    noise: a constant motion `base` (pel units) plus a slow ramp plus noise
    of +-spread, and SADs below thscd1's default scale, sad_hi of them far
    over it."""
    nby, nbx = meta.blk_y, meta.blk_x
    yy, xx = np.mgrid[0:nby, 0:nbx]
    vx = base[0] + (xx * 4) // max(nbx, 1) + rng.integers(-spread, spread + 1,
                                                         (nby, nbx))
    vy = base[1] - (yy * 3) // max(nby, 1) + rng.integers(-spread,
                                                         spread + 1,
                                                         (nby, nbx))
    area = meta.blk_size_x * meta.blk_size_y
    sad = rng.integers(0, 5 * area, (nby, nbx)).astype(np.int64)
    hi = rng.random((nby, nbx)) < sad_hi
    sad[hi] = rng.integers(40 * area, 200 * area, int(hi.sum()))
    return vx.astype(np.int32), vy.astype(np.int32), sad


def fields(arrays, meta, tmeta, validity=1):
    """(JAX MVField, port MVField) of one level's (vx, vy, sad) arrays."""
    import jax.numpy as jnp
    import torch
    from mvtools_tpu.core.types import MVField, MVPlaneField
    from mvtools_tpu_torch.core.types import MVField as TField
    from mvtools_tpu_torch.core.types import MVPlaneField as TPlane

    vx, vy, sad = arrays
    jf = MVField((MVPlaneField(jnp.asarray(vx), jnp.asarray(vy),
                               jnp.asarray(sad)),),
                 jnp.asarray(validity, jnp.int32), meta)
    tf = TField((TPlane(torch.from_numpy(vx), torch.from_numpy(vy),
                        torch.from_numpy(sad)),),
                torch.tensor(validity, dtype=torch.int32), tmeta)
    return jf, tf


def meta_pair(aspec, is_backward):
    """(JAX meta, port meta) with is_backward set."""
    from mvtools_tpu_torch import convert

    meta = dataclasses.replace(aspec.meta, is_backward=is_backward)
    return meta, convert.analysis_meta_from_dict(dataclasses.asdict(meta))


def equal(got, want, msg=""):
    """got: a tensor or a list of tensors; want: JAX arrays alike."""
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            equal(g, w, f"{msg} [{i}]")
        return
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    assert g.dtype == w.dtype, f"{msg}: dtype {g.dtype} != {w.dtype}"
    np.testing.assert_array_equal(g, w, err_msg=msg)


# (family, w, h, pel, blksize, overlap): gray 64x48 pel 2 blk 8; YUV420
# 72x56 pel 1 blk 16 overlap 4, whose block grid (5 x 4) is padded to
# cover the frame
CONFIGS = (("GRAY", 64, 48, 2, 8, 0), ("YUV420", 72, 56, 1, 16, 4))


def setup(cfg, n=2):
    """The inputs of one configuration: specs, n frames' numpy planes, and
    their supers built by each package (held equal here)."""
    family, w, h, pel, blk, ov = cfg
    sspec, aspec, tsspec, taspec = specs(w, h, pel=pel, blksize=blk,
                                         overlap=ov, family=family)
    rng = np.random.default_rng(w)
    planes = frames(rng, n, w, h, family=family)
    jsups, tsups = zip(*(supers(fr, sspec, tsspec) for fr in planes))
    for js, ts in zip(jsups, tsups):       # the same supers on both sides
        for jp, tp in zip(js.planes, ts.planes):
            for jl, tl in zip(jp, tp):
                equal(tl, jl, "super")
    return dict(cfg=cfg, sspec=sspec, aspec=aspec, tsspec=tsspec,
                taspec=taspec, planes=planes, jsups=jsups, tsups=tsups,
                rng=rng)


def make_fields(s, is_backward, sad_hi, validity=1, **kw):
    """(JAX MVField, port MVField) of a synthetic field for setup s."""
    meta, tmeta = meta_pair(s["aspec"], is_backward)
    return fields(field_arrays(s["rng"], meta, sad_hi=sad_hi, **kw), meta,
                  tmeta, validity)
