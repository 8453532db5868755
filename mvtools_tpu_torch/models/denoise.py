"""Frame-batched temporal denoise (mv.Super -> mv.Analyse -> mv.Degrain).

degrain_clip denoises a whole clip with temporal radius N (the canonical
Super -> Analyse(backward + forward, radius N) -> DegrainN graph);
degrain_window the inner frames of a window of luma frames.

Clip-edge semantics match the reference: a neighbour beyond the clip is
edge-replicated for shape uniformity but marked invalid, so Degrain gives
it weight 0 — the behaviour of the reference's default all-invalid field at
clip edges (MVAnalyse.c:219-222, GroupOfPlanes.c:150-164, MVDegrains.h
thSCD gate).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyse import _check_ported, analyse_batch
from ..core.config import (AnalyseConfig, AnalyseSpec, SuperConfig,
                           SuperSpec)
from ..convert import require_device
from ..core.types import ColorFamily, MVField, MVPlaneField, VideoFormat
from ..degrain import DegrainConfig, degrain
from ..super import build_super


def degrain_window(window: torch.Tensor, sspec: SuperSpec,
                   aspec: AnalyseSpec, dcfg: DegrainConfig,
                   radius: int = 1, info: Optional[dict] = None):
    """Denoise the inner frames of a window of luma frames.

    window: [B + 2*radius, H, W] uint8, on the device the work should run
    on -> [B, H, W] denoised frames B = window frames minus the `radius`
    frames of context on either side.

    One program serves the whole window: the supers of all frames are built
    in one batch, all 2*radius*B analyses run as ONE analyse_batch call
    (job order per output frame: backward 1, forward 1, backward 2, ...),
    and degrain runs batched over the output frames.  `info`, if given,
    receives the batched MV field under "fields" and, when the window is on
    a CUDA device, CUDA events around the three stages under "events"
    ("super", "analyse", "degrain": (start, end))."""
    batch = window.shape[0] - 2 * radius
    if batch < 1:
        raise ValueError("degrain_window: window shorter than 2*radius + 1")
    dev = window.device

    def mark():
        if info is None or dev.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    t0 = mark()
    sups = build_super([window], sspec)
    t1 = mark()
    src_idx, ref_idx = [], []
    for i in range(batch):
        c = i + radius
        for k in range(1, radius + 1):
            src_idx += [c, c]
            ref_idx += [c + k, c - k]
    src_t = torch.tensor(src_idx, device=dev)
    ref_t = torch.tensor(ref_idx, device=dev)
    sup_ref = sups.map(lambda a: a[ref_t])
    mvb = analyse_batch(sups.map(lambda a: a[src_t]), sup_ref, aspec)
    t2 = mark()
    j_per = 2 * radius

    def job(t, j):
        return t.reshape((batch, j_per) + t.shape[1:])[:, j]

    mvs = [MVField(tuple(MVPlaneField(job(l.x, j), job(l.y, j), job(l.sad, j))
                         for l in mvb.levels), job(mvb.validity, j), mvb.meta)
           for j in range(j_per)]
    sups_r = [sup_ref.map(lambda a, j=j: job(a, j).contiguous())
              for j in range(j_per)]
    out = degrain([window[radius:radius + batch]], sups_r, mvs, aspec.meta,
                  dcfg)[0]
    t3 = mark()
    if info is not None:
        info["fields"] = mvb
        if t0 is not None:
            info["events"] = dict(super=(t0, t1), analyse=(t1, t2),
                                  degrain=(t2, t3))
    return out


def edge_validity(total: int, radius: int, device):
    """(prev_ok, next_ok), each [total, radius] bool: prev_ok[t, k-1] iff
    frame t - k exists, next_ok[t, k-1] iff frame t + k does.  Where False,
    the reference produces a default all-invalid MV field
    (MVAnalyse.c:219-222) and Degrain gives the neighbour weight 0."""
    t = torch.arange(total, device=device)[:, None]
    k = torch.arange(1, radius + 1, device=device)[None, :]
    return t - k >= 0, t + k <= total - 1


def neighbour_index(total: int, radius: int, sign: int, device):
    """[radius * total] frame index of the k-th neighbour of every frame in
    direction `sign` (+1 later, -1 earlier), entry (k-1)*total + t, clamped
    into the clip: a neighbour past the edge is the edge frame."""
    t = torch.arange(total, device=device).repeat(radius)
    k = torch.arange(1, radius + 1, device=device).repeat_interleave(total)
    return (t + sign * k).clamp(0, total - 1)


# Analyse jobs handed to one analyse_batch call; a longer clip's jobs run
# in chunks, so that the level-0 SAD maps of one call (about 70 MB per
# 1080p job with chroma and overlap 8) stay a few GB.
_MAX_JOBS = 48


def _analyse_jobs(sups, src_t, ref_t, aspec) -> MVField:
    parts = [analyse_batch(sups.map(lambda a: a[src_t[j:j + _MAX_JOBS]]),
                           sups.map(lambda a: a[ref_t[j:j + _MAX_JOBS]]),
                           aspec)
             for j in range(0, src_t.shape[0], _MAX_JOBS)]
    return MVField(
        tuple(MVPlaneField(*(torch.cat([getattr(p.levels[lv], key)
                                        for p in parts])
                             for key in ("x", "y", "sad")))
              for lv in range(len(parts[0].levels))),
        torch.cat([p.validity for p in parts]), parts[0].meta)


def degrain_clip(clip_planes: Sequence[torch.Tensor], fmt: VideoFormat,
                 scfg: SuperConfig = SuperConfig(),
                 acfg: AnalyseConfig = AnalyseConfig(),
                 dcfg: DegrainConfig = DegrainConfig(), radius: int = 1,
                 engine: str = "lockstep", mesh=None, spatial=None,
                 info: Optional[dict] = None) -> List[torch.Tensor]:
    """Denoise a whole clip with temporal radius N.

    clip_planes: [T, H, W] uint8 per color plane ([Y] or [Y, U, V]), on the
    device the work should run on -> the denoised planes, same shapes.

    Each frame's super is built once; the (frame, delta) pairs of one
    direction are one analyse_batch call (job (k-1)*T + t pairs frame t
    with frame t +- k); degrain runs batched over the frames with its
    references in Backward1, Forward1, Backward2, ... order.  Frames near
    the clip edges mark the missing neighbours invalid instead of wrapping.

    Only engine="lockstep" on one device is ported.  `info`, if given,
    receives the batched MV fields under "fields_b" / "fields_f" and, when
    the clip is on a CUDA device, CUDA events around the three stages under
    "events" ("super", "analyse", "degrain": (start, end))."""
    if engine == "exact":
        raise NotImplementedError(
            'degrain_clip: engine="exact" (the sequential block scan) is '
            "not ported")
    if engine != "lockstep":
        raise ValueError(f"degrain_clip: unknown engine {engine!r}")
    if mesh is not None or spatial is not None:
        raise NotImplementedError(
            "degrain_clip: sharding over a device mesh is not ported")
    if acfg.fields:
        raise NotImplementedError(
            "degrain_clip: fields=True (interlaced input) is not ported")
    sspec = scfg.validate(fmt)
    aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
    aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    _check_ported(aspec_b, sspec, 0)     # before any work is done
    clip_planes = list(clip_planes)
    total = clip_planes[0].shape[0]
    dev = clip_planes[0].device

    def mark():
        if info is None or dev.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    t0 = mark()
    sups = build_super(clip_planes, sspec)
    t1 = mark()
    cur = torch.arange(total, device=dev).repeat(radius)
    nxt = neighbour_index(total, radius, +1, dev)
    prv = neighbour_index(total, radius, -1, dev)
    mvs_b = _analyse_jobs(sups, cur, nxt, aspec_b)
    mvs_f = _analyse_jobs(sups, cur, prv, aspec_f)
    t2 = mark()
    prev_ok, next_ok = edge_validity(total, radius, dev)

    def delta(mv: MVField, k: int) -> MVField:
        sl = slice(k * total, (k + 1) * total)
        return MVField(tuple(MVPlaneField(l.x[sl], l.y[sl], l.sad[sl])
                             for l in mv.levels), mv.validity[sl], mv.meta)

    sups_r, mvs, valid = [], [], []
    for k in range(radius):
        sl = slice(k * total, (k + 1) * total)
        sups_r += [sups.map(lambda a: a[nxt[sl]]),
                   sups.map(lambda a: a[prv[sl]])]
        mvs += [delta(mvs_b, k), delta(mvs_f, k)]
        valid += [next_ok[:, k], prev_ok[:, k]]
    out = degrain(clip_planes, sups_r, mvs, aspec_b.meta, dcfg, valid=valid)
    t3 = mark()
    if info is not None:
        info["fields_b"], info["fields_f"] = mvs_b, mvs_f
        if t0 is not None:
            info["events"] = dict(super=(t0, t1), analyse=(t1, t2),
                                  degrain=(t2, t3))
    return out


def headline_specs(width: int = 1920, height: int = 1080, blksize: int = 16,
                   levels: int = 3):
    """(SuperSpec, AnalyseSpec, DegrainConfig) of the headline pipeline:
    gray 8-bit, pel 2, `levels` pyramid levels, truemotion search, thsad
    400."""
    fmt = VideoFormat(width, height, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=levels, chroma=False).validate(fmt)
    acfg = AnalyseConfig(blksize=blksize, levels=levels, truemotion=True,
                         chroma=False)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    return sspec, aspec, DegrainConfig(thsad=400)


def make_test_clip(frames: int, width: int = 1920, height: int = 1080,
                   seed: int = 0, flash: Optional[Tuple[int, int, int, int]]
                   = None, device="cuda") -> torch.Tensor:
    """[frames, H, W] uint8 test clip: one uniform-noise plane panned by
    (2, 3) pixels per frame (mod 16).

    flash = (y, x, h, w) adds a flashing region: it is dark (pixel >> 2)
    in every frame and saturated (255) in every third frame, starting with
    frame 1.  Between a flash frame and its neighbours every pixel of the
    region then differs by at least 192 at every candidate vector, so
    finest-level block SADs exceed any bad-SAD threshold the way a camera
    flash or a cut does, and the search's rescue runs.  (Shifted noise alone
    never does: a mismatched block of uniform noise costs ~85 per pixel.)"""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (height + 32, width + 32), np.uint8)
    out = np.empty((frames, height, width), np.uint8)
    for i in range(frames):
        dy, dx = (i * 2) % 16, (i * 3) % 16
        out[i] = base[dy:dy + height, dx:dx + width]
        if flash is not None:
            y, x, h, w = flash
            out[i, y:y + h, x:x + w] = (255 if i % 3 == 1
                                        else out[i, y:y + h, x:x + w] >> 2)
    return torch.from_numpy(out).to(dev)


def make_test_clip_yuv(frames: int, width: int = 1920, height: int = 1080,
                       seed: int = 0,
                       flash: Optional[Tuple[int, int, int, int]] = None,
                       noise: int = 0, pan: Tuple[int, int] = (2, 3),
                       clean: Optional[Tuple[int, int, int, int]] = None,
                       device="cuda") -> List[torch.Tensor]:
    """[Y, U, V] planes ([frames, H, W], [frames, H/2, W/2] x 2, uint8) of a
    YUV420 test clip: per plane one uniform-noise image panned by `pan` =
    (down, right) luma pixels per frame (mod 16; chroma moves half as far).

    flash = (y, x, h, w) in luma pixels adds a flashing region to all three
    planes: it is dark (pixel >> 2) in every frame and bright
    (192 + (pixel >> 2)) in every third frame, starting with frame 1.
    Between a bright frame and its neighbours every pixel of the region
    differs by more than 100 at every candidate vector at every pyramid
    level, so a region that covers most of the frame makes block SADs
    exceed the bad-SAD threshold down to the coarsest levels, the way a
    camera flash or a cut does.

    noise > 0 adds fresh uniform noise in [-noise, noise] to every frame:
    a compensated neighbour is then close to the frame but not equal to it,
    and degrain has something to average.  clean = (y, x, h, w) in luma
    pixels keeps a region free of that noise: there a true vector matches
    exactly, which leaves Recalculate blocks under its threshold."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    planes = []
    for sub in (0, 1, 1):
        pw, ph = width >> sub, height >> sub
        base = rng.integers(0, 256, (ph + 32, pw + 32), np.uint8)
        out = np.empty((frames, ph, pw), np.uint8)
        for i in range(frames):
            dy, dx = ((i * pan[0]) % 16) >> sub, ((i * pan[1]) % 16) >> sub
            out[i] = base[dy:dy + ph, dx:dx + pw]
            if flash is not None:
                y, x, h, w = (v >> sub for v in flash)
                reg = out[i, y:y + h, x:x + w] >> 2
                out[i, y:y + h, x:x + w] = reg + (192 if i % 3 == 1 else 0)
            if noise:
                grain = rng.integers(-noise, noise + 1, (ph, pw))
                if clean is not None:
                    y, x, h, w = (v >> sub for v in clean)
                    grain[y:y + h, x:x + w] = 0
                out[i] = np.clip(out[i].astype(np.int64) + grain, 0, 255)
        planes.append(torch.from_numpy(out).to(dev))
    return planes


def flagship_configs(levels: int = 0):
    """(SuperConfig, AnalyseConfig, DegrainConfig, radius) of the flagship
    pipeline: YUV420 8-bit, pel 2, blk 16 with overlap 8, chroma in the
    search, truemotion, the full pyramid (levels=0), MDegrain3, thsad 400."""
    return (SuperConfig(pel=2, levels=levels, chroma=True),
            AnalyseConfig(blksize=16, levels=levels, overlap=8,
                          truemotion=True, chroma=True),
            DegrainConfig(thsad=400), 3)
