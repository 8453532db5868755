"""Frame-batched temporal denoise (mv.Super -> mv.Analyse -> mv.Degrain)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..analyse import analyse_batch
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
