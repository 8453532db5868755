"""mv.Flow equivalent: per-pixel warp by a motion-vector field.

Equivalent of MVFlow.cpp: upsizes the block MV field to full resolution and
either gathers ("Fetch" mode, :93-116) or scatters ("Shift" mode, :119-148)
pixels of the Finest-resolution reference.  The scatter keeps the
reference's raster-order last-write-wins rule in two deterministic steps:
the latest raster position per target (a scatter max), then one write by
each target's unique winner.  One frame: planes [H, W], unbatched supers
and fields.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField
from .finest import finest as make_finest
from .flowutils import (FlowGeometry, plane_geom, small_vector_fields,
                        upsize_vectors)
from .ops import maskfun, pixels
from .super import Super

I32 = torch.int32

FLOW_FETCH = 0
FLOW_SHIFT = 1


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """mv.Flow parameters (MVFlow.cpp:391-470)."""
    time: float = 100.0
    mode: int = 0          # 0 fetch, 1 shift
    fields: bool = False
    thscd1: int = 400
    thscd2: int = 130
    tff: Optional[bool] = None

    def __post_init__(self):
        if not 0.0 <= self.time <= 100.0:
            raise ValueError("Flow: time must be between 0.0 and 100.0 (inclusive).")
        if self.mode not in (0, 1):
            raise ValueError("Flow: mode must be 0 or 1.")

    @property
    def time256(self) -> int:
        return int(self.time * 256 / 100)


def _fetch(plane_fine, oy, ox, vx_full, vy_full, time256, pel):
    """flowFetch (MVFlow.cpp:93-116): vx = (VX*time256 + 128) >> 8."""
    pel_log = pel.bit_length() - 1
    h_idx, w_idx = maskfun.hw_grids(*vx_full.shape, vx_full.device)
    vx = (vx_full * time256 + 128) >> 8
    vy = (vy_full * time256 + 128) >> 8
    return maskfun.take_clamped(plane_fine, (h_idx << pel_log) + vy + oy,
                                (w_idx << pel_log) + vx + ox)


def _shift(plane_fine, oy, ox, vx_full, vy_full, time256, pel, pixel_max):
    """flowShift (MVFlow.cpp:119-148): raster-order scatter, last write
    wins; uncovered pixels = pixel_max (:311-312)."""
    pel_log = pel.bit_length() - 1
    h, w = vx_full.shape
    h_idx, w_idx = maskfun.hw_grids(h, w, vx_full.device)
    rounding = 128 << pel_log
    shift = 8 + pel_log
    vx = (-vx_full * time256 + rounding) >> shift
    vy = (-vy_full * time256 + rounding) >> shift
    href = h_idx + vy
    wref = w_idx + vx
    valid = (href >= 0) & (href < h) & (wref >= 0) & (wref < w)
    src_vals = maskfun.take_clamped(plane_fine, (h_idx << pel_log) + oy,
                                    (w_idx << pel_log) + ox).to(I32)
    target = torch.where(valid, href * w + wref, h * w)   # h*w: dump slot
    order = (h_idx * w + w_idx).reshape(-1)
    tgt_flat = target.reshape(-1).long()
    val_flat = src_vals.reshape(-1)
    # last raster write wins: the source with the largest order per target
    best = torch.full((h * w + 1,), -1, dtype=I32,
                      device=order.device).scatter_reduce(
        0, tgt_flat, order, "amax")
    win = best[tgt_flat] == order
    out_flat = torch.full((h * w + 1,), pixel_max, dtype=I32,
                          device=order.device)
    # the winners' targets are unique; the others all write pixel_max to
    # the dump slot
    out_flat[torch.where(win, tgt_flat, h * w)] = torch.where(win, val_flat,
                                                              pixel_max)
    return out_flat[:h * w].reshape(h, w)


def flow(clip_planes, ref_super: Super, mv: MVField, meta: AnalysisMeta,
         cfg: FlowConfig, field_shift: int = 0) -> List[torch.Tensor]:
    """Warp the reference toward the current frame.

    clip_planes: the fallback frame (returned on scene change).
    ref_super: super of the reference frame (provides the Finest planes).
    """
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "Flow")
    usable = is_usable(mv, nscd1, nscd2)
    geo = FlowGeometry.from_meta(meta)
    time256 = cfg.time256
    pel = meta.pel
    pixel_max = (1 << meta.bits_per_sample) - 1

    vx_small, vy_small = small_vector_fields(mv, meta, geo, field_shift)
    fine_planes = make_finest(ref_super)

    out = []
    for p, fine in enumerate(fine_planes):
        chroma = p > 0
        vx_full, vy_full = upsize_vectors(vx_small, vy_small, meta, geo,
                                          chroma)
        w, h, oy, ox = plane_geom(meta, chroma, pel)
        vx_full = vx_full[:h, :w]
        vy_full = vy_full[:h, :w]
        fine32 = pixels.widen(fine)
        if cfg.mode == FLOW_FETCH:
            res = _fetch(fine32, oy, ox, vx_full, vy_full, time256, pel)
        else:
            res = _shift(fine32, oy, ox, vx_full, vy_full, time256, pel,
                         pixel_max)
        fallback = pixels.widen(clip_planes[p])
        out.append(pixels.narrow(torch.where(usable, res, fallback),
                                 clip_planes[p].dtype))
    return out
