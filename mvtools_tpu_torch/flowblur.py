"""mv.FlowBlur equivalent: motion blur along the flow paths.

Equivalent of MVFlowBlur.c: for each pixel, average samples along the
backward and forward motion paths; the step count per pixel is
max(|v*blur256|)/prec >> 8 (RealFlowBlur :72-128).  The data-dependent path
length becomes a masked loop over a fixed bound (max_steps): contributions
past a pixel's own step count are masked out.  One frame: planes [H, W],
unbatched supers and fields.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField, check_similarity
from .finest import finest as make_finest
from .flowutils import (FlowGeometry, plane_geom, small_vector_fields,
                        upsize_vectors)
from .ops import maskfun, pixels
from .super import Super

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class FlowBlurConfig:
    """mv.FlowBlur parameters (MVFlowBlur.c:396-460)."""
    blur: float = 50.0
    prec: int = 1
    thscd1: int = 400
    thscd2: int = 130
    max_steps: int = 128   # static bound on the per-pixel path length

    def __post_init__(self):
        if not 0.0 <= self.blur <= 200.0:
            raise ValueError("FlowBlur: blur must be between 0 and 200 (inclusive).")
        if self.prec < 1:
            raise ValueError("FlowBlur: prec must be at least 1.")

    @property
    def blur256(self) -> int:
        return int(self.blur * 256 / 200)


def _path_sum(pref, oy, ox, vx_full, vy_full, blur256, prec, pel_log,
              max_steps):
    """Accumulate samples along one direction's motion path; returns
    (sum, steps)."""
    h, w = vx_full.shape
    dev = vx_full.device
    h_idx, w_idx = maskfun.hw_grids(h, w, dev)
    vx0 = vx_full * blur256
    vy0 = vy_full * blur256
    m = (torch.maximum(vx0.abs(), vy0.abs()) // prec) >> 8
    m = m.clamp(max=max_steps)
    # C division by m where m > 0 (the divisor is held at 1 elsewhere,
    # where the step is 0 anyway)
    div = m.clamp(min=1)
    step_x = torch.where(m > 0, torch.div(vx0, div, rounding_mode="trunc"),
                         0)
    step_y = torch.where(m > 0, torch.div(vy0, div, rounding_mode="trunc"),
                         0)
    total = torch.zeros((h, w), dtype=I32, device=dev)
    vx, vy = step_x, step_y
    for i in range(max_steps):
        sample = maskfun.take_clamped(pref,
                                      (h_idx << pel_log) + (vy >> 8) + oy,
                                      (w_idx << pel_log) + (vx >> 8) + ox)
        total = total + torch.where(i < m, sample, 0)
        vx = vx + step_x
        vy = vy + step_y
    return total, m


def flowblur(src_planes: Sequence[torch.Tensor], src_super: Super,
             mv_b: MVField, mv_f: MVField, meta: AnalysisMeta,
             cfg: FlowBlurConfig) -> List[torch.Tensor]:
    """Blur frame n along its own backward/forward flow
    (mvbw and mvfw both at frame n)."""
    if mv_b.meta is not None and mv_f.meta is not None:
        check_similarity(mv_b.meta, mv_f.meta, "FlowBlur", "mvbw", "mvfw")
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "FlowBlur")
    usable = is_usable(mv_b, nscd1, nscd2) & is_usable(mv_f, nscd1, nscd2)
    geo = FlowGeometry.from_meta(meta)
    pel = meta.pel
    pel_log = pel.bit_length() - 1
    blur256 = cfg.blur256

    vxb_s, vyb_s = small_vector_fields(mv_b, meta, geo)
    vxf_s, vyf_s = small_vector_fields(mv_f, meta, geo)
    fine = make_finest(src_super)

    out = []
    for p in range(len(fine)):
        chroma = p > 0
        w, h, oy, ox = plane_geom(meta, chroma, pel)
        vxb, vyb = upsize_vectors(vxb_s, vyb_s, meta, geo, chroma)
        vxf, vyf = upsize_vectors(vxf_s, vyf_s, meta, geo, chroma)
        vxb, vyb = vxb[:h, :w], vyb[:h, :w]
        vxf, vyf = vxf[:h, :w], vyf[:h, :w]
        pref = pixels.widen(fine[p])
        h_idx, w_idx = maskfun.hw_grids(h, w, pref.device)
        base = maskfun.take_clamped(pref, (h_idx << pel_log) + oy,
                                    (w_idx << pel_log) + ox)
        sum_f, m_f = _path_sum(pref, oy, ox, vxf, vyf, blur256, cfg.prec,
                               pel_log, cfg.max_steps)
        sum_b, m_b = _path_sum(pref, oy, ox, vxb, vyb, blur256, cfg.prec,
                               pel_log, cfg.max_steps)
        res = (base + sum_f + sum_b) // (m_f + m_b + 1)
        fallback = pixels.widen(src_planes[p])
        out.append(pixels.narrow(torch.where(usable, res, fallback),
                                 src_planes[p].dtype))
    return out
