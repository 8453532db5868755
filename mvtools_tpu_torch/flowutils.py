"""Shared machinery of the Flow family: full-resolution vector fields.

Implements the pipeline every Flow filter repeats (e.g.
MVFlowInter.c:210-260): per-block vx/vy grids -> pad the block grid to cover
the frame (CheckAndPadSmallY) -> SimpleResize to full resolution with
progressive clamping -> optional chroma scaling; plus the occlusion-mask
variant.  In the reference, MVFlowFPSHelper caches these fields as frame
props (MVFlowFPSHelper.c:11-110); here they are plain functions of one
frame's MV field (unbatched [nblky, nblkx] tensors), computed on the
field's device.
"""

from __future__ import annotations

import dataclasses

from .core.types import AnalysisMeta, MVField
from .ops import maskfun, resize


@dataclasses.dataclass(frozen=True)
class FlowGeometry:
    """Padded block-grid geometry (MVFlow.cpp:535-554)."""
    nblkx_p: int
    nblky_p: int
    width_p: int
    height_p: int

    @classmethod
    def from_meta(cls, meta: AnalysisMeta) -> "FlowGeometry":
        nbxp, nbyp = meta.blk_x, meta.blk_y
        sx = meta.blk_size_x - meta.overlap_x
        sy = meta.blk_size_y - meta.overlap_y
        while nbxp * sx + meta.overlap_x < meta.width:
            nbxp += 1
        while nbyp * sy + meta.overlap_y < meta.height:
            nbyp += 1
        return cls(nbxp, nbyp, nbxp * sx + meta.overlap_x,
                   nbyp * sy + meta.overlap_y)


def small_vector_fields(mv: MVField, meta: AnalysisMeta, geo: FlowGeometry,
                        field_shift: int = 0):
    """Padded small vx/vy grids [nblky_p, nblkx_p] (MakeVectorSmallMasks +
    CheckAndPadSmallY); field_shift is added to vy after padding
    (MVFlow.cpp:299-303)."""
    finest = mv.levels[0]
    vx, vy = maskfun.check_and_pad_small(finest.x, finest.y,
                                         geo.nblkx_p, geo.nblky_p)
    if field_shift:
        vy = vy + field_shift
    return vx, vy


def upsize_vectors(vx_small, vy_small, meta: AnalysisMeta, geo: FlowGeometry,
                   chroma: bool = False):
    """Full-resolution int16-style vector fields with the progressive
    clamping of the int16 SimpleResize path."""
    if chroma:
        xr, yr = meta.x_ratio_uv, meta.y_ratio_uv
        vx_small = maskfun.vector_small_mask_y_to_half_uv(vx_small, xr)
        vy_small = maskfun.vector_small_mask_y_to_half_uv(vy_small, yr)
        w, h = geo.width_p // xr, geo.height_p // yr
        lw, lh = meta.width // xr, meta.height // yr
    else:
        w, h = geo.width_p, geo.height_p
        lw, lh = meta.width, meta.height
    vx_full = resize.simple_resize(vx_small, h, w, limit=True, limit_width=lw,
                                   limit_height=lh, pel=meta.pel,
                                   horizontal_vectors=True)
    vy_full = resize.simple_resize(vy_small, h, w, limit=True, limit_width=lw,
                                   limit_height=lh, pel=meta.pel,
                                   horizontal_vectors=False)
    return vx_full, vy_full


def upsize_mask(small_mask, meta: AnalysisMeta, geo: FlowGeometry,
                chroma: bool = False):
    small_mask = maskfun.check_and_pad_mask(small_mask, geo.nblkx_p,
                                            geo.nblky_p)
    if chroma:
        w = geo.width_p // meta.x_ratio_uv
        h = geo.height_p // meta.y_ratio_uv
    else:
        w, h = geo.width_p, geo.height_p
    return resize.simple_resize(small_mask, h, w)


def occlusion_mask_small(mv: MVField, meta: AnalysisMeta, is_backward: bool,
                         ml: float, time256: int):
    finest = mv.levels[0]
    return maskfun.make_vector_occlusion_mask_time(
        finest.x, finest.y, is_backward, float(ml), 1.0, meta.pel, time256,
        meta.blk_size_x - meta.overlap_x, meta.blk_size_y - meta.overlap_y)


def plane_geom(meta: AnalysisMeta, chroma: bool, pel: int):
    """(w, h, oy, ox) of a plane: its unpadded size and the origin of the
    unpadded frame inside its finest plane."""
    if chroma:
        return (meta.width // meta.x_ratio_uv, meta.height // meta.y_ratio_uv,
                (meta.vpadding // meta.y_ratio_uv) * pel,
                (meta.hpadding // meta.x_ratio_uv) * pel)
    return meta.width, meta.height, meta.vpadding * pel, meta.hpadding * pel
