"""mv.FlowFPS equivalent: motion-interpolated frame-rate conversion.

Equivalent of MVFlowFPS.c.  The reference wraps each MV clip in an internal
FlowFPSHelper filter so the host scheduler caches the full-res vector
fields (MVFlowFPSHelper.c:11-110); here those fields are plain functions of
the MV field.  An output frame n of an fa/fb retimed clip maps to source
pair (nleft, nleft+off) with fractional position time256
(MVFlowFPS.c:94-136); time256 == 0/256 passes the source frame through,
scene changes blend or repeat (:479-519).  One frame at a time: planes
[H, W], unbatched supers and fields, all on one device; the per-pixel
gathers are plain torch ops there.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField, check_similarity
from .finest import finest as make_finest
from .flowutils import (FlowGeometry, occlusion_mask_small, plane_geom,
                        small_vector_fields, upsize_mask, upsize_vectors)
from .ops import maskfun, pixels
from .super import Super


@dataclasses.dataclass(frozen=True)
class FlowFPSConfig:
    """mv.FlowFPS parameters (MVFlowFPS.c:531-620)."""
    num: int = 0               # output fps numerator (0 -> x2)
    den: int = 1
    maskmode: int = 2
    ml: float = 100.0
    blend: bool = True
    thscd1: int = 400
    thscd2: int = 130

    def __post_init__(self):
        if self.maskmode not in (0, 1, 2):
            raise ValueError("FlowFPS: mask must be 0, 1 or 2.")


def output_frame_mapping(n: int, fa: Fraction, off: int) -> Tuple[int, int, int]:
    """Map output frame n to (nleft, nright, time256)
    (MVFlowFPS.c:94-136).  fa = input_fps/output_fps as an exact fraction."""
    nleft = int(n * fa)
    time256 = int((float(n * fa) - nleft) * 256 + 0.5)
    if off > 1:
        time256 = time256 // off
    return nleft, nleft + off, time256


def flowfps_frame(src_planes: Sequence[torch.Tensor],
                  ref_planes: Sequence[torch.Tensor],
                  src_super: Super, ref_super: Super,
                  mv_b: MVField, mv_f: MVField,
                  meta: AnalysisMeta, cfg: FlowFPSConfig, time256: int,
                  mv_bb: Optional[MVField] = None,
                  mv_ff: Optional[MVField] = None) -> List[torch.Tensor]:
    """Synthesise the intermediate frame at `time256` between nleft (src)
    and nright (ref).  mv_b = mvbw at nleft, mv_f = mvfw at nright;
    mv_bb/mv_ff = mvbw at nright / mvfw at nleft (maskmode 2)."""
    if time256 == 0:
        return list(src_planes)
    if time256 == 256:
        return list(ref_planes)
    return interpolate(src_planes, ref_planes, src_super, ref_super, mv_b,
                       mv_f, meta, time256, cfg.maskmode, cfg.ml, cfg.blend,
                       cfg.thscd1, cfg.thscd2, "FlowFPS", mv_bb, mv_ff)


def interpolate(src_planes, ref_planes, src_super: Super, ref_super: Super,
                mv_b: MVField, mv_f: MVField, meta: AnalysisMeta,
                time256: int, maskmode: int, ml: float, blend: bool,
                thscd1: int, thscd2: int, filter_name: str,
                mv_bb: Optional[MVField] = None,
                mv_ff: Optional[MVField] = None) -> List[torch.Tensor]:
    """The frame at `time256` between src and ref, the body that FlowFPS
    and FlowInter share (MVFlowFPS.c, MVFlowInter.c): full-resolution
    vector fields and occlusion masks of mv_b and mv_f, per-pixel
    interpolation (maskmode 0 FlowInterSimple, 1 FlowInter, 2 FlowInter
    or, with usable mv_bb and mv_ff, FlowInterExtra), and the blend (or
    src) on a scene change."""
    if mv_b.meta is not None and mv_f.meta is not None:
        check_similarity(mv_b.meta, mv_f.meta, filter_name, "mvbw", "mvfw")
    nscd1, nscd2 = scale_thscd(thscd1, thscd2, meta, filter_name)
    usable = is_usable(mv_b, nscd1, nscd2) & is_usable(mv_f, nscd1, nscd2)
    geo = FlowGeometry.from_meta(meta)
    pel = meta.pel

    vxb_s, vyb_s = small_vector_fields(mv_b, meta, geo)
    vxf_s, vyf_s = small_vector_fields(mv_f, meta, geo)
    mask_b_small = occlusion_mask_small(mv_b, meta, True, ml, 256 - time256)
    mask_f_small = occlusion_mask_small(mv_f, meta, False, ml, time256)

    extra = maskmode == 2 and mv_bb is not None and mv_ff is not None
    if extra:
        extra_usable = (is_usable(mv_bb, nscd1, nscd2)
                        & is_usable(mv_ff, nscd1, nscd2))
        vxbb_s, vybb_s = small_vector_fields(mv_bb, meta, geo)
        vxff_s, vyff_s = small_vector_fields(mv_ff, meta, geo)

    fine_src = make_finest(src_super)
    fine_ref = make_finest(ref_super)

    out = []
    for p in range(len(fine_src)):
        chroma = p > 0
        w, h, oy, ox = plane_geom(meta, chroma, pel)
        vxb, vyb = upsize_vectors(vxb_s, vyb_s, meta, geo, chroma)
        vxf, vyf = upsize_vectors(vxf_s, vyf_s, meta, geo, chroma)
        mb = upsize_mask(mask_b_small, meta, geo, chroma)[:h, :w]
        mf = upsize_mask(mask_f_small, meta, geo, chroma)[:h, :w]
        vxb, vyb = vxb[:h, :w], vyb[:h, :w]
        vxf, vyf = vxf[:h, :w], vyf[:h, :w]
        pref_b = pixels.widen(fine_ref[p])   # prefB = ref (nright)
        pref_f = pixels.widen(fine_src[p])   # prefF = src (nleft)

        if maskmode == 0:
            res = maskfun.flow_inter_simple(pref_b, pref_f, oy, ox, vxb, vxf,
                                            vyb, vyf, mb, mf, time256, pel)
        else:
            res = maskfun.flow_inter(pref_b, pref_f, oy, ox, vxb, vxf, vyb,
                                     vyf, mb, mf, time256, pel)
        if extra:
            vxbb, vybb = upsize_vectors(vxbb_s, vybb_s, meta, geo, chroma)
            vxff, vyff = upsize_vectors(vxff_s, vyff_s, meta, geo, chroma)
            rich = maskfun.flow_inter_extra(
                pref_b, pref_f, oy, ox, vxb, vxf, vyb, vyf, mb, mf, time256,
                pel, vxbb[:h, :w], vxff[:h, :w], vybb[:h, :w], vyff[:h, :w])
            res = torch.where(extra_usable, rich, res)

        src_p = pixels.widen(src_planes[p])
        ref_p = pixels.widen(ref_planes[p])
        if blend:
            fallback = maskfun.blend(src_p, ref_p, time256,
                                     meta.bits_per_sample)
        else:
            fallback = src_p
        out.append(pixels.narrow(torch.where(usable, res, fallback),
                                 src_planes[p].dtype))
    return out
