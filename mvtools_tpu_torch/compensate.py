"""mv.Compensate equivalent: motion-compensated frame.

A redesign of MVCompensate.c for a wide parallel device: all block patches
are fetched from the reference super at once (degrain.gather_blocks, the
block fetch kernel on the card); blocks whose SAD fails `thsad` fall back
to the source-super patch (occlusion handling, MVCompensate.c:233-246);
overlapped assembly reuses the phase-decomposed overlap-add; scene changes
select a whole-frame copy (src or ref per `scbehavior`, :319-364) with
torch.where.  One frame: unbatched supers and field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField
from .degrain import gather_blocks
from .ops import overlap as overlap_ops
from .ops import pixels
from .super import Super

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CompensateConfig:
    """mv.Compensate parameters (MVCompensate.c:421-476)."""
    scbehavior: bool = True     # on scene change: True -> keep src, False -> ref
    thsad: int = 10000
    fields: bool = False
    time: float = 100.0
    thscd1: int = 400
    thscd2: int = 130
    tff: Optional[bool] = None

    def __post_init__(self):
        if not 0.0 <= self.time <= 100.0:
            raise ValueError(
                "Compensate: time must be between 0.0 and 100.0 (inclusive).")

    @property
    def time256(self) -> int:
        return int(self.time * 256 / 100)


def _trunc_div256(v):
    """C `v * time256 / 256` truncation toward zero for possibly negative v."""
    return torch.div(v, 256, rounding_mode="trunc")


def unpadded_plane(sup: Super, plane: int, meta: AnalysisMeta):
    """The frame's own pixels of a plane: subplane 0 of the super's level
    0 without its padding."""
    sub_x = meta.x_ratio_uv.bit_length() - 1 if plane else 0
    sub_y = meta.y_ratio_uv.bit_length() - 1 if plane else 0
    hpad, vpad = meta.hpadding >> sub_x, meta.vpadding >> sub_y
    p_w, p_h = meta.width >> sub_x, meta.height >> sub_y
    return sup.planes[plane][0][0, vpad:vpad + p_h, hpad:hpad + p_w]


def compensate(src_super: Super, ref_super: Super, mv: MVField,
               meta: AnalysisMeta, cfg: CompensateConfig,
               field_shift: int = 0):
    """Compensate one frame; returns frame-sized planes (unpadded)."""
    bits = meta.bits_per_sample
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "Compensate")
    thsad = cfg.thsad * nscd1 // cfg.thscd1  # MVCompensate.c:521
    time256 = cfg.time256

    nbx, nby = meta.blk_x, meta.blk_y
    bsx, bsy = meta.blk_size_x, meta.blk_size_y
    ovx, ovy = meta.overlap_x, meta.overlap_y
    pel = meta.pel
    log_pel = pel.bit_length() - 1
    logx = meta.x_ratio_uv.bit_length() - 1
    logy = meta.y_ratio_uv.bit_length() - 1
    width_b = (bsx - ovx) * nbx + ovx
    height_b = (bsy - ovy) * nby + ovy

    finest = mv.levels[0]
    usable = is_usable(mv, nscd1, nscd2)
    dev = finest.x.device
    pos_y, pos_x = torch.meshgrid(
        torch.arange(nby, dtype=I32, device=dev) * (bsy - ovy),
        torch.arange(nbx, dtype=I32, device=dev) * (bsx - ovx),
        indexing="ij")

    good = finest.sad < thsad
    # MC position in pel units (MVCompensate.c:239-240); fallback = the
    # source block at the block's own position (:246-248, :293-295)
    mc_x = (pos_x << log_pel) + _trunc_div256(finest.x * time256)
    mc_y = ((pos_y << log_pel) + _trunc_div256(finest.y * time256)
            + field_shift)
    fb_x = pos_x << log_pel
    fb_y = (pos_y << log_pel) + field_shift
    vx = torch.where(good, mc_x, fb_x) - (pos_x << log_pel)
    vy = torch.where(good, mc_y, fb_y) - (pos_y << log_pel)
    zero = torch.zeros_like(vx)

    out_planes = []
    for plane in range(src_super.num_planes):
        sub_x = logx if plane else 0
        sub_y = logy if plane else 0
        p_bsx, p_bsy = bsx >> sub_x, bsy >> sub_y
        p_ovx, p_ovy = ovx >> sub_x, ovy >> sub_y
        p_wb, p_hb = width_b >> sub_x, height_b >> sub_y
        hpad_p = meta.hpadding >> sub_x
        vpad_p = meta.vpadding >> sub_y

        def fetch(sup, mx, my):
            return gather_blocks(
                sup.planes[plane][0][None], pos_x, pos_y, mx[None], my[None],
                p_bsy, p_bsx, log_pel, hpad_p * pel, vpad_p * pel, sub_x,
                sub_y, pitch_fp=p_bsx - p_ovx)[0]

        rb = fetch(ref_super, vx, vy)
        sb = fetch(src_super, zero, zero + field_shift)
        blocks = torch.where(good[..., None, None], rb, sb)

        src_unpadded = pixels.widen(unpadded_plane(src_super, plane, meta))
        ref_unpadded = pixels.widen(unpadded_plane(ref_super, plane, meta))
        sc_frame = src_unpadded if cfg.scbehavior else ref_unpadded

        out = sc_frame.clone()
        if ovx == 0 and ovy == 0:
            grid = blocks.permute(0, 2, 1, 3).reshape(nby * p_bsy,
                                                      nbx * p_bsx)
            out[:p_hb, :p_wb] = grid[:p_hb, :p_wb]
        else:
            wins = overlap_ops.overlap_windows(p_bsx, p_bsy, p_ovx, p_ovy)
            acc = overlap_ops.overlap_add(blocks[None], nbx, nby,
                                          (p_bsx, p_bsy), (p_ovx, p_ovy),
                                          wins)[0]
            out[:p_hb, :p_wb] = overlap_ops.to_pixels(acc, bits)
        # the uncovered margins hold sc_frame's pixels (:319-340)
        final = torch.where(usable, out, sc_frame)
        out_planes.append(pixels.narrow(final,
                                        src_super.planes[plane][0].dtype))
    return out_planes
