"""Flow toolbox: vector fields, occlusion/SAD masks, blend, flow kernels.

Equivalents of MaskFun.cpp.  The reference's serial span-update occlusion
loop (MakeVectorOcclusionMaskTime :85-132) becomes a dense all-pairs max
along each axis; the per-pixel flow interpolation kernels (FlowInter*
:374-555) become whole-plane gathers.  Plain torch ops on the device of
their inputs, in the dtypes of the JAX package (int32 fields, int64 pixel
sums, float64 mask values), so that both agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64


def _trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """C integer division (truncate toward zero), b > 0."""
    return torch.div(a, b, rounding_mode="trunc")


def check_and_pad_small(vx: torch.Tensor, vy: torch.Tensor, nblkx_p: int,
                        nblky_p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the [nblky, nblkx] vector grids to [nblky_p, nblkx_p]
    (CheckAndPadSmallY MaskFun.cpp:38-60): right columns replicate with vx
    clamped non-positive; bottom rows replicate with vy clamped
    non-positive."""
    nblky, nblkx = vx.shape
    if nblkx_p > nblkx:
        n = nblkx_p - nblkx
        vx = torch.cat([vx, vx[:, -1:].clamp(max=0).expand(-1, n)], dim=1)
        vy = torch.cat([vy, vy[:, -1:].expand(-1, n)], dim=1)
    if nblky_p > nblky:
        n = nblky_p - nblky
        vx = torch.cat([vx, vx[-1:, :].expand(n, -1)], dim=0)
        vy = torch.cat([vy, vy[-1:, :].clamp(max=0).expand(n, -1)], dim=0)
    return vx, vy


def check_and_pad_mask(mask: torch.Tensor, nblkx_p: int,
                       nblky_p: int) -> torch.Tensor:
    """CheckAndPadMaskSmall (MaskFun.cpp:64-82): plain edge replication."""
    nblky, nblkx = mask.shape
    if nblkx_p > nblkx:
        mask = torch.cat([mask, mask[:, -1:].expand(-1, nblkx_p - nblkx)],
                         dim=1)
    if nblky_p > nblky:
        mask = torch.cat([mask, mask[-1:, :].expand(nblky_p - nblky, -1)],
                         dim=0)
    return mask


def vector_small_mask_y_to_half_uv(v: torch.Tensor,
                                   ratio_uv: int) -> torch.Tensor:
    """VectorSmallMaskYToHalfUV (MaskFun.cpp:183-203)."""
    return (v >> 1) if ratio_uv == 2 else v


def _byte_occ_value(occlusion: torch.Tensor, occnorm: float,
                    gamma: float) -> torch.Tensor:
    """ByteOccMask value (MaskFun.cpp:85-91): 255*(occ*occnorm)^gamma,
    truncated and clamped to 255; 0 where occlusion <= 0."""
    occf = occlusion.to(F64) * occnorm
    if gamma == 1.0:
        val = (255.0 * occf).to(I32)
    else:
        val = (255.0 * torch.pow(occf, gamma)).to(I32)
    val = val.clamp(max=255)
    return torch.where(occlusion > 0, val, 0)


def make_vector_occlusion_mask_time(vx: torch.Tensor, vy: torch.Tensor,
                                    is_backward: bool,
                                    mask_norm_divider: float, gamma: float,
                                    pel: int, time256: int, blk_step_x: int,
                                    blk_step_y: int) -> torch.Tensor:
    """MakeVectorOcclusionMaskTime (MaskFun.cpp:94-132).

    vx/vy: [nblky, nblkx] int32 finest vectors.  Returns the uint8-range
    int32 occlusion mask [nblky, nblkx].  A block's occlusion spreads over
    a span of blocks along each axis; the span updates are one dense
    [nblky, nblkx, nblkx] (and [nblky, nblky, nblkx]) max."""
    nblky, nblkx = vx.shape
    dev = vx.device
    time4096x = time256 * 16 // (blk_step_x * pel)
    time4096y = time256 * 16 // (blk_step_y * pel)
    occnorm_x = 80.0 / (mask_norm_divider * blk_step_x * pel)
    occnorm_y = 80.0 / (mask_norm_divider * blk_step_y * pel)
    ax = torch.arange(nblkx, dtype=I32, device=dev)
    ay = torch.arange(nblky, dtype=I32, device=dev)

    # X direction: block bx against its right neighbour
    occ_x = torch.where(vx[:, 1:] < vx[:, :-1], vx[:, :-1] - vx[:, 1:], 0)
    occ_x = torch.nn.functional.pad(occ_x, (0, 1))   # source bx < nblkx-1
    val_x = _byte_occ_value(occ_x, occnorm_x, gamma)
    shift_x = _trunc_div(occ_x * time4096x, 4096)
    if is_backward:
        minb_x = (ax[None, :] + 1 - shift_x).clamp(min=0)
        maxb_x = (ax[None, :] + 1).expand_as(occ_x)
    else:
        minb_x = ax[None, :].expand_as(occ_x)
        maxb_x = (ax[None, :] + 1 - shift_x).clamp(max=nblkx - 1)
    # dense all-pairs: target bxi gets val_x[by, bx] if minb <= bxi <= maxb
    bxi = ax[None, None, :]
    in_span = ((bxi >= minb_x[:, :, None]) & (bxi <= maxb_x[:, :, None])
               & (occ_x[:, :, None] > 0))
    mask = torch.where(in_span, val_x[:, :, None], 0).amax(dim=1)

    # Y direction: block by against its bottom neighbour
    occ_y = torch.where(vy[1:, :] < vy[:-1, :], vy[:-1, :] - vy[1:, :], 0)
    occ_y = torch.nn.functional.pad(occ_y, (0, 0, 0, 1))
    val_y = _byte_occ_value(occ_y, occnorm_y, gamma)
    shift_y = _trunc_div(occ_y * time4096y, 4096)
    if is_backward:
        minb_y = (ay[:, None] + 1 - shift_y).clamp(min=0)
        maxb_y = (ay[:, None] + 1).expand_as(occ_y)
    else:
        minb_y = ay[:, None].expand_as(occ_y)
        maxb_y = (ay[:, None] + 1 - shift_y).clamp(max=nblky - 1)
    # [src_by, target_by, bx]: target byi gets val_y[src_by, bx]
    byi = ay[None, :, None]
    in_span_y = ((byi >= minb_y[:, None, :]) & (byi <= maxb_y[:, None, :])
                 & (occ_y[:, None, :] > 0))
    mask_y = torch.where(in_span_y, val_y[:, None, :], 0).amax(dim=0)
    return torch.maximum(mask, mask_y)


def byte_norm(sad: torch.Tensor, sad_norm_factor: float,
              gamma: float) -> torch.Tensor:
    """ByteNorm (MaskFun.cpp:135-140)."""
    l = 255.0 * torch.pow(sad.to(F64) * sad_norm_factor, gamma)
    return l.clamp(max=255.0).to(I32)


def make_sad_mask_time(vx: torch.Tensor, vy: torch.Tensor, sad: torch.Tensor,
                       sad_norm_factor: float, gamma: float, pel: int,
                       time256: int, blk_step_x: int, blk_step_y: int,
                       bits: int) -> torch.Tensor:
    """MakeSADMaskTime (MaskFun.cpp:143-166): SAD mask sampled at the
    time-projected block position."""
    nblky, nblkx = vx.shape
    dev = vx.device
    time4096x = (256 - time256) * 16 // (blk_step_x * pel)
    time4096y = (256 - time256) * 16 // (blk_step_y * pel)
    by, bx = torch.meshgrid(torch.arange(nblky, dtype=I32, device=dev),
                            torch.arange(nblkx, dtype=I32, device=dev),
                            indexing="ij")
    bxi = bx - _trunc_div(vx * time4096x, 4096)
    byi = by - _trunc_div(vy * time4096y, 4096)
    oob = (bxi < 0) | (bxi >= nblkx) | (byi < 0) | (byi >= nblky)
    bxi = torch.where(oob, bx, bxi)
    byi = torch.where(oob, by, byi)
    sad_s = sad[byi.long(), bxi.long()] >> (bits - 8)
    return byte_norm(sad_s, sad_norm_factor, gamma)


def sad_to_mask(sad: torch.Tensor, sadnorm1024: int) -> torch.Tensor:
    """SADToMask (MaskFun.cpp:340-345)."""
    l = torch.div(sadnorm1024 * sad, 1024, rounding_mode="floor")
    return l.clamp(max=255).to(I32)


def blend(src: torch.Tensor, ref: torch.Tensor, time256: int,
          bits: int) -> torch.Tensor:
    """Time-weighted blend (Blend MaskFun.cpp:348-371) of int32 planes."""
    s = src.to(I32)
    r = ref.to(I32)
    return (s * (256 - time256) + r * time256) >> 8


def hw_grids(height: int, width: int, device):
    """int32 row [h, 1] and column [1, w] indices of a plane."""
    return (torch.arange(height, dtype=I32, device=device)[:, None],
            torch.arange(width, dtype=I32, device=device)[None, :])


def take_clamped(plane: torch.Tensor, y, x) -> torch.Tensor:
    """plane[y, x] for int32 coordinate tensors, each clamped into the
    plane (the reference relies on the frame's padding; SimpleResize's
    limiting keeps the vectors in range anyway)."""
    hp, wp = plane.shape
    return plane.reshape(-1)[(y.clamp(0, hp - 1) * wp
                              + x.clamp(0, wp - 1)).long()]


def _gather_fine(pref: torch.Tensor, oy: int, ox: int, h_idx, w_idx, vy, vx,
                 pel_log: int) -> torch.Tensor:
    """pref[(h << pel_log) + vy + oy, (w << pel_log) + vx + ox] as int64,
    clamped into the plane."""
    return take_clamped(pref, (h_idx << pel_log) + vy + oy,
                        (w_idx << pel_log) + vx + ox).to(I64)


def flow_inter(pref_b, pref_f, oy: int, ox: int, vxb, vxf, vyb, vyf, mask_b,
               mask_f, time256: int, pel: int) -> torch.Tensor:
    """FlowInter (MaskFun.cpp:374-417).  pref_*: finest planes; oy/ox:
    offset of the unpadded origin inside them.  vx/vy/masks: full-res int32
    fields.  Returns int32 pixels."""
    pel_log = pel.bit_length() - 1
    h, w = vxb.shape
    h_idx, w_idx = hw_grids(h, w, vxb.device)
    t = time256
    vxf_t = (vxf * t) >> 8
    vyf_t = (vyf * t) >> 8
    vxb_t = (vxb * (256 - t)) >> 8
    vyb_t = (vyb * (256 - t)) >> 8
    zero = torch.zeros_like(vxf)
    dst_f = _gather_fine(pref_f, oy, ox, h_idx, w_idx, vyf_t, vxf_t, pel_log)
    dst_f0 = _gather_fine(pref_f, oy, ox, h_idx, w_idx, zero, zero, pel_log)
    dst_b = _gather_fine(pref_b, oy, ox, h_idx, w_idx, vyb_t, vxb_t, pel_log)
    dst_b0 = _gather_fine(pref_b, oy, ox, h_idx, w_idx, zero, zero, pel_log)
    mf = mask_f.to(I64)
    mb = mask_b.to(I64)
    out = ((((dst_f * (255 - mf)
              + ((mf * (dst_b * (255 - mb) + mb * dst_f0) + 255) >> 8)
              + 255) >> 8) * (256 - t)
            + ((dst_b * (255 - mb)
                + ((mb * (dst_f * (255 - mf) + mf * dst_b0) + 255) >> 8)
                + 255) >> 8) * t) >> 8)
    return out.to(I32)


def flow_inter_extra(pref_b, pref_f, oy: int, ox: int, vxb, vxf, vyb, vyf,
                     mask_b, mask_f, time256: int, pel: int, vxbb, vxff,
                     vybb, vyff) -> torch.Tensor:
    """FlowInterExtra (MaskFun.cpp:420-488)."""
    pel_log = pel.bit_length() - 1
    h, w = vxb.shape
    h_idx, w_idx = hw_grids(h, w, vxb.device)
    t = time256

    def fine(pref, vy, vx):
        return _gather_fine(pref, oy, ox, h_idx, w_idx, vy, vx, pel_log)

    dst_f = fine(pref_f, (vyf * t) >> 8, (vxf * t) >> 8)
    dst_ff = fine(pref_f, (vyff * t) >> 8, (vxff * t) >> 8)
    dst_b = fine(pref_b, (vyb * (256 - t)) >> 8, (vxb * (256 - t)) >> 8)
    dst_bb = fine(pref_b, (vybb * (256 - t)) >> 8, (vxbb * (256 - t)) >> 8)
    minfb = torch.minimum(dst_b, dst_f)
    maxfb = torch.maximum(dst_b, dst_f)
    median_bb = torch.maximum(minfb, torch.minimum(dst_bb, maxfb))
    median_ff = torch.maximum(minfb, torch.minimum(dst_ff, maxfb))
    mf = mask_f.to(I64)
    mb = mask_b.to(I64)
    out = ((((median_bb * mf + dst_f * (255 - mf) + 255) >> 8) * (256 - t)
            + ((median_ff * mb + dst_b * (255 - mb) + 255) >> 8) * t) >> 8)
    return out.to(I32)


def flow_inter_simple(pref_b, pref_f, oy: int, ox: int, vxb, vxf, vyb, vyf,
                      mask_b, mask_f, time256: int, pel: int) -> torch.Tensor:
    """FlowInterSimple (MaskFun.cpp:491-555), with the time256 == 128 fast
    path and its different rounding."""
    pel_log = pel.bit_length() - 1
    h, w = vxb.shape
    h_idx, w_idx = hw_grids(h, w, vxb.device)
    t = time256
    mf = mask_f.to(I64)
    mb = mask_b.to(I64)

    def fine(pref, vy, vx):
        return _gather_fine(pref, oy, ox, h_idx, w_idx, vy, vx, pel_log)

    if t == 128:
        dst_f = fine(pref_f, vyf >> 1, vxf >> 1)
        dst_b = fine(pref_b, vyb >> 1, vxb >> 1)
        out = (((dst_f + dst_b) << 8) + (dst_b - dst_f) * (mf - mb)) >> 9
    else:
        dst_f = fine(pref_f, (vyf * t) >> 8, (vxf * t) >> 8)
        dst_b = fine(pref_b, (vyb * (256 - t)) >> 8, (vxb * (256 - t)) >> 8)
        out = (((dst_f * (255 - mf) + dst_b * mf + 255) >> 8) * (256 - t)
               + ((dst_b * (255 - mb) + dst_f * mb + 255) >> 8) * t) >> 8
    return out.to(I32)
