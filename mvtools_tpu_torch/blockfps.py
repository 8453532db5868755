"""mv.BlockFPS equivalent: block-based frame-rate conversion.

Equivalent of MVBlockFPS.c: per-block motion-compensated fetch from both
neighbour frames with mode 0-8 combination rules (RealResultBlock
:117-228), occlusion = product of forward/backward small masks (MultMasks
:93-101), both non-overlapped and windowed overlap-add assembly, and
time-weighted blending of uncovered margins.  One frame: planes [H, W],
unbatched supers and fields.

The blocks come from degrain.gather_blocks, which on the card runs the
block fetch kernel on the uint8 / uint16 stacks: the motion-compensated
blocks from the neighbours' supers (a start outside the stack is taken
the way a window slice takes it, wrap once and clamp, as the JAX
package's dynamic_slice does) and the source and reference blocks from
their frames' own pixels.  The fetch kernel takes pixel stacks only, so
the int32 full-resolution masks are cut into blocks by a plain gather
with the same addressing (degrain.extract_grid_blocks: block (j, i) at
(j * pitch_y, i * pitch_x), all inside the plane).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from .compensate import unpadded_plane
from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField, check_similarity
from .degrain import extract_grid_blocks, gather_blocks
from .flowutils import FlowGeometry
from .ops import maskfun, pixels, resize
from .ops import overlap as overlap_ops
from .super import Super

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class BlockFPSConfig:
    """mv.BlockFPS parameters (MVBlockFPS.c create)."""
    num: int = 0
    den: int = 1
    mode: int = 3
    ml: float = 100.0
    blend: bool = True
    thscd1: int = 400
    thscd2: int = 130

    def __post_init__(self):
        if not 0 <= self.mode <= 8:
            raise ValueError("BlockFPS: mode must be between 0 and 8 (inclusive).")


def _median(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _trunc_div(a, b: int):
    return a if b == 1 else torch.div(a, b, rounding_mode="trunc")


def blockfps_frame(src_planes: Sequence[torch.Tensor],
                   ref_planes: Sequence[torch.Tensor],
                   src_super: Super, ref_super: Super,
                   mv_b: MVField, mv_f: MVField,
                   meta: AnalysisMeta, cfg: BlockFPSConfig,
                   time256: int) -> List[torch.Tensor]:
    """Synthesise the intermediate frame between nleft (src) and nright
    (ref).  mv_b = mvbw at nleft, mv_f = mvfw at nright."""
    if time256 == 0:
        return list(src_planes)
    if time256 == 256:
        return list(ref_planes)

    if mv_b.meta is not None and mv_f.meta is not None:
        check_similarity(mv_b.meta, mv_f.meta, "BlockFPS", "mvbw", "mvfw")
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "BlockFPS")
    usable = is_usable(mv_b, nscd1, nscd2) & is_usable(mv_f, nscd1, nscd2)
    geo = FlowGeometry.from_meta(meta)
    mode = cfg.mode
    pel = meta.pel
    log_pel = pel.bit_length() - 1
    bits = meta.bits_per_sample
    nbx, nby = meta.blk_x, meta.blk_y
    bsx, bsy = meta.blk_size_x, meta.blk_size_y
    ovx, ovy = meta.overlap_x, meta.overlap_y
    logx = meta.x_ratio_uv.bit_length() - 1
    logy = meta.y_ratio_uv.bit_length() - 1
    width_b = (bsx - ovx) * nbx + ovx
    height_b = (bsy - ovy) * nby + ovy

    fb = mv_b.levels[0]
    ff = mv_f.levels[0]
    dev = fb.x.device

    # small masks (mode dependent, MVBlockFPS.c:170-205)
    need_masks = 3 <= mode <= 8
    need_occ = mode in (4, 5, 7, 8)
    mask_small_f = mask_small_b = occ_small = None
    if need_masks:
        if mode <= 5:
            mask_small_f = maskfun.make_vector_occlusion_mask_time(
                ff.x, ff.y, False, float(cfg.ml), 1.0, pel, time256,
                bsx - ovx, bsy - ovy)
            mask_small_b = maskfun.make_vector_occlusion_mask_time(
                fb.x, fb.y, True, float(cfg.ml), 1.0, pel, 256 - time256,
                bsx - ovx, bsy - ovy)
        else:
            mask_small_f = maskfun.make_sad_mask_time(
                ff.x, ff.y, ff.sad, 4.0 / (cfg.ml * bsx * bsy), 1.0, pel,
                time256, bsx - ovx, bsy - ovy, bits)
            mask_small_b = maskfun.make_sad_mask_time(
                fb.x, fb.y, fb.sad, 4.0 / (cfg.ml * bsx * bsy), 1.0, pel,
                256 - time256, bsx - ovx, bsy - ovy, bits)
        mask_small_f = maskfun.check_and_pad_mask(mask_small_f, geo.nblkx_p,
                                                  geo.nblky_p)
        mask_small_b = maskfun.check_and_pad_mask(mask_small_b, geo.nblkx_p,
                                                  geo.nblky_p)
        if need_occ:
            occ_small = (mask_small_f * mask_small_b) // 255

    pos_y, pos_x = torch.meshgrid(
        torch.arange(nby, dtype=I32, device=dev) * (bsy - ovy),
        torch.arange(nbx, dtype=I32, device=dev) * (bsx - ovx),
        indexing="ij")

    # MC positions in pel units (MVBlockFPS.c:477-483): block pos * pel +
    # (v * t) >> 8 (arithmetic shift)
    mcb_x = (pos_x << log_pel) + ((fb.x * (256 - time256)) >> 8)
    mcb_y = (pos_y << log_pel) + ((fb.y * (256 - time256)) >> 8)
    mcf_x = (pos_x << log_pel) + ((ff.x * time256) >> 8)
    mcf_y = (pos_y << log_pel) + ((ff.y * time256) >> 8)

    out = []
    for plane in range(len(src_planes)):
        sub_x = logx if plane else 0
        sub_y = logy if plane else 0
        xr = meta.x_ratio_uv if plane else 1
        yr = meta.y_ratio_uv if plane else 1
        p_bsx, p_bsy = bsx >> sub_x, bsy >> sub_y
        p_ovx, p_ovy = ovx >> sub_x, ovy >> sub_y
        p_wb, p_hb = width_b >> sub_x, height_b >> sub_y
        hpad_p = meta.hpadding >> sub_x
        vpad_p = meta.vpadding >> sub_y
        sp_x = pos_x >> sub_x
        sp_y = pos_y >> sub_y
        pitch = p_bsx - p_ovx

        def gather_mc(sup, mx, my):
            # positions in pel units; chroma divides (truncating); the
            # block at pel position (gx, gy) of the padded stack
            stk = sup.planes[plane][0]
            lp = max(int(round(stk.shape[0] ** 0.5)).bit_length() - 1, 0)
            gx = _trunc_div(mx, xr) + hpad_p * pel
            gy = _trunc_div(my, yr) + vpad_p * pel
            return gather_blocks(stk[None], sp_x, sp_y,
                                 (gx - (sp_x << lp))[None],
                                 (gy - (sp_y << lp))[None], p_bsy, p_bsx,
                                 lp, 0, 0, pitch_fp=pitch)[0]

        mcb = gather_mc(ref_super, mcb_x, mcb_y)   # B vectors: ref (nright)
        mcf = gather_mc(src_super, mcf_x, mcf_y)   # F vectors: src (nleft)

        src_px = unpadded_plane(src_super, plane, meta)
        ref_px = unpadded_plane(ref_super, plane, meta)
        zeros = torch.zeros((1,) + tuple(sp_x.shape), dtype=I32, device=dev)

        def grid_blocks(px):
            return gather_blocks(px.contiguous()[None, None], sp_x, sp_y,
                                 zeros, zeros, p_bsy, p_bsx, 0, 0, 0,
                                 pitch_fp=pitch)[0]

        src_blocks = grid_blocks(src_px)
        ref_blocks = grid_blocks(ref_px)
        src_u = pixels.widen(src_px)
        ref_u = pixels.widen(ref_px)

        # full-res masks, cut into the blocks of the grid
        def mask_blocks(small):
            full = resize.simple_resize(small, geo.height_p // yr,
                                        geo.width_p // xr)
            return extract_grid_blocks(full[None], nby, nbx, p_bsy, p_bsx,
                                       p_bsy - p_ovy, pitch)[0]

        mb = mask_blocks(mask_small_b) if need_masks else None
        mf = mask_blocks(mask_small_f) if need_masks else None
        occ = mask_blocks(occ_small) if need_occ else None

        t = time256
        if mode == 0:
            blocks = (mcb * t + mcf * (256 - t)) >> 8
        elif mode == 1:
            mca = (mcb * t + mcf * (256 - t)) >> 8
            blocks = _median(ref_blocks, src_blocks, mca)
        elif mode == 2:
            avg = (ref_blocks * t + src_blocks * (256 - t)) >> 8
            blocks = _median(avg, mcb, mcf)
        elif mode in (3, 6):
            blocks = (((mb * mcf + (255 - mb) * mcb + 255) >> 8) * t
                      + ((mf * mcb + (255 - mf) * mcf + 255) >> 8)
                      * (256 - t)) >> 8
        elif mode in (4, 7):
            f = (mf * mcb + (255 - mf) * mcf + 255) >> 8
            b = (mb * mcf + (255 - mb) * mcb + 255) >> 8
            avg = (ref_blocks * t + src_blocks * (256 - t) + 255) >> 8
            m = (b * t + f * (256 - t)) >> 8
            blocks = (avg * occ + m * (255 - occ) + 255) >> 8
        else:  # 5, 8: show the occlusion mask
            blocks = occ << (bits - 8)

        res = maskfun.blend(src_u, ref_u, t, bits)
        if ovx == 0 and ovy == 0:
            res[:nby * p_bsy, :nbx * p_bsx] = blocks.permute(0, 2, 1, 3) \
                .reshape(nby * p_bsy, nbx * p_bsx)
        else:
            wins = overlap_ops.overlap_windows(p_bsx, p_bsy, p_ovx, p_ovy)
            acc = overlap_ops.overlap_add(blocks[None], nbx, nby,
                                          (p_bsx, p_bsy), (p_ovx, p_ovy),
                                          wins)[0]
            res[:p_hb, :p_wb] = overlap_ops.to_pixels(acc, bits)

        src_p = pixels.widen(src_planes[plane])
        ref_p = pixels.widen(ref_planes[plane])
        if cfg.blend:
            fallback = maskfun.blend(src_p, ref_p, t, bits)
        else:
            fallback = src_p
        out.append(pixels.narrow(torch.where(usable, res, fallback),
                                 src_planes[plane].dtype))
    return out
