"""mv.Degrain1-6 equivalent: motion-compensated temporal denoising.

A redesign of MVDegrains.cpp for a wide parallel device: instead of a
serial per-block loop, all blocks' reference patches are fetched at once
(the block fetch kernel, ops/probe.py), the SAD-driven weights are computed
for the whole block grid in one shot (DegrainWeight / normaliseWeights
MVDegrains.h:184-223), and the weighted sum runs as one elementwise pass at
plane level (Degrain_C MVDegrains.h:31-53), and overlapped blending is the
phase-decomposed overlap-add of ops/overlap.py.  Bit-exact against the
reference's scalar path.  Frames may carry an explicit leading batch axis.

Ported: 8-bit, luma and chroma planes, with and without overlap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField, check_vectors_similarity
from .ops import overlap as overlap_ops
from .ops import probe as probe_ops
from .ops.pad import edge_pad
from .super import Super

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class DegrainConfig:
    """mv.Degrain1-6 parameters (MVDegrains.cpp:475-599)."""
    thsad: int = 400
    thsadc: Optional[int] = None     # defaults to thsad
    plane: int = 4                   # 0 luma, 1/2 chroma, 3 both chroma, 4 all
    limit: Optional[int] = None      # defaults to pixel max
    limitc: Optional[int] = None     # defaults to limit
    thscd1: int = 400                # MV_DEFAULT_SCD1
    thscd2: int = 130                # MV_DEFAULT_SCD2


def _degrain_weight(thsad: int, block_sad: torch.Tensor) -> torch.Tensor:
    """DegrainWeight (MVDegrains.h:184-189): 0 if sad >= thsad, else
    (th-s)*(th+s)*256 / (th^2 + s^2) with double division, truncated."""
    s = block_sad.to(I64)
    num = ((thsad - s) * (thsad + s) * 256).to(torch.float64)
    den = (thsad * thsad + s * s).to(torch.float64)
    w = (num / den).to(I32)
    return torch.where(s >= thsad, 0, w)


def _normalise_weights(wrefs: List[torch.Tensor]):
    """normaliseWeights (MVDegrains.h:209-223)."""
    wsum = 257
    for w in wrefs:
        wsum = wsum + w
    scale = 256.0 / wsum.to(torch.float64)
    out = [(w.to(torch.float64) * scale).to(I32) for w in wrefs]
    wsrc = 256
    for w in out:
        wsrc = wsrc - w
    return wsrc, out


def gather_blocks(plane_stack: torch.Tensor, block_x, block_y, mv_x, mv_y,
                  bsy: int, bsx: int, log_pel: int, pad_x_pel: int,
                  pad_y_pel: int, sub_x: int = 0, sub_y: int = 0, *,
                  pitch_fp: int) -> torch.Tensor:
    """Fetch one [bsy, bsx] int32 patch per block from a pel-subplane stack.

    plane_stack: [B, pel^2, PH, PW] uint8; block_x/y: [nby, nbx] unpadded
    LUMA pixel position of each block; mv_x/mv_y: [B, nby, nbx] in pel
    units; sub_x/sub_y: log2 subsampling of a chroma plane.
    Matches useBlock's mvpGetPointer addressing (MVDegrains.h:192-206):
    blx = (block_pos << log_pel) + mv, shifted arithmetically for chroma.
    The subplane comes from the
    position's own parity; a full-pel origin outside the plane is clamped
    so the whole patch stays inside it (what a window slice does with an
    out-of-range start).  pitch_fp: full-pel distance between consecutive
    blocks of a grid row of block_x [nby, nbx], for the tiled fetch."""
    nb, n_sub, ph, pw = plane_stack.shape
    lp = max(int(round(n_sub ** 0.5)).bit_length() - 1, 0)
    m = (1 << lp) - 1
    xa = (((block_x << log_pel) + mv_x) >> sub_x) + pad_x_pel
    ya = (((block_y << log_pel) + mv_y) >> sub_y) + pad_y_pel
    fx = (xa >> lp).clamp(0, pw - bsx)
    fy = (ya >> lp).clamp(0, ph - bsy)
    cx = ((fx << lp) | (xa & m)).reshape(nb, -1, 1).contiguous()
    cy = ((fy << lp) | (ya & m)).reshape(nb, -1, 1).contiguous()
    flat = probe_ops.fetch_blocks_tiled(
        plane_stack, cy, cx, bsy, bsx, 1 << lp, row_len=block_x.shape[1],
        pitch_x=pitch_fp)[:, :, 0]
    return flat.reshape(nb, *block_x.shape, bsy, bsx)


def extract_grid_blocks(plane: torch.Tensor, nby: int, nbx: int, bsy: int,
                        bsx: int, pitch_y: int, pitch_x: int) -> torch.Tensor:
    """[B, nby, nbx, bsy, bsx] blocks of the static degrain block grid
    (FakePlaneOfBlocks fpobInit positions) of planes [B, H, W]: block
    (j, i) starts at (j * pitch_y, i * pitch_x).  Where the grid runs past
    the plane, the plane's edge pixels repeat."""
    hh, ww = plane.shape[-2:]
    need_h = (nby - 1) * pitch_y + bsy
    need_w = (nbx - 1) * pitch_x + bsx
    if need_h > hh or need_w > ww:
        plane = edge_pad(plane, 0, max(0, need_h - hh), 0,
                         max(0, need_w - ww))
    return (plane[:, :need_h, :need_w].unfold(1, bsy, pitch_y)
            .unfold(2, bsx, pitch_x))


def degrain(src_planes: Sequence[torch.Tensor], super_refs: Sequence[Super],
            mv_fields: Sequence[MVField], meta: AnalysisMeta,
            cfg: DegrainConfig, usable: Optional[Sequence] = None,
            valid: Optional[Sequence] = None):
    """Degrain one frame, or a batch of frames.

    src_planes: the frame to denoise, [Y] or [Y, U, V], each [H, W] or
    batched [B, H, W].
    super_refs: one Super per vector clip, in Backward1, Forward1,
    Backward2, ... order (the reference's VectorOrder, MVDegrains.h:10-23).
    mv_fields: matching MVFields.  radius = len(mv_fields) // 2.
    With a batch, supers and fields carry the same leading [B] axis.
    usable: optional bool tensors per ref (default: computed from thSCD).
    valid: optional bool tensors per ref ANDed into usability — False
    marks a neighbour that does not exist in the clip (reference
    default-field semantics at clip edges, MVAnalyse.c:219-222).
    Returns the denoised planes.
    """
    radius2 = len(mv_fields)
    filter_name = f"Degrain{radius2 // 2}"
    # pairwise vector-clip compatibility (MVDegrains.cpp:599-600) and
    # source frame size (:682-683)
    check_vectors_similarity([f.meta for f in mv_fields], filter_name)
    if tuple(src_planes[0].shape[-2:]) != (meta.height, meta.width):
        raise ValueError(
            f"{filter_name}: wrong source or super clip frame size.")
    if meta.bits_per_sample != 8:
        raise NotImplementedError(f"{filter_name}: 16-bit clips are not ported")
    sspec = super_refs[0].spec
    nplanes = len(src_planes)
    if nplanes > super_refs[0].num_planes:
        raise ValueError(f"{filter_name}: the super clips hold no chroma "
                         "planes")
    pixel_max = (1 << meta.bits_per_sample) - 1
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "Degrain")
    thsadc = cfg.thsadc if cfg.thsadc is not None else cfg.thsad
    # thSAD normalised to block SAD (MVDegrains.cpp:658-660)
    thsad = [cfg.thsad * nscd1 // cfg.thscd1,
             thsadc * nscd1 // cfg.thscd1,
             thsadc * nscd1 // cfg.thscd1]
    limit = cfg.limit if cfg.limit is not None else pixel_max
    limitc = cfg.limitc if cfg.limitc is not None else limit
    limits = [limit, limitc, limitc]
    process = [cfg.plane in (0, 4), cfg.plane in (1, 3, 4),
               cfg.plane in (2, 3, 4)]

    batched = src_planes[0].ndim == 3
    if not batched:
        src_planes = [p[None] for p in src_planes]
        super_refs = [s.map(lambda a: a[None]) for s in super_refs]
    dev = src_planes[0].device

    def lead(t, nd):
        """Give an unbatched field tensor its leading axis."""
        return t if t.ndim == nd else t[None]

    if usable is None:
        usable = [lead(is_usable(mv, nscd1, nscd2), 1) for mv in mv_fields]
    else:
        usable = [lead(torch.as_tensor(u, device=dev), 1) for u in usable]
    if valid is not None:
        usable = [u & lead(torch.as_tensor(v, device=dev), 1)
                  for u, v in zip(usable, valid)]

    nbx, nby = meta.blk_x, meta.blk_y
    bsx, bsy = meta.blk_size_x, meta.blk_size_y
    ovx, ovy = meta.overlap_x, meta.overlap_y
    log_pel = {1: 0, 2: 1, 4: 2}[meta.pel]
    logx = meta.x_ratio_uv.bit_length() - 1
    logy = meta.y_ratio_uv.bit_length() - 1
    pel = sspec.pel

    # per-block positions (FakePlaneOfBlocks fpobInit Fakery.c:17-35)
    pos_y, pos_x = torch.meshgrid(
        torch.arange(nby, dtype=I32, device=dev) * (bsy - ovy),
        torch.arange(nbx, dtype=I32, device=dev) * (bsx - ovx),
        indexing="ij")
    width_b = (bsx - ovx) * nbx + ovx
    height_b = (bsy - ovy) * nby + ovy
    vecs = [(lead(f.levels[0].x, 3), lead(f.levels[0].y, 3),
             lead(f.levels[0].sad, 3)) for f in mv_fields]

    out_planes = []
    for plane in range(nplanes):
        src = src_planes[plane]
        if not process[plane]:
            out_planes.append(src if batched else src[0])
            continue
        sub_x = logx if plane else 0
        sub_y = logy if plane else 0
        p_bsx, p_bsy = bsx >> sub_x, bsy >> sub_y
        p_ovx, p_ovy = ovx >> sub_x, ovy >> sub_y
        p_wb, p_hb = width_b >> sub_x, height_b >> sub_y
        hpad_p = sspec.hpad >> sub_x
        vpad_p = sspec.vpad >> sub_y
        src32 = src.to(I32)

        # per-ref weights + reference blocks
        wrefs = []
        ref_blocks = []
        for r in range(radius2):
            vx, vy, vsad = vecs[r]
            w_r = _degrain_weight(thsad[plane], vsad)
            wrefs.append(torch.where(usable[r][:, None, None], w_r,
                                     0).to(I32))
            ref_blocks.append(gather_blocks(
                super_refs[r].planes[plane][0], pos_x, pos_y, vx, vy, p_bsy,
                p_bsx, log_pel, hpad_p * pel, vpad_p * pel, sub_x, sub_y,
                pitch_fp=(bsx - ovx) >> sub_x))
        wsrc, wrefs = _normalise_weights(wrefs)

        if ovx == 0 and ovy == 0:
            # plane-level weighted sum: source blocks ARE the grid region
            # of the plane; per-block weights upsample by repeat; each
            # fetched ref grid reshapes to plane layout
            def up(wb):
                return (wb.repeat_interleave(p_bsy, dim=1)
                        .repeat_interleave(p_bsx, dim=2))

            gh, gw = nby * p_bsy, nbx * p_bsx
            acc = 128 + src32[:, :gh, :gw] * up(wsrc)
            for r in range(radius2):
                rg = ref_blocks[r].permute(0, 1, 3, 2, 4).reshape(-1, gh, gw)
                acc += rg * up(wrefs[r])
            pix = (acc >> 8)[:, :p_hb, :p_wb]
        else:
            # overlapped: block layout feeds the phase-decomposed
            # overlap-add
            acc = extract_grid_blocks(
                src32, nby, nbx, p_bsy, p_bsx, p_bsy - p_ovy,
                p_bsx - p_ovx) * wsrc[..., None, None]
            acc += 128
            for r in range(radius2):
                acc += ref_blocks[r] * wrefs[r][..., None, None]
            wins = overlap_ops.overlap_windows(p_bsx, p_bsy, p_ovx, p_ovy)
            acc_plane = overlap_ops.overlap_add(
                acc >> 8, nbx, nby, (p_bsx, p_bsy), (p_ovx, p_ovy), wins)
            pix = overlap_ops.to_pixels(acc_plane, meta.bits_per_sample)
        out = src32.clone()
        out[:, :p_hb, :p_wb] = pix
        if limits[plane] < pixel_max:
            out = torch.minimum(torch.maximum(out, src32 - limits[plane]),
                                src32 + limits[plane])
        out = out.to(src.dtype)
        out_planes.append(out if batched else out[0])
    return out_planes
