"""mv.Analyse equivalent: hierarchical block motion search, lock-step
engine.

A redesign of the reference engine (GroupOfPlanes.c:69-125,
PlaneOfBlocks.cpp:819-1131) for a wide parallel device.  The reference's
EPZ walk is Gauss-Seidel: each block's left/up predictors read vectors
written moments earlier in the same raster pass (pobFetchPredictors
PlaneOfBlocks.cpp:419-440), which serializes the scan.  Here every block of
every job of a batch searches SIMULTANEOUSLY, and the neighbour predictors
are iterated Jacobi-style: iteration k reads the field produced by
iteration k-1 (iteration 0 reads the inter-level prediction).  Differences
vs the sequential engine: predictor values lag one iteration, and the
badcount feedback (PlaneOfBlocks.cpp:942-945) is per-block instead of
globally accumulated.

Every tensor carries an explicit leading job axis [J, ...]; analyse() is
the J = 1 case of analyse_batch().  Pixels are uint8 (uint16 for clips of
9 to 16 bits), block math int32, costs int64.

Float islands: the lambda adaptation uses C doubles (pobFetchPredictors
PlaneOfBlocks.cpp:461-462), reproduced here in float64 on the device.

Ported: luma and chroma, overlapped block grids, the plain-SAD cost (dct 0),
the DCT costs (dct 1-4) and the SATD costs (dct 5-10), pel 1/2, 8-bit, and
9- to 16-bit clips with dct 0 while a block's SAD stays under 2^24 (16-bit:
blocks up to 16x16), searches HEX2 and EXHAUSTIVE, no
trymany/divide/field_shift, every level on the dense map.  Anything else
raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import field_engine as fe
from .core import geometry
from .core.config import AnalyseSpec
from .core.types import MVField, MVPlaneField, SearchType
from .field_engine import mix_dct_cost, mix_dct_cost_sums, mix_satd_cost
from .ops import dct as dct_ops
from .ops import pixels
from .ops import sad as sad_ops
from .ops.pad import edge_pad
from .super import Super

I32 = torch.int32
I64 = torch.int64


class LevelCtx(NamedTuple):
    """Static + tensor context of one pyramid level of a batch of frame
    pairs."""
    src_planes: Tuple[torch.Tensor, ...]  # per color plane [J, ph, pw]
    ref_stacks: Tuple[torch.Tensor, ...]  # per color plane [J, pel^2, ph, pw]
    # static geometry
    level: int
    pel: int            # this level's pel (1 except finest)
    log_pel: int
    blk_size: Tuple[int, int]       # (bsx, bsy) luma
    blk_size_c: Tuple[int, int]     # chroma
    nblk: Tuple[int, int]           # (nblkx, nblky)
    overlap: Tuple[int, int]
    log_ratio_uv: Tuple[int, int]   # (log2 xRatioUV, log2 yRatioUV)
    hpad: Tuple[int, int]           # (luma, chroma)
    vpad: Tuple[int, int]
    padded: Tuple[int, int]         # luma (pw, ph)
    bits: int
    chroma: bool


def _trunc_div(a, b):
    """C integer division (truncation toward zero) for positive divisor."""
    return torch.sign(a) * (a.abs() // b)


def _median3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


class DenseEvaluator:
    """SAD evaluation for UNIFORM displacements: every block of every job
    probes the same vector (the zero trial; the rescue cross/hex4 around
    (0,0), PlaneOfBlocks.cpp:727-769, 940-963).

    A uniform displacement is one SHIFT of the whole ref plane + an
    elementwise |src-ref| + per-block box sums — no gathers, bit-identical
    SAD values.  With dctmode 1-4 the luma cost is the DCT mix and with
    dctmode 5-10 the SATD mix: the transform is taken per block on block
    views of the shifted region, the reference sums come from the same box
    sums.

    The differences run in int16 for 8-bit pixels and in int32 for deeper
    ones, whose differences int16 cannot hold.
    """

    def __init__(self, ctx: LevelCtx, pad: int, dctmode: int = 0,
                 src_luma=None, dctweight16=None, dct_src=None):
        """src_luma: [J, nblk] int64 source block sums; dctweight16: [J];
        dct_src: [J, nblk, bsy, bsx] int32 requantised DCT of the source
        blocks (dct 1-4)."""
        self.ctx = ctx
        self.pad = pad
        self.dctmode = dctmode
        self.src_luma = src_luma
        self.dctweight16 = dctweight16
        self.dct_src = dct_src
        self._src_view = None           # [J, nblk, bsy, bsx], made on demand
        bsx, bsy = ctx.blk_size
        bcx, bcy = ctx.blk_size_c
        ovx, ovy = ctx.overlap
        nbx, nby = ctx.nblk
        logx, logy = ctx.log_ratio_uv
        hpad, hpad_c = ctx.hpad
        vpad, vpad_c = ctx.vpad
        # luma block-grid region and padded ref stack
        self.hr = (nby - 1) * (bsy - ovy) + bsy
        self.wr = (nbx - 1) * (bsx - ovx) + bsx
        self._work = torch.int16 if ctx.bits == 8 else torch.int32
        self.src_region = self._diffable(ctx.src_planes[0][
            :, vpad:vpad + self.hr, hpad:hpad + self.wr])
        self.ref_pad = edge_pad(ctx.ref_stacks[0], pad, pad, pad, pad)
        self.base_y = vpad + pad
        self.base_x = hpad + pad
        if ctx.chroma:
            pc = max(pad >> logx, pad >> logy, 2)
            self.hr_c = (nby - 1) * ((bsy - ovy) >> logy) + bcy
            self.wr_c = (nbx - 1) * ((bsx - ovx) >> logx) + bcx
            self.src_regions_c = tuple(
                self._diffable(ctx.src_planes[p][
                    :, vpad_c:vpad_c + self.hr_c, hpad_c:hpad_c + self.wr_c])
                for p in (1, 2))
            self.ref_pads_c = tuple(edge_pad(ctx.ref_stacks[p], pc, pc, pc, pc)
                                    for p in (1, 2))
            self.base_y_c = vpad_c + pc
            self.base_x_c = hpad_c + pc

    def _diffable(self, pix):
        """Pixels in the dtype the differences run in."""
        if self._work == torch.int16:
            return pix.to(torch.int16)
        return pixels.widen(pix)

    @staticmethod
    def _block_sums(diff, bs, ov, nb):
        """Per-block sums of `diff` [J, hr, wr] over a (possibly
        overlapped) regular block grid -> [J, nblk] int64.

        Where the block pitch divides the block size (no overlap, overlap
        of half a block) the region is cut into pitch-sized cells, the
        cells are summed, and a block is the sum of its cells.  Any other
        overlap goes through an int64 integral image; the corner reads are
        strided slices because the block origins form a regular grid."""
        bsx, bsy = bs
        ovx, ovy = ov
        nbx, nby = nb
        sy, sx = bsy - ovy, bsx - ovx
        if bsy % sy == 0 and bsx % sx == 0:
            ky, kx = bsy // sy, bsx // sx
            cells = diff.reshape(-1, nby - 1 + ky, sy, nbx - 1 + kx,
                                 sx).sum(dim=(2, 4), dtype=I64)
            s = cells[:, :nby, :nbx].clone()
            for j in range(ky):
                for i in range(kx):
                    if j or i:
                        s += cells[:, j:j + nby, i:i + nbx]
            return s.reshape(-1, nby * nbx)
        integ = torch.nn.functional.pad(
            diff.to(I64).cumsum(dim=1).cumsum(dim=2), (1, 0, 1, 0))

        def corners(oy, ox):
            return integ[:, oy:oy + (nby - 1) * sy + 1:sy,
                         ox:ox + (nbx - 1) * sx + 1:sx]

        return (corners(bsy, bsx) - corners(bsy, 0) - corners(0, bsx)
                + corners(0, 0)).reshape(-1, nby * nbx)

    @staticmethod
    def _shifted_region(ref_pad, idx, sy, sx, hr, wr):
        """[J, hr, wr] view of subplane idx of ref_pad at origin (sy, sx);
        an origin outside the padded plane clamps, as a window slice
        would."""
        hp, wp = ref_pad.shape[-2:]
        sy = min(max(sy, 0), hp - hr)
        sx = min(max(sx, 0), wp - wr)
        return ref_pad[:, idx, sy:sy + hr, sx:sx + wr]

    def _shifted_sads(self, src_region, ref_pad, idx, sy, sx, bs, ov, nb):
        """[J, nblk] int64 SADs of the block grid of src_region [J, hr, wr]
        against subplane idx of ref_pad at region origin (sy, sx)."""
        region = self._shifted_region(ref_pad, idx, sy, sx,
                                      *src_region.shape[-2:])
        diff = (src_region - self._diffable(region)).abs_()
        return self._block_sums(diff, bs, ov, nb)

    def luma_sads(self, vx: int, vy: int) -> torch.Tensor:
        """[J, nblk] int64 luma cost at the uniform pel-units displacement
        (vx, vy), Python ints: the SAD, the DCT mix for dct 1-4 or the SATD
        mix for dct 5-10
        (pobGetRefBlock pel math, PlaneOfBlocks.cpp:34-54 — block origins
        are pel-aligned so the subplane index is uniform)."""
        ctx = self.ctx
        pelm = ctx.pel - 1
        logp = ctx.log_pel
        idx = (vx & pelm) | ((vy & pelm) << logp)
        sy, sx = self.base_y + (vy >> logp), self.base_x + (vx >> logp)
        s = self._shifted_sads(
            self.src_region, self.ref_pad, idx, sy, sx, ctx.blk_size,
            ctx.overlap, ctx.nblk)
        if not self.dctmode:
            return s
        # the same region once more, per block: the transform has no
        # sliding decomposition
        region = self._shifted_region(self.ref_pad, idx, sy, sx, self.hr,
                                      self.wr)
        (bsx, bsy), (ovx, ovy), (nbx, nby) = ctx.blk_size, ctx.overlap, ctx.nblk
        ref_view = _blocks_of(region, 0, 0, nby, nbx, bsy, bsx, bsy - ovy,
                              bsx - ovx)
        if self.dctmode <= 4:
            ref_luma = (self._block_sums(region, ctx.blk_size, ctx.overlap,
                                         ctx.nblk)
                        if self.dctmode >= 3 else None)
            return mix_dct_cost(self.dctmode, s, self.dct_src,
                                dct_ops.dct_block(ref_view, ctx.bits),
                                self.src_luma, ref_luma,
                                self.dctweight16[:, None], bsx)
        if self._src_view is None:
            self._src_view = _blocks_of(self.src_region, 0, 0, nby, nbx, bsy,
                                        bsx, bsy - ovy, bsx - ovx)
        satd_v = sad_ops.satd(self._src_view, ref_view)
        ref_luma = self._block_sums(region, ctx.blk_size, ctx.overlap,
                                    ctx.nblk)
        return mix_satd_cost(self.dctmode, s, satd_v, self.src_luma, ref_luma,
                             self.dctweight16[:, None])

    def chroma_sads(self, vx: int, vy: int):
        """[J, nblk] int64 U + V SAD at the chroma position of the uniform
        luma displacement (vx, vy); the division by the subsampling ratio
        truncates toward zero (pobGetRefBlockU/V PlaneOfBlocks.cpp:57-77).
        The int 0 without chroma."""
        ctx = self.ctx
        if not ctx.chroma:
            return 0
        pelm = ctx.pel - 1
        logp = ctx.log_pel
        logx, logy = ctx.log_ratio_uv
        tx = (vx + ((1 << logx) - 1 if vx < 0 else 0)) >> logx
        ty = (vy + ((1 << logy) - 1 if vy < 0 else 0)) >> logy
        idx = (tx & pelm) | ((ty & pelm) << logp)
        ov = (ctx.overlap[0] >> logx, ctx.overlap[1] >> logy)
        total = 0
        for src_region, ref_pad in zip(self.src_regions_c, self.ref_pads_c):
            total = total + self._shifted_sads(
                src_region, ref_pad, idx, self.base_y_c + (ty >> logp),
                self.base_x_c + (tx >> logp), ctx.blk_size_c, ov, ctx.nblk)
        return total

    def check_uniform(self, field, offsets, bounds, pred, lam, pnew,
                      active):
        """Sequential running-min update over a static list of uniform
        displacements — one plane-shift per candidate.

        field: dict of [J, nblk] tensors (bx, by, bsad, mincost);
        offsets: static [(dx, dy)] in pel units, evaluated in order;
        bounds: (dxmin, dxmax, dymin, dymax) [nblk];
        pred: (pred_x, pred_y) [J, nblk]; active: [J, nblk] bool gate.
        """
        dxmin, dxmax, dymin, dymax = bounds
        px, py = pred
        bx, by = field["bx"], field["by"]
        bsad, mincost = field["bsad"], field["mincost"]
        for vx, vy in offsets:
            ls = self.luma_sads(vx, vy)
            cs = self.chroma_sads(vx, vy)
            ok = (active & (vx >= dxmin) & (vy >= dymin)
                  & (vx < dxmax) & (vy < dymax))
            dx = px - vx
            dy = py - vy
            dist = (dx * dx + dy * dy).to(I32)
            md = ((lam * dist.to(I64)) >> 8).to(I32).to(I64)
            cost = md + ls + cs + ((pnew * ls) >> 8) + ((pnew * cs) >> 8)
            improve = ok & (cost < mincost)
            bx = torch.where(improve, vx, bx)
            by = torch.where(improve, vy, by)
            bsad = torch.where(improve, ls + cs, bsad)
            mincost = torch.where(improve, cost, mincost)
        return dict(bx=bx, by=by, bsad=bsad, mincost=mincost)


def _blocks_of(plane, base_y, base_x, nb_y, nb_x, bh, bw, step_y=None,
               step_x=None):
    """[J, nblk, bh, bw] blocks of a regular grid with pitch (step_y,
    step_x), default the block size, contiguous: overlapped grids are
    strided views copied once, and so is a single row (which reshape would
    leave a view)."""
    step_y = bh if step_y is None else step_y
    step_x = bw if step_x is None else step_x
    region = plane[:, base_y:base_y + (nb_y - 1) * step_y + bh,
                   base_x:base_x + (nb_x - 1) * step_x + bw]
    return (region.unfold(1, bh, step_y).unfold(2, bw, step_x)
            .reshape(-1, nb_y * nb_x, bh, bw).contiguous())


def search_level_lockstep(ctx: LevelCtx, level_params, vectors_in,
                          global_mv, mean_luma_change, iters: int = 1,
                          rescue_mode: str = "inline", resc_state=None):
    """Search all blocks of one level for the whole batch.

    vectors_in: (x, y, sad) [J, nblk] inter-level prediction; global_mv:
    (gx, gy) [J]; mean_luma_change: [J] int32.  Returns
    ((x, y, sad), mean_luma_change).

    rescue_mode: "inline" (default) runs the bad-SAD rescue inside this
    call; "defer" skips it and returns a third value, the state the
    rescue needs; "apply" skips the search and runs ONLY the rescue from a
    previously returned state."""
    nbx, nby = ctx.nblk
    nblk = nbx * nby
    bsx, bsy = ctx.blk_size
    bcx, bcy = ctx.blk_size_c
    ovx, ovy = ctx.overlap
    logx, logy = ctx.log_ratio_uv
    hpad, hpad_c = ctx.hpad
    vpad, vpad_c = ctx.vpad
    pw, ph = ctx.padded
    logp = ctx.log_pel
    level = ctx.level
    dev = ctx.src_planes[0].device
    dctmode = level_params["dctmode"]
    if rescue_mode not in ("inline", "defer", "apply"):
        raise ValueError(f"unknown rescue_mode {rescue_mode!r}")
    smallest = level_params["smallest_plane"]
    meander = level_params["meander"]
    lsad_const = level_params["lsad"]
    lambda_level = level_params["lambda_level"]
    pnew = level_params["pnew"]

    dctweight16 = torch.clamp(mean_luma_change.abs() // (bsx * bsy), max=16)
    hps = hpad >> level
    vps = vpad >> level
    gx_scaled = ((1 << logp) * global_mv[0]).to(I32)
    gy_scaled = ((1 << logp) * global_mv[1]).to(I32)

    idx = torch.arange(nblk, dtype=I32, device=dev)
    blky_a = idx // nbx
    blkx_a = idx % nbx
    if meander:
        scan_dir_a = torch.where((blky_a % 2) == 0, 1, -1).to(I32)
    else:
        scan_dir_a = torch.ones_like(idx)

    x0_a = hpad + (bsx - ovx) * blkx_a
    y0_a = vpad + (bsy - ovy) * blky_a
    xc_a = hpad_c + ((bsx - ovx) >> logx) * blkx_a
    yc_a = vpad_c + ((bsy - ovy) >> logy) * blky_a
    dxmax_a = ((pw - bsx - hpad + hps) - x0_a) << logp
    dymax_a = ((ph - bsy - vpad + vps) - y0_a) << logp
    dxmin_a = -((x0_a - (hpad - hps)) << logp)
    dymin_a = -((y0_a - (vpad - vps)) << logp)
    lam0_a = torch.where(blky_a == 0, 0, lambda_level).to(torch.float64)

    src_blocks = [_blocks_of(ctx.src_planes[0], vpad, hpad, nby, nbx, bsy,
                             bsx, bsy - ovy, bsx - ovx)]
    if ctx.chroma:
        src_blocks += [
            _blocks_of(ctx.src_planes[p], vpad_c, hpad_c, nby, nbx, bcy, bcx,
                       (bsy - ovy) >> logy, (bsx - ovx) >> logx)
            for p in (1, 2)]

    # static per-row scan direction for the grid-shift predictor fetch
    # ([nby, 1] bool: True = raster order, i.e. predecessor left)
    if meander:
        fwd_row = (torch.arange(nby, device=dev) % 2 == 0)[:, None]
    else:
        fwd_row = torch.ones((nby, 1), dtype=torch.bool, device=dev)

    def _nbr(a, dy_n: int, signed_dx: int):
        """[J, nblk] value at grid neighbour (by + dy_n,
        bx + scan_dir*signed_dx).  Out-of-grid entries are zero — callers
        mask them."""
        a2 = a.reshape(-1, nby, nbx)
        pad = torch.nn.functional.pad(a2, (1, 1, 1, 1))

        def at(dy2, dx2):
            return pad[:, 1 + dy2:1 + dy2 + nby, 1 + dx2:1 + dx2 + nbx]

        if signed_dx == 0:
            out = at(dy_n, 0)
        else:
            out = torch.where(fwd_row, at(dy_n, signed_dx),
                              at(dy_n, -signed_dx))
        return out.reshape(-1, nblk)

    def predictors_from(vx_a, vy_a, vs_a):
        """Jacobi neighbour predictors, meander-aware layout
        (pobFetchPredictors PlaneOfBlocks.cpp:419-463)."""
        def clip(x, y):
            return (_clip(x, dxmin_a, dxmax_a - 1),
                    _clip(y, dymin_a, dymax_a - 1))

        left_ok = torch.where(scan_dir_a == 1, blkx_a > 0, blkx_a < nbx - 1)
        p1x, p1y = clip(torch.where(left_ok, _nbr(vx_a, 0, -1), 0),
                        torch.where(left_ok, _nbr(vy_a, 0, -1), 0))
        p1s = torch.where(left_ok, _nbr(vs_a, 0, -1), 0)

        up_ok = blky_a > 0
        p2x, p2y = clip(torch.where(up_ok, _nbr(vx_a, -1, 0), 0),
                        torch.where(up_ok, _nbr(vy_a, -1, 0), 0))
        p2s = torch.where(up_ok, _nbr(vs_a, -1, 0), 0)

        x_ok = torch.where(scan_dir_a == 1, blkx_a < nbx - 1, blkx_a > 0)
        br_ok = (blky_a < nby - 1) & x_ok
        ur_ok = up_ok & x_ok
        p3x_raw = torch.where(br_ok, _nbr(vx_a, 1, 1),
                              torch.where(ur_ok, _nbr(vx_a, -1, 1), 0))
        p3y_raw = torch.where(br_ok, _nbr(vy_a, 1, 1),
                              torch.where(ur_ok, _nbr(vy_a, -1, 1), 0))
        p3s = torch.where(br_ok, _nbr(vs_a, 1, 1),
                          torch.where(ur_ok, _nbr(vs_a, -1, 1), 0))
        p3x, p3y = clip(p3x_raw, p3y_raw)

        p0x = torch.where(up_ok, _median3(p1x, p2x, p3x), p1x)
        p0y = torch.where(up_ok, _median3(p1y, p2y, p3y), p1y)
        p0s = torch.where(up_ok, torch.maximum(p1s, torch.maximum(p2s, p3s)),
                          p1s)
        return (p0x, p0y, p0s), (p1x, p1y), (p2x, p2y), (p3x, p3y)

    pred_in_x = _clip(vectors_in[0], dxmin_a, dxmax_a - 1)
    pred_in_y = _clip(vectors_in[1], dymin_a, dymax_a - 1)
    pred_in_s = vectors_in[2]

    bounds = (dxmin_a, dxmax_a, dymin_a, dymax_a)
    if not fe.map_supported(ctx, fe.map_radius(ctx), dctmode):
        raise NotImplementedError(
            f"level {level}: the plane cannot ride the dense SAD map; the "
            "probe-only search that serves such levels is not ported")
    cost = fe.cost_keywords(dctmode, src_blocks[0], dctweight16, ctx.bits)
    stacks = fe.pad_stacks(ctx)
    prober = fe.FieldProber(ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds,
                            pnew, stacks=stacks, **cost)
    if level_params["badrange"] > 0:
        max_off = level_params["badrange"] * ctx.pel + 4
    elif level_params["badrange"] < 0:
        max_off = -level_params["badrange"] * ctx.pel + ctx.pel
    else:
        max_off = 1
    dense = DenseEvaluator(ctx, (max_off >> ctx.log_pel) + 2, **cost)
    if rescue_mode == "apply":
        st = {k: resc_state[k]
              for k in ("bx", "by", "bsad", "mincost", "dir")}
        st = fe.field_rescue(
            prober, dense, level_params, st, resc_state["lam"],
            (resc_state["prx"], resc_state["pry"]), idx, probe_p=prober)
        return (st["bx"], st["by"], st["bsad"]), mean_luma_change

    vx_a, vy_a, vs_a = vectors_in
    for it in range(iters):
        p0, p1, p2, p3 = predictors_from(vx_a, vy_a, vs_a)
        if smallest:
            prx, pry, prs = p0
        else:
            prx, pry, prs = pred_in_x, pred_in_y, pred_in_s
        # lambda adaptation in C doubles, truncated toward zero
        lsad_f = float(lsad_const)
        scale = lsad_f / (lsad_f + (prs >> 1).to(torch.float64))
        lam_a = ((lam0_a * scale) * scale).to(I64)
        p_it = fe.MapProber(ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds,
                            pnew, pred_vx=prx, pred_vy=pry, stacks=stacks,
                            **cost)
        # the bad-SAD rescue runs once per reference block pass;
        # intermediate Jacobi sweeps skip it
        st = fe.field_epz(p_it, dense, level_params, gx_scaled, gy_scaled,
                          (prx, pry, prs), (p0[:2], p1, p2, p3), lam_a, idx,
                          do_rescue=(rescue_mode == "inline"
                                     and it == iters - 1),
                          probe_p=prober)
        vx_a, vy_a, vs_a = st["bx"], st["by"], st["bsad"]
    if smallest:
        ref0_blocks = _blocks_of(ctx.ref_stacks[0][:, 0], vpad, hpad, nby,
                                 nbx, bsy, bsx, bsy - ovy, bsx - ovx)
        sumluma = (sad_ops.luma(ref0_blocks)
                   - sad_ops.luma(src_blocks[0])).sum(dim=-1)
        mean_luma_change = _trunc_div(sumluma, nblk).to(I32)
    if rescue_mode == "defer":
        resc = dict(bx=vx_a, by=vy_a, bsad=vs_a, mincost=st["mincost"],
                    dir=st["dir"], lam=lam_a, prx=prx, pry=pry)
        return (vx_a, vy_a, vs_a), mean_luma_change, resc
    return (vx_a, vy_a, vs_a), mean_luma_change


# ---------------------------------------------------------------------------
# Global MV estimation (pobEstimateGlobalMVDoubled PlaneOfBlocks.cpp:1559-1636)


def estimate_global_mv_doubled(vx, vy):
    """Most-frequent x/y (first max wins = smallest value among the modes)
    + mean of joint inliers within +-6, doubled for the next finer level.
    vx, vy: [J, nblk]; returns (gx, gy) int32 [J]."""

    def most_frequent(v):
        # sort + run lengths: the leftmost longest run is exactly the
        # reference histogram's first argmax
        vals, _ = torch.sort(v, dim=-1)
        n = vals.shape[-1]
        pos = torch.arange(n, device=v.device)
        change = vals[:, 1:] != vals[:, :-1]
        one = torch.ones_like(vals[:, :1], dtype=torch.bool)
        start_flag = torch.cat([one, change], dim=-1)
        end_flag = torch.cat([change, one], dim=-1)
        run_start = torch.where(start_flag, pos, -1).cummax(dim=-1).values
        score = torch.where(end_flag, pos - run_start + 1, 0)
        best = score.amax(dim=-1, keepdim=True)
        k = torch.where(score == best, pos, n).amin(dim=-1, keepdim=True)
        return vals.gather(-1, k)[:, 0].to(I32)

    medianx = most_frequent(vx)
    mediany = most_frequent(vy)
    inlier = (((vx - medianx[:, None]).abs() < 6)
              & ((vy - mediany[:, None]).abs() < 6))
    num = inlier.sum(dim=-1)
    sumx = torch.where(inlier, vx, 0).sum(dim=-1)
    sumy = torch.where(inlier, vy, 0).sum(dim=-1)
    den = num.clamp(min=1)
    gx = torch.where(num > 0, _trunc_div(2 * sumx, den), 2 * medianx)
    gy = torch.where(num > 0, _trunc_div(2 * sumy, den), 2 * mediany)
    return gx.to(I32), gy.to(I32)


# ---------------------------------------------------------------------------
# Hierarchical prediction (pobInterpolatePrediction PlaneOfBlocks.cpp:1447-1514)


def interpolate_prediction(coarse, nbx2: int, nby2: int, nbx: int, nby: int,
                           blk_size, overlap, log_pel_fine: int):
    """Interpolate level lv+1 vectors [J, nby2*nbx2] to the level lv grid
    [J, nby*nbx].  Returns (x, y, sad) flat tensors."""
    cvx, cvy, cvs = coarse
    bsx, bsy = blk_size
    ovx, ovy = overlap
    dev = cvx.device
    norm_factor = 3 - log_pel_fine  # coarse level pel is always 1
    mul_factor = -norm_factor if norm_factor < 0 else 0
    norm_factor = max(norm_factor, 0)

    # clamped fine->coarse index maps are static
    i_np = np.minimum(np.arange(nbx), 2 * nbx2 - 1)
    j_np = np.minimum(np.arange(nby), 2 * nby2 - 1)
    i2 = torch.as_tensor(i_np // 2, device=dev)
    j2 = torch.as_tensor(j_np // 2, device=dev)
    offx = torch.as_tensor(-1 + 2 * (i_np % 2), device=dev)
    offy = torch.as_tensor(-1 + 2 * (j_np % 2), device=dev)
    edge_x = torch.as_tensor((i_np == 0) | (i_np >= 2 * nbx2 - 1),
                             device=dev)[None, :]
    edge_y = torch.as_tensor((j_np == 0) | (j_np >= 2 * nby2 - 1),
                             device=dev)[:, None]
    i2x = (i2 + offx).clamp(0, nbx2 - 1)
    j2y = (j2 + offy).clamp(0, nby2 - 1)

    def corners(cv):
        a2 = cv.reshape(-1, nby2, nbx2)
        cc = a2[:, j2[:, None], i2[None, :]]
        cx = a2[:, j2[:, None], i2x[None, :]]
        cy = a2[:, j2y[:, None], i2[None, :]]
        xy = a2[:, j2y[:, None], i2x[None, :]]
        return cc, cx, cy, xy

    if ovx or ovy:
        if ovx > bsx // 2 or ovy > bsy // 2:
            raise ValueError("interpolate_prediction: overlap larger than "
                             "half a block")
        # area weights of the four coarse vectors under an overlapped grid
        ax1 = torch.where(offx > 0, bsx * 3 - ovx * 2,
                          bsx * 3 - ovx * 4)[None, :]
        ax2 = (bsx - ovx) * 4 - ax1
        ay1 = torch.where(offy > 0, bsy * 3 - ovy * 2,
                          bsy * 3 - ovy * 4)[:, None]
        ay2 = (bsy - ovy) * 4 - ay1
        weights = (ax1 * ay1, ax2 * ay1, ax1 * ay2, ax2 * ay2)
        # two operations in C doubles: multiply by the reciprocal, truncate
        scaleov = 1.0 / ((bsx - ovx) * (bsy - ovy))
    else:
        weights = (9, 3, 3, 1)

    out = []
    for cv in (cvx.to(I64), cvy.to(I64), cvs.to(I64)):
        cc, cx, cy, xy = corners(cv)
        # v1..v4 per the three cases (PlaneOfBlocks.cpp:1470-1485)
        v2 = torch.where(edge_x | edge_y, cc, cx)
        v3 = torch.where(edge_x & edge_y, cc,
                         torch.where(edge_x, cy, torch.where(edge_y, cx, cy)))
        v4 = torch.where(edge_x & edge_y, cc,
                         torch.where(edge_x, cy, torch.where(edge_y, cx, xy)))
        out.append(weights[0] * cc + weights[1] * v2 + weights[2] * v3
                   + weights[3] * v4)
    x, y, sad = out
    if ovx or ovy:
        x = (x.to(torch.float64) * scaleov).to(I32)
        y = (y.to(torch.float64) * scaleov).to(I32)
        sad = (sad.to(torch.float64) * scaleov).to(I64)
    else:
        sad = sad + 8
    x = (x >> norm_factor) * (1 << mul_factor)
    y = (y >> norm_factor) * (1 << mul_factor)
    sad = sad >> 4
    return (x.to(I32).reshape(-1, nby * nbx), y.to(I32).reshape(-1, nby * nbx),
            sad.reshape(-1, nby * nbx))


# ---------------------------------------------------------------------------
# Top level (gopSearchMVs GroupOfPlanes.c:69-125, mvanalyseGetFrame)


def _level_ctx(sspec, spec: AnalyseSpec, level: int, src_supers=None,
               ref_supers=None) -> LevelCtx:
    """LevelCtx of a pyramid level; without supers only the static
    geometry fields are populated (enough for map_supported)."""
    m = spec.meta
    geos = geometry.level_geometries(
        sspec.width, sspec.height, sspec.hpad, sspec.vpad, sspec.pel,
        sspec.levels, sspec.x_ratio_uv, sspec.y_ratio_uv)
    g = geos[level]
    gc = geometry.chroma_geometry(g, sspec.x_ratio_uv, sspec.y_ratio_uv)
    pel = sspec.pel if level == 0 else 1
    width_b = (m.blk_size_x - m.overlap_x) * m.blk_x + m.overlap_x
    height_b = (m.blk_size_y - m.overlap_y) * m.blk_y + m.overlap_y
    nbx, nby = geometry.level_block_counts(
        width_b, height_b, m.blk_size_x, m.blk_size_y, m.overlap_x,
        m.overlap_y, level)
    src_planes = ref_stacks = ()
    if src_supers is not None:
        srcs = [src_supers.planes[p][level]
                for p in range(3 if spec.chroma else 1)]
        refs = [ref_supers.planes[p][level]
                for p in range(3 if spec.chroma else 1)]
        src_planes = tuple(a[:, 0].contiguous() if a.ndim == 4 else a
                           for a in srcs)
        ref_stacks = tuple(a if a.ndim == 4 else a[:, None] for a in refs)
    logx = geometry.ilog2(sspec.x_ratio_uv)
    logy = geometry.ilog2(sspec.y_ratio_uv)
    return LevelCtx(
        src_planes=src_planes, ref_stacks=ref_stacks, level=level, pel=pel,
        log_pel=geometry.ilog2(pel),
        blk_size=(m.blk_size_x, m.blk_size_y),
        blk_size_c=(m.blk_size_x >> logx, m.blk_size_y >> logy),
        nblk=(nbx, nby), overlap=(m.overlap_x, m.overlap_y),
        log_ratio_uv=(logx, logy),
        hpad=(g.hpad, gc.hpad), vpad=(g.vpad, gc.vpad),
        padded=(g.padded_width, g.padded_height),
        bits=sspec.bits, chroma=spec.chroma)


def _level_plan(spec: AnalyseSpec, lv: int) -> dict:
    """Static per-level search parameters — the per-level switches of
    gopSearchMVs (GroupOfPlanes.c:69-125)."""
    m = spec.meta
    lv_count = m.lv_count
    verybig = m.blk_size_x * m.blk_size_y * (1 << m.bits_per_sample)
    pglobal = spec.pglobal if spec.global_ else spec.pzero
    coarsest = lv == lv_count - 1
    finest = lv == 0
    if spec.search in (SearchType.HORIZONTAL, SearchType.VERTICAL):
        search_lv = spec.search
    elif coarsest:
        search_lv = spec.search if lv_count == 1 else spec.search_coarse
    elif finest:
        search_lv = spec.search
    else:
        search_lv = spec.search_coarse
    if coarsest:
        param_lv = (spec.pel_search if lv_count == 1
                    else spec.n_search_param)
    elif finest:
        param_lv = spec.pel_search
    else:
        param_lv = spec.n_search_param
    trymany_lv = spec.trymany and lv > 0

    # lambda scaling (doPobSearchMVs PlaneOfBlocks.cpp:1024-1028)
    pel_lv = m.pel if lv == 0 else 1
    lambda_level = spec.lambda_ // (pel_lv * pel_lv)
    if spec.plevel == 1:
        lambda_level *= (1 << lv)
    elif spec.plevel == 2:
        lambda_level *= (1 << lv) * (1 << lv)

    return dict(
        search=search_lv, param=param_lv, pzero=spec.pzero,
        pglobal=pglobal, badsad=spec.badsad,
        badrange=spec.badrange, trymany=trymany_lv,
        dctmode=spec.dct, smallest_plane=coarsest,
        meander=spec.meander, lsad=spec.lsad,
        lambda_level=lambda_level, pnew=spec.pnew, verybig=verybig)


def batch_supported(spec: AnalyseSpec, sspec) -> bool:
    """Static predicate: every pyramid level of this config rides the
    dense-map search."""
    for lv in range(spec.meta.lv_count):
        ctx = _level_ctx(sspec, spec, lv)
        if not fe.map_supported(ctx, fe.map_radius(ctx), spec.dct):
            return False
    return True


def _unported_costs(spec: AnalyseSpec):
    """(condition, what) pairs of the luma costs that are not ported."""
    m = spec.meta
    return [
        (1 <= spec.dct <= 4 and (m.bits_per_sample != 8 or m.pel == 4),
         f"dct={spec.dct} with {m.bits_per_sample}-bit input at pel={m.pel} "
         "(the DCT costs dct 1-4 are ported for 8-bit input at pel 1 and 2)"),
        (spec.dct >= 5 and m.bits_per_sample != 8,
         f"dct={spec.dct} with {m.bits_per_sample}-bit input (the SATD "
         "costs dct 5-10 are ported for 8-bit input)"),
        (spec.dct >= 5 and not sad_ops.satd_supported(m.blk_size_x,
                                                      m.blk_size_y),
         f"dct={spec.dct} with {m.blk_size_x}x{m.blk_size_y} blocks (no SATD "
         "for that size)")]


def _check_ported(spec: AnalyseSpec, sspec, field_shift) -> None:
    m = spec.meta
    unported = _unported_costs(spec) + [
        (sspec.pel == 4, "pel=4"),
        (spec.trymany, "trymany=True"),
        (spec.divide != 0, "divide != 0"),
        (field_shift != 0, "field_shift != 0"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"Analyse: {what} is not ported")
    if spec.chroma and not sspec.chroma:
        raise ValueError("Analyse: chroma=True needs a super clip with "
                         "chroma planes")
    for lv in range(m.lv_count):
        search = _level_plan(spec, lv)["search"]
        if search not in (SearchType.HEX2, SearchType.EXHAUSTIVE):
            raise NotImplementedError(
                f"Analyse: search={SearchType(search).name} is not ported "
                "(HEX2 and EXHAUSTIVE are)")
    if not batch_supported(spec, sspec):
        raise NotImplementedError(
            "Analyse: some pyramid level cannot ride the dense SAD map; the "
            "probe-only search for such levels is not ported")


def analyse_batch(src_supers: Super, ref_supers: Super, spec: AnalyseSpec,
                  field_shift=0, lockstep_iters: int = 1) -> MVField:
    """Frame-batched lockstep analyse: Supers with a leading job axis [J]
    -> MVField with [J]-leading tensors, on the device the supers live on.

    Every whole-field op serves all J jobs at once and each level builds
    its dense SAD map for the whole batch in one kernel launch.  The
    bad-SAD rescue runs for the batch behind one host read per level; it
    is gated per block, so a job without bad blocks comes out exactly as
    if it had been searched alone."""
    if not src_supers.batched or not ref_supers.batched:
        raise ValueError("analyse_batch: supers need a leading job axis")
    _check_ported(spec, src_supers.spec, field_shift)
    m = spec.meta
    lv_count = m.lv_count
    dev = src_supers.planes[0][0].device
    nj = src_supers.planes[0][0].shape[0]

    mlc = torch.zeros((nj,), dtype=I32, device=dev)
    gmx = torch.zeros((nj,), dtype=I32, device=dev)
    gmy = torch.zeros((nj,), dtype=I32, device=dev)

    level_fields = {}
    vectors = None
    for lv in range(lv_count - 1, -1, -1):
        ctx = _level_ctx(src_supers.spec, spec, lv, src_supers, ref_supers)
        nbx, nby = ctx.nblk
        nblk = nbx * nby
        level_params = _level_plan(spec, lv)
        if lv == lv_count - 1:
            vectors_in = (torch.zeros((nj, nblk), dtype=I32, device=dev),
                          torch.zeros((nj, nblk), dtype=I32, device=dev),
                          torch.zeros((nj, nblk), dtype=I64, device=dev))
        else:
            if spec.global_:
                gmx, gmy = estimate_global_mv_doubled(vectors[0], vectors[1])
            pnbx, pnby = level_fields[lv + 1]["nblk"]
            vectors_in = interpolate_prediction(
                vectors, pnbx, pnby, nbx, nby,
                (m.blk_size_x, m.blk_size_y), (m.overlap_x, m.overlap_y),
                ctx.log_pel)
        vectors, mlc = search_level_lockstep(
            ctx, level_params, vectors_in, (gmx, gmy), mlc,
            iters=lockstep_iters)
        level_fields[lv] = {"vectors": vectors, "nblk": (nbx, nby)}

    levels_out = []
    for lv in range(lv_count):
        vx, vy, vs = level_fields[lv]["vectors"]
        nbx, nby = level_fields[lv]["nblk"]
        levels_out.append(MVPlaneField(vx.reshape(nj, nby, nbx),
                                       vy.reshape(nj, nby, nbx),
                                       vs.reshape(nj, nby, nbx)))
    return MVField(tuple(levels_out),
                   torch.ones((nj,), dtype=I32, device=dev), m)


def analyse(src_super: Super, ref_super: Super, spec: AnalyseSpec,
            field_shift=0, engine: str = "lockstep",
            lockstep_iters: int = 1) -> MVField:
    """Run the full hierarchical search for one frame pair: the J = 1 case
    of analyse_batch.  Returns an MVField (finest level first) without a
    job axis.  Only engine="lockstep" is ported."""
    if engine == "exact":
        raise NotImplementedError(
            'Analyse: engine="exact" (the sequential block scan) is not '
            "ported")
    if engine != "lockstep":
        raise ValueError(f"Analyse: unknown engine {engine!r}")
    mv = analyse_batch(src_super.map(lambda a: a[None]),
                       ref_super.map(lambda a: a[None]), spec, field_shift,
                       lockstep_iters)
    return MVField(tuple(MVPlaneField(l.x[0], l.y[0], l.sad[0])
                         for l in mv.levels), mv.validity[0], mv.meta)
