"""mv.Recalculate equivalent: refine an MV field at the finest level.

Equivalent of MVRecalculate.c + pobRecalculateMVs
(PlaneOfBlocks.cpp:1158-1424): each new block takes a bilinear/nearest
interpolation of the old field as its predictor, rescaled to the new pel
and block area, and is re-searched only when the predictor's cost exceeds
`thsad`.

Recalculate has NO dependency between blocks (the reference's scan writes
vectors but never reads neighbours), so every block of every job refines in
lockstep: the predictor's cost comes from one real probe per block
(field_engine.FieldProber), the refinement runs on a dense map anchored at
the clipped predictor field (field_engine.MapProber), gated per block by
`cost > thsad`.  Every tensor carries an explicit leading job axis [J, ...];
supers and the old field may come without it (one frame pair).

Ported: the lockstep engine, 8-bit, pel 1/2, the plain-SAD cost (dct 0), the
DCT costs (dct 1-4) and the SATD costs (dct 5-10), searches HEX2 and
EXHAUSTIVE, smooth 0 and 1, any old / new block grid.  engine="exact",
divide, fields, field_shift, UMH and the other searches raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import field_engine as fe
from .analyse import (_blocks_of, _clip, _level_ctx, _trunc_div,
                      _unported_costs)
from .core.config import AnalyseConfig, AnalyseSpec
from .core.types import AnalysisMeta, MVField, MVPlaneField, SearchType
from .super import Super

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class RecalculateConfig:
    """mv.Recalculate parameters (MVRecalculate.c create)."""
    thsad: int = 200
    smooth: int = 1
    blksize: int = 8
    blksizev: Optional[int] = None
    search: SearchType = SearchType.HEX2
    searchparam: int = 2
    chroma: bool = True
    truemotion: bool = True
    lambda_: Optional[int] = None
    pnew: Optional[int] = None
    overlap: int = 0
    overlapv: Optional[int] = None
    divide: int = 0
    meander: bool = True
    fields: bool = False
    tff: Optional[bool] = None
    dct: int = 0

    def to_analyse_config(self) -> AnalyseConfig:
        return AnalyseConfig(
            blksize=self.blksize, blksizev=self.blksizev, levels=1,
            search=self.search, searchparam=self.searchparam,
            chroma=self.chroma, truemotion=self.truemotion,
            lambda_=self.lambda_, pnew=self.pnew, overlap=self.overlap,
            overlapv=self.overlapv, divide=self.divide, meander=self.meander,
            fields=self.fields, tff=self.tff, dct=self.dct)


def _np_trunc_div(a, b):
    return np.sign(a) * (np.abs(a) // b)


def _interpolate_old_vectors(old: MVPlaneField, old_meta: AnalysisMeta,
                             meta: AnalysisMeta, smooth: int, log_pel: int):
    """Map old-grid vectors [J, nbyo, nbxo] onto the new block grid
    (PlaneOfBlocks.cpp:1279-1330).  Returns (x, y, sad) [J, nby, nbx]: x / y
    int32, sad int64."""
    nbx, nby = meta.blk_x, meta.blk_y
    bsx, bsy = meta.blk_size_x, meta.blk_size_y
    ovx, ovy = meta.overlap_x, meta.overlap_y
    bsxo, bsyo = old_meta.blk_size_x, old_meta.blk_size_y
    nbxo, nbyo = old_meta.blk_x, old_meta.blk_y
    step_xo = bsxo - old_meta.overlap_x
    step_yo = bsyo - old_meta.overlap_y
    log_pel_old = old_meta.pel.bit_length() - 1
    dev = old.x.device

    # which old blocks surround each new block's centre is static geometry
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    center_x = bsx // 2 + (bsx - ovx) * bx
    center_y = bsy // 2 + (bsy - ovy) * by
    blkxold = _np_trunc_div(center_x - bsxo // 2, step_xo)
    blkyold = _np_trunc_div(center_y - bsyo // 2, step_yo)
    delta_x = np.maximum(0, center_x - (bsxo // 2 + step_xo * blkxold))
    delta_y = np.maximum(0, center_y - (bsyo // 2 + step_yo * blkyold))

    def index(a, hi):
        return torch.as_tensor(np.clip(a, 0, hi), device=dev)

    bx1, bx2 = index(blkxold, nbxo - 1), index(blkxold + 1, nbxo - 1)
    by1, by2 = index(blkyold, nbyo - 1), index(blkyold + 1, nbyo - 1)

    if smooth == 1:
        def lerp(comp, dtype):
            # C int arithmetic for x / y, 64-bit for the SAD
            comp = comp.to(dtype)
            v1, v2 = comp[:, by1, bx1], comp[:, by1, bx2]
            v3, v4 = comp[:, by2, bx1], comp[:, by2, bx2]
            dx = torch.as_tensor(delta_x, dtype=dtype, device=dev)
            dy = torch.as_tensor(delta_y, dtype=dtype, device=dev)
            a = v1 * step_xo + dx * (v2 - v1)
            b = v3 * step_xo + dx * (v4 - v3)
            return _trunc_div(a + _trunc_div(dy * (b - a), step_yo), step_xo)
        x = lerp(old.x, I32)
        y = lerp(old.y, I32)
        sad = lerp(old.sad, I64)
    else:
        sel_bx = torch.where(
            torch.as_tensor(delta_x * 2 >= step_xo, device=dev), bx2, bx1)
        sel_by = torch.where(
            torch.as_tensor(delta_y * 2 >= step_yo, device=dev), by2, by1)
        x = old.x[:, sel_by, sel_bx].to(I32)
        y = old.y[:, sel_by, sel_bx].to(I32)
        sad = old.sad[:, sel_by, sel_bx].to(I64)

    # rescale to the new pel and the new block area (:1326-1330)
    x = (x << log_pel) >> log_pel_old
    y = (y << log_pel) >> log_pel_old
    sad = sad * (bsx * bsy) // (bsxo * bsyo)
    return x, y, sad


def _check_ported(spec: AnalyseSpec, cfg: RecalculateConfig, sspec,
                  field_shift, engine: str) -> None:
    if engine == "exact":
        raise NotImplementedError(
            'Recalculate: engine="exact" (the sequential block scan) is not '
            "ported")
    if engine != "lockstep":
        raise ValueError(f"recalculate: unknown engine {engine!r}")
    unported = _unported_costs(spec) + [
        (sspec.pel == 4, "pel=4"),
        (sspec.bits != 8, "16-bit clips"),
        (spec.divide != 0 or cfg.divide != 0, "divide != 0"),
        (spec.fields or cfg.fields, "fields=True"),
        (field_shift != 0, "field_shift != 0"),
        (spec.search not in (SearchType.HEX2, SearchType.EXHAUSTIVE),
         f"search={SearchType(spec.search).name} (HEX2 and EXHAUSTIVE are "
         "ported)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"Recalculate: {what} is not ported")
    if spec.chroma and not sspec.chroma:
        raise ValueError("Recalculate: chroma=True needs a super clip with "
                         "chroma planes")


def recalculate(src_super: Super, ref_super: Super, old_mv: MVField,
                spec: AnalyseSpec, cfg: RecalculateConfig, field_shift=0,
                engine: str = "lockstep") -> MVField:
    """Refine `old_mv` on the finest level.  `spec` is the resolved
    AnalyseSpec of the NEW grid (cfg.to_analyse_config().validate(sspec)),
    `old_mv` carries its own meta.

    Supers and `old_mv` carry a leading job axis [J] or none (one frame
    pair); the result has what they have.  Each job comes out exactly as if
    it had been refined alone: the map anchors are per job and tile, the
    refinement is gated per block.  Only engine="lockstep" is ported."""
    sspec = src_super.spec
    _check_ported(spec, cfg, sspec, field_shift, engine)
    if not src_super.batched:
        one = recalculate(
            src_super.map(lambda a: a[None]), ref_super.map(lambda a: a[None]),
            MVField(tuple(MVPlaneField(l.x[None], l.y[None], l.sad[None])
                          for l in old_mv.levels), old_mv.validity[None],
                    old_mv.meta), spec, cfg, field_shift, engine)
        return MVField(tuple(MVPlaneField(l.x[0], l.y[0], l.sad[0])
                             for l in one.levels), one.validity[0], one.meta)
    meta = spec.meta
    old_meta = old_mv.meta if old_mv.meta is not None else meta
    ctx = _level_ctx(sspec, spec, 0, src_super, ref_super)
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
    dev = ctx.src_planes[0].device
    nj = ctx.src_planes[0].shape[0]

    # thSAD scaled by bit depth and block size, as Analyse scales lsad
    pixel_max = (1 << meta.bits_per_sample) - 1
    thsad = int(cfg.thsad * pixel_max / 255.0 + 0.5)
    thsad = thsad * (meta.blk_size_x * meta.blk_size_y) // 64
    lambda_level = spec.lambda_ // ((1 << logp) * (1 << logp))

    px_a, py_a, _ = _interpolate_old_vectors(old_mv.levels[0], old_meta, meta,
                                             cfg.smooth, logp)
    px_a = px_a.reshape(nj, nblk)
    py_a = py_a.reshape(nj, nblk)

    idx = torch.arange(nblk, dtype=I32, device=dev)
    blky_a = idx // nbx
    blkx_a = idx % nbx
    x0_a = hpad + (bsx - ovx) * blkx_a
    y0_a = vpad + (bsy - ovy) * blky_a
    xc_a = hpad_c + ((bsx - ovx) >> logx) * blkx_a
    yc_a = vpad_c + ((bsy - ovy) >> logy) * blky_a
    # search bounds (PlaneOfBlocks.cpp:1274-1277: no scaled padding)
    dxmax_a = ((pw - bsx) - x0_a) << logp
    dymax_a = ((ph - bsy) - y0_a) << logp
    dxmin_a = -(x0_a << logp)
    dymin_a = -(y0_a << logp)
    bounds = (dxmin_a, dxmax_a, dymin_a, dymax_a)
    lam_a = torch.where(blky_a == 0, 0, lambda_level).to(I64)

    src_blocks = [_blocks_of(ctx.src_planes[0], vpad, hpad, nby, nbx, bsy,
                             bsx, bsy - ovy, bsx - ovx)]
    if ctx.chroma:
        src_blocks += [
            _blocks_of(ctx.src_planes[p], vpad_c, hpad_c, nby, nbx, bcy, bcx,
                       (bsy - ovy) >> logy, (bsx - ovx) >> logx)
            for p in (1, 2)]
    cost = fe.cost_keywords(spec.dct, src_blocks[0],
                            torch.full((nj,), 8, dtype=I32, device=dev),
                            ctx.bits)
    stacks = fe.pad_stacks(ctx)
    prober = fe.FieldProber(ctx, src_blocks, x0_a, y0_a, xc_a, yc_a, bounds,
                            spec.pnew, stacks=stacks, **cost)

    cpx = _clip(px_a, dxmin_a, dxmax_a - 1)
    cpy = _clip(py_a, dymin_a, dymax_a - 1)
    # the predictor's cost comes from a real probe (every block needs a
    # valid bound: off the map it would be INVALID_SAD, and that would be
    # the block's output SAD); the refinement stays within map range of the
    # old vector, so it runs on the dense map anchored at the predictors
    sad0 = prober.plain_sad(cpx, cpy)
    refine_p = prober
    if fe.map_supported(ctx, fe.map_radius(ctx), spec.dct):
        refine_p = fe.MapProber(ctx, src_blocks, x0_a, y0_a, xc_a, yc_a,
                                bounds, spec.pnew, pred_vx=cpx, pred_vy=cpy,
                                stacks=stacks, **cost)
    st = {"bx": cpx, "by": cpy, "bsad": sad0, "mincost": sad0,
          "dir": torch.zeros((nj, nblk), dtype=I32, device=dev)}
    st = fe.refine(refine_p, st, spec.search, spec.n_search_param, lam_a,
                   (cpx, cpy), active=sad0 > thsad)
    level = MVPlaneField(st["bx"].reshape(nj, nby, nbx),
                         st["by"].reshape(nj, nby, nbx),
                         st["bsad"].reshape(nj, nby, nbx))
    return MVField((level,), torch.ones((nj,), dtype=I32, device=dev), meta)
