"""Filter configuration dataclasses.

Each config mirrors the parameter list, defaults and validation of the
corresponding reference filter's Create function (e.g. MVSuper.c:140-275,
MVAnalyse.c:267-635), including the truemotion preset cascade and the
bit-depth scaling of thresholds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import geometry
from .types import (
    AnalysisMeta,
    ColorFamily,
    MOTION_IS_BACKWARD,
    MOTION_USE_CHROMA_MOTION,
    SearchType,
    VideoFormat,
)

_VALID_BLOCK_SIZES = {
    (4, 4), (8, 4), (8, 8), (16, 2), (16, 8), (16, 16),
    (32, 16), (32, 32), (64, 32), (64, 64), (128, 64), (128, 128),
}  # reference: MVAnalyse.c:399-414


@dataclasses.dataclass(frozen=True)
class SuperConfig:
    """mv.Super parameters (reference: MVSuper.c:140-275)."""
    hpad: int = 16
    vpad: int = 16
    pel: int = 2
    levels: int = 0           # 0 -> max levels
    chroma: bool = True
    sharp: int = 2            # SharpWiener
    rfilter: int = 2          # RfilterBilinear

    def validate(self, fmt: VideoFormat) -> "SuperSpec":
        if self.pel not in (1, 2, 4):
            raise ValueError("Super: pel must be 1, 2, or 4.")
        if not 0 <= self.sharp <= 2:
            raise ValueError("Super: sharp must be between 0 and 2 (inclusive).")
        if not 0 <= self.rfilter <= 4:
            raise ValueError("Super: rfilter must be between 0 and 4 (inclusive).")
        if fmt.bits > 16:
            raise ValueError("Super: input clip must be up to 16 bits.")
        chroma = self.chroma and fmt.family != ColorFamily.GRAY
        levels_max = geometry.super_levels_max(
            fmt.width, fmt.height, fmt.x_ratio_uv, fmt.y_ratio_uv,
            self.hpad, self.vpad)
        levels = self.levels
        if levels <= 0 or levels > levels_max:
            levels = levels_max
        return SuperSpec(
            width=fmt.width, height=fmt.height, bits=fmt.bits,
            family=fmt.family, hpad=self.hpad, vpad=self.vpad, pel=self.pel,
            levels=levels, chroma=chroma, sharp=self.sharp,
            rfilter=self.rfilter)


@dataclasses.dataclass(frozen=True)
class SuperSpec:
    """Resolved static geometry of a super clip (the equivalent of the
    Super_* frame props, MVSuper.c:111-120)."""
    width: int
    height: int
    bits: int
    family: ColorFamily
    hpad: int
    vpad: int
    pel: int
    levels: int
    chroma: bool
    sharp: int
    rfilter: int

    @property
    def fmt(self) -> VideoFormat:
        return VideoFormat(self.width, self.height, self.bits, self.family)

    @property
    def x_ratio_uv(self) -> int:
        return self.fmt.x_ratio_uv

    @property
    def y_ratio_uv(self) -> int:
        return self.fmt.y_ratio_uv

    @property
    def num_planes(self) -> int:
        return 1 if not self.chroma else self.fmt.num_planes


@dataclasses.dataclass(frozen=True)
class AnalyseConfig:
    """mv.Analyse parameters (reference: MVAnalyse.c:267-635).

    Defaults follow the reference exactly, including the truemotion preset
    (MVAnalyse.c:309-337) and pzero <- pnew cascading.
    """
    blksize: int = 8
    blksizev: Optional[int] = None
    levels: int = 0
    search: SearchType = SearchType.HEX2
    search_coarse: SearchType = SearchType.EXHAUSTIVE
    searchparam: int = 2
    pelsearch: int = 0
    isb: bool = False
    chroma: bool = True
    delta: int = 1
    truemotion: bool = True
    lambda_: Optional[int] = None
    lsad: Optional[int] = None
    plevel: Optional[int] = None
    global_: Optional[bool] = None
    pnew: Optional[int] = None
    pzero: Optional[int] = None
    pglobal: int = 0
    overlap: int = 0
    overlapv: Optional[int] = None
    divide: int = 0
    badsad: int = 10000
    badrange: int = 24
    meander: bool = True
    trymany: bool = False
    fields: bool = False
    tff: Optional[bool] = None
    dct: int = 0

    def validate(self, sup: SuperSpec) -> "AnalyseSpec":
        blksize = self.blksize
        blksizev = self.blksizev if self.blksizev is not None else blksize
        if not 0 <= int(self.search) <= 7:
            raise ValueError("Analyse: search must be between 0 and 7 (inclusive).")
        if not 0 <= int(self.search_coarse) <= 7:
            raise ValueError("Analyse: search_coarse must be between 0 and 7 (inclusive).")
        if not 0 <= self.dct <= 10:
            raise ValueError("Analyse: dct must be between 0 and 10 (inclusive).")
        if self.dct >= 5 and blksize == 16 and blksizev == 2:
            raise ValueError("Analyse: dct 5..10 cannot work with 16x2 blocks.")
        if not 0 <= self.divide <= 2:
            raise ValueError("Analyse: divide must be between 0 and 2 (inclusive).")
        if (blksize, blksizev) not in _VALID_BLOCK_SIZES:
            raise ValueError(
                "Analyse: the block size must be 4x4, 8x4, 8x8, 16x2, 16x8, "
                "16x16, 32x16, 32x32, 64x32, 64x64, 128x64, or 128x128.")

        # truemotion preset cascade (MVAnalyse.c:309-337)
        lambda_ = self.lambda_
        if lambda_ is None:
            lambda_ = 1000 * blksize * blksizev // 64 if self.truemotion else 0
        lsad = self.lsad if self.lsad is not None else (1200 if self.truemotion else 400)
        plevel = self.plevel if self.plevel is not None else (1 if self.truemotion else 0)
        global_ = self.global_ if self.global_ is not None else self.truemotion
        pnew = self.pnew if self.pnew is not None else (50 if self.truemotion else 0)
        pzero = self.pzero if self.pzero is not None else pnew

        if not 0 <= plevel <= 2:
            raise ValueError("Analyse: plevel must be between 0 and 2 (inclusive).")
        if not 0 <= pnew <= 256:
            raise ValueError("Analyse: pnew must be between 0 and 256 (inclusive).")
        if not 0 <= pzero <= 256:
            raise ValueError("Analyse: pzero must be between 0 and 256 (inclusive).")
        if not 0 <= self.pglobal <= 256:
            raise ValueError("Analyse: pglobal must be between 0 and 256 (inclusive).")

        overlap = self.overlap
        overlapv = self.overlapv if self.overlapv is not None else overlap
        if (overlap < 0 or overlap > blksize // 2
                or overlapv < 0 or overlapv > blksizev // 2):
            raise ValueError(
                "Analyse: overlap must be at most half of blksize, overlapv "
                "must be at most half of blksizev, and they both need to be "
                "at least 0.")
        if self.divide and (blksize < 8 or blksizev < 8):
            raise ValueError(
                "Analyse: blksize and blksizev must be at least 8 when divide=True.")

        # search param clamping (MVAnalyse.c:453-456)
        if self.search == SearchType.NSTEP:
            n_search_param = max(0, self.searchparam)
        else:
            n_search_param = max(1, self.searchparam)

        chroma = self.chroma and sup.family != ColorFamily.GRAY
        if overlap % sup.x_ratio_uv or overlapv % sup.y_ratio_uv:
            raise ValueError(
                "Analyse: The requested overlap is incompatible with the "
                "super clip's subsampling.")
        if self.divide and (overlap % (2 * sup.x_ratio_uv)
                            or overlapv % (2 * sup.y_ratio_uv)):
            raise ValueError(
                "Analyse: overlap and overlapv must be multiples of 2 or 4 "
                "when divide=True, depending on the super clip's subsampling.")

        # bit-depth scaling of thresholds (MVAnalyse.c:477-483)
        pixel_max = (1 << sup.bits) - 1
        lsad = int(lsad * pixel_max / 255.0 + 0.5)
        badsad = int(self.badsad * pixel_max / 255.0 + 0.5)
        lambda_ = int(lambda_ * pixel_max / 255.0 + 0.5)
        lsad = lsad * (blksize * blksizev) // 64
        badsad = badsad * (blksize * blksizev) // 64

        nblkx, nblky = geometry.block_counts(
            sup.width, sup.height, blksize, blksizev, overlap, overlapv)
        width_b = (blksize - overlap) * nblkx + overlap
        height_b = (blksizev - overlapv) * nblky + overlapv
        levels_max = geometry.analyse_levels_max(
            width_b, height_b, blksize, blksizev, overlap, overlapv)
        lv_count = self.levels if self.levels > 0 else levels_max + self.levels
        if lv_count < 1 or lv_count > levels_max:
            raise ValueError("Analyse: invalid number of levels.")
        if lv_count > sup.levels:
            raise ValueError(
                f"Analyse: super clip has {sup.levels} levels. Analyse needs "
                f"{lv_count} levels.")

        pelsearch = self.pelsearch if self.pelsearch > 0 else sup.pel

        motion_flags = 0
        if self.isb:
            motion_flags |= MOTION_IS_BACKWARD
        if chroma:
            motion_flags |= MOTION_USE_CHROMA_MOTION

        meta = AnalysisMeta(
            blk_size_x=blksize, blk_size_y=blksizev, pel=sup.pel,
            lv_count=lv_count, delta_frame=self.delta, is_backward=self.isb,
            motion_flags=motion_flags, width=sup.width, height=sup.height,
            overlap_x=overlap, overlap_y=overlapv, blk_x=nblkx, blk_y=nblky,
            bits_per_sample=sup.bits, y_ratio_uv=sup.y_ratio_uv,
            x_ratio_uv=sup.x_ratio_uv, hpadding=sup.hpad, vpadding=sup.vpad)

        return AnalyseSpec(
            meta=meta, search=self.search, search_coarse=self.search_coarse,
            n_search_param=n_search_param, pel_search=pelsearch,
            lambda_=lambda_, lsad=lsad, pnew=pnew, plevel=plevel,
            global_=global_, pzero=pzero, pglobal=self.pglobal,
            badsad=badsad, badrange=self.badrange, meander=self.meander,
            trymany=self.trymany, divide=self.divide, dct=self.dct,
            chroma=chroma, fields=self.fields, tff=self.tff)


@dataclasses.dataclass(frozen=True)
class AnalyseSpec:
    """Resolved Analyse parameters (all static)."""
    meta: AnalysisMeta
    search: SearchType
    search_coarse: SearchType
    n_search_param: int
    pel_search: int
    lambda_: int
    lsad: int
    pnew: int
    plevel: int
    global_: bool
    pzero: int
    pglobal: int
    badsad: int
    badrange: int
    meander: bool
    trymany: bool
    divide: int
    dct: int
    chroma: bool
    fields: bool
    tff: Optional[bool]

    @property
    def divided_meta(self) -> AnalysisMeta:
        """Metadata of the divided field (MVAnalyse.c:615-624)."""
        m = self.meta
        return dataclasses.replace(
            m, blk_x=m.blk_x * 2, blk_y=m.blk_y * 2,
            blk_size_x=m.blk_size_x // 2, blk_size_y=m.blk_size_y // 2,
            overlap_x=m.overlap_x // 2, overlap_y=m.overlap_y // 2,
            lv_count=m.lv_count + 1)
