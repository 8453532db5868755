"""Core data types: video format, analysis metadata, motion-vector fields.

The reference transports motion vectors between filters as opaque binary
frame props (MVAnalysisData.h:36-44, GroupOfPlanes.c:77-108).  Here an MV
field is a plain object holding tensors — one (x, y, sad) triple per block
per pyramid level — plus a static `AnalysisMeta` mirroring MVAnalysisData
(MVAnalysisData.h:81-134) for compatibility checks and serialization.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import torch


class SearchType(enum.IntEnum):
    """Search algorithms (reference: MVAnalysisData.h:55-64)."""
    ONETIME = 0
    NSTEP = 1
    LOGARITHMIC = 2
    EXHAUSTIVE = 3
    HEX2 = 4
    UMH = 5
    HORIZONTAL = 6
    VERTICAL = 7


class ColorFamily(enum.IntEnum):
    GRAY = 0
    YUV420 = 1
    YUV422 = 2
    YUV440 = 3
    YUV444 = 4


_SUBSAMPLING = {
    ColorFamily.GRAY: (1, 1),
    ColorFamily.YUV420: (2, 2),
    ColorFamily.YUV422: (2, 1),
    ColorFamily.YUV440: (1, 2),
    ColorFamily.YUV444: (1, 1),
}


@dataclasses.dataclass(frozen=True)
class VideoFormat:
    """Constant format of a clip (subset of VSVideoInfo the filters need)."""
    width: int
    height: int
    bits: int = 8
    family: ColorFamily = ColorFamily.YUV420

    @property
    def x_ratio_uv(self) -> int:
        return _SUBSAMPLING[self.family][0]

    @property
    def y_ratio_uv(self) -> int:
        return _SUBSAMPLING[self.family][1]

    @property
    def num_planes(self) -> int:
        return 1 if self.family == ColorFamily.GRAY else 3

    @property
    def pixel_max(self) -> int:
        return (1 << self.bits) - 1

    @property
    def dtype(self):
        return torch.uint8 if self.bits <= 8 else torch.uint16


MV_ANALYSIS_DATA_VERSION = 5  # reference: MVAnalysisData.h:79
MV_DEFAULT_SCD1 = 400         # reference: MVAnalysisData.h:73
MV_DEFAULT_SCD2 = 130


@dataclasses.dataclass(frozen=True)
class AnalysisMeta:
    """Static metadata of an MV clip (reference: MVAnalysisData.h:81-134).

    Field-for-field mirror of MVAnalysisData so fields produced here can be
    serialized into reference-compatible blobs and validated with the same
    compatibility rules (adataCheckSimilarity, MVAnalysisData.c:68-98).
    """
    blk_size_x: int
    blk_size_y: int
    pel: int
    lv_count: int
    delta_frame: int
    is_backward: bool
    motion_flags: int
    width: int
    height: int
    overlap_x: int
    overlap_y: int
    blk_x: int
    blk_y: int
    bits_per_sample: int
    y_ratio_uv: int
    x_ratio_uv: int
    hpadding: int
    vpadding: int
    magic_key: int = 0x564D  # arbitrary; kept for blob layout parity
    version: int = MV_ANALYSIS_DATA_VERSION

    @property
    def chroma(self) -> bool:
        return bool(self.motion_flags & MOTION_USE_CHROMA_MOTION)

    @property
    def blk_count(self) -> int:
        return self.blk_x * self.blk_y

    def level_blocks(self) -> List[Tuple[int, int]]:
        """(blk_x, blk_y) per level, level 0 first (GroupOfPlanes.c:49-50)."""
        width_b = (self.blk_size_x - self.overlap_x) * self.blk_x + self.overlap_x
        height_b = (self.blk_size_y - self.overlap_y) * self.blk_y + self.overlap_y
        out = []
        for lv in range(self.lv_count):
            nbx = ((width_b >> lv) - self.overlap_x) // (self.blk_size_x - self.overlap_x)
            nby = ((height_b >> lv) - self.overlap_y) // (self.blk_size_y - self.overlap_y)
            out.append((nbx, nby))
        return out


def check_similarity(ad1: AnalysisMeta, ad2: AnalysisMeta,
                     filter_name1: str, filter_name2: str,
                     vector_name: str) -> None:
    """Pairwise MV-clip compatibility validation
    (adataCheckSimilarity, MVAnalysisData.c:68-98).  Raises ValueError with
    the reference's error text on the first mismatch (the reference writes
    each message into the same buffer, so the LAST failing check wins —
    reproduced by checking in reverse order and keeping the first hit)."""
    checks = [
        (ad1.width != ad2.width, "widths"),
        (ad1.height != ad2.height, "heights"),
        (ad1.blk_size_x != ad2.blk_size_x
         or ad1.blk_size_y != ad2.blk_size_y, "block sizes"),
        (ad1.pel != ad2.pel, "pel precision"),
        (ad1.overlap_x != ad2.overlap_x
         or ad1.overlap_y != ad2.overlap_y, "overlap"),
        (ad1.x_ratio_uv != ad2.x_ratio_uv, "horizontal subsampling"),
        (ad1.y_ratio_uv != ad2.y_ratio_uv, "vertical subsampling"),
        (ad1.bits_per_sample != ad2.bits_per_sample, "bit depths"),
    ]
    for bad, what in reversed(checks):
        if bad:
            raise ValueError(
                f"{filter_name1}: {filter_name2} and {vector_name} have "
                f"different {what}.")


def check_vectors_similarity(metas, filter_name: str,
                             vector_names=None) -> None:
    """Validate a consumer's MV inputs pairwise against the first, in the
    reference's vector order (MVDegrains.cpp:588-600: mvbw, mvfw, mvbw2,
    ...).  Entries may be AnalysisMeta or None (unchecked)."""
    metas = list(metas)
    if vector_names is None:
        vector_names = ["mvbw", "mvfw"] + [
            f"mv{d}w{i}" for i in range(2, 7) for d in ("b", "f")]
    first = next((m for m in metas if m is not None), None)
    if first is None:
        return
    base_idx = metas.index(first)
    for r, m in enumerate(metas):
        if m is None or r == base_idx:
            continue
        check_similarity(first, m, filter_name, vector_names[base_idx],
                         vector_names[r])


# Motion flags (reference: MVAnalysisData.h:67-72)
MOTION_USE_SIMD = 0x00000001
MOTION_IS_BACKWARD = 0x00000002
MOTION_SMALLEST_PLANE = 0x00000004
MOTION_USE_CHROMA_MOTION = 0x00000008


class MVPlaneField:
    """Motion vectors of one pyramid level: x/y int32 [nBlkY, nBlkX] and
    sad int64 [nBlkY, nBlkX] (reference VECTOR: MVAnalysisData.h:40-44).
    A job-batched field carries a leading [J] axis on all three."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, sad: torch.Tensor):
        self.x = x
        self.y = y
        self.sad = sad

    @property
    def shape(self):
        return self.x.shape

    def __repr__(self):
        return f"MVPlaneField(shape={self.x.shape})"


class MVField:
    """A full per-frame MV field: one MVPlaneField per level, level 0
    (finest) first, plus validity (reference array layout:
    GroupOfPlanes.c:77-108 stores coarsest first; we keep finest-first and
    flip in the codec)."""

    def __init__(self, levels: Tuple[MVPlaneField, ...], validity: torch.Tensor,
                 meta: Optional[AnalysisMeta] = None):
        self.levels = tuple(levels)
        self.validity = validity  # int32 scalar: 1 valid, 0 default field
        self.meta = meta

    @property
    def finest(self) -> MVPlaneField:
        return self.levels[0]

    def __repr__(self):
        return (f"MVField(levels={len(self.levels)}, "
                f"shapes={[l.shape for l in self.levels]})")
