"""Static geometry of super-clip pyramids and block grids.

Mirrors the level/plane geometry of the reference implementation
(reference: MVFrame.cpp:1209-1247, MVSuper.c:220-264, MVAnalyse.c:574-598,
GroupOfPlanes.c:43-55).  All functions here are plain Python executed at
config time; nothing touches a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


def ilog2(i: int) -> int:
    """Largest x such that 2**x <= i (reference: CommonFunctions.h ilog2)."""
    result = 0
    while i > 1:
        i //= 2
        result += 1
    return result


def plane_height_luma(src_height: int, level: int, y_ratio_uv: int, vpad: int) -> int:
    """Height of pyramid level `level` (reference: MVFrame.cpp:1209-1216)."""
    height = src_height
    for _ in range(1, level + 1):
        if vpad >= y_ratio_uv:
            height = ((height // y_ratio_uv + 1) // 2) * y_ratio_uv
        else:
            height = ((height // y_ratio_uv) // 2) * y_ratio_uv
    return height


def plane_width_luma(src_width: int, level: int, x_ratio_uv: int, hpad: int) -> int:
    """Width of pyramid level `level` (reference: MVFrame.cpp:1219-1226)."""
    width = src_width
    for _ in range(1, level + 1):
        if hpad >= x_ratio_uv:
            width = ((width // x_ratio_uv + 1) // 2) * x_ratio_uv
        else:
            width = ((width // x_ratio_uv) // 2) * x_ratio_uv
    return width


def plane_super_offset(chroma: bool, src_height: int, level: int, pel: int,
                       vpad: int, plane_pitch: int, y_ratio_uv: int) -> int:
    """Byte/pixel offset of a level inside a packed super plane
    (reference: MVFrame.cpp:1229-1247).  Only needed for interop with the
    reference's packed super-frame layout."""
    if level == 0:
        return 0
    offset = pel * pel * plane_pitch * (src_height + vpad * 2)
    for i in range(1, level):
        if chroma:
            height = plane_height_luma(src_height * y_ratio_uv, i, y_ratio_uv,
                                       vpad * y_ratio_uv) // y_ratio_uv
        else:
            height = plane_height_luma(src_height, i, y_ratio_uv, vpad)
        offset += plane_pitch * (height + vpad * 2)
    return offset


def super_levels_max(width: int, height: int, x_ratio_uv: int, y_ratio_uv: int,
                     hpad: int, vpad: int) -> int:
    """Max pyramid levels for mv.Super (reference: MVSuper.c:220-225)."""
    n = 0
    while (plane_height_luma(height, n, y_ratio_uv, vpad) >= y_ratio_uv * 2
           and plane_width_luma(width, n, x_ratio_uv, hpad) >= x_ratio_uv * 2):
        n += 1
    return n


def analyse_levels_max(width_b: int, height_b: int, blk_size_x: int, blk_size_y: int,
                       overlap_x: int, overlap_y: int) -> int:
    """Max levels for mv.Analyse (reference: MVAnalyse.c:584-590)."""
    n = 0
    while (((width_b >> n) - overlap_x) // (blk_size_x - overlap_x) > 0
           and ((height_b >> n) - overlap_y) // (blk_size_y - overlap_y) > 0):
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class LevelGeometry:
    """Geometry of one pyramid level of one color plane."""
    width: int            # unpadded width of this level
    height: int           # unpadded height
    hpad: int             # horizontal padding (same absolute pad at all levels)
    vpad: int             # vertical padding
    pel: int              # subpel factor (1 for all levels except level 0)

    @property
    def padded_width(self) -> int:
        return self.width + 2 * self.hpad

    @property
    def padded_height(self) -> int:
        return self.height + 2 * self.vpad


def level_geometries(width: int, height: int, hpad: int, vpad: int, pel: int,
                     levels: int, x_ratio_uv: int, y_ratio_uv: int) -> List[LevelGeometry]:
    """Per-level luma geometry; the reference keeps the same absolute padding
    at every level (MVFrame.cpp:1871-1877) but only level 0 has pel subplanes
    (GroupOfPlanes.c:54 `nPelCurrent = 1` after level 0)."""
    out = []
    for lv in range(levels):
        w = plane_width_luma(width, lv, x_ratio_uv, hpad)
        h = plane_height_luma(height, lv, y_ratio_uv, vpad)
        out.append(LevelGeometry(w, h, hpad, vpad, pel if lv == 0 else 1))
    return out


def chroma_geometry(g: LevelGeometry, x_ratio_uv: int, y_ratio_uv: int) -> LevelGeometry:
    """Chroma geometry of a level (reference: MVFrame.cpp:1764-1786)."""
    return LevelGeometry(g.width // x_ratio_uv, g.height // y_ratio_uv,
                         g.hpad // x_ratio_uv, g.vpad // y_ratio_uv, g.pel)


def block_counts(width: int, height: int, blk_size_x: int, blk_size_y: int,
                 overlap_x: int, overlap_y: int) -> Tuple[int, int]:
    """Finest-level block grid (reference: MVAnalyse.c:574-576)."""
    nblkx = (width - overlap_x) // (blk_size_x - overlap_x)
    nblky = (height - overlap_y) // (blk_size_y - overlap_y)
    return nblkx, nblky


def level_block_counts(width_b: int, height_b: int, blk_size_x: int, blk_size_y: int,
                       overlap_x: int, overlap_y: int, level: int) -> Tuple[int, int]:
    """Block grid at pyramid level `level` (reference: GroupOfPlanes.c:49-50)."""
    nblkx = ((width_b >> level) - overlap_x) // (blk_size_x - overlap_x)
    nblky = ((height_b >> level) - overlap_y) // (blk_size_y - overlap_y)
    return nblkx, nblky
