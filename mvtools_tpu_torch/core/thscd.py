"""Scene-change-detection threshold scaling and usability gates.

Equivalent of scaleThSCD (MVAnalysisData.c:7-31) and the Fakery usability
tests (fpobIsSceneChange Fakery.c:52-58, fgopIsUsable :144-146).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .types import AnalysisMeta, MOTION_USE_CHROMA_MOTION, MVField


def scale_thscd(thscd1: int, thscd2: int, meta: AnalysisMeta,
                filter_name: str = "mvtools") -> Tuple[int, int]:
    """Normalise user thresholds to actual block size / chroma / bit depth."""
    max_sad = 8 * 8 * 255
    if thscd1 > max_sad:
        raise ValueError(f"{filter_name}: thscd1 can be at most {max_sad}.")
    reference_block_size = 8 * 8
    thscd1 = thscd1 * (meta.blk_size_x * meta.blk_size_y) // reference_block_size
    if meta.motion_flags & MOTION_USE_CHROMA_MOTION:
        thscd1 += thscd1 // (meta.x_ratio_uv * meta.y_ratio_uv) * 2
    pixel_max = (1 << meta.bits_per_sample) - 1
    thscd1 = int(thscd1 * pixel_max / 255.0 + 0.5)
    thscd2 = thscd2 * meta.blk_x * meta.blk_y // 256
    return thscd1, thscd2


def is_scene_change(mv: MVField, thscd1: int, thscd2: int) -> torch.Tensor:
    """count(finest blocks with sad > thscd1) > thscd2 (Fakery.c:52-58),
    one bool per leading (job) index of the field."""
    finest = mv.levels[0]
    count = (finest.sad > thscd1).sum(dim=(-2, -1))
    return count > thscd2


def is_usable(mv: MVField, thscd1: int, thscd2: int) -> torch.Tensor:
    """!sceneChange && validity (fgopIsUsable Fakery.c:144-146)."""
    return ~is_scene_change(mv, thscd1, thscd2) & (mv.validity != 0)
