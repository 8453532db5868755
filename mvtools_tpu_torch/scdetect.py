"""mv.SCDetection equivalent: scene-change flags from an MV field.

Equivalent of MVSCDetection.c: the output property `_SceneChangePrev` /
`_SceneChangeNext` is simply `!fgopIsUsable` (MVSCDetection.c:63-65); the
direction depends on the vector clip's isBackward flag.
"""

from __future__ import annotations

import dataclasses

import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField


@dataclasses.dataclass(frozen=True)
class SCDetectionConfig:
    thscd1: int = 400
    thscd2: int = 130


def scdetect(mv: MVField, meta: AnalysisMeta,
             cfg: SCDetectionConfig = SCDetectionConfig()) -> torch.Tensor:
    """A bool tensor (one per job of a batched field): True when this frame
    starts a scene change in the vector clip's direction (the value of the
    _SceneChangePrev/Next frame prop)."""
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "SCDetection")
    return ~is_usable(mv, nscd1, nscd2)
