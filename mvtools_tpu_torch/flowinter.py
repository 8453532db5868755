"""mv.FlowInter equivalent: time-interpolated intermediate frame.

Equivalent of MVFlowInter.c: forward+backward full-res vector fields with
occlusion masks, per-pixel two-sided interpolation (FlowInter /
FlowInterExtra kernels), and time-weighted Blend fallback on scene change
(:419-446).  One frame: planes [H, W], unbatched supers and fields.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .core.types import AnalysisMeta, MVField
from .flowfps import interpolate
from .super import Super


@dataclasses.dataclass(frozen=True)
class FlowInterConfig:
    """mv.FlowInter parameters (MVFlowInter.c:470-530)."""
    time: float = 50.0
    ml: float = 100.0
    blend: bool = True
    thscd1: int = 400
    thscd2: int = 130

    def __post_init__(self):
        if not 0.0 <= self.time <= 100.0:
            raise ValueError(
                "FlowInter: time must be between 0.0 and 100.0 (inclusive).")

    @property
    def time256(self) -> int:
        return int(self.time * 256 / 100)


def flowinter(src_planes: Sequence[torch.Tensor],
              ref_planes: Sequence[torch.Tensor],
              src_super: Super, ref_super: Super,
              mv_b: MVField, mv_f: MVField,
              meta: AnalysisMeta, cfg: FlowInterConfig,
              mv_bb: Optional[MVField] = None,
              mv_ff: Optional[MVField] = None) -> List[torch.Tensor]:
    """Interpolate between frame n (src) and n+off (ref) at cfg.time.

    mv_b: backward vectors at frame n; mv_f: forward vectors at frame n+off
    (MVFlowInter.c:119-131).  mv_bb / mv_ff: the extra fields (mvbw at
    n+off / mvfw at n, :264-276) enabling the median-corrected kernel.
    src_planes/ref_planes: the ordinary clip frames for the blend fallback.
    FlowFPS's body with its maskmode 2 (flowfps.interpolate)."""
    return interpolate(src_planes, ref_planes, src_super, ref_super, mv_b,
                       mv_f, meta, cfg.time256, 2, cfg.ml, cfg.blend,
                       cfg.thscd1, cfg.thscd2, "FlowInter", mv_bb, mv_ff)
