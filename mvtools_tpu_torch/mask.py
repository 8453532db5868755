"""mv.Mask equivalent: motion-vector visualisation masks.

Equivalent of MVMask.c: per-block masks (motion length, SAD, occlusion,
|vx|, |vy|, vx->U & vy->V) upscaled to frame size with SimpleResize; scene
changes produce a constant `ysc` frame (MVMask.c:193-201).  One frame:
planes [H, W], an unbatched field.  The float steps keep the JAX package's
dtypes and order: float64 for the motion length, float32 scalars and
tensors for the vector masks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField
from .ops import maskfun, pixels, resize

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """mv.Mask parameters (MVMask.c:230-280)."""
    ml: float = 100.0
    gamma: float = 1.0
    kind: int = 0
    time: float = 100.0
    ysc: int = 0
    thscd1: int = 400
    thscd2: int = 130

    def __post_init__(self):
        if self.gamma < 0:
            raise ValueError("Mask: gamma must not be negative.")
        if not 0 <= self.kind <= 5:
            raise ValueError("Mask: kind must 0, 1, 2, 3, 4, or 5.")
        if not 0.0 <= self.time <= 100.0:
            raise ValueError("Mask: time must be between 0.0 and 100.0 (inclusive).")
        if not 0 <= self.ysc <= 255:
            raise ValueError("Mask: ysc must be between 0 and 255 (inclusive).")

    @property
    def time256(self) -> int:
        return int(self.time * 256 / 100)


def _small_mask(mv: MVField, meta: AnalysisMeta, cfg: MaskConfig):
    """The per-block uint8-range mask(s) (MVMask.c:139-158)."""
    finest = mv.levels[0]
    vx = finest.x
    vy = finest.y
    f = np.float32(1.0) / np.float32(cfg.ml)
    f2 = np.float32(f * f)
    half_gamma = np.float32(cfg.gamma) * np.float32(0.5)
    kind = cfg.kind
    pel = meta.pel
    small_v = None
    if kind == 0:
        norme = (vx * vx + vy * vy).to(torch.float64) / (pel * pel)
        l = 255.0 * torch.pow(norme * float(f2), float(half_gamma))
        small = l.clamp(max=255.0).to(I32)
    elif kind == 1:
        small = maskfun.make_sad_mask_time(
            vx, vy, finest.sad,
            4.0 * float(f) / (meta.blk_size_x * meta.blk_size_y),
            cfg.gamma, pel, cfg.time256,
            meta.blk_size_x - meta.overlap_x, meta.blk_size_y - meta.overlap_y,
            meta.bits_per_sample)
    elif kind == 2:
        small = maskfun.make_vector_occlusion_mask_time(
            vx, vy, meta.is_backward, float(cfg.ml),
            cfg.gamma, pel, cfg.time256,
            meta.blk_size_x - meta.overlap_x, meta.blk_size_y - meta.overlap_y)
    else:
        f32 = torch.tensor(f, dtype=torch.float32, device=vx.device)

        def scaled(v):
            val = (v.to(torch.float32) * f32 * 100.0 + 128.0).to(I32)
            return val.clamp(0, 255)
        if kind == 3:
            small = scaled(vx)
        elif kind == 4:
            small = scaled(vy)
        else:
            small = scaled(vx)
            small_v = scaled(vy)
    return small, small_v


def _upsize_with_margins(small, width_b, height_b, width, height):
    up = resize.simple_resize(small, height_b, width_b)
    out = torch.zeros((height, width), dtype=I32, device=small.device)
    out[:height_b, :width_b] = up[:height, :width]
    if width > width_b:
        out[:, width_b:] = out[:, width_b - 1:width_b]
    if height > height_b:
        out[height_b:, :] = out[height_b - 1:height_b, :]
    return out


def mask(src_planes: Sequence[torch.Tensor], mv: MVField, meta: AnalysisMeta,
         cfg: MaskConfig = MaskConfig()) -> List[torch.Tensor]:
    """Build the mask frame.  src_planes supplies the luma passthrough for
    kind=5 and the output dtype/shape."""
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "Mask")
    usable = is_usable(mv, nscd1, nscd2)
    width, height = meta.width, meta.height
    width_b = meta.blk_x * (meta.blk_size_x - meta.overlap_x) + meta.overlap_x
    height_b = meta.blk_y * (meta.blk_size_y - meta.overlap_y) + meta.overlap_y
    wuv = width // meta.x_ratio_uv
    huv = height // meta.y_ratio_uv
    wbuv = width_b // meta.x_ratio_uv
    hbuv = height_b // meta.y_ratio_uv

    small, small_v = _small_mask(mv, meta, cfg)

    if cfg.kind == 5:
        luma = pixels.widen(src_planes[0])
    else:
        luma = _upsize_with_margins(small, width_b, height_b, width, height)
    u = _upsize_with_margins(small, wbuv, hbuv, wuv, huv)
    if cfg.kind == 5:
        v = _upsize_with_margins(small_v, wbuv, hbuv, wuv, huv)
    else:
        v = u

    dev = small.device
    if cfg.kind == 5:
        luma_sc = pixels.widen(src_planes[0])
    else:
        luma_sc = torch.full((height, width), cfg.ysc, dtype=I32, device=dev)
    u_sc = torch.full((huv, wuv), cfg.ysc, dtype=I32, device=dev)

    dtype = src_planes[0].dtype
    return [pixels.narrow(torch.where(usable, luma, luma_sc), dtype),
            pixels.narrow(torch.where(usable, u, u_sc), dtype),
            pixels.narrow(torch.where(usable, v, u_sc), dtype)]
