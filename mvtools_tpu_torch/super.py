"""mv.Super equivalent: build the hierarchical sub-pel pyramid.

The reference packs all pyramid levels and sub-pel planes into one tall
video frame (MVSuper.c:43-126, PlaneSuperOffset MVFrame.cpp:1229-1247) — a
VapourSynth transport hack.  Here a super frame is a structured object:
for each color plane, a tuple of levels, where level 0 carries its pel*pel
sub-pel planes as an axis [pel^2, PH, PW] and coarser levels are single
padded planes [PH_k, PW_k].  A batch of frames carries one explicit leading
axis [F, ...] on every level tensor.

Pipeline per plane (mvsuperGetFrame MVSuper.c:78-103):
  1. level 0 = source plane surrounded by zeros (frame memset),
  2. reduce level k -> k+1 with the rfilter (level 0 source has zero
     context; deeper levels replicate-padded context), pad each level,
  3. replicate-pad level 0,
  4. sub-pel refine level 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .core import geometry
from .core.config import SuperConfig, SuperSpec
from .core.types import ColorFamily, VideoFormat
from .ops import interp, pixels, reduce as reduce_ops
from .ops.pad import pad_replicate


class Super:
    """Super pyramid of one frame or of a batch of frames.

    planes: tuple (one entry per color plane) of tuples of per-level tensors.
    Level 0 tensors have shape [(F,) pel*pel, PH, PW]; level k>0 tensors
    [(F,) PH, PW].  dtype uint8, or uint16 for clips of 9 to 16 bits.
    """

    def __init__(self, planes: Tuple[Tuple[torch.Tensor, ...], ...],
                 spec: SuperSpec):
        self.planes = tuple(tuple(lv for lv in p) for p in planes)
        self.spec = spec

    @property
    def batched(self) -> bool:
        return self.planes[0][0].ndim == 4

    def map(self, fn) -> "Super":
        """A Super with `fn` applied to every level tensor (index a frame
        out of a batch, gather jobs, move devices)."""
        return Super(tuple(tuple(fn(lv) for lv in p) for p in self.planes),
                     self.spec)

    def take(self, idx: torch.Tensor) -> "Super":
        """The frames `idx` (a 1-D index tensor) of a batch, as a batch."""
        return self.map(lambda a: pixels.gather(a, idx))

    def level_plane(self, plane: int, level: int) -> torch.Tensor:
        return self.planes[plane][level]

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    def __repr__(self):
        return (f"Super(levels={self.spec.levels}, pel={self.spec.pel}, "
                f"planes={self.num_planes})")


# A clip of super frames: the same object with a leading frame axis on every
# plane tensor.
SuperClip = Super


def _plane_geometries(spec: SuperSpec, plane: int) -> List[geometry.LevelGeometry]:
    geos = geometry.level_geometries(
        spec.width, spec.height, spec.hpad, spec.vpad, spec.pel,
        spec.levels, spec.x_ratio_uv, spec.y_ratio_uv)
    if plane == 0:
        return geos
    return [geometry.chroma_geometry(g, spec.x_ratio_uv, spec.y_ratio_uv)
            for g in geos]


def build_super_plane(plane: torch.Tensor, spec: SuperSpec,
                      plane_idx: int) -> Tuple[torch.Tensor, ...]:
    """Build all pyramid levels for one color plane.

    plane: [..., H, W] uint8 or uint16 source plane(s); leading axes are a
    batch.
    """
    geos = _plane_geometries(spec, plane_idx)
    dtype = plane.dtype
    out: List[torch.Tensor] = []

    # Level 0: replicate-padded source.
    lv0 = pixels.widen(plane)
    lv0_padded = pad_replicate(lv0, geos[0].hpad, geos[0].vpad)

    # Reduce chain.  The source region for level0->1 is the unpadded plane
    # with zero context (the frame memset); for deeper levels the previously
    # padded plane supplies replicate context (MVFrame.cpp:1928-1933).
    padded = [lv0_padded]
    for lv in range(1, spec.levels):
        src_geo, dst_geo = geos[lv - 1], geos[lv]
        if lv == 1:
            src_region = lv0[..., :src_geo.height + 4, :src_geo.width + 4]
        else:
            # the unpadded region plus the replicate padding below/right
            src_region = padded[lv - 1][..., src_geo.vpad:, src_geo.hpad:]
        red = reduce_ops.rb2(src_region, dst_geo.height, dst_geo.width,
                             spec.rfilter, zero_context=(lv == 1))
        padded.append(pad_replicate(red, dst_geo.hpad, dst_geo.vpad))

    # Level 0 sub-pel planes.
    subplanes = interp.refine_subplanes(lv0_padded, spec.pel, spec.sharp,
                                        spec.bits)
    out.append(torch.stack([pixels.narrow(p, dtype) for p in subplanes],
                           dim=-3))
    for lv in range(1, spec.levels):
        out.append(pixels.narrow(padded[lv], dtype))
    return tuple(out)


def build_super(frame_planes: Sequence[torch.Tensor], cfg_or_spec,
                fmt: Optional[VideoFormat] = None) -> Super:
    """Build a Super pyramid from a frame's planes.

    frame_planes: [Y] or [Y, U, V] tensors, [H, W] or frame-batched
    [F, H, W], uint8, or uint16 for clips of 9 to 16 bits (without `fmt`
    a uint16 clip is taken as 16-bit; a 10-bit clip passes its
    VideoFormat); the pyramid is built on the device the planes live on.
    cfg_or_spec: a SuperConfig (resolved against `fmt`) or a SuperSpec.
    """
    if isinstance(cfg_or_spec, SuperConfig):
        if fmt is None:
            h, w = frame_planes[0].shape[-2:]
            bits = 8 if frame_planes[0].dtype == torch.uint8 else 16
            if len(frame_planes) == 1:
                family = ColorFamily.GRAY
            else:
                ch, cw = frame_planes[1].shape[-2:]
                family = {(2, 2): ColorFamily.YUV420,
                          (2, 1): ColorFamily.YUV422,
                          (1, 2): ColorFamily.YUV440,
                          (1, 1): ColorFamily.YUV444}[(w // cw, h // ch)]
            fmt = VideoFormat(w, h, bits, family)
        spec = cfg_or_spec.validate(fmt)
    else:
        spec = cfg_or_spec
    if frame_planes[0].dtype != pixels.dtype_of(spec.bits):
        raise ValueError(f"Super: {spec.bits}-bit clips take "
                         f"{pixels.dtype_of(spec.bits)} planes, got "
                         f"{frame_planes[0].dtype}")
    if tuple(frame_planes[0].shape[-2:]) != (spec.height, spec.width):
        raise ValueError("Super: frame size does not match the spec.")
    if len(frame_planes) < spec.num_planes:
        raise ValueError(f"Super: the spec asks for {spec.num_planes} planes, "
                         f"got {len(frame_planes)}.")
    return Super(tuple(build_super_plane(frame_planes[p], spec, p)
                       for p in range(spec.num_planes)), spec)
