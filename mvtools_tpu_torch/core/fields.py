"""Interlaced-field helpers: per-frame vertical field shift.

For field-separated clips (fields=True) analysed at sub-pel precision,
opposite-parity frame pairs are vertically offset by half a line; the
reference compensates with a per-frame-pair `fieldShift` applied at the
finest search level (MVAnalyse.c:160-178, MVCompensate.c:188-225).
"""

from __future__ import annotations

from typing import Optional

import torch


def frame_top_field(n: int, tff: bool) -> bool:
    """Top-field flag of frame `n` in a field-separated clip with the
    given top-field-first order (the reference's `tff ^ (n % 2)`)."""
    return bool(tff) ^ bool(n % 2)


def field_shift(n: int, nref: int, pel: int, fields: bool,
                tff: Optional[bool],
                src_top_field: Optional[bool] = None,
                ref_top_field: Optional[bool] = None,
                filter_name: str = "Analyse") -> int:
    """Vertical shift (in pel units) between frame `n` and `nref`.

    Matches MVAnalyse.c:174-178 / MVCompensate.c:188-225: nonzero only
    for fields=True, pel > 1, and an odd frame delta; +pel/2 when the
    source is a top field and the reference a bottom field, -pel/2 for
    the opposite pairing.  `tff`, when given, overrides the per-frame
    `_Field` flags (src_top_field/ref_top_field); with neither, raises
    the reference's error.
    """
    if not fields or pel <= 1 or (nref - n) % 2 == 0:
        return 0
    if tff is not None:
        src_top = frame_top_field(n, tff)
        ref_top = frame_top_field(nref, tff)
    else:
        if src_top_field is None or ref_top_field is None:
            raise ValueError(
                f"{filter_name}: _Field property not found in input "
                f"frame. Therefore, you must pass tff argument.")
        src_top = bool(src_top_field)
        ref_top = bool(ref_top_field)
    if src_top and not ref_top:
        return pel // 2
    if ref_top and not src_top:
        return -(pel // 2)
    return 0


def field_shift_frames(g: torch.Tensor, k: int, pel: int, fields: bool,
                       tff: bool) -> torch.Tensor:
    """`field_shift(g, g + k, ...)` for a [J] tensor of frame indices `g`:
    an int32 tensor of the same shape, on the same device.

    For an odd delta the two frames always have opposite field parity,
    so the sign follows the source frame's field flag alone.
    """
    if not fields or pel <= 1 or (k % 2) == 0:
        return torch.zeros_like(g, dtype=torch.int32)
    src_top = (g % 2) == (0 if tff else 1)
    half = pel // 2
    return torch.where(src_top, half, -half).to(torch.int32)
