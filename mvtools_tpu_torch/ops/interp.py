"""Subpel refinement interpolators for the super pyramid.

Equivalents of the reference's Wiener 6-tap pel-refine kernels
(MVFrame.cpp:1019-1111), Average2 (MVFrame.cpp:1180-1197) and the pel=2/4
subplane schedule of mvpRefine (MVFrame.cpp:1386-1527).  Only sharp=2
(Wiener) is ported; bilinear and bicubic raise.

All kernels operate on full padded planes [..., PH, PW] (the reference
refines padded planes) in int32 and reproduce the exact edge special-cases
of the C code.
"""

from __future__ import annotations

from typing import List

import torch

SHARP_WIENER = 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def h_wiener(p: torch.Tensor, bits: int) -> torch.Tensor:
    """HorizontalWiener: 6 taps (1,-5,20,20,-5,1)/32 (MVFrame.cpp:1071-1111)."""
    pixel_max = (1 << bits) - 1
    w = p.shape[-1]
    cols = [
        _avg2(p[..., 0:1], p[..., 1:2]),
        _avg2(p[..., 1:2], p[..., 2:3]),
    ]
    # i in [2, w-4): taps at i-2, i-1, i, i+1, i+2, i+3
    m0 = p[..., 0:w - 6]
    m1 = p[..., 1:w - 5]
    m2 = p[..., 2:w - 4]
    m3 = p[..., 3:w - 3]
    m4 = p[..., 4:w - 2]
    m5 = p[..., 5:w - 1]
    mid = ((m2 + m3) * 4 - (m1 + m4)) * 5 + m0 + m5 + 16
    cols.append((mid >> 5).clamp_(0, pixel_max))
    cols.append(_avg2(p[..., w - 4:w - 1], p[..., w - 3:w]))
    cols.append(p[..., w - 1:w])
    return torch.cat(cols, dim=-1)


def v_wiener(p: torch.Tensor, bits: int) -> torch.Tensor:
    """VerticalWiener (MVFrame.cpp:1019-1068)."""
    return h_wiener(p.transpose(-1, -2), bits).transpose(-1, -2)


def _avg_shift_col(a, b):
    """Average2(dst, src1 + 1 pixel, src2) with width-1: the reference leaves
    the final column at the frame's zero init (MVFrame.cpp:1517)."""
    out = _avg2(a[..., 1:], b[..., :-1])
    return torch.cat([out, torch.zeros_like(a[..., :1])], dim=-1)


def _avg_shift_row(a, b):
    """Average2(dst, src1 + 1 row, src2) with height-1; the final row stays
    0."""
    out = _avg2(a[..., 1:, :], b[..., :-1, :])
    return torch.cat([out, torch.zeros_like(a[..., :1, :])], dim=-2)


def refine_subplanes(p0: torch.Tensor, pel: int, sharp: int,
                     bits: int) -> List[torch.Tensor]:
    """Compute all pel*pel subpel planes of a padded int32 plane.

    Returns a list of pel*pel planes indexed by (x & (pel-1)) | ((y & (pel-1))
    << log2(pel)), i.e. plane[idx][Y, X] samples position (X + xfrac/pel,
    Y + yfrac/pel).  Matches mvpRefine (MVFrame.cpp:1386-1527): horizontal,
    vertical, and horizontal-of-vertical, and at pel 4 the Average2
    schedule between them."""
    if pel == 1:
        return [p0]
    if pel not in (2, 4):
        raise ValueError(f"pel must be 1, 2 or 4, got {pel}")
    if sharp != SHARP_WIENER:
        raise NotImplementedError(
            f"sharp={sharp} at pel {pel}: only the Wiener interpolator "
            "(sharp=2) is ported")
    ph = h_wiener(p0, bits)
    pv = v_wiener(p0, bits)
    pd = h_wiener(pv, bits)
    if pel == 2:
        return [p0, ph, pv, pd]
    pl = [None] * 16
    pl[0], pl[2], pl[8], pl[10] = p0, ph, pv, pd
    # Average2 schedule (MVFrame.cpp:1511-1523)
    pl[1] = _avg2(pl[0], pl[2])
    pl[9] = _avg2(pl[8], pl[10])
    pl[4] = _avg2(pl[0], pl[8])
    pl[6] = _avg2(pl[2], pl[10])
    pl[5] = _avg2(pl[4], pl[6])
    pl[3] = _avg_shift_col(pl[0], pl[2])
    pl[11] = _avg_shift_col(pl[8], pl[10])
    pl[12] = _avg_shift_row(pl[0], pl[8])
    pl[14] = _avg_shift_row(pl[2], pl[10])
    pl[13] = _avg2(pl[12], pl[14])
    pl[7] = _avg_shift_col(pl[4], pl[6])
    pl[15] = _avg_shift_col(pl[12], pl[14])
    return pl
