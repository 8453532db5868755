"""Replicate padding of frame planes.

Equivalent of the reference's PadReferenceFrame (MVFrame.cpp:1264-1318):
corners take the nearest corner pixel, edges replicate the nearest edge
pixel.  Written as clamped-index gathers because
`F.pad(mode="replicate")` does not take integer tensors; uint16 pixels are
gathered through their int16 view (ops/pixels.py).
"""

from __future__ import annotations

import torch


def edge_pad(t: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate the last two axes of `t` by the given amounts."""
    if t.dtype == torch.uint16:
        return edge_pad(t.view(torch.int16), top, bottom, left,
                        right).view(torch.uint16)
    h, w = t.shape[-2], t.shape[-1]
    if top or bottom:
        iy = torch.arange(-top, h + bottom, device=t.device).clamp_(0, h - 1)
        t = t.index_select(-2, iy)
    if left or right:
        ix = torch.arange(-left, w + right, device=t.device).clamp_(0, w - 1)
        t = t.index_select(-1, ix)
    return t


def pad_replicate(plane: torch.Tensor, hpad: int, vpad: int) -> torch.Tensor:
    """Pad [..., H, W] planes to [..., H + 2*vpad, W + 2*hpad] by edge
    replication."""
    return edge_pad(plane, vpad, vpad, hpad, hpad)
