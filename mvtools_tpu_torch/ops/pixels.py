"""Pixel tensors of either depth: uint8 for 8-bit clips, uint16 for clips
of 9 to 16 bits (the JAX package's two pixel dtypes).

PyTorch implements few operations on uint16, and not the same ones on the
CPU and on the card (on CUDA tensors advanced indexing, `where` and all
arithmetic raise).  So pixels enter and leave the port as uint8 or uint16,
every arithmetic step runs in int32, and a uint16 tensor passes only
through the helpers below, which reach it through its int16 view (the same
bits) where an operation needs one.
"""

from __future__ import annotations

import torch

PIXEL_DTYPES = (torch.uint8, torch.uint16)


def dtype_of(bits: int) -> torch.dtype:
    """The pixel dtype of a clip of `bits` bits per sample."""
    return torch.uint8 if bits <= 8 else torch.uint16


def widen(t: torch.Tensor) -> torch.Tensor:
    """The int32 values of a tensor of pixels (or of any integer tensor)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


def narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 pixel values, already inside the range of `dtype`, as pixels
    of that dtype."""
    if dtype == torch.uint16:
        return t.to(torch.int16).view(torch.uint16)
    return t.to(dtype)


def gather(t: torch.Tensor, index) -> torch.Tensor:
    """t[index] (advanced indexing) for a tensor of pixels of either
    dtype."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[index].view(torch.uint16)
    return t[index]
