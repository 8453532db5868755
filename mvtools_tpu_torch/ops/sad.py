"""Block cost helpers: SAD and block luma sum over the trailing two axes
(reference: sad_c SADFunctions.cpp:354-367, luma_c Luma.cpp:14-25).
Inputs are widened to int32 first: uint8 arithmetic wraps in torch."""

from __future__ import annotations

import torch


def sad(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d = src.to(torch.int32) - ref.to(torch.int32)
    return d.abs().sum(dim=(-2, -1))


def luma(src: torch.Tensor) -> torch.Tensor:
    return src.to(torch.int32).sum(dim=(-2, -1))


def _hadamard4(d: torch.Tensor, dim: int) -> torch.Tensor:
    """Unnormalised 4-point Hadamard butterfly along `dim` (HADAMARD4,
    SADFunctions.cpp:581-592).  Only the sum of |coefficients| is used, so
    the row order does not matter."""
    a, b, c, e = d.unbind(dim)
    s0, s1, s2, s3 = a + b, a - b, c + e, c - e
    return torch.stack((s0 + s2, s1 + s3, s0 - s2, s1 - s3), dim)


def _hadamard_abs_sum_4x4(d: torch.Tensor) -> torch.Tensor:
    """sum |H4 @ D @ H4^T| of int32 4x4 tiles [..., 4, 4]."""
    return _hadamard4(_hadamard4(d, -1), -2).abs().sum(
        dim=(-2, -1), dtype=torch.int32)


def satd(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """int32 SATD over the last two axes [..., bh, bw], any leading axes.

    The reference's scalar composition (Satd_C SADFunctions.cpp:713-741): a
    4x4 block is a single transform with the final >> 1; larger blocks sum
    8x4 partitions, each partition being two 4x4 transforms whose absolute
    sums are added BEFORE the >> 1."""
    bh, bw = src.shape[-2:]
    d = src.to(torch.int32) - ref.to(torch.int32)
    if bh == 4 and bw == 4:
        return _hadamard_abs_sum_4x4(d) >> 1
    if bh % 4 or bw % 8:
        raise ValueError(f"SATD unsupported for block size {bw}x{bh}")
    # [..., bh/4, 4, bw/4, 4] -> [..., bh/4, bw/4, 4, 4]
    tiles = d.reshape(*d.shape[:-2], bh // 4, 4, bw // 4, 4).movedim(-3, -2)
    tile_sums = _hadamard_abs_sum_4x4(tiles)             # [..., bh/4, bw/4]
    pair = (tile_sums[..., 0::2] + tile_sums[..., 1::2]) >> 1
    return pair.sum(dim=(-2, -1), dtype=torch.int32)


def satd_supported(bw: int, bh: int) -> bool:
    """The reference has no SATD for 16x2 blocks (PlaneOfBlocks.cpp:365-368)."""
    if bw == 4 and bh == 4:
        return True
    return bh % 4 == 0 and bw % 8 == 0
