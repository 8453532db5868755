"""Overlapped-block windows and window-accumulate ("overlap-add").

Equivalent of Overlap.cpp: 9 raised-cosine^2 window variants in 11-bit
fixed point (overInit Overlap.cpp:40-125), the `pDst += (src*win)>>6`
accumulation (overlaps_c :144-158) and the final `(acc+16)>>5` normalisation
(ToPixels :335-356).

The reference walks blocks serially and accumulates into a temp plane; here
the whole overlap-add is done as four phase-decomposed reshapes (blocks at
even/odd grid positions never overlap because overlap <= blocksize/2, which
Analyse enforces — MVAnalyse.c:441-445), so the accumulation is four plane
adds with no scatter.  Blocks carry a leading batch axis.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

OW_TL, OW_TM, OW_TR = 0, 1, 2
OW_ML, OW_MM, OW_MR = 3, 4, 5
OW_BL, OW_BM, OW_BR = 6, 7, 8


@functools.lru_cache(maxsize=None)
def overlap_windows(nx: int, ny: int, ox: int, oy: int) -> np.ndarray:
    """The 9 int16 windows, shape [9, ny, nx] (overInit Overlap.cpp:40-125).

    Computed in float32 like the reference's cosf pipeline.
    """
    def axis_windows(n, o):
        win = np.ones(n, np.float32)
        first = np.ones(n, np.float32)
        last = np.ones(n, np.float32)
        for i in range(o):
            c = np.cos(np.float32(math.pi) * np.float32(i - o + 0.5)
                       / np.float32(o * 2), dtype=np.float32)
            win[i] = c * c
            last[i] = win[i]
        for i in range(n - o, n):
            c = np.cos(np.float32(math.pi) * np.float32(i - n + o + 0.5)
                       / np.float32(o * 2), dtype=np.float32)
            win[i] = c * c
            first[i] = win[i]
        return win, first, last

    wx, wxf, wxl = axis_windows(nx, ox)
    wy, wyf, wyl = axis_windows(ny, oy)
    ys = [wyf, wy, wyl]
    xs = [wxf, wx, wxl]
    out = np.zeros((9, ny, nx), np.int16)
    for wy_i in range(3):
        for wx_i in range(3):
            prod = (ys[wy_i][:, None].astype(np.float32)
                    * xs[wx_i][None, :].astype(np.float32)
                    * np.float32(2048) + np.float32(0.5))
            out[wy_i * 3 + wx_i] = prod.astype(np.int32).astype(np.int16)
    return out


@functools.lru_cache(maxsize=None)
def window_indices(nblkx: int, nblky: int) -> np.ndarray:
    """Per-block window index [nblky, nblkx] (MVDegrains.cpp:256-261):
    wby in {0,3,6} for first/middle/last row, wbx in {0,1,2}; a single
    row/column uses the last-row/column window (the C expression's
    behaviour)."""
    def row_sel(n, i):
        if n == 1:
            return 2
        if n == 2:
            return 0 if i == 0 else 2
        return ((i + n - 3) // (n - 2))  # 0 first, 1 middle, 2 last

    wby = np.array([row_sel(nblky, by) * 3 for by in range(nblky)], np.int64)
    wbx = np.ones(nblkx, np.int64)
    wbx[0] = 0
    wbx[nblkx - 1] = 2
    return wby[:, None] + wbx[None, :]


def overlap_add(blocks: torch.Tensor, nblkx: int, nblky: int,
                blk_size: Tuple[int, int], overlap: Tuple[int, int],
                windows: np.ndarray) -> torch.Tensor:
    """Windowed overlap-add of per-block pixels.

    blocks: [B, nblky, nblkx, bsy, bsx] int32 block pixel values.
    Returns the accumulator planes [B, height_b, width_b] int32 where
    height_b = (bsy-ovy)*nblky + ovy (the covered region), containing
    sum((block * win) >> 6) like the reference's temp plane.
    """
    bsx, bsy = blk_size
    ovx, ovy = overlap
    sx, sy = bsx - ovx, bsy - ovy
    width_b = sx * nblkx + ovx
    height_b = sy * nblky + ovy
    dev = blocks.device
    nb = blocks.shape[0]

    widx = torch.from_numpy(window_indices(nblkx, nblky)).to(dev)
    wins = torch.from_numpy(windows.astype(np.int32)).to(dev)  # [9, bsy, bsx]
    weighted = (blocks * wins[widx]) >> 6       # [B, nblky, nblkx, bsy, bsx]

    acc = torch.zeros((nb, height_b + bsy, width_b + bsx), dtype=torch.int32,
                      device=dev)
    cy = 2 * sy if ovy > 0 else sy
    cx = 2 * sx if ovx > 0 else sx
    for py in range(2 if ovy > 0 else 1):
        for px in range(2 if ovx > 0 else 1):
            sub = weighted[:, py::2, px::2]
            nby_p, nbx_p = sub.shape[1], sub.shape[2]
            padded = torch.nn.functional.pad(sub, (0, cx - bsx, 0, cy - bsy))
            big = padded.permute(0, 1, 3, 2, 4).reshape(nb, nby_p * cy,
                                                        nbx_p * cx)
            oy_off = py * sy
            ox_off = px * sx
            acc[:, oy_off:oy_off + nby_p * cy,
                ox_off:ox_off + nbx_p * cx] += big
    return acc[:, :height_b, :width_b]


def to_pixels(acc: torch.Tensor, bits: int) -> torch.Tensor:
    """(acc + 16) >> 5, saturated (ToPixels Overlap.cpp:335-356)."""
    return ((acc + 16) >> 5).clamp(0, (1 << bits) - 1)
