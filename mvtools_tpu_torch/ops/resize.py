"""SimpleResize: bilinear upscaler with precomputed integer tables.

Equivalent of SimpleResize.cpp: 14-bit fixed-point separable bilinear with
edge-pinned tables (InitTables :27-56).  Used to upscale the per-block vx/vy
fields and the uint8 masks to full frame resolution.  The int16 variant
progressively clamps vectors so `pixel + v` stays inside the padded frame
(simpleResize<int16_t> :60-121).  Plain torch ops on the device of the
input; the tables are numpy, made once per size pair.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

I32 = torch.int32

WEIGHT_SHIFT = 14
WEIGHT_MAX = 1 << WEIGHT_SHIFT
WEIGHT_HALF = WEIGHT_MAX // 2


@functools.lru_cache(maxsize=None)
def init_tables(out: int, in_: int) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, weights) per output coordinate (InitTables, float32 math)."""
    leftmost = np.float32(0.5)
    rightmost = np.float32(in_) - np.float32(0.5)
    leftmost_idx = max(int(leftmost), 0)
    rightmost_idx = min(int(rightmost), in_ - 1)
    offsets = np.zeros(out, np.int32)
    weights = np.zeros(out, np.int32)
    for i in range(out):
        position = np.float32((i + np.float32(0.5)) * np.float32(in_)
                              / np.float32(out))
        if position <= leftmost:
            offset = leftmost_idx
            weight = np.float32(0.0)
        elif position >= rightmost:
            offset = rightmost_idx - 1
            weight = np.float32(1.0)
        else:
            offset = int(position - leftmost)
            weight = np.float32(position - leftmost - np.float32(offset))
        offsets[i] = offset
        weights[i] = int(weight * WEIGHT_MAX)
    return offsets, weights


@functools.lru_cache(maxsize=64)
def _tables(out: int, in_: int, device: torch.device):
    """(offsets, offsets + 1 clamped to the input, weights) as int64 /
    int32 tensors on `device`."""
    off, w = init_tables(out, in_)
    off_t = torch.from_numpy(off.astype(np.int64)).to(device)
    return (off_t, (off_t + 1).clamp(max=in_ - 1),
            torch.from_numpy(w).to(device))


def simple_resize(src: torch.Tensor, dst_height: int, dst_width: int,
                  limit: bool = False, limit_width: int = 0,
                  limit_height: int = 0, pel: int = 1,
                  horizontal_vectors: bool = False) -> torch.Tensor:
    """Resize [sh, sw] -> [dst_height, dst_width] in int32.

    limit=True replicates the int16 path's progressive vector clamping: the
    per-output-pixel bound is `limit * pel - 1 - coord * step` so that
    coord*pel + value stays in the padded frame, and the lower bound walks
    down by step (-coord * pel)."""
    sh, sw = src.shape
    dev = src.device
    v_off, v_off1, v_w = _tables(dst_height, sh, dev)
    h_off, h_off1, h_w = _tables(dst_width, sw, dev)
    src = src.to(I32)
    v_w = v_w[:, None]
    work = (src[v_off] * (WEIGHT_MAX - v_w) + src[v_off1] * v_w
            + WEIGHT_HALF) >> WEIGHT_SHIFT             # [dst_height, sw]
    h_w = h_w[None, :]
    out = (work[:, h_off] * (WEIGHT_MAX - h_w) + work[:, h_off1] * h_w
           + WEIGHT_HALF) >> WEIGHT_SHIFT
    if limit:
        n = dst_width if horizontal_vectors else dst_height
        lim = limit_width if horizontal_vectors else limit_height
        step = pel * torch.arange(n, dtype=I32, device=dev)
        maxi, mini = lim * pel - 1 - step, -step
        if horizontal_vectors:
            maxi, mini = maxi[None, :], mini[None, :]
        else:
            maxi, mini = maxi[:, None], mini[:, None]
        out = torch.minimum(torch.maximum(out, mini), maxi)
    return out
