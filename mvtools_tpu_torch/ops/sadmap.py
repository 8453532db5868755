"""Dense tile-level SAD maps: every block's SAD at every pel offset of a
+-R grid around a per-tile anchor, in one pass.

The reference's innermost unit is one SAD per candidate per block
(pobCheckMV PlaneOfBlocks.cpp:219-261).  Here a TILE of consecutive blocks
in one block row shares one full-pel anchor near the median of the tile's
predictors, and every static grid offset (dx, dy) in [-Rx, Rx] x [-Ry, Ry]
pel is evaluated for all blocks of the tile (CUDA kernel csrc/sadmap.cu,
plain PyTorch version beside it).  The whole hierarchical search (predictor
trials, hex2 walk, expanding rings) then runs as lookups into the resulting
[J, nblk, Dy, Dx] map (field_engine.MapProber).

With stats="sad_satd_luma" every entry is the triple (SAD, SATD, sum of the
reference block) that the SATD cost modes (dct 5-10) mix: [J, nblk, Dy, Dx, 3],
a kernel of its own in the same source file.

Contract: map entries are bit-identical to probe SADs (or stat triples) for
the same candidate.  Candidates outside the grid are the caller's to reject (they
report INVALID_SAD and lose every cost comparison; the dense zero trial
guarantees a real cost bound exists for every block).

map_geom and anchor_bounds are integer host code that clamps the anchors,
so they decide which candidates fall off the map; their window sizes are
kept exactly as first defined (rounded to 8/32 rows and 128 columns) even
though the CUDA kernel itself needs no such alignment.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import probe as probe_ops

I32 = torch.int32
INVALID_SAD = probe_ops.INVALID_SAD

launches = {"sad_map": 0, "sad_map[stats3]": 0}
plain_calls_on_cuda = 0


def map_geom(r_y: int, r_x: int, bs_y: int, bs_x: int, pel: int,
             tile: int, pitch_fp: int):
    """Static window geometry of a tile map.

    Returns (min_oy, min_ox, span_x, span_pad, rows2, wy_total,
    wx_total): min_o* are the most-negative full-pel grid offsets,
    span_x the tile's source span, span_pad its rounding to 128, rows2
    the row count rounded to 8, w*_total the nominal window size that
    anchor_bounds keeps inside the padded stack."""
    logp = pel.bit_length() - 1
    min_oy = (-r_y) >> logp
    max_oy = r_y >> logp
    min_ox = (-r_x) >> logp
    max_ox = r_x >> logp
    span_x = (tile - 1) * pitch_fp + bs_x
    span_pad = -(-span_x // 128) * 128
    wy_logical = bs_y + (max_oy - min_oy)
    rows2 = -(-wy_logical // 8) * 8
    wx_logical = span_pad + (max_ox - min_ox)
    sl = -(-(max_oy - min_oy + 1) // 8) * 8
    rows_v2 = -(-(bs_y + sl - 1) // 8) * 8
    wy_total = -(-max(wy_logical + 8, rows_v2) // 32) * 32
    wx_total = -(-(wx_logical + 128) // 128) * 128
    return min_oy, min_ox, span_x, span_pad, rows2, wy_total, wx_total


def grid_offsets(r_y: int, r_x: int):
    """The static pel-offset grid, dy-major (row index iy = dy + r_y,
    column index ix = dx + r_x)."""
    return [(dx, dy) for dy in range(-r_y, r_y + 1)
            for dx in range(-r_x, r_x + 1)]


def anchor_bounds(r_y: int, r_x: int, bs_y: int, bs_x: int, pel: int,
                  tile: int, pitch_fp: int, hp: int, wp: int):
    """Inclusive [lo, hi] full-pel anchor ranges (y, x) such that the
    nominal tile window stays inside a [hp, wp] padded stack."""
    min_oy, min_ox, _, _, _, wy_total, wx_total = map_geom(
        r_y, r_x, bs_y, bs_x, pel, tile, pitch_fp)
    lo_y, lo_x = -min_oy, -min_ox
    hi_y = hp - wy_total - min_oy
    hi_x = wp - wx_total - min_ox
    return (lo_y, hi_y), (lo_x, hi_x)


def sad_map_plain(stack, src_plane, anchor_fy, anchor_fx, r_y: int, r_x: int,
                  bs_y: int, bs_x: int, pel: int, tile: int, pitch_x: int,
                  pitch_y: int, nbx: int, nby: int, src_y0: int,
                  src_x0: int, stats: str = "sad") -> torch.Tensor:
    """Plain PyTorch version of the SAD map (same contract as the
    kernel, either form)."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    stats3 = _check_stats(stats, stack, pitch_x, bs_y, bs_x)
    logp = pel.bit_length() - 1
    pelm = pel - 1
    nj, n_sub, hp, wp = stack.shape
    hs, ws = src_plane.shape[-2:]
    dev = stack.device
    ntx = -(-nbx // tile)
    by = torch.arange(nby, device=dev)
    bx = torch.arange(nbx, device=dev)
    # source blocks [J, nby, nbx, bs_y, bs_x]
    sy = (src_y0 + by[:, None] * pitch_y
          + torch.arange(bs_y, device=dev)[None, :]).clamp(0, hs - 1)
    sx = (src_x0 + bx[:, None] * pitch_x
          + torch.arange(bs_x, device=dev)[None, :]).clamp(0, ws - 1)
    src = src_plane[:, sy[:, None, :, None], sx[None, :, None, :]].to(I32)
    # per-block full-pel reference origin at offset (0, 0)
    t_of = bx // tile
    afy = anchor_fy.reshape(nj, nby, ntx)[:, :, t_of]              # [J,nby,nbx]
    afx = (anchor_fx.reshape(nj, nby, ntx)[:, :, t_of]
           + ((bx % tile) * pitch_x)[None, None, :])
    yy = torch.arange(bs_y, device=dev)[:, None]
    xx = torch.arange(bs_x, device=dev)[None, :]
    job = torch.arange(nj, device=dev).reshape(nj, 1, 1, 1, 1)
    flat_stack = stack.reshape(-1)
    rows = []
    for dy in range(-r_y, r_y + 1):
        cols = []
        gy = (afy[..., None, None] + (dy >> logp) + yy).clamp(0, hp - 1)
        for dx in range(-r_x, r_x + 1):
            sub = (dx & pelm) | ((dy & pelm) << logp)
            gx = (afx[..., None, None] + (dx >> logp) + xx).clamp(0, wp - 1)
            ref = flat_stack[((job * n_sub + sub) * hp + gy) * wp + gx]
            cols.append(probe_ops._block_costs(ref.to(I32), src, stats3))
        rows.append(torch.stack(cols, dim=3))
    out = torch.stack(rows, dim=3)                 # [J, nby, nbx, Dy, Dx(, 3)]
    return out.reshape((nj, nby * nbx) + out.shape[3:]).to(I32)


def _check_stats(stats: str, stack, pitch_x: int, bs_y: int,
                 bs_x: int) -> bool:
    """True for the three-stat form, which needs 8-bit data and a block
    grid whose 8x4 SATD partitions line up: pitch and block width multiples
    of 8, block height a multiple of 4."""
    if stats not in probe_ops.STATS:
        raise ValueError(f"sad_map: stats must be one of {probe_ops.STATS}")
    if stats == "sad":
        return False
    if (pitch_x % 8 or bs_x % 8 or bs_y % 4
            or stack.dtype != torch.uint8):
        raise ValueError("sad_map: the satd map needs u8 data, pitch % 8 == "
                         "0, bs_x % 8 == 0 and bs_y % 4 == 0")
    return True


def _lib(stats3: bool):
    lib = cuda_build.load("sadmap")
    fn = lib.mvt_sad_map_stats3 if stats3 else lib.mvt_sad_map
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sad_map(stack, src_plane, anchor_fy, anchor_fx, r_y: int, r_x: int,
            bs_y: int, bs_x: int, pel: int, tile: int, pitch_x: int,
            pitch_y: int, nbx: int, nby: int, src_y0: int,
            src_x0: int, stats: str = "sad") -> torch.Tensor:
    """[J, nby*nbx, 2*r_y+1, 2*r_x+1] int32 SAD map, dy-major; with
    stats="sad_satd_luma" [J, nby*nbx, 2*r_y+1, 2*r_x+1, 3] triples (SAD,
    SATD, sum of the reference block).

    stack: [J, pel^2, Hp, Wp] uint8 pad_stack output; src_plane:
    [J, Hs, Ws] uint8 source plane, block (row, col) at
    (src_y0 + row*pitch_y, src_x0 + col*pitch_x); anchor_fy/fx:
    [J, nby*ceil(nbx/tile)] int32 full-pel stack positions of each tile's
    first block at offset (0, 0), pre-clamped to anchor_bounds."""
    stats3 = _check_stats(stats, stack, pitch_x, bs_y, bs_x)
    if not stack.is_cuda:
        return sad_map_plain(stack, src_plane, anchor_fy, anchor_fx, r_y,
                             r_x, bs_y, bs_x, pel, tile, pitch_x, pitch_y,
                             nbx, nby, src_y0, src_x0, stats)
    dev = stack.device
    probe_ops._check(stack, "stack", torch.uint8, 4)
    probe_ops._check(src_plane, "src_plane", torch.uint8, 3, dev)
    probe_ops._check(anchor_fy, "anchor_fy", I32, 2, dev)
    probe_ops._check(anchor_fx, "anchor_fx", I32, 2, dev)
    nj = stack.shape[0]
    ntile = nby * (-(-nbx // tile))
    if (stack.shape[1] != pel * pel or src_plane.shape[0] != nj
            or tuple(anchor_fy.shape) != (nj, ntile)
            or tuple(anchor_fx.shape) != (nj, ntile)):
        raise ValueError("sad_map: inconsistent shapes")
    name = "sad_map[stats3]" if stats3 else "sad_map"
    out = torch.empty((nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1)
                      + ((3,) if stats3 else ()), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _lib(stats3)(
            stack.data_ptr(), src_plane.data_ptr(), anchor_fy.data_ptr(),
            anchor_fx.data_ptr(), out.data_ptr(), nj, pel * pel,
            stack.shape[2], stack.shape[3], src_plane.shape[1],
            src_plane.shape[2], nbx, nby, tile, pitch_x, pitch_y, bs_y, bs_x,
            src_y0, src_x0, r_y, r_x, pel.bit_length() - 1,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out
