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
a kernel of its own in the same source file (launch geometry:
map3_launch_geom), defined for 8-bit data only.  The SAD form takes uint8
and uint16 (9- to 16-bit) stacks, a kernel instantiation for each, and
counts the launches of the uint16 one as "sad_map[u16]".

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

from . import cuda_build, pixels
from . import probe as probe_ops

I32 = torch.int32
INVALID_SAD = probe_ops.INVALID_SAD

launches = {"sad_map": 0, "sad_map[stats3]": 0, "sad_map[u16]": 0}
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
    src = pixels.widen(pixels.gather(
        src_plane, (slice(None), sy[:, None, :, None], sx[None, :, None, :])))
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
            ref = pixels.gather(flat_stack,
                                ((job * n_sub + sub) * hp + gy) * wp + gx)
            cols.append(probe_ops._block_costs(pixels.widen(ref), src,
                                               stats3))
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


# The plain map kernel's limits on this card: threads per CTA (its
# __launch_bounds__) and shared memory a CTA may use (227 KB).
MAP_MAX_THREADS = 512
SMEM_LIMIT = 232448
# template instantiations of csrc/sadmap.cu::sadmap_kernel: source words a
# row step holds, and column accumulators a thread owns
MAP_NWS = (1, 2, 4, 8)
MAP_NOX = (6, 9, 16)


def _parity_first(r: int, q: int, pelm: int) -> int:
    """First offset d >= -r of pel parity q (the kernel's parity_first)."""
    return -r + ((q + r) & pelm)


def _parity_count(r: int, q: int, pel: int) -> int:
    """Offsets of pel parity q in [-r, r]."""
    d0 = _parity_first(r, q, pel - 1)
    return max(0, ((r - d0) >> (pel.bit_length() - 1)) + 1)


def map_launch_geom(r_y: int, r_x: int, bs_y: int, bs_x: int, pel: int,
                    tile: int, pitch_x: int, pix_bytes: int = 1) -> dict:
    """Launch geometry of the plain map kernel for one map shape and pixel
    size (1: uint8, 2: uint16): the template choice, the work split and the
    shared-memory layout.

    A CTA serves `nbc` consecutive blocks of one tile (the whole tile
    unless its staging would pass SMEM_LIMIT; then the tile's blocks are
    split over n_part CTAs, each staging the window of its own blocks round
    the tile's anchor: the uint16 form's way with 10-bit 128x128 blocks;
    every 8-bit shape fits whole, and the 8-bit form takes no split).  A
    thread owns one (block, subplane, full-pel row) and `nox` full-pel
    columns of that grid row (n_chunk chunks cover the row); the CTA stages
    the [pel^2, wy, ref_pitch] reference window, each block's source rows
    ([nbc, src_stride] bytes, word-aligned) and the blocks' int32 results.
    A 32-bit word holds 4 // pix_bytes pixels.
    ref_pitch covers the last word any thread reads (its column start, the
    block row's words and the funnel shift's spill); the two strides are
    odd word counts, so the threads of a warp, which differ in their block,
    hit different shared-memory banks."""
    if pel not in (1, 2):
        raise ValueError("map_launch_geom: pel must be 1 or 2")
    if pix_bytes not in (1, 2):
        raise ValueError("map_launch_geom: pixels are 1 or 2 bytes")
    logp = pel.bit_length() - 1
    ppw = 4 // pix_bytes
    wpr = -(-bs_x // ppw)
    nws = next(n for n in reversed(MAP_NWS) if wpr % n == 0)
    if bs_x % ppw:
        nws = 1
    nox_max = max(_parity_count(r_x, q, pel) for q in range(pel))
    nox = next((n for n in MAP_NOX if n >= nox_max), MAP_NOX[-1])
    n_chunk = -(-nox_max // nox)
    n_rows = pel * sum(_parity_count(r_y, q, pel) for q in range(pel))
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    wy = bs_y + (r_y >> logp) - min_oy
    col_off = max((_parity_first(r_x, q, pel - 1) >> logp) - min_ox
                  for q in range(pel))
    src_stride = bs_y * wpr * 4
    if (src_stride // 4) % 2 == 0:
        src_stride += 4
    for nbc in range(tile, 0, -1):
        col0_max = (nbc - 1) * pitch_x + col_off + (n_chunk - 1) * nox
        last = (pix_bytes * (col0_max + nox) + 4 * wpr
                + (2 if pix_bytes == 1 else 0))
        ref_pitch = -(-last // 4) * 4
        if (ref_pitch // 4) % 2 == 0:
            ref_pitch += 4
        src_off = pel * pel * wy * ref_pitch
        out_off = src_off + nbc * src_stride
        smem = out_off + nbc * (2 * r_y + 1) * (2 * r_x + 1) * 4
        if smem <= SMEM_LIMIT:
            break
    if pix_bytes == 1 and nbc < tile:
        raise ValueError("map_launch_geom: an 8-bit map whose tile does "
                         "not fit a CTA")
    items = nbc * n_rows * n_chunk
    passes = -(-items // MAP_MAX_THREADS)
    threads = -(-(-(-items // passes)) // 32) * 32
    return dict(threads=threads, smem=smem, ref_pitch=ref_pitch,
                src_stride=src_stride, src_off=src_off, out_off=out_off,
                nws=nws, nox=nox, n_chunk=n_chunk, n_rows=n_rows, wy=wy,
                items=items, nbc=nbc, n_part=-(-tile // nbc))


_GEOM_ARGS = ("threads", "smem", "ref_pitch", "src_stride", "src_off",
              "out_off", "nws", "nox", "n_chunk", "n_rows", "nbc", "n_part")

# template instantiations of csrc/sadmap.cu::sadmap3_kernel: full-pel
# columns a thread owns; its threads per CTA (its __launch_bounds__)
MAP3_NOX = (4, 5, 6, 7, 8)
MAP3_MAX_THREADS = 288
# rows of 4x4 reference positions whose transforms a band holds
MAP3_BAND = 4


def map3_launch_geom(r_y: int, r_x: int, bs_y: int, bs_x: int, pel: int,
                     tile: int, pitch_x: int) -> dict:
    """Launch geometry of the three-stat map kernel (K1') for one map
    shape: the work split and the shared-memory layout.

    Per CTA (job, tile) and subplane, an item is one (block, full-pel grid
    row, chunk of nox full-pel columns) of that subplane's offsets; a
    thread owns one item a pass (`passes` passes cover a subplane).  Shared
    memory holds, in this order: the subplane's reference window
    ([wy, ref_pitch] bytes), the tile's source span ([bs_y, span_pitch]
    bytes), the Hadamard transforms of the span's 4x4 source tiles
    ([bs_y/4, nxs] of 32 bytes), the blocks' source constants (tile ints),
    one band of transformed 4x4 reference positions ([MAP3_BAND,
    hr_pitch] bytes, 32 a position, rows padded by 16 bytes against bank
    conflicts; the column sums of the box sums use it first) and the
    block-sized box sums of the reference window ([ny, nbox] ints)."""
    if pel not in (1, 2):
        raise ValueError("map3_launch_geom: pel must be 1 or 2")
    if pitch_x % 8 or bs_x % 8 or bs_y % 4:
        raise ValueError("map3_launch_geom: needs pitch % 8 == 0, "
                         "bs_x % 8 == 0 and bs_y % 4 == 0")
    logp = pel.bit_length() - 1
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    ny = (r_y >> logp) - min_oy + 1
    nx = (r_x >> logp) - min_ox + 1
    wy = bs_y + ny - 1
    span = (tile - 1) * pitch_x + bs_x
    wx = span + nx - 1
    rmax = max(_parity_count(r_y, q, pel) for q in range(pel))
    cmax = max(_parity_count(r_x, q, pel) for q in range(pel))
    n_chunk = -(-cmax // MAP3_NOX[-1])
    while (n_chunk < -(-cmax // MAP3_NOX[0])
           and tile * rmax * (n_chunk + 1) <= MAP3_MAX_THREADS):
        n_chunk += 1
    nox = max(MAP3_NOX[0], -(-cmax // n_chunk))
    items = tile * rmax * n_chunk
    passes = -(-items // MAP3_MAX_THREADS)
    nyp = wy - 3
    n_band = -(-nyp // MAP3_BAND)
    npos = wx - 3
    # enough threads for a pass of items and, where the cap allows, for one
    # column strip of the window each (the box sums' and the bands' phases)
    threads = -(-min(MAP3_MAX_THREADS, max(-(-items // passes), wx)) // 32) * 32
    nbox = wx - bs_x + 1
    nxs = span // 4
    # the last reference byte an item reads: its column start, the block
    # row and the funnel shift's spill word
    col_off = max((_parity_first(r_x, q, pel - 1) >> logp) - min_ox
                  for q in range(pel))
    col0_max = (tile - 1) * pitch_x + col_off + (n_chunk - 1) * nox
    last_word = (col0_max >> 2) + (bs_x >> 2) - 2 + (3 + nox - 1 + 7) // 4 + 1
    ref_pitch = 4 * max(last_word + 1, -(-wx // 4))
    if (ref_pitch // 4) % 2 == 0:
        ref_pitch += 4
    span_pitch = -(-span // 4) * 4
    if (span_pitch // 4) % 2 == 0:
        span_pitch += 4
    hr_pitch = 32 * npos + 16

    def up16(v):
        return -(-v // 16) * 16

    src_off = up16(wy * ref_pitch)
    hs_off = up16(src_off + bs_y * span_pitch)
    sc_off = hs_off + (bs_y // 4) * nxs * 32
    hr_off = up16(sc_off + 4 * tile)
    box_off = hr_off + max(MAP3_BAND * hr_pitch, 4 * ny * wx)
    smem = box_off + 4 * ny * nbox
    return dict(threads=threads, smem=smem, passes=passes, items=items,
                nox=nox, n_chunk=n_chunk, ref_pitch=ref_pitch,
                span_pitch=span_pitch, src_off=src_off, hs_off=hs_off,
                sc_off=sc_off, hr_off=hr_off, hr_pitch=hr_pitch,
                box_off=box_off, nxs=nxs, npos=npos, nbox=nbox, ny=ny,
                nyp=nyp, n_band=n_band, wy=wy, wx=wx)


_GEOM3_ARGS = ("threads", "smem", "nox", "n_chunk", "ref_pitch",
               "span_pitch", "src_off", "hs_off", "sc_off", "hr_off",
               "hr_pitch", "box_off", "nxs", "npos", "nbox", "ny", "nyp",
               "n_band")


def _lib(stats3: bool):
    lib = cuda_build.load("sadmap")
    fn = lib.mvt_sad_map_stats3 if stats3 else lib.mvt_sad_map
    if not fn.argtypes:
        n_int = 18 + (len(_GEOM3_ARGS) if stats3 else len(_GEOM_ARGS) + 1)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int \
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

    stack: [J, pel^2, Hp, Wp] uint8 or uint16 pad_stack output (the
    three-stat form: uint8); src_plane: [J, Hs, Ws] source plane of the
    stack's dtype, block (row, col) at
    (src_y0 + row*pitch_y, src_x0 + col*pitch_x); anchor_fy/fx:
    [J, nby*ceil(nbx/tile)] int32 full-pel stack positions of each tile's
    first block at offset (0, 0), pre-clamped to anchor_bounds."""
    stats3 = _check_stats(stats, stack, pitch_x, bs_y, bs_x)
    if not stack.is_cuda:
        return sad_map_plain(stack, src_plane, anchor_fy, anchor_fx, r_y,
                             r_x, bs_y, bs_x, pel, tile, pitch_x, pitch_y,
                             nbx, nby, src_y0, src_x0, stats)
    dev = stack.device
    probe_ops._check(stack, "stack", pixels.PIXEL_DTYPES, 4)
    probe_ops._check(src_plane, "src_plane", stack.dtype, 3, dev)
    probe_ops._check(anchor_fy, "anchor_fy", I32, 2, dev)
    probe_ops._check(anchor_fx, "anchor_fx", I32, 2, dev)
    nj = stack.shape[0]
    ntile = nby * (-(-nbx // tile))
    if (stack.shape[1] != pel * pel or src_plane.shape[0] != nj
            or tuple(anchor_fy.shape) != (nj, ntile)
            or tuple(anchor_fx.shape) != (nj, ntile)):
        raise ValueError("sad_map: inconsistent shapes")
    u16 = stack.dtype == torch.uint16
    if stats3:
        name = "sad_map[stats3]"
        g = map3_launch_geom(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x)
        geom = tuple(g[k] for k in _GEOM3_ARGS)
    else:
        name = "sad_map[u16]" if u16 else "sad_map"
        g = map_launch_geom(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x,
                            2 if u16 else 1)
        geom = tuple(g[k] for k in _GEOM_ARGS) + (int(u16),)
    out = torch.empty((nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1)
                      + ((3,) if stats3 else ()), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _lib(stats3)(
            stack.data_ptr(), src_plane.data_ptr(), anchor_fy.data_ptr(),
            anchor_fx.data_ptr(), out.data_ptr(), nj, pel * pel,
            stack.shape[2], stack.shape[3], src_plane.shape[1],
            src_plane.shape[2], nbx, nby, tile, pitch_x, pitch_y, bs_y, bs_x,
            src_y0, src_x0, r_y, r_x, pel.bit_length() - 1, *geom,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out
