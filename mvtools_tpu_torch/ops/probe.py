"""Candidate probes and reference-block fetches on a pel-subplane stack.

The reference's innermost loop is one SAD per candidate vector per block
(pobCheckMV_Template PlaneOfBlocks.cpp:219-261 over pobGetRefBlock's
pel-plane pointer math :34-54).  Three operations live here, each as a CUDA
kernel (csrc/probe.cu, csrc/probe_block.cu, csrc/fetch.cu) with a plain
PyTorch version beside it:

* probe_sads — [J, nblk, K, D] int32 SADs for K candidate centres per block
  times D static pel offsets, one window per (block, candidate); every entry
  is a real SAD.  It serves the planes that are too small for the tiled
  probe's shared window (the coarse pyramid levels, small chroma planes).
* probe_sads_tiled — [J, nblk, K, D] int32 SADs for K candidate centres per
  block times D static pel offsets, with the tile-extent validity rule:
  candidates whose window leaves their tile's shared window report
  INVALID_SAD and lose every cost comparison.  A plane smaller than the tile
  window goes to probe_sads instead.
* fetch_blocks_tiled — [J, nblk, K, bs_y, bs_x] int32 reference blocks at pel
  positions, exact for every block.

Both probes also come in a three-stat form (stats="sad_satd_luma"): every
entry is the triple (SAD, SATD, sum of the reference block) that the SATD
cost modes (dct 5-10) mix, output [..., 3].  It is a kernel of its own in
the same source file, defined for 8-bit stacks and the block sizes the SATD
exists for.

A wrapper launches its kernel when the tensors are on a CUDA device and
uses the plain version only for CPU tensors.

Coordinates: candidates are PEL-space positions of the block origin
including the frame padding and the extra probe padding applied by
pad_stack, i.e. (hpad + probe_pad + x) * pel + vx.  The job axis J is an
explicit leading axis everywhere.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from . import sad as sad_ops
from .pad import edge_pad

I32 = torch.int32

# Extra bottom/right padding of a probe stack.  The sizes come from the
# window alignment of the first implementation of these probes; they stay
# because they are part of the result: anchor clamps (sadmap.anchor_bounds)
# and tile-window clamps (_tile_base) are taken against the padded extent,
# so they decide which candidates fall off a map or a tile.
ALIGN_SLACK_Y = 64
ALIGN_SLACK_X = 384

INVALID_SAD = 2147483647   # int32 max

STATS = ("sad", "sad_satd_luma")

# one count per kernel; the three-stat forms are kernels of their own
launches = {"probe_sads": 0, "probe_sads_tiled": 0, "fetch_blocks_tiled": 0,
            "probe_sads[stats3]": 0, "probe_sads_tiled[stats3]": 0}
plain_calls_on_cuda = 0    # plain versions run on CUDA tensors (comparisons)


def pad_stack(stack: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-pad every subplane of a [..., pel^2, ph, pw] stack by `pad`
    full-pel pixels, plus ALIGN_SLACK on the bottom/right."""
    return edge_pad(stack, pad, pad + ALIGN_SLACK_Y, pad, pad + ALIGN_SLACK_X)


def _window_geom(offsets, bs_y: int, bs_x: int, pel: int):
    """Full-pel window size and base pel-offset for a static offset set."""
    logp = pel.bit_length() - 1
    min_dx = min(o[0] for o in offsets)
    max_dx = max(o[0] for o in offsets)
    min_dy = min(o[1] for o in offsets)
    max_dy = max(o[1] for o in offsets)
    # full-pel span: positions (c+d)>>logp for d in [min_d, max_d]
    wy = bs_y + ((max_dy >> logp) - (min_dy >> logp)) + 1
    wx = bs_x + ((max_dx >> logp) - (min_dx >> logp)) + 1
    return min_dx, min_dy, wy, wx


def _tile_geom(offsets, bs_y: int, bs_x: int, pel: int):
    """(min_dx, min_dy, wy, wx, rows2, cxs): logical window of the offset
    set plus the two rounded sizes the validity rule is stated in (rows2:
    rows to a multiple of 8, cxs: columns + 127 to a multiple of 128)."""
    min_dx, min_dy, wy, wx = _window_geom(offsets, bs_y, bs_x, pel)
    rows2 = -(-wy // 8) * 8
    cxs = -(-(wx + 127) // 128) * 128
    return min_dx, min_dy, wy, wx, rows2, cxs


def tile_params(offsets, bs_y: int, bs_x: int, pel: int, tile: int,
                pitch_x: int, margin_y: int = 20, margin_x: int = 64):
    """Static tile-window extents and anchor centering for
    probe_sads_tiled.

    pitch_x: full-pel distance between consecutive blocks' window bases;
    margins are the tolerated full-pel MV deviation from the tile anchor."""
    _, _, wy, wx, rows2, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    wy_total = -(-(max(rows2, wy + 2 * margin_y)) // 32) * 32
    span = (tile - 1) * pitch_x
    wx_total = -(-(span + cxs + 2 * margin_x) // 128) * 128
    center_y = margin_y
    center_x = (tile // 2) * pitch_x + margin_x
    return wy_total, wx_total, center_y, center_x


def _med3(a, b, c):
    return torch.maximum(torch.minimum(a, b),
                         torch.minimum(torch.maximum(a, b), c))


def _tile_base(wb0, wbm, wb1, center: int, lo_max: int, align_mask: int):
    """Clamped, aligned-down tile window base from the med3 anchor."""
    base = (_med3(wb0, wbm, wb1) - center).clamp(0, lo_max)
    return base & align_mask


@functools.lru_cache(maxsize=None)
def _offsets_tensor(offsets: tuple, device) -> torch.Tensor:
    """[D, 2] int32 (dx, dy) device table of a static offset set, made once
    per set and device."""
    return torch.tensor([[int(dx), int(dy)] for dx, dy in offsets],
                        dtype=I32, device=device)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device=None):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor, got "
            f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_stats(what: str, stats: str, stack) -> bool:
    """True for the three-stat form.  It is defined for 8-bit stacks only
    and needs a block size the SATD exists for."""
    if stats not in STATS:
        raise ValueError(f"{what}: stats must be one of {STATS}")
    if stats == "sad":
        return False
    if stack.dtype != torch.uint8:
        raise ValueError(f"{what}: the stats path supports 8-bit stacks only")
    return True


def _block_costs(ref, src, stats3: bool):
    """SAD [...] of int32 blocks ref against src over the last two axes, or
    with stats3 the triple (SAD, SATD, sum of the reference block)
    [..., 3]."""
    s = (ref - src).abs().sum(dim=(-2, -1))
    if not stats3:
        return s
    return torch.stack((s, sad_ops.satd(src, ref),
                        ref.sum(dim=(-2, -1))), dim=-1)


def _gather_at(stack, sub, fy, fx, bs_y: int, bs_x: int):
    """int32 [..., bs_y, bs_x] patches of stack [J, n_sub, H, W] from
    subplane `sub` at full-pel origin (fy, fx), all [J, ...]; rows/columns
    clamped into the plane."""
    nj, n_sub, hp, wp = stack.shape
    dev = stack.device
    gy = (fy[..., None, None]
          + torch.arange(bs_y, device=dev)[:, None]).clamp(0, hp - 1)
    gx = (fx[..., None, None]
          + torch.arange(bs_x, device=dev)[None, :]).clamp(0, wp - 1)
    job = torch.arange(nj, device=dev).reshape((nj,) + (1,) * (gy.ndim - 1))
    flat = ((job * n_sub + sub[..., None, None]) * hp + gy) * wp + gx
    return stack.reshape(-1)[flat].to(I32)


def _gather_blocks_plain(stack, pos_y, pos_x, bs_y: int, bs_x: int, logp: int):
    """int32 [..., bs_y, bs_x] patches of stack [J, n_sub, H, W] at pel
    positions pos_y/pos_x [J, ...]; rows/columns clamped into the plane."""
    pelm = (1 << logp) - 1
    sub = (pos_x & pelm) | ((pos_y & pelm) << logp)
    return _gather_at(stack, sub, pos_y >> logp, pos_x >> logp, bs_y, bs_x)


# ---------------------------------------------------------------------------
# K4: per-block probe


def probe_sads_plain(stack, cand_y, cand_x, src_blocks, offsets, bs_y: int,
                     bs_x: int, pel: int, stats: str = "sad") -> torch.Tensor:
    """Plain PyTorch version of the per-block probe (same contract as the
    kernel, either form).  Out-of-range rule: the window of the whole offset set is
    shifted as a whole into the plane and each offset's block keeps its
    place inside it — what a clamped window slice followed by an in-window
    slice does."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    stats3 = _check_stats("probe_sads", stats, stack)
    logp = pel.bit_length() - 1
    pelm = pel - 1
    min_dx, min_dy, wy, wx = _window_geom(offsets, bs_y, bs_x, pel)
    hp, wp = stack.shape[-2:]
    wb_y = (cand_y + min_dy) >> logp
    wb_x = (cand_x + min_dx) >> logp
    shift_y = wb_y.clamp(0, hp - wy) - wb_y
    shift_x = wb_x.clamp(0, wp - wx) - wb_x
    src = src_blocks.to(I32)[:, :, None]                    # [J, nblk, 1, ..]
    cols = []
    for dx, dy in offsets:
        ay = cand_y + dy
        ax = cand_x + dx
        sub = (ax & pelm) | ((ay & pelm) << logp)
        ref = _gather_at(stack, sub, (ay >> logp) + shift_y,
                         (ax >> logp) + shift_x, bs_y, bs_x)
        cols.append(_block_costs(ref, src, stats3))
    return torch.stack(cols, dim=3).to(I32)


def _probe_block_lib(stats3: bool):
    lib = cuda_build.load("probe_block")
    fn = lib.mvt_probe_sads_stats3 if stats3 else lib.mvt_probe_sads
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_probe_args(what, stack, cand_y, cand_x, src_blocks, bs_y, bs_x,
                      pel, stats3=False):
    if stack.dtype != torch.uint8:
        raise NotImplementedError(f"{what}: only 8-bit stacks are ported")
    if stats3 and not sad_ops.satd_supported(bs_x, bs_y):
        raise ValueError(f"{what}: no SATD for block size {bs_x}x{bs_y}")
    if pel not in (1, 2, 4):
        raise ValueError(f"{what}: pel must be 1, 2 or 4")
    dev = stack.device
    _check(stack, "stack", torch.uint8, 4)
    _check(cand_y, "cand_y", I32, 3, dev)
    _check(cand_x, "cand_x", I32, 3, dev)
    _check(src_blocks, "src_blocks", torch.uint8, 4, dev)
    nj, nblk, _ = cand_y.shape
    if (cand_x.shape != cand_y.shape or stack.shape[0] != nj
            or stack.shape[1] != pel * pel
            or tuple(src_blocks.shape) != (nj, nblk, bs_y, bs_x)):
        raise ValueError(f"{what}: inconsistent shapes")


def probe_sads(stack, cand_y, cand_x, src_blocks, offsets, bs_y: int,
               bs_x: int, pel: int, stats: str = "sad") -> torch.Tensor:
    """[J, nblk, K, D] int32 SADs, one window per (block, candidate); with
    stats="sad_satd_luma" [J, nblk, K, D, 3] triples (SAD, SATD, sum of the
    reference block).

    stack: [J, pel^2, Hp, Wp] uint8 pad_stack output; cand_y/cand_x:
    [J, nblk, K] int32 candidate pel positions (see module doc);
    src_blocks: [J, nblk, bs_y, bs_x] uint8; offsets: static [(dx, dy), ...]
    pel offsets evaluated per candidate.  The kernel serves every call on
    CUDA tensors, however few the blocks."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    stats3 = _check_stats("probe_sads", stats, stack)
    _check_probe_args("probe_sads", stack, cand_y, cand_x, src_blocks, bs_y,
                      bs_x, pel, stats3)
    min_dx, min_dy, wy, wx = _window_geom(offsets, bs_y, bs_x, pel)
    if stack.shape[2] < wy or stack.shape[3] < wx:
        raise ValueError("probe_sads: the plane is smaller than the window "
                         "of the offset set")
    if not stack.is_cuda:
        return probe_sads_plain(stack, cand_y, cand_x, src_blocks, offsets,
                                bs_y, bs_x, pel, stats)
    dev = stack.device
    nj, nblk, kk = cand_y.shape
    offs = _offsets_tensor(offsets, dev)
    name = "probe_sads[stats3]" if stats3 else "probe_sads"
    out = torch.empty((nj, nblk, kk, len(offsets)) + ((3,) if stats3 else ()),
                      dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _probe_block_lib(stats3)(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            src_blocks.data_ptr(), offs.data_ptr(), out.data_ptr(),
            nj, pel * pel, stack.shape[2], stack.shape[3], nblk, kk,
            len(offsets), bs_y, bs_x, pel.bit_length() - 1, min_dy, min_dx,
            wy, wx, torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# K2: tiled probe


def probe_sads_tiled_plain(stack, cand_y, cand_x, src_blocks, offsets,
                           bs_y: int, bs_x: int, pel: int, row_len: int,
                           tile: int, wy_total: int, wx_total: int,
                           center_y: int, center_x: int,
                           stats: str = "sad") -> torch.Tensor:
    """Plain PyTorch version of the tiled probe (same contract as the
    kernel, either form): per-candidate SADs (or stat triples) where the
    candidate window fits its tile's extent, INVALID_SAD (in all three)
    elsewhere."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    stats3 = _check_stats("probe_sads_tiled", stats, stack)
    logp = pel.bit_length() - 1
    min_dx, min_dy, wy, _, _, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    nj, _, hp, wp = stack.shape
    _, nblk, kk = cand_y.shape
    nrows = nblk // row_len
    dev = stack.device
    wb_y = ((cand_y + min_dy) >> logp).reshape(nj, nrows, row_len, kk)
    wb_x = ((cand_x + min_dx) >> logp).reshape(nj, nrows, row_len, kk)
    # tile members, block rows edge-padded to a multiple of `tile`
    col = torch.arange(row_len, device=dev)
    c0 = (col // tile) * tile
    last = row_len - 1

    def member(wb, c):
        return wb[:, :, c.clamp(max=last), 0]               # [J, rows, len]

    ay = _tile_base(member(wb_y, c0), member(wb_y, c0 + tile // 2),
                    member(wb_y, c0 + tile - 1), center_y, hp - wy_total, ~7)
    ax = _tile_base(member(wb_x, c0), member(wb_x, c0 + tile // 2),
                    member(wb_x, c0 + tile - 1), center_x, wp - wx_total,
                    ~127)
    rel_y = wb_y - ay[..., None]
    rel_x = wb_x - ax[..., None]
    valid = ((rel_y >= 0) & (rel_y + wy <= wy_total) & (rel_x >= 0)
             & ((rel_x & ~127) + cxs <= wx_total)).reshape(nj, nblk, kk)
    src = src_blocks.to(I32)[:, :, None]                    # [J, nblk, 1, ..]
    cols = []
    for dx, dy in offsets:
        ref = _gather_blocks_plain(stack, cand_y + dy, cand_x + dx, bs_y,
                                   bs_x, logp)
        cols.append(_block_costs(ref, src, stats3))
    out = torch.stack(cols, dim=3)
    valid = valid.reshape(valid.shape + (1,) * (out.ndim - 3))
    return torch.where(valid, out, INVALID_SAD).to(I32)


def _probe_lib(stats3: bool):
    lib = cuda_build.load("probe")
    fn = lib.mvt_probe_sads_tiled_stats3 if stats3 else lib.mvt_probe_sads_tiled
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def probe_sads_tiled(stack, cand_y, cand_x, src_blocks, offsets,
                     bs_y: int, bs_x: int, pel: int, row_len: int,
                     pitch_x: int, tile: int = 0, margin_y: int = 20,
                     margin_x: int = 64, stats: str = "sad") -> torch.Tensor:
    """[J, nblk, K, D] int32 SADs over a [nrows, row_len] block grid; with
    stats="sad_satd_luma" [J, nblk, K, D, 3] triples (SAD, SATD, sum of the
    reference block), an off-tile candidate reporting INVALID_SAD in all
    three.

    stack: [J, pel^2, Hp, Wp] uint8 pad_stack output; cand_y/cand_x:
    [J, nblk, K] int32 candidate pel positions (see module doc);
    src_blocks: [J, nblk, bs_y, bs_x] uint8; offsets: static [(dx, dy), ...]
    pel offsets evaluated per candidate.  Block rows are treated as
    edge-padded to a multiple of `tile` (the kernel clamps member indices
    instead of materialising the padding).  A plane smaller than the tile
    window is served by probe_sads: every candidate is then valid."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    nj, nblk, kk = cand_y.shape
    if tile <= 0:
        tile = 8 if kk <= 2 else 4
    wy_total, wx_total, center_y, center_x = tile_params(
        offsets, bs_y, bs_x, pel, tile, pitch_x,
        margin_y=margin_y, margin_x=margin_x)
    if (stack.shape[-2] < wy_total or stack.shape[-1] < wx_total
            or nblk % row_len != 0):
        return probe_sads(stack, cand_y, cand_x, src_blocks, offsets, bs_y,
                          bs_x, pel, stats)
    stats3 = _check_stats("probe_sads_tiled", stats, stack)
    _check_probe_args("probe_sads_tiled", stack, cand_y, cand_x, src_blocks,
                      bs_y, bs_x, pel, stats3)
    if not stack.is_cuda:
        return probe_sads_tiled_plain(
            stack, cand_y, cand_x, src_blocks, offsets, bs_y, bs_x, pel,
            row_len, tile, wy_total, wx_total, center_y, center_x, stats)

    dev = stack.device
    min_dx, min_dy, wy, _, _, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    offs = _offsets_tensor(offsets, dev)
    name = "probe_sads_tiled[stats3]" if stats3 else "probe_sads_tiled"
    out = torch.empty((nj, nblk, kk, len(offsets)) + ((3,) if stats3 else ()),
                      dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _probe_lib(stats3)(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            src_blocks.data_ptr(), offs.data_ptr(), out.data_ptr(),
            nj, pel * pel, stack.shape[2], stack.shape[3], nblk, row_len,
            kk, len(offsets), tile, bs_y, bs_x, pel.bit_length() - 1,
            min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, name)
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# K3: block fetch


def fetch_blocks_tiled_plain(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                             pel: int) -> torch.Tensor:
    """Plain PyTorch version of the block fetch (same contract as the
    kernel)."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
    return _gather_blocks_plain(stack, cand_y, cand_x, bs_y, bs_x,
                                pel.bit_length() - 1)


def _fetch_lib():
    lib = cuda_build.load("fetch")
    fn = lib.mvt_fetch_blocks
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fetch_blocks_tiled(stack, cand_y, cand_x, bs_y: int, bs_x: int,
                       pel: int) -> torch.Tensor:
    """[J, nblk, K, bs_y, bs_x] int32 reference blocks.

    stack: [J, pel^2, Hp, Wp] uint8; cand_y/cand_x: [J, nblk, K] int32 pel
    positions of the block origin in the stack.  Exact for every block;
    rows/columns outside the plane read its edge pixels."""
    if not stack.is_cuda:
        return fetch_blocks_tiled_plain(stack, cand_y, cand_x, bs_y, bs_x,
                                        pel)
    dev = stack.device
    _check(stack, "stack", torch.uint8, 4)
    _check(cand_y, "cand_y", I32, 3, dev)
    _check(cand_x, "cand_x", I32, 3, dev)
    nj, nblk, kk = cand_y.shape
    if (cand_x.shape != cand_y.shape or stack.shape[0] != nj
            or stack.shape[1] != pel * pel):
        raise ValueError("fetch_blocks_tiled: inconsistent shapes")
    out = torch.empty((nj, nblk, kk, bs_y, bs_x), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _fetch_lib()(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            out.data_ptr(), nj, pel * pel, stack.shape[2], stack.shape[3],
            nblk, kk, bs_y, bs_x, pel.bit_length() - 1,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "fetch_blocks_tiled")
    launches["fetch_blocks_tiled"] += 1
    return out
