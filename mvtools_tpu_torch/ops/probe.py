"""Candidate probes and reference-block fetches on a pel-subplane stack.

The reference's innermost loop is one SAD per candidate vector per block
(pobCheckMV_Template PlaneOfBlocks.cpp:219-261 over pobGetRefBlock's
pel-plane pointer math :34-54).  Two operations live here, each as a CUDA
kernel (csrc/probe.cu, csrc/fetch.cu) with a plain PyTorch version beside
it:

* probe_sads_tiled — [J, nblk, K, D] int32 SADs for K candidate centres per
  block times D static pel offsets, with the tile-extent validity rule:
  candidates whose window leaves their tile's shared window report
  INVALID_SAD and lose every cost comparison.
* fetch_blocks_tiled — [J, nblk, K, bs_y, bs_x] int32 reference blocks at pel
  positions, exact for every block.

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

launches = {"probe_sads_tiled": 0, "fetch_blocks_tiled": 0}
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


def _gather_blocks_plain(stack, pos_y, pos_x, bs_y: int, bs_x: int, logp: int):
    """int32 [..., bs_y, bs_x] patches of stack [J, n_sub, H, W] at pel
    positions pos_y/pos_x [J, ...]; rows/columns clamped into the plane."""
    nj, n_sub, hp, wp = stack.shape
    pelm = (1 << logp) - 1
    sub = (pos_x & pelm) | ((pos_y & pelm) << logp)
    dev = stack.device
    gy = ((pos_y >> logp)[..., None, None]
          + torch.arange(bs_y, device=dev)[:, None]).clamp(0, hp - 1)
    gx = ((pos_x >> logp)[..., None, None]
          + torch.arange(bs_x, device=dev)[None, :]).clamp(0, wp - 1)
    job = torch.arange(nj, device=dev).reshape((nj,) + (1,) * (gy.ndim - 1))
    flat = ((job * n_sub + sub[..., None, None]) * hp + gy) * wp + gx
    return stack.reshape(-1)[flat].to(I32)


# ---------------------------------------------------------------------------
# K2: tiled probe


def probe_sads_tiled_plain(stack, cand_y, cand_x, src_blocks, offsets,
                           bs_y: int, bs_x: int, pel: int, row_len: int,
                           tile: int, wy_total: int, wx_total: int,
                           center_y: int, center_x: int) -> torch.Tensor:
    """Plain PyTorch version of the tiled probe (same contract as the
    kernel): per-candidate SADs where the candidate window fits its tile's
    extent, INVALID_SAD elsewhere."""
    global plain_calls_on_cuda
    if stack.is_cuda:
        plain_calls_on_cuda += 1
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
        cols.append((ref - src).abs().sum(dim=(-2, -1)))
    out = torch.stack(cols, dim=-1)
    return torch.where(valid[..., None], out, INVALID_SAD).to(I32)


def _probe_lib():
    lib = cuda_build.load("probe")
    fn = lib.mvt_probe_sads_tiled
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def probe_sads_tiled(stack, cand_y, cand_x, src_blocks, offsets,
                     bs_y: int, bs_x: int, pel: int, row_len: int,
                     pitch_x: int, tile: int = 0, margin_y: int = 20,
                     margin_x: int = 64) -> torch.Tensor:
    """[J, nblk, K, D] int32 SADs over a [nrows, row_len] block grid.

    stack: [J, pel^2, Hp, Wp] uint8 pad_stack output; cand_y/cand_x:
    [J, nblk, K] int32 candidate pel positions (see module doc);
    src_blocks: [J, nblk, bs_y, bs_x] uint8; offsets: static [(dx, dy), ...]
    pel offsets evaluated per candidate.  Block rows are treated as
    edge-padded to a multiple of `tile` (the kernel clamps member indices
    instead of materialising the padding)."""
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    nj, nblk, kk = cand_y.shape
    if tile <= 0:
        tile = 8 if kk <= 2 else 4
    wy_total, wx_total, center_y, center_x = tile_params(
        offsets, bs_y, bs_x, pel, tile, pitch_x,
        margin_y=margin_y, margin_x=margin_x)
    if (stack.shape[-2] < wy_total or stack.shape[-1] < wx_total
            or nblk % row_len != 0):
        raise NotImplementedError(
            "probe_sads_tiled: the plane is too small for the tile window "
            f"({tuple(stack.shape[-2:])} < {(wy_total, wx_total)}); the "
            "per-block probe that serves such planes is not ported")
    if not stack.is_cuda:
        return probe_sads_tiled_plain(
            stack, cand_y, cand_x, src_blocks, offsets, bs_y, bs_x, pel,
            row_len, tile, wy_total, wx_total, center_y, center_x)

    dev = stack.device
    _check(stack, "stack", torch.uint8, 4)
    _check(cand_y, "cand_y", I32, 3, dev)
    _check(cand_x, "cand_x", I32, 3, dev)
    _check(src_blocks, "src_blocks", torch.uint8, 4, dev)
    if (cand_x.shape != cand_y.shape or stack.shape[0] != nj
            or stack.shape[1] != pel * pel
            or tuple(src_blocks.shape) != (nj, nblk, bs_y, bs_x)):
        raise ValueError("probe_sads_tiled: inconsistent shapes")
    min_dx, min_dy, wy, _, _, cxs = _tile_geom(offsets, bs_y, bs_x, pel)
    offs = _offsets_tensor(offsets, dev)
    out = torch.empty((nj, nblk, kk, len(offsets)), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = _probe_lib()(
            stack.data_ptr(), cand_y.data_ptr(), cand_x.data_ptr(),
            src_blocks.data_ptr(), offs.data_ptr(), out.data_ptr(),
            nj, pel * pel, stack.shape[2], stack.shape[3], nblk, row_len,
            kk, len(offsets), tile, bs_y, bs_x, pel.bit_length() - 1,
            min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "probe_sads_tiled")
    launches["probe_sads_tiled"] += 1
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
