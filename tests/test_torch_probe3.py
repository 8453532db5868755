"""PyTorch port: the three-stat tiled probe's kernel (K2', csrc/probe.cu::
probe_stats3_kernel) emulated on the CPU, word for word, against the plain
version (its launch geometry: test_torch_stats_kernels.py).

The kernel cannot run here: this rehearses its work split (one warp per
(job, block, candidate), the validity rule once, `active` flags by ballot,
32 / G offsets at a time, a lane's 4x4 tiles) and its arithmetic (the SAD
and reference sum by byte-SIMD words, the SATD from the biased 16-bit
transforms of source and reference tiles and the minima of coefficient
pairs), so that a fault shows on the CPU before the card.  Tolerance 0
(integers)."""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.core.config import _VALID_BLOCK_SIZES
from mvtools_tpu_torch.ops import probe as probe_ops, sad as sad_ops

from test_torch_sadmap3 import ZB, _min_sum, _tile_words  # noqa: E402

INT_MAX = probe_ops.INVALID_SAD
SATD_SIZES = sorted((bw, bh) for bw, bh in _VALID_BLOCK_SIZES
                    if sad_ops.satd_supported(bw, bh))
HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))


def _words_at(flat, addr):
    """ref_word / the source loads: the little-endian word of the four
    bytes at each byte address."""
    b = [flat[addr + i].astype(np.int64) for i in range(4)]
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def _valid(cand_y, cand_x, p):
    """candidate_valid for every (job, block, candidate)."""
    nj, nblk, kk = cand_y.shape
    blk = np.arange(nblk)
    row, col = blk // p["row_len"], blk % p["row_len"]
    c0 = (col // p["tile"]) * p["tile"]
    last = p["row_len"] - 1
    base = row * p["row_len"]

    def axis(cand, min_d, center, lo_max, mask):
        wb = (cand + min_d) >> p["logp"]
        m = [wb[:, base + np.minimum(c, last), 0]
             for c in (c0, c0 + p["tile"] // 2, c0 + p["tile"] - 1)]
        med = np.maximum(np.minimum(m[0], m[1]),
                         np.minimum(np.maximum(m[0], m[1]), m[2]))
        a = np.clip(med - center, 0, lo_max) & mask
        return wb - a[..., None]

    rel_y = axis(cand_y, p["min_dy"], p["center_y"], p["hp"] - p["wy_total"],
                 ~7)
    rel_x = axis(cand_x, p["min_dx"], p["center_x"], p["wp"] - p["wx_total"],
                 ~127)
    return ((rel_y >= 0) & (rel_y + p["wy"] <= p["wy_total"]) & (rel_x >= 0)
            & ((rel_x & ~127) + p["cxs"] <= p["wx_total"]))


def _emulate_probe3(stack, cand_y, cand_x, src, offsets, bs_y, bs_x, pel,
                    row_len, tile, active):
    """probe_stats3_kernel on numpy arrays: warps, slots, lanes' tiles and
    word arithmetic; returns [J, nblk, K, D, 3] int64."""
    d_n = len(offsets)
    geom = probe_ops.probe3_launch_geom(bs_y, bs_x, d_n)
    gl, tpl, cpw = geom["g"], geom["tpl"], geom["cpw"]
    nj, n_sub, hp, wp = stack.shape
    _, nblk, kk = cand_y.shape
    logp = pel.bit_length() - 1
    min_dx, min_dy, wy, _, _, cxs = probe_ops._tile_geom(offsets, bs_y, bs_x,
                                                        pel)
    wy_total, wx_total, center_y, center_x = probe_ops.tile_params(
        offsets, bs_y, bs_x, pel, tile, bs_x)
    p = dict(row_len=row_len, tile=tile, logp=logp, min_dy=min_dy,
             min_dx=min_dx, center_y=center_y, center_x=center_x, hp=hp,
             wp=wp, wy_total=wy_total, wx_total=wx_total, wy=wy, cxs=cxs)
    valid = _valid(cand_y, cand_x, p)
    ntx, n_tiles = bs_x // 4, (bs_y // 4) * (bs_x // 4)
    # the lane of each tile, and the tiles of each lane
    if tpl:
        assert gl * tpl == n_tiles
        lane_of = np.array([t % gl for t in range(n_tiles)])
    else:
        assert gl == 32
        lane_of = np.arange(n_tiles) % 32
    counts = np.bincount(lane_of, minlength=gl)
    assert (counts == tpl).all() if tpl else counts.max() - counts.min() <= 1
    n_slots = 32 // gl
    spc = n_slots // cpw                  # offset slots a candidate
    assert spc >= 1 and (cpw == 1 or cpw * d_n <= n_slots)
    out = np.full((nj, nblk, kk, d_n, 3), INT_MAX, np.int64)
    flat = stack.reshape(-1)
    src_flat = src.reshape(-1)
    seen = np.zeros((nj, nblk, kk, d_n), np.int64)
    t = np.arange(n_tiles)
    ty, tx = t // ntx, t % ntx
    n_cand = nj * nblk * kk
    act_all = (np.ones((n_cand, d_n), bool) if active is None
               else active.reshape(n_cand, d_n))
    for w0 in range(0, n_cand, cpw):          # a warp
        for d0 in range(0, d_n, spc):         # a round of its slots
            for slot in range(n_slots):
                cl, so = slot // spc, slot % spc
                w, d = w0 + cl, d0 + so
                if w >= n_cand or d >= d_n:
                    continue
                job, rest = divmod(w, nblk * kk)
                blk, k = divmod(rest, kk)
                if not (act_all[w, d] and valid[job, blk, k]):
                    continue                  # INT_MAX in all three
                seen[job, blk, k, d] += 1
                cy, cx = cand_y[job, blk, k], cand_x[job, blk, k]
                sbase = ((job * nblk + blk) * bs_y * bs_x
                         + 4 * (ty * bs_x + tx))
                sw = [_words_at(src_flat, sbase + y * bs_x) for y in range(4)]
                hs = _tile_words(sw)                          # [tiles, 8]
                sconst = 8 * (sw[0] & 255) + 16 * ZB
                dx, dy = offsets[d]
                px, py = cx + dx, cy + dy
                sub = (px & (pel - 1)) | ((py & (pel - 1)) << logp)
                rbase = (((job * n_sub + sub) * hp + (py >> logp)) * wp
                         + (px >> logp) + 4 * (ty * wp + tx))
                rw = [_words_at(flat, rbase + y * wp) for y in range(4)]
                sb = [np.stack([(x >> (8 * i)) & 255 for i in range(4)], -1)
                      for x in sw]
                rb = [np.stack([(x >> (8 * i)) & 255 for i in range(4)], -1)
                      for x in rw]
                sad = sum(np.abs(a - b).sum(-1) for a, b in zip(rb, sb))
                luma = sum(b.sum(-1) for b in rb)
                sat = (sconst + 8 * (rw[0] & 255)
                       - _min_sum(hs, _tile_words(rw)))
                # each lane's sums, then the slot's
                lanes = np.zeros((gl, 3), np.int64)
                np.add.at(lanes, lane_of, np.stack([sad, sat, luma], -1))
                out[job, blk, k, d] = lanes.sum(0)
    live = valid[..., None] & (np.ones((nj, nblk, kk, d_n), bool)
                               if active is None else active)
    assert (seen == live).all()
    return out


def _probe_case(bw, bh, pel, offsets, kk, masked, seed):
    """Stack, candidates round a smooth field with a twentieth thrown off
    their tile, source blocks and (masked) an `active` mask; the plain
    version's output and the emulation's."""
    rng = np.random.default_rng(seed)
    tile = 8 if kk <= 2 else 4
    row_len, nrows, nj = 3, 2, 2
    wy_total, wx_total, _, _ = probe_ops.tile_params(offsets, bh, bw, pel,
                                                     tile, bw)
    hp, wp = wy_total + 24, wx_total + 40
    stack = rng.integers(0, 256, (nj, pel * pel, hp, wp), np.uint8)
    src = rng.integers(0, 256, (nj, nrows * row_len, bh, bw), np.uint8)
    blk = np.arange(nrows * row_len)
    base_y = ((20 + (blk // row_len) * bh) << (pel - 1))
    base_x = ((70 + (blk % row_len) * bw) << (pel - 1))
    vy = rng.integers(-6, 7, (nj, blk.size, kk))
    vx = rng.integers(-6, 7, (nj, blk.size, kk))
    far = rng.random((nj, blk.size, kk)) < 0.05
    far[0, 1, kk - 1] = True         # block 1 is no tile member
    vx = np.where(far, vx + 150 * pel, vx)
    vy = np.where(far, vy - 30 * pel, vy)
    cy = (base_y[None, :, None] + vy).astype(np.int32)
    cx = (base_x[None, :, None] + vx).astype(np.int32)
    active = None
    if masked:
        active = rng.random((nj, blk.size, kk, len(offsets))) < 0.6
        active &= rng.random((nj, blk.size, kk, 1)) < 0.6   # dead warps
    want = probe_ops.probe_sads_tiled_plain(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bh, bw, pel, row_len, tile,
        *probe_ops.tile_params(offsets, bh, bw, pel, tile, bw),
        "sad_satd_luma",
        None if active is None else torch.from_numpy(active)).numpy()
    got = _emulate_probe3(stack, cy, cx, src, offsets, bh, bw, pel, row_len,
                          tile, active)
    return got, want


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_probe3_kernel_emulation_matches_plain(masked):
    """For every block size the SATD admits (4x4 to 128x128: one lane a
    tile, two or four a lane, and the generic body), the emulated kernel
    == probe_sads_tiled_plain(stats="sad_satd_luma"), with candidates off
    their tile and, masked, with inactive entries and whole dead warps;
    at pel 1 and 2, with one candidate and with six."""
    for i, (bw, bh) in enumerate(SATD_SIZES):
        pel, kk = (1, 6) if i % 2 else (2, 1)
        got, want = _probe_case(bw, bh, pel, HEXAGON, kk, masked, 80 + i)
        np.testing.assert_array_equal(got, want, err_msg=f"{bw}x{bh}")
        assert (want[..., 0] == INT_MAX).any(), f"{bw}x{bh}"
        assert (want[..., 0] != INT_MAX).any(), f"{bw}x{bh}"


@pytest.mark.parametrize("bw,bh,n_off,pel", [
    (16, 16, 1, 2),     # Recalculate's one offset: two candidates a warp
    (4, 4, 1, 1),       # one lane a block: 32 candidates a warp
    (8, 8, 3, 2),       # three offsets: two candidates a warp
    (8, 8, 49, 2),      # more than 32 offsets (read a round at a time)
    (16, 16, 49, 1),
])
def test_probe3_kernel_emulation_with_other_offset_counts(bw, bh, n_off,
                                                          pel):
    """Offset counts that pack several candidates into a warp, and more
    than 32 offsets, whose flags are read one by one; masked."""
    grid = tuple((dx, dy) for dy in range(-3, 4) for dx in range(-3, 4))
    offsets = ((0, 0),) if n_off == 1 else HEXAGON[:3] if n_off == 3 \
        else grid
    got, want = _probe_case(bw, bh, pel, offsets, 1, True, 90 + bw + n_off)
    np.testing.assert_array_equal(got, want, err_msg=f"{bw}x{bh}")
    assert (want[..., 0] != INT_MAX).any()
