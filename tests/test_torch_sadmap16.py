"""PyTorch port: the uint16 SAD map's kernel (K1 u16, csrc/sadmap.cu::
sadmap16_kernel) emulated on the CPU, word for word, against the plain
version on 10- and 16-bit data.

The kernel cannot run here: this rehearses its arithmetic (the SAD as the
source sum plus the reference sum less twice the sum of minima, one
min.u16x2 and one IDP.2A a word; the reference sums from block-high column
sums slid along a grid row) and its indexing (a subplane's staged window,
the items of a subplane, the words, rows and column sums each item reads),
so that a fault shows on the CPU before the card.  Tolerance 0
(integers)."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.ops import probe as probe_ops, sadmap

M32 = 0xFFFFFFFF


def _pairs(rows, x, w):
    """pixel_pair: the words of pixels (x, x + 1) of uint16 plane rows
    [..., w], the columns x [..., n] clamped into [0, w)."""
    shape = np.broadcast_shapes(rows.shape[:-1], x.shape[:-1])
    rows = np.broadcast_to(rows, shape + rows.shape[-1:]).astype(np.int64)
    x = np.broadcast_to(x, shape + x.shape[-1:])
    lo = np.take_along_axis(rows, np.clip(x, 0, w - 1), -1)
    hi = np.take_along_axis(rows, np.clip(x + 1, 0, w - 1), -1)
    return lo | (hi << 16)


def _half_sum(w):
    """IDP.2A with bytes (1, 1): the sum of a word's two halves."""
    return (w & 0xFFFF) + (w >> 16)


def _min16(a, b):
    """min.u16x2."""
    return np.minimum(a & 0xFFFF, b & 0xFFFF) | (np.minimum(a >> 16, b >> 16)
                                                 << 16)


def _parity(r, q, pel):
    first = -r + ((q + r) & (pel - 1))
    return first, max(0, ((r - first) >> (pel.bit_length() - 1)) + 1)


def _emulate_map16(stack, src, afy, afx, r_y, r_x, bs_y, bs_x, pel, tile,
                   pitch_x, pitch_y, nbx, nby, src_y0, src_x0, n_part=1):
    """sadmap16_kernel on numpy arrays: the same CTAs (n_part a tile),
    staging, sums, items and word arithmetic; returns the map and the
    largest staged word, row and column-sum index any item read."""
    g = sadmap.map16_launch_geom(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x,
                                 n_part)
    nj, n_sub, hp, wp = stack.shape
    hs_, ws_ = src.shape[1:]
    logp = pel.bit_length() - 1
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    wy, wx, ny, nox, nws = g["wy"], g["wx"], g["ny"], g["nox"], g["nws"]
    rpw, wpr = g["ref_pitch"] // 4, bs_x // 2
    ntx = -(-nbx // tile)
    dxn, dn = 2 * r_x + 1, (2 * r_y + 1) * (2 * r_x + 1)
    out = np.full((nj, nby * nbx, dn), -1, np.int64)
    written = np.zeros((nj, nby * nbx, dn), np.int64)
    reach = dict(word=0, row=0, box=0)
    for job, row, tc, part in itertools.product(range(nj), range(nby),
                                                range(ntx),
                                                range(g["n_part"])):
        b0 = tc * tile + part * g["nbc"]
        nb = min(g["nbc"], tile - part * g["nbc"], nbx - b0)
        if nb <= 0:
            continue
        # each block's source words [nb, bs_y, wpr] and their sums
        sy = np.clip(src_y0 + row * pitch_y + np.arange(bs_y), 0, hs_ - 1)
        sw = _src_words(src[job], sy, src_x0 + (b0 + np.arange(nb))
                        * pitch_x, wpr, ws_)
        ss = _half_sum(sw).sum(axis=(1, 2))
        t = row * ntx + tc
        base_y = afy[job, t] + min_oy
        base_x = afx[job, t] + min_ox + part * g["nbc"] * pitch_x
        for s in range(n_sub):
            ry = np.clip(base_y + np.arange(wy), 0, hp - 1)
            win = _pairs(stack[job, s][ry], base_x + 2 * np.arange(rpw)[None],
                         wp)
            halves = np.stack([win & 0xFFFF, win >> 16], -1).reshape(wy, -1)
            # block-high column sums at every grid row (a thread a word
            # column: its two pixel columns, sliding down the rows)
            cs = np.zeros((ny, wx), np.int64)
            for cw in range(rpw):
                for x in (2 * cw, 2 * cw + 1):
                    if x >= wx:
                        continue
                    acc = halves[:bs_y, x].sum()
                    for oy in range(ny):
                        if oy:
                            acc += halves[oy + bs_y - 1, x] - halves[oy - 1, x]
                        cs[oy, x] = acc & M32
            px, py = s & (pel - 1), s >> logp
            dy0, rows_s = _parity(r_y, py, pel)
            dx0, cols_s = _parity(r_x, px, pel)
            for item in range(rows_s * nb * g["n_chunk"]):
                kr, rest = item % rows_s, item // rows_s
                b, chunk = rest % nb, rest // nb
                ncol = min(nox, cols_s - chunk * nox)
                if ncol <= 0:
                    continue
                dy = dy0 + (kr << logp)
                oy = (dy >> logp) - min_oy
                col0 = b * pitch_x + (dx0 >> logp) - min_ox + chunk * nox
                m = col0 & 1
                nrw = ((m + nox - 1 + 2 * (nws - 1)) >> 1) + 2
                acc = np.zeros(nox, np.int64)
                for y in range(bs_y):
                    reach["row"] = max(reach["row"], oy + y)
                    for wc in range(0, wpr, nws):
                        r = win[oy + y, (col0 >> 1) + wc:
                                (col0 >> 1) + wc + nrw]
                        reach["word"] = max(reach["word"],
                                            (col0 >> 1) + wc + nrw - 1)
                        for i, k in itertools.product(range(nox),
                                                      range(nws)):
                            o = m + i + 2 * k
                            v = (((r[o >> 1] >> 16) | (r[(o >> 1) + 1] << 16))
                                 & M32) if o & 1 else r[o >> 1]
                            acc[i] += _half_sum(_min16(v, sw[b, y, wc + k]))
                # sum S + sum R - 2 sum min, sum R sliding along the row
                box = ss[b] + cs[oy, col0:col0 + bs_x].sum()
                for c in range(ncol):
                    if c:
                        box += cs[oy, col0 + c - 1 + bs_x] - cs[oy, col0 + c - 1]
                    reach["box"] = max(reach["box"], col0 + c - 1 + bs_x)
                    dx = dx0 + ((chunk * nox + c) << logp)
                    e = (dy + r_y) * dxn + dx + r_x
                    blk = row * nbx + b0 + b
                    v = (box - 2 * acc[c]) & M32
                    out[job, blk, e] = v - (1 << 32) if v >> 31 else v
                    written[job, blk, e] += 1
    assert (written == 1).all()
    return out.reshape(nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1), reach, g


def _src_words(plane, sy, bx, wpr, ws):
    """[nb, bs_y, wpr] source words of blocks starting at columns bx."""
    rows = plane[sy]                                       # [bs_y, ws]
    x = bx[:, None] + 2 * np.arange(wpr)[None, :]          # [nb, wpr]
    return _pairs(rows[None, :, :], x[:, None, :], ws)


def _case(pel, r, bs_y, bs_x, pitch, nbx, tile, bits, extreme=False,
          seed=0, n_part=1):
    rng = np.random.default_rng(seed)
    nby, pad, hpad = 2, 12, 6
    ph = (nby - 1) * pitch + bs_y + 2 * hpad
    pw = (nbx - 1) * pitch + bs_x + 2 * hpad
    top = (1 << bits) - 1
    if extreme:
        ref = np.full((1, pel * pel, ph, pw), top, np.uint16)
        src = np.zeros((1, ph, pw), np.uint16)
    else:
        ref = rng.integers(0, top + 1, (1, pel * pel, ph, pw), np.uint16)
        src = rng.integers(0, top + 1, (1, ph, pw), np.uint16)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    hp, wp = stack.shape[-2:]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bs_y, bs_x, pel, tile, pitch, hp, wp)
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (1, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (1, nby * ntx)).astype(np.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    args = (r, r, bs_y, bs_x, pel, tile, pitch, pitch, nbx, nby, hpad, hpad)
    want = sadmap.sad_map_plain(stack, torch.from_numpy(src),
                                torch.from_numpy(afy), torch.from_numpy(afx),
                                *args).numpy()
    got, reach, g = _emulate_map16(stack.numpy(), src, afy, afx, *args,
                                   n_part=n_part)
    return got, want, reach, g


@pytest.mark.parametrize("pel,r,bs_y,bs_x,pitch,nbx,tile,bits,n_part", [
    (2, 8, 16, 16, 8, 5, 3, 16, 1),  # the YUV luma map, a ragged last tile
    (2, 5, 8, 8, 4, 7, 5, 10, 2),    # the YUV chroma map, 10-bit, split
    (1, 9, 4, 12, 5, 4, 3, 16, 3),   # odd pitch, two column chunks, split
    (2, 3, 2, 2, 1, 6, 6, 10, 1),    # 2x2 chroma blocks: one word a row
])
def test_map16_kernel_emulation_matches_plain(pel, r, bs_y, bs_x, pitch, nbx,
                                              tile, bits, n_part):
    """The emulated kernel == sad_map_plain on full-range data, with
    anchors at both clamp ends, whole tiles and tiles split over CTAs, and
    every item reads inside the staged words and rows and the column sums
    the geometry lays out."""
    got, want, reach, g = _case(pel, r, bs_y, bs_x, pitch, nbx, tile, bits,
                                seed=70 + bits + bs_x + pitch, n_part=n_part)
    assert g["n_part"] == n_part
    np.testing.assert_array_equal(got, want)
    assert reach["word"] < g["ref_pitch"] // 4
    assert reach["row"] < g["wy"] and reach["box"] < g["wx"]


@pytest.mark.parametrize("bits", [10, 16])
def test_map16_kernel_emulation_holds_the_largest_sums(bits):
    """Blocks of 0 against the maximum: every entry of a 16x16 map is
    16 * 16 * (2**bits - 1) (16 776 960 at 16 bits), and sum S + sum R (at
    most twice that) stays exact in 32 bits."""
    got, want, _, _ = _case(2, 4, 16, 16, 8, 4, 4, bits, extreme=True,
                            seed=3)
    np.testing.assert_array_equal(got, want)
    assert (got == 256 * ((1 << bits) - 1)).all()
