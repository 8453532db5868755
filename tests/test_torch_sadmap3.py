"""PyTorch port: the three-stat SAD map's kernel (K1', csrc/sadmap.cu::
sadmap3_kernel) emulated on the CPU, word for word, against the plain
version and the port's SATD (which the other test files hold to the JAX
package), and its launch geometry for every map shape the search admits.

The kernel cannot run here: these tests rehearse its arithmetic (the
Hadamard transforms of source and reference tiles in biased 16-bit halves,
the SATD from the minima of coefficient pairs, the box sums) and its
indexing (items, bands, staged rows and words), so that a fault shows on
the CPU before the card.  Tolerance 0 everywhere (integers).

Some of its checks live in test_torch_sadmap3_{emul,geom}.py, files of at
most six tests that pytest-xdist's loadfile scheduling hands out after the
suite's longest file."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.ops import probe as probe_ops, sad as sad_ops, sadmap

from test_torch_sadmap import _admitted_map_shapes  # noqa: E402

M32 = 0xFFFFFFFF
ZB = 16384
ZP = ZB | (ZB << 16)


# ---------------------------------------------------------------------------
# The kernel's word arithmetic (int64 numpy arrays holding uint32 words)

def _byte_perm(x, y, sel):
    b = [(x >> (8 * i)) & 255 for i in range(4)] + \
        [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _row_pass(w):
    e = _byte_perm(w, 0, 0x4240)
    f = _byte_perm(w, 0, 0x4341)
    g = (e + f + ZP) & M32
    k = (e - f + ZP) & M32
    pp = _byte_perm(g, k, 0x5410)
    qq = _byte_perm(g, k, 0x7632)
    return (pp + qq - ZP) & M32, (pp - qq + ZP) & M32


def _col_pass(a, b, c, e):
    s0, s1 = (a + b - ZP) & M32, (a - b + ZP) & M32
    s2, s3 = (c + e - ZP) & M32, (c - e + ZP) & M32
    return ((s0 + s2 - ZP) & M32, (s1 + s3 - ZP) & M32,
            (s0 - s2 + ZP) & M32, (s1 - s3 + ZP) & M32)


def _tile_words(rows):
    """8 words [..., 8] of the transform of 4x4 tiles whose rows are the
    words rows[0..3] (tile_words)."""
    ab = [_row_pass(w) for w in rows]
    a = _col_pass(*(x[0] for x in ab))
    b = _col_pass(*(x[1] for x in ab))
    return np.stack(a + b, axis=-1)


def _halves(w):
    return w & 0xFFFF, w >> 16


def _words(pix):
    """Little-endian words [..., 4 rows] of 4x4 uint8 tiles [..., 4, 4]."""
    p = pix.astype(np.int64)
    return [p[..., y, 0] | (p[..., y, 1] << 8) | (p[..., y, 2] << 16)
            | (p[..., y, 3] << 24) for y in range(4)]


def _min_sum(hs, hr):
    """sum over words of (min.lo + min.hi) of min.u16x2 (the IDP.2A sum)."""
    ls, hs_ = _halves(hs)
    lr, hr_ = _halves(hr)
    return (np.minimum(ls, lr) + np.minimum(hs_, hr_)).sum(-1)


def _satd_by_tables(s, r):
    """SATD of uint8 blocks [N, bs_y, bs_x] the way the kernel forms it."""
    n, bs_y, bs_x = s.shape
    total = np.zeros(n, np.int64)
    for ty in range(bs_y // 4):
        for pj in range(bs_x // 8):
            ys, xs = 4 * ty, 8 * pj
            m = 0
            for off in (0, 4):
                ws = _tile_words(_words(s[:, ys:ys + 4, xs + off:xs + off + 4]))
                wr = _tile_words(_words(r[:, ys:ys + 4, xs + off:xs + off + 4]))
                m = m + _min_sum(ws, wr)
            total += (8 * (s[:, ys, xs].astype(np.int64) + s[:, ys, xs + 4]
                           + r[:, ys, xs] + r[:, ys, xs + 4]) + 32 * ZB - m)
    return total


def _extreme_blocks(bs_y, bs_x):
    """All-0 against all-255, +-255 checkerboards and a bent pattern (every
    coefficient of S - R at +-1020), both ways."""
    yy, xx = np.mgrid[:bs_y, :bs_x]
    bent = np.where(((yy >> 1) & (xx >> 1) & 1) ^ (yy & xx & 1), 255,
                    0).astype(np.uint8)
    board = np.where((yy + xx) % 2 == 0, 255, 0).astype(np.uint8)
    rows = np.where(yy % 2 == 0, 255, 0).astype(np.uint8)
    full, zero = np.full((bs_y, bs_x), 255, np.uint8), np.zeros(
        (bs_y, bs_x), np.uint8)
    pairs = [(full, zero), (zero, full), (board, 255 - board),
             (255 - board, board), (rows, 255 - rows), (board, zero),
             (full, board), (bent, 255 - bent), (255 - bent, bent)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


@pytest.mark.parametrize("bs_y,bs_x", [(4, 8), (8, 8), (16, 16), (32, 32)])
def test_satd_from_transform_tables_matches_satd(bs_y, bs_x):
    """H(S - R) = H(S) - H(R): the kernel's SATD, from the biased 16-bit
    transforms of source and reference tiles and the minima of coefficient
    pairs, equals ops/sad.py::satd (and so the plain map's) on random and
    extreme blocks.  The extreme ones reach the bounds the packing rests
    on: a coefficient of S - R at +-4080 (16 * 255), and every biased
    coefficient of S or R inside [Z - 4080, Z + 4080], below 2**15 (the
    signed IDP.2A reads the minima as int16).  A partition's 16
    |coefficients| of one half stay under 65 280 (16 * 4080), the bound a
    packed accumulation would need: a tile's |coefficients| sum to at most
    4 * 4 * 255 * 4 = 16 320 (Parseval), reached by the bent pattern."""
    rng = np.random.default_rng(60 + bs_x)
    s = rng.integers(0, 256, (300, bs_y, bs_x), np.uint8)
    r = rng.integers(0, 256, (300, bs_y, bs_x), np.uint8)
    es, er = _extreme_blocks(bs_y, bs_x)
    s, r = np.concatenate([s, es]), np.concatenate([r, er])
    want = sad_ops.satd(torch.from_numpy(s), torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(_satd_by_tables(s, r), want)
    costs = probe_ops._block_costs(torch.from_numpy(r).to(torch.int32),
                                   torch.from_numpy(s).to(torch.int32), True)
    np.testing.assert_array_equal(costs[:, 1].numpy(), want)
    # the bounds, on the extreme blocks' first 8x4 partition
    ws = np.concatenate([_tile_words(_words(es[:, :4, o:o + 4]))
                         for o in (0, 4)], -1)
    wr = np.concatenate([_tile_words(_words(er[:, :4, o:o + 4]))
                         for o in (0, 4)], -1)
    for w in (ws, wr):
        for h in _halves(w):
            assert h.min() >= ZB - 4080 and h.max() <= ZB + 4080 < 2 ** 15
    d = [np.abs(a - b) for a, b in zip(_halves(ws), _halves(wr))]
    assert max(x.max() for x in d) == 4080
    assert max(x.sum(-1).max() for x in d) == 16320 <= 65280


def test_tile_transform_sums_to_sixteen_times_the_corner():
    """The biased coefficients of a tile sum to 16 * (top-left pixel) +
    16 Z, the identity the kernel's SATD uses for sum u_S and sum u_R."""
    rng = np.random.default_rng(61)
    t = rng.integers(0, 256, (500, 4, 4), np.uint8)
    w = _tile_words(_words(t))
    lo, hi = _halves(w)
    np.testing.assert_array_equal((lo + hi).sum(-1),
                                  16 * t[:, 0, 0].astype(np.int64) + 16 * ZB)


# ---------------------------------------------------------------------------
# The whole kernel, emulated

def _parity(r, q, pel):
    first = -r + ((q + r) & (pel - 1))
    return first, max(0, ((r - first) >> (pel.bit_length() - 1)) + 1)


def _emulate_map3(stack, src, afy, afx, r_y, r_x, bs_y, bs_x, pel, tile,
                  pitch_x, pitch_y, nbx, nby, src_y0, src_x0):
    """sadmap3_kernel on numpy arrays: the same staging, tables, bands,
    items and word arithmetic; returns the map and, per (job, tile), the
    largest staged reference word, H(R) position and box index any item
    read."""
    g = sadmap.map3_launch_geom(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x)
    nj, n_sub, hp, wp = stack.shape
    hs_, ws_ = src.shape[1:]
    logp = pel.bit_length() - 1
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    wy, wx, ny, nox = g["wy"], g["wx"], g["ny"], g["nox"]
    ntx = -(-nbx // tile)
    dxn, dn = 2 * r_x + 1, (2 * r_y + 1) * (2 * r_x + 1)
    out = np.full((nj, nby * nbx, dn, 3), -1, np.int64)
    written = np.zeros((nj, nby * nbx, dn), np.int64)
    reach = dict(word=0, pos=0, box=0)
    parts = bs_x // 8
    for job, row, tc in itertools.product(range(nj), range(nby), range(ntx)):
        b0 = tc * tile
        nb = min(tile, nbx - b0)
        sy = np.clip(src_y0 + row * pitch_y + np.arange(bs_y), 0, hs_ - 1)
        sx = np.clip(src_x0 + b0 * pitch_x + np.arange(g["span_pitch"]), 0,
                     ws_ - 1)
        span = src[job][sy[:, None], sx[None, :]].astype(np.int64)
        tiles = span[:, :4 * g["nxs"]].reshape(bs_y // 4, 4, g["nxs"], 4)
        hs = _tile_words(_words(tiles.transpose(0, 2, 1, 3)))  # [ty, X, 8]
        sc = [sum(8 * (span[4 * ty, b * pitch_x + 8 * pj]
                       + span[4 * ty, b * pitch_x + 8 * pj + 4]) + 32 * ZB
                  for ty in range(bs_y // 4) for pj in range(parts))
              for b in range(nb)]
        t_idx = row * ntx + tc
        base_y = afy[job, t_idx] + min_oy
        base_x = afx[job, t_idx] + min_ox
        for s in range(n_sub):
            ry = np.clip(base_y + np.arange(wy), 0, hp - 1)
            rx = np.clip(base_x + np.arange(g["ref_pitch"]), 0, wp - 1)
            ref = stack[job, s][ry[:, None], rx[None, :]].astype(np.int64)
            cs = np.stack([ref[oy:oy + bs_y, :wx].sum(0) for oy in range(ny)])
            box = np.stack([cs[:, x:x + bs_x].sum(1)
                            for x in range(g["nbox"])], 1)
            # H(R) of every 4x4 position (the kernel makes it band by band)
            rw = ref[:, :g["npos"] + 3]
            win = np.lib.stride_tricks.sliding_window_view(rw, (4, 4))
            hr = _tile_words(_words(win[:g["nyp"], :g["npos"]]))
            px, py = s & (pel - 1), s >> logp
            dy0, rows_s = _parity(r_y, py, pel)
            dx0, cols_s = _parity(r_x, px, pel)
            for item in range(nb * rows_s * g["n_chunk"]):
                kr, rest = item % rows_s, item // rows_s
                chunk, b = rest % g["n_chunk"], rest // g["n_chunk"]
                dy = dy0 + (kr << logp)
                oy = (dy >> logp) - min_oy
                ncol = min(nox, cols_s - chunk * nox)
                col0 = b * pitch_x + (dx0 >> logp) - min_ox + chunk * nox
                sad = np.zeros(nox, np.int64)
                sat = np.zeros(nox, np.int64)
                seen = []
                for band in range(g["n_band"]):
                    y0 = 4 * band
                    i = (y0 - oy + 3) >> 2
                    if i < 0 or i >= bs_y // 4 or oy + 4 * i >= y0 + 4:
                        continue
                    seen.append(i)
                    yb = oy + 4 * i
                    assert yb < g["nyp"]
                    for pj in range(parts):
                        w0 = (col0 >> 2) + 2 * pj
                        nrw = ((col0 & 3) + nox - 1 + 7) // 4 + 1
                        reach["word"] = max(reach["word"], w0 + nrw - 1)
                        for c in range(nox):
                            x = col0 + c + 8 * pj
                            rblk = ref[yb:yb + 4, x:x + 8]
                            sblk = span[4 * i:4 * i + 4,
                                        b * pitch_x + 8 * pj:
                                        b * pitch_x + 8 * pj + 8]
                            sad[c] += np.abs(rblk - sblk).sum()
                            sat[c] += 8 * (rblk[0, 0] + rblk[0, 4])
                            xc = min(x, g["npos"] - 5)
                            reach["pos"] = max(reach["pos"], xc + 4)
                            h_s = np.concatenate(
                                [hs[i, (b * pitch_x >> 2) + 2 * pj],
                                 hs[i, (b * pitch_x >> 2) + 2 * pj + 1]])
                            h_r = np.concatenate([hr[yb, xc], hr[yb, xc + 4]])
                            sat[c] -= _min_sum(h_s, h_r)
                assert seen == list(range(bs_y // 4))
                for c in range(ncol):
                    dx = dx0 + ((chunk * nox + c) << logp)
                    e = (dy + r_y) * dxn + dx + r_x
                    blk = row * nbx + b0 + b
                    reach["box"] = max(reach["box"], col0 + c)
                    out[job, blk, e] = (sad[c], sat[c] + sc[b],
                                        box[oy, col0 + c])
                    written[job, blk, e] += 1
    assert (written == 1).all()
    return out.reshape(nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1, 3), reach, g


def _admitted_stats3_shapes(family):
    """Every (r_y, r_x, bs_y, bs_x, pel, tile, pitch_x) of a three-stat map
    that MapProber builds at 8-bit: the luma maps of the SATD modes."""
    return [sh for sh in _admitted_map_shapes(family)
            if sh[6] % 8 == 0 and sh[3] % 8 == 0 and sh[2] % 4 == 0]


