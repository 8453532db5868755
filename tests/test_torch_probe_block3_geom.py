"""PyTorch port: the launch geometry of the three-stat per-block probe
(kernel K4', csrc/probe_block.cu::probe_block_stats3_kernel<TILE4>) and a
word-for-word emulation of the kernel on the CPU.

ops/probe.py::probe_block3_launch_geom is walked over every block size with
a SATD among the luma blocks Analyse accepts and their chroma blocks: the
lanes of an entry and their 8x4 partitions must cover each (offset, pixel)
of an item exactly once, and the CTAs must fit the card.  The emulation
follows the kernel lane by lane: its index arithmetic, the window shift,
the source loads, the aligned 32-bit reference loads and funnel shifts, the
4x4 Hadamard on biased 16-bit halves of 32-bit words (byte permutes, adds
modulo 2^32), the min.u16x2 / IDP.2A sum of the SATD, the VABSDIFF4 / IDP.4A
sums of the SAD and the reference sum, the sum over an entry's lanes and
the `active` mask (INVALID_SAD in all three stats of a dead entry).  It is
held to probe_sads_plain (tolerance 0).  Inputs come from numpy with a
seed."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.ops import sad as sad_ops

from test_torch_probe_block_geom import (GRID16, H100_SMS, HEXAGON, _inputs,
                                         _load32, block_sizes)

STATS3 = "sad_satd_luma"
M32 = (1 << 32) - 1
ZB = 16384
ZP = ZB | (ZB << 16)


def satd_block_sizes():
    return [(y, x) for y, x in block_sizes() if sad_ops.satd_supported(x, y)]


def test_launch_geom3_covers_every_partition_once():
    """For every block size with a SATD, D in {1, 6, 8, 16} and K in {1, 6}:
    the lanes of the launch, entry by entry and partition by partition,
    touch each (item, offset, pixel) exactly once, and an entry's lanes are
    a power-of-two group inside one warp."""
    sizes = satd_block_sizes()
    assert (4, 4) in sizes and (16, 16) in sizes and (128, 128) in sizes
    for (bs_y, bs_x), d, kk in itertools.product(sizes, (1, 6, 8, 16),
                                                 (1, 6)):
        n = kk * d
        g = probe_ops.probe_block3_launch_geom(bs_y, bs_x, n, H100_SMS)
        lanes = 1 << g["lg"]
        assert g["g"] == lanes and 32 % lanes == 0
        assert g["tile4"] == (bs_x == 4)
        t = np.arange(n * lanes)
        e, gl = t >> g["lg"], t & (lanes - 1)
        hits = []
        for i in range(g["parts"]):
            q = gl + (i << g["lg"])
            if g["tile4"]:
                row, col, pw = 0, 0, 4
            else:
                row = (q >> g["lpx"]) * 4
                col = (q & ((1 << g["lpx"]) - 1)) * 8
                pw = 8
            for y in range(4):
                for c in range(pw):
                    hits.append((e * bs_y + row + y) * bs_x + col + c)
        count = np.bincount(np.concatenate(hits), minlength=n * bs_y * bs_x)
        assert count.size == n * bs_y * bs_x
        assert (count == 1).all(), (bs_y, bs_x, d, kk)


def test_launch_geom3_fits_the_card():
    """CTAs of 32-256 lanes, whole warps, the largest that still gives
    each SM a CTA, enough of them for every lane, 32-bit lane indices; a
    block without a SATD raises."""
    for bs_y, bs_x in satd_block_sizes():
        for n in (1, 6, 8 * 6 * 6, 8 * 6 * 8, 12 * 98 * 16, 84 * 480 * 9):
            g = probe_ops.probe_block3_launch_geom(bs_y, bs_x, n, H100_SMS)
            lanes = n * g["g"]
            assert g["threads"] in probe_ops.PROBE_BLOCK_THREADS
            assert g["ctas"] * g["threads"] >= lanes
            assert (g["ctas"] - 1) * g["threads"] < lanes
            assert lanes < 2 ** 31
            if g["threads"] > 32:
                assert g["ctas"] >= H100_SMS
            if g["threads"] < 256:
                assert -(-lanes // (2 * g["threads"])) < H100_SMS
    with pytest.raises(ValueError, match="SATD"):
        probe_ops.probe_block3_launch_geom(2, 16, 10, H100_SMS)


# ---------------------------------------------------------------------------
# The kernel's word arithmetic (csrc/satd.cuh), on uint64 arrays of 32-bit
# words


def _byte(w, k):
    return (w >> np.uint64(8 * k)) & np.uint64(255)


def _perm(a, b, sel):
    """__byte_perm(a, b, sel): byte i of the result is byte (sel >> 4i) & 7
    of the 8-byte value b:a."""
    out = np.zeros_like(a)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        src = a if k < 4 else b
        out |= _byte(src, k & 3) << np.uint64(8 * i)
    return out


def _add(*terms):
    acc = np.zeros_like(terms[0])
    for t in terms:
        acc = (acc + t) & np.uint64(M32)
    return acc


def _neg(a):
    return (np.uint64(1 << 32) - a) & np.uint64(M32)


ZPU = np.uint64(ZP)


def _row_pass(w):
    zero = np.zeros_like(w)
    e = _perm(w, zero, 0x4240)
    f = _perm(w, zero, 0x4341)
    g = _add(e, f, ZPU)
    k = _add(e, _neg(f), ZPU)
    pp = _perm(g, k, 0x5410)
    qq = _perm(g, k, 0x7632)
    return _add(pp, qq, _neg(ZPU)), _add(pp, _neg(qq), ZPU)


def _col_pass(a, b, c, e):
    s0, s1 = _add(a, b, _neg(ZPU)), _add(a, _neg(b), ZPU)
    s2, s3 = _add(c, e, _neg(ZPU)), _add(c, _neg(e), ZPU)
    return (_add(s0, s2, _neg(ZPU)), _add(s1, s3, _neg(ZPU)),
            _add(s0, _neg(s2), ZPU), _add(s1, _neg(s3), ZPU))


def _hadamard(w):
    """tile_hadamard: the 8 biased words of a 4x4 tile's transform."""
    rows = [_row_pass(x) for x in w]
    a = list(_col_pass(*[r[0] for r in rows]))
    b = list(_col_pass(*[r[1] for r in rows]))
    return a + b


def _half(w, hi):
    return ((w >> np.uint64(16 if hi else 0)) & np.uint64(0xffff)).astype(
        np.int64)


def _tile3(s, r, sad, sat, luma):
    """tile3: one tile's SAD, reference sum and SATD half added in."""
    for y in range(4):
        for k in range(4):
            sb, rb = _byte(s[y], k).astype(np.int64), \
                _byte(r[y], k).astype(np.int64)
            sad = (sad + np.abs(rb - sb)) & M32
            luma = (luma + rb) & M32
    sat = sat + 8 * _byte(r[0], 0).astype(np.int64)
    hs, hr = _hadamard(s), _hadamard(r)
    for k in range(8):
        for hi in (False, True):
            m = np.minimum(_half(hs[k], hi), _half(hr[k], hi))
            m = np.where(m >= 1 << 15, m - (1 << 16), m)   # signed halves
            sat = sat - m
    sat = sat + 8 * _byte(s[0], 0).astype(np.int64) + 16 * ZB
    return sad, sat, luma


def emulate_probe_block3(stack, cy, cx, src, offsets, bs_y, bs_x, pel,
                         active):
    """The kernel's [J, nblk, K, D, 3] output, lane by lane, on numpy
    arrays."""
    nj, n_sub, hp, wp = stack.shape
    _, nblk, kk = cy.shape
    d_n = len(offsets)
    n = nj * nblk * kk * d_n
    g = probe_ops.probe_block3_launch_geom(bs_y, bs_x, n, H100_SMS)
    lg, lanes = g["lg"], g["g"]
    logp = pel.bit_length() - 1
    min_dx, min_dy, wy, wx = probe_ops._window_geom(offsets, bs_y, bs_x, pel)
    sbuf = np.frombuffer(stack.tobytes(), np.uint8)
    sbuf = np.concatenate([sbuf, np.zeros(-sbuf.size % 4 + 4, np.uint8)])
    srcb = np.frombuffer(src.tobytes(), np.uint8)
    srcb = np.concatenate([srcb, np.zeros(16, np.uint8)])
    offs = np.asarray(offsets, np.int64)
    t = np.arange(g["ctas"] * g["threads"], dtype=np.int64)
    t = t[t < n * lanes]
    e, gl = t >> lg, t & (lanes - 1)
    w = e // d_n
    d = e - w * d_n
    live = (np.ones(e.shape, bool) if active is None
            else active.reshape(-1)[e])
    cyv = cy.reshape(-1)[w].astype(np.int64)
    cxv = cx.reshape(-1)[w].astype(np.int64)
    jb = w // kk
    job = jb // nblk
    wb_y, wb_x = (cyv + min_dy) >> logp, (cxv + min_dx) >> logp

    def window_start(start, size, length):
        return np.clip(np.where(start < 0, start + size, start), 0,
                       size - length)

    ax, ay = cxv + offs[d, 0], cyv + offs[d, 1]
    sub = (ax & (pel - 1)) | ((ay & (pel - 1)) << logp)
    oy = (ay >> logp) + window_start(wb_y, hp, wy) - wb_y
    ox = (ax >> logp) + window_start(wb_x, wp, wx) - wb_x
    r0 = ((job * n_sub + sub) * hp + oy) * wp + ox
    s0 = jb * bs_y * bs_x

    def ref_words(a, cw):
        """reference_words<cw, false>: cw + 1 aligned loads (each holding a
        byte of the part, none past the stack) and funnel shifts."""
        sh = ((a & 3) * 8).astype(np.uint64)
        addrs = [(a & ~3) + 4 * j for j in range(cw)]
        addrs.append((a + 4 * cw - 1) & ~3)
        for addr in addrs:
            assert ((addr <= a + 4 * cw - 1) & (addr + 3 >= a)).all()
        v = [_load32(sbuf, addr, stack.nbytes) for addr in addrs]
        return [((v[j + 1] << np.uint64(32) | v[j]) >> sh) & np.uint64(M32)
                for j in range(cw)]

    sad = np.zeros(t.shape, np.int64)
    sat = np.zeros(t.shape, np.int64)
    luma = np.zeros(t.shape, np.int64)
    for i in range(g["parts"]):
        q = gl + (i << lg)
        if g["tile4"]:
            s = [_load32(srcb, s0 + 4 * y, src.nbytes) for y in range(4)]
            r = [ref_words(r0 + y * wp, 1)[0] for y in range(4)]
            sad, sat, luma = _tile3(s, r, sad, sat, luma)
            continue
        row = (q >> g["lpx"]) * 4
        col = (q & ((1 << g["lpx"]) - 1)) * 8
        sa, sb, ra, rb = [], [], [], []
        for y in range(4):
            addr = s0 + (row + y) * bs_x + col
            assert (addr % 8 == 0).all()                # one 8-byte load
            sa.append(_load32(srcb, addr, src.nbytes))
            sb.append(_load32(srcb, addr + 4, src.nbytes))
            words = ref_words(r0 + (row + y) * wp + col, 2)
            ra.append(words[0])
            rb.append(words[1])
        sad, sat, luma = _tile3(sa, ra, sad, sat, luma)
        sad, sat, luma = _tile3(sb, rb, sad, sat, luma)
    out = np.zeros((n, 3), np.int64)
    for k, v in enumerate((sad, sat, luma)):
        np.add.at(out[:, k], e, np.where(live, v, 0))
    out = ((out & M32).astype(np.uint32)).view(np.int32).reshape(n, 3)
    entry_live = np.ones(n, bool) if active is None else active.reshape(-1)
    out = np.where(entry_live[:, None], out, np.int32(probe_ops.INVALID_SAD))
    return out.reshape(nj, nblk, kk, d_n, 3)


# (bs_y, bs_x, pel, K, offsets, live share): the 4x4 tile, one and two
# partitions, the SATD path's 16x16 (eight lanes an entry), 32x32 (a warp),
# 64x64 and 128x128 (several partitions a lane); all live, 30 %, 3 % and
# none
EMUL3_CASES = {
    "narrow": [(4, 4, 2, 2, HEXAGON, 0.3), (4, 8, 1, 1, GRID16, 1.0),
               (8, 8, 2, 6, ((0, 0),), 0.03), (4, 4, 1, 1, GRID16, 0.0)],
    "wide": [(16, 16, 2, 1, HEXAGON, 1.0), (16, 16, 2, 1, GRID16, 0.3),
             (32, 32, 1, 6, ((0, 0),), 0.03), (16, 32, 2, 1, HEXAGON, 0.0),
             (64, 64, 1, 1, ((0, 0), (1, -1)), 1.0),
             (128, 128, 2, 1, ((0, 0),), 0.5)],
}


@pytest.mark.parametrize("cases", EMUL3_CASES.values(),
                         ids=EMUL3_CASES.keys())
def test_emulated_kernel3_matches_plain(cases):
    for n, (bs_y, bs_x, pel, kk, offsets, share) in enumerate(cases):
        stack, cy, cx, src, active = _inputs(90 + n + bs_x, 8, bs_y, bs_x,
                                             pel, kk, offsets, share)
        if n == 0:       # 0 against 255: the largest coefficients
            src[0] = 0
            stack[0] = 255
        got = emulate_probe_block3(stack, cy, cx, src, offsets, bs_y, bs_x,
                                   pel, active)
        want = probe_ops.probe_sads_plain(
            torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs_y, bs_x,
            pel, STATS3, active=torch.from_numpy(active)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(cases[n][:5]))
        dead = got == probe_ops.INVALID_SAD
        assert (dead.all(-1) == ~active).all()
        assert int(dead.sum()) == 3 * int((~active).sum())
