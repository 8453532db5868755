"""PyTorch port: the launch geometry of the per-block probe (kernel K4,
csrc/probe_block.cu::probe_block_kernel<T, CW, HALF>) and a word-for-word
emulation of the kernel on the CPU.

ops/probe.py::probe_block_launch_geom is walked over every block size
Analyse accepts (core/config.py's _VALID_BLOCK_SIZES) and their chroma
blocks at 4:2:0, 4:2:2 and 4:4:4: the lanes of an entry and their parts must
cover each (offset, pixel) of an item exactly once, and the CTAs must fit the
card.  The emulation follows the kernel lane by lane: its index arithmetic,
the window shift, the source loads, the aligned 32-bit reference loads and
funnel shifts, the packed sums (VABSDIFF4 + IDP.4A for uint8; sum S + sum R
- 2 sum min(S, R), modulo 2^32, for uint16), the sum over an entry's lanes
and the `active` mask; every aligned load must hold a byte of its part and
start inside the stack.  It is held to probe_sads_plain (tolerance 0) at
each of the kernel's width classes.  Inputs come from numpy with a seed."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.core.config import _VALID_BLOCK_SIZES
from mvtools_tpu_torch.ops import probe as probe_ops

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
H100_SMS = 132


def block_sizes():
    """(bs_y, bs_x) of every luma block Analyse accepts and of its chroma
    at 4:2:0, 4:2:2 and 4:4:4."""
    sizes = set()
    for w, h in _VALID_BLOCK_SIZES:
        for logx, logy in ((1, 1), (1, 0), (0, 0)):
            sizes.add((h >> logy, w >> logx))
    return sorted(sizes)


def part_pixels(bs_x, u16, geom):
    """Pixels of one part: CW words (two pixels of a 2-wide uint8 row)."""
    return 2 if geom["half"] else geom["cw"] * (2 if u16 else 4)


def test_launch_geom_covers_every_offset_and_pixel_once():
    """For every block size at 8 and at 16 bits, D in {1, 6, 8, 9, 16} and
    K in {1, 6}: the lanes of the launch, entry by entry and part by part,
    touch each (item, offset, pixel) exactly once, and an entry's lanes are
    a power-of-two group inside one warp."""
    for (bs_y, bs_x), u16 in itertools.product(block_sizes(), (False, True)):
        for d in (1, 6, 8, 9, 16):
            for kk in (1, 6):
                n = kk * d                     # one block's items
                g = probe_ops.probe_block_launch_geom(bs_y, bs_x, n, u16,
                                                      H100_SMS)
                lanes = 1 << g["lg"]
                assert g["g"] == lanes and 32 % lanes == 0
                ppp = part_pixels(bs_x, u16, g)
                assert (bs_x // ppp) == 1 << g["lppr"]
                assert g["parts"] * lanes == bs_y * (bs_x // ppp)
                t = np.arange(n * lanes)
                e, gl = t >> g["lg"], t & (lanes - 1)
                hits = []
                for i in range(g["parts"]):
                    q = gl + (i << g["lg"])
                    row = q >> g["lppr"]
                    col = (q & ((1 << g["lppr"]) - 1)) * ppp
                    for c in range(ppp):
                        hits.append((e * bs_y + row) * bs_x + col + c)
                count = np.bincount(np.concatenate(hits),
                                    minlength=n * bs_y * bs_x)
                assert count.size == n * bs_y * bs_x
                assert (count == 1).all(), (bs_y, bs_x, d, kk)


def test_launch_geom_fits_the_card():
    """CTAs of 32-256 lanes (the kernel's launch bound), whole warps, the
    largest that still gives each SM a CTA, enough of them for every lane,
    and 32-bit lane indices, from a handful of entries to the most a coarse
    level gives."""
    for bs_y, bs_x in block_sizes():
        for u16 in (False, True):
            for n in (1, 6, 98 * 16, 12 * 98 * 16, 12 * 18 * 6, 84 * 480 * 9):
                g = probe_ops.probe_block_launch_geom(bs_y, bs_x, n, u16,
                                                      H100_SMS)
                lanes = n * g["g"]
                assert g["threads"] in probe_ops.PROBE_BLOCK_THREADS
                assert g["threads"] % 32 == 0 and g["threads"] <= 256
                assert g["ctas"] * g["threads"] >= lanes
                assert (g["ctas"] - 1) * g["threads"] < lanes
                assert lanes < 2 ** 31
                if g["threads"] > 32:
                    assert g["ctas"] >= H100_SMS
                if g["threads"] < 256:
                    assert -(-lanes // (2 * g["threads"])) < H100_SMS
    with pytest.raises(ValueError, match="wide"):
        probe_ops.probe_block_launch_geom(8, 6, 10, False, H100_SMS)
    with pytest.raises(ValueError, match="wide"):
        probe_ops.probe_block_launch_geom(8, 3, 10, True, H100_SMS)


def _load32(buf, addr, limit):
    """Little-endian 32-bit words of a byte buffer at aligned addresses,
    each of which must start before byte `limit` (the data's end; the
    buffer holds the allocation's rounding past it)."""
    assert (addr % 4 == 0).all()
    assert (addr >= 0).all() and (addr < limit).all()
    b = buf[addr[..., None] + np.arange(4)].astype(np.uint64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def emulate_probe_block(stack, cy, cx, src, offsets, bs_y, bs_x, pel,
                        active):
    """The kernel's output, lane by lane, on numpy arrays."""
    u16 = stack.dtype == np.uint16
    pb = 2 if u16 else 1
    nj, n_sub, hp, wp = stack.shape
    _, nblk, kk = cy.shape
    d_n = len(offsets)
    n = nj * nblk * kk * d_n
    g = probe_ops.probe_block_launch_geom(bs_y, bs_x, n, u16, H100_SMS)
    lg, lanes, cw, half = g["lg"], g["g"], g["cw"], g["half"]
    logp = pel.bit_length() - 1
    min_dx, min_dy, wy, wx = probe_ops._window_geom(offsets, bs_y, bs_x, pel)
    # the stack's bytes, the allocation rounded up to whole words
    sbuf = np.frombuffer(stack.astype(stack.dtype.newbyteorder("<"))
                         .tobytes(), np.uint8)
    sbuf = np.concatenate([sbuf, np.zeros(-sbuf.size % 4 + 4, np.uint8)])
    srcb = np.frombuffer(src.astype(src.dtype.newbyteorder("<")).tobytes(),
                         np.uint8)
    srcb = np.concatenate([srcb, np.zeros(16, np.uint8)])
    offs = np.asarray(offsets, np.int64)
    t = np.arange(g["ctas"] * g["threads"], dtype=np.int64)
    t = t[t < n * lanes]                       # lanes past the end return
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
    pelm = pel - 1
    sub = (ax & pelm) | ((ay & pelm) << logp)
    oy = (ay >> logp) + window_start(wb_y, hp, wy) - wb_y
    ox = (ax >> logp) + window_start(wb_x, wp, wx) - wb_x
    r0 = (((job * n_sub + sub) * hp + oy) * wp + ox) * pb   # bytes
    s0 = jb * bs_y * bs_x                                   # pixels
    ppp = 2 if half else cw * 4 // pb
    mask32 = np.uint64(0xffffffff)
    acc = np.zeros(t.shape, np.uint64)
    for i in range(g["parts"]):
        q = gl + (i << lg)
        row = q >> g["lppr"]
        col = (q & ((1 << g["lppr"]) - 1)) * ppp
        s_addr = (s0 + row * bs_x + col) * pb
        if half:
            sw = [srcb[s_addr].astype(np.uint64)
                  | srcb[s_addr + 1].astype(np.uint64) << 8]
        else:
            sw = [_load32(srcb, s_addr + 4 * j, src.nbytes)
                  for j in range(cw)]
        a = r0 + (row * wp + col) * pb
        sh = ((a & 3) * 8).astype(np.uint64)
        a4 = a & ~3
        addrs = [a4 + 4 * j for j in range(cw)]
        addrs.append((a + (1 if half else 4 * cw - 1)) & ~3)
        last = a + ppp * pb - 1                  # the part's last byte
        for addr in addrs:                       # each word holds a byte
            assert ((addr <= last) & (addr + 3 >= a)).all()
        v = [_load32(sbuf, addr, stack.nbytes) for addr in addrs]
        for j in range(cw):
            rj = ((v[j + 1] << 32 | v[j]) >> sh) & mask32    # funnel shift
            if half:
                rj &= np.uint64(0xffff)
            if u16:
                for k in (0, 16):
                    s_h = (sw[j] >> np.uint64(k)) & np.uint64(0xffff)
                    r_h = (rj >> np.uint64(k)) & np.uint64(0xffff)
                    acc = (acc + s_h + r_h - 2 * np.minimum(s_h, r_h)) \
                        & mask32
            else:
                for k in range(0, 32, 8):
                    s_b = ((sw[j] >> np.uint64(k)) & np.uint64(255)) \
                        .astype(np.int64)
                    r_b = ((rj >> np.uint64(k)) & np.uint64(255)) \
                        .astype(np.int64)
                    acc = (acc + np.abs(r_b - s_b).astype(np.uint64)) \
                        & mask32
    # the xor-shuffle sum over an entry's lanes, modulo 2^32
    acc = np.where(live, acc, 0)
    total = np.zeros(n, np.uint64)
    np.add.at(total, e, acc)
    total &= mask32
    out = total.astype(np.uint32).view(np.int32)
    entry_live = np.ones(n, bool) if active is None else active.reshape(-1)
    out = np.where(entry_live, out, np.int32(probe_ops.INVALID_SAD))
    return out.reshape(nj, nblk, kk, d_n)


def _inputs(seed, bits, bs_y, bs_x, pel, kk, offsets, live_share):
    """A small stack of `bits`-bit pixels (uint8 for 8), candidates round a
    block grid with some past the stack's bottom/right edges and before its
    top/left, source blocks, and an `active` mask."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if bits == 8 else np.uint16
    nj, nbx, nby = 2, 3, 2
    pad = 6
    hp = nby * bs_y + 2 * pad + 5
    wp = nbx * bs_x + 2 * pad + 7
    top = (1 << bits) - 1
    stack = rng.integers(0, top + 1, (nj, pel * pel, hp, wp)).astype(dtype)
    src = rng.integers(0, top + 1, (nj, nby * nbx, bs_y, bs_x)).astype(dtype)
    idx = np.arange(nby * nbx)
    base_y = (pad + bs_y * (idx // nbx)) * pel
    base_x = (pad + bs_x * (idx % nbx)) * pel
    spread = 6 * pel
    cy = base_y[None, :, None] + rng.integers(-spread, spread + 1,
                                              (nj, nby * nbx, kk))
    cx = base_x[None, :, None] + rng.integers(-spread, spread + 1,
                                              (nj, nby * nbx, kk))
    cy[0, -1, 0] = (hp - bs_y + 3) * pel + 1              # past the bottom
    cx[1, -1, -1] = (wp - bs_x + 4) * pel                 # past the right
    cy[1, 0, 0], cx[1, 0, 0] = -3 * pel, -5 * pel + 1     # before the stack
    active = rng.random((nj, nby * nbx, kk, len(offsets))) < live_share
    return (stack, cy.astype(np.int32), cx.astype(np.int32), src, active)


# (bits, bs_y, bs_x, pel, K, offsets, live share): every width class of the
# kernel: uint8 2 wide (half a word), 4 wide (one word), 8 wide (two-word
# parts, also one row: a lane an entry), 16 and 64 wide (four-word parts,
# several a lane); uint16 2, 4, 8, 16 and 128 wide
EMUL_CASES = {
    "u8-narrow": [(8, 2, 2, 2, 2, HEXAGON, 0.3), (8, 2, 4, 1, 1, GRID16, 1.0),
                  (8, 1, 8, 2, 6, ((0, 0),), 0.5),
                  (8, 8, 8, 2, 1, GRID16, 0.03)],
    "u8-wide": [(8, 16, 16, 2, 6, ((0, 0),), 1.0),
                (8, 16, 16, 1, 1, HEXAGON, 0.3),
                (8, 64, 64, 1, 1, ((0, 0), (1, -1)), 1.0)],
    "u16-narrow": [(10, 2, 2, 2, 1, HEXAGON, 1.0),
                   (16, 4, 2, 1, 2, HEXAGON, 0.3),
                   (16, 2, 4, 2, 1, GRID16, 0.03),
                   (10, 8, 8, 2, 1, GRID16, 0.5)],
    "u16-wide": [(16, 16, 16, 2, 6, ((0, 0),), 1.0),
                 (10, 16, 16, 1, 1, HEXAGON, 0.3),
                 (10, 128, 128, 1, 1, ((0, 0),), 1.0)],
}


@pytest.mark.parametrize("cases", EMUL_CASES.values(), ids=EMUL_CASES.keys())
def test_emulated_kernel_matches_plain(cases):
    for n, (bits, bs_y, bs_x, pel, kk, offsets, share) in enumerate(cases):
        stack, cy, cx, src, active = _inputs(80 + n + bs_x, bits, bs_y, bs_x,
                                             pel, kk, offsets, share)
        got = emulate_probe_block(stack, cy, cx, src, offsets, bs_y, bs_x,
                                  pel, active)
        want = probe_ops.probe_sads_plain(
            torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs_y, bs_x,
            pel, active=torch.from_numpy(active)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(cases[n][:5]))
        assert int((got == probe_ops.INVALID_SAD).sum()) == \
            int((~active).sum())
