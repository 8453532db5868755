"""PyTorch port: the uint16 tiled probe's CUDA body (K2 u16,
csrc/probe.cu::probe16_kernel) emulated word for word on the CPU and held
against the plain version, probe_sads_tiled_plain (tolerance 0: integers).

The emulation walks the launch geometry of ops/probe.py::probe16_launch_geom
thread by thread (3-D grid of tile groups, block rows and jobs; threads of
(lane, candidate, block of the tile group)), computes every thread's tile
base from the three members' candidate 0, the validity rule and the live
bits the ballots assemble, loads the source chunks and the reference words
the way the kernel addresses them (byte addresses; aligned 8-byte loads for
four-word chunks, 32-bit ones for narrower, one funnel shift a word; every
load must hold a pixel of its chunk), adds
sum S + sum R - 2 sum min(S, R) in 32-bit arithmetic, sums each item's lanes
and writes each entry from the lane the kernel writes it from: every entry
exactly once.

At most six tests and no JAX reference: pytest-xdist's loadfile scheduling
hands this file out after the larger ones.  Inputs are made with numpy from
a seed: full-range 16-bit and 10-bit samples, 30 %-live masks with whole
items dead, a twentieth of the candidates thrown off their tile, block rows
whose length is not a multiple of the tile, and blocks of 0 against 65 535.
"""
import os
import re
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.core.config import _VALID_BLOCK_SIZES  # noqa: E402
from mvtools_tpu_torch.ops import probe as probe_ops  # noqa: E402

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
WALK = ((0, -2), (0, 2), (-2, 0), (2, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
M32 = (1 << 32) - 1
INT_MAX = probe_ops.INVALID_SAD
# warps of the kernel the card keeps resident (probe16_in_flight reads it on
# the card): an H100's 132 SMs at 32 warps each
IN_FLIGHT = 132 * 32
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mvtools_tpu_torch", "csrc", "probe.cu")


def _word(buf, addr):
    """Little-endian 32-bit words of a byte array at aligned addresses."""
    assert (addr % 4 == 0).all() and (addr >= 0).all()
    assert (addr + 4 <= buf.size).all()
    b = buf[addr[..., None] + np.arange(4)].astype(np.int64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _halves(v):
    return v & 0xFFFF, (v >> 16) & 0xFFFF


def emulate_probe16(stack, cand_y, cand_x, src, offsets, bs_y, bs_x, pel,
                    row_len, tile, active, geom):
    """out [J, nblk, K, D] as probe16_kernel computes it under the launch
    geometry `geom`; numpy arrays in, every entry written exactly once."""
    nj, n_sub, hp, wp = stack.shape
    _, nblk, kk = cand_y.shape
    dd = len(offsets)
    logp = pel.bit_length() - 1
    pelm = pel - 1
    min_dx, min_dy, wy, _, _, cxs = probe_ops._tile_geom(offsets, bs_y,
                                                         bs_x, pel)
    wy_total, wx_total, center_y, center_x = probe_ops.tile_params(
        offsets, bs_y, bs_x, pel, tile, bs_x)
    cw, ch, g_n, warps, span = (geom[k] for k in ("cw", "ch", "g", "warps",
                                                  "span"))
    # the host entry's checks and derived values
    wpr = bs_x // 2
    assert bs_x % 2 == 0 and wpr % cw == 0 and g_n & (g_n - 1) == 0
    assert 1 <= warps <= 8 and span >= 1
    cpr = wpr // cw
    assert cpr & (cpr - 1) == 0
    lcpr = cpr.bit_length() - 1
    nc = bs_y << lcpr
    assert (ch == 0 and g_n == 32) or g_n * ch == nc
    n_grp = 32 // g_n
    threads = 32 * warps
    grid = (-(-row_len // span), nblk // row_len, nj)
    # first pass: every lane of every CTA, warp and round of the item loop,
    # one item each
    recs = []
    for bx in range(grid[0]):
        col0 = bx * span
        n_items = min(span, row_len - col0) * kk
        for i0 in range(0, n_items, 32):
            lanes = np.arange(32)
            it = i0 + lanes
            keep = it < n_items
            recs.append((np.full(keep.sum(), len(recs)), it[keep],
                         np.full(keep.sum(), col0), lanes[keep]))
            assert (i0 // 32) % warps < warps
    key = np.concatenate([r[0] for r in recs])    # (CTA column, pass)
    it = np.concatenate([r[1] for r in recs])
    col0 = np.concatenate([r[2] for r in recs])
    lane = np.concatenate([r[3] for r in recs])
    # ... for every block row and job
    n1 = key.size
    rows, jobs = np.meshgrid(np.arange(grid[1]), np.arange(grid[2]),
                             indexing="ij")
    rows, jobs = rows.ravel(), jobs.ravel()
    key = (np.tile(key, rows.size) * rows.size
           + np.repeat(np.arange(rows.size), n1))
    it, col0, lane = (np.tile(a, rows.size) for a in (it, col0, lane))
    row, job = np.repeat(rows, n1), np.repeat(jobs, n1)
    rb = job * nblk + row * row_len
    w = (rb + col0) * kk + it
    cover = np.zeros(nj * nblk * kk, np.int64)
    np.add.at(cover, w, 1)
    assert (cover == 1).all()
    out = np.full(nj * nblk * kk * dd, -1, np.int64)
    writes = np.zeros(out.shape, np.int64)

    def write(idx, val):
        np.add.at(writes, idx, 1)
        out[idx] = val

    def fill_invalid(items, lanes, g_items):
        """INT_MAX into the items' entries from their lanes: four at a time
        (one 16-byte store) where D is a multiple of 4."""
        step = 4 if dd % 4 == 0 else 1
        for j in range(-(-dd // (step * g_items))):
            e = step * (lanes + j * g_items)
            sel = e < dd
            for q in range(step):
                write(items[sel] * dd + e[sel] + q, INT_MAX)

    act = None if active is None else active.reshape(-1, dd)
    abytes = None if act is None else act.astype(np.uint8).reshape(-1)
    few = dd <= 32
    if act is not None and few:
        live = np.zeros(w.shape, np.int64)
        if dd % 4 == 0:      # the item's flags as aligned 32-bit words
            for q in range(0, dd, 4):
                wd = _word(abytes, w * dd + q)
                live |= ((((wd & 0x01010101) * 0x01020408) & M32) >> 24) << q
        else:                # byte by byte
            for d in range(dd):
                live |= abytes[w * dd + d].astype(np.int64) << d
        assert (live == (act[w] * (1 << np.arange(dd))).sum(-1)).all()
        anyl = live != 0
    elif act is not None:
        live, anyl = None, act[w].any(-1)
    else:
        live = np.full(w.shape, (1 << dd) - 1) if few else None
        anyl = np.ones(w.shape, bool)
    cyf, cxf = cand_y.reshape(-1), cand_x.reshape(-1)
    cy, cx = cyf[w], cxf[w]
    col = col0 + it // kk
    c0 = col - col % tile
    last = row_len - 1

    def base(cf, mdv, center, lo_max, mask):
        m = [(cf[(rb + np.minimum(c, last)) * kk] + mdv) >> logp
             for c in (c0, c0 + tile // 2, c0 + tile - 1)]
        med = np.maximum(np.minimum(m[0], m[1]),
                         np.minimum(np.maximum(m[0], m[1]), m[2]))
        return np.clip(med - center, 0, lo_max) & mask

    ay = base(cyf, min_dy, center_y, hp - wy_total, ~7)
    ax = base(cxf, min_dx, center_x, wp - wx_total, ~127)
    rel_y = ((cy + min_dy) >> logp) - ay
    rel_x = ((cx + min_dx) >> logp) - ax
    ok = (anyl & (rel_y >= 0) & (rel_y + wy <= wy_total) & (rel_x >= 0)
          & ((rel_x & ~127) + cxs <= wx_total))
    fill_invalid(w[~ok], np.zeros((~ok).sum(), np.int64), 1)
    # second pass: the live, valid items of a warp's round go to its groups
    # of G lanes in lane order, n_grp a turn
    order = np.lexsort((lane, key))
    okw = ok[order]
    k_ok, w_ok = key[order][okw], w[order][okw]
    live_ok = live[order][okw] if live is not None else None
    cy_ok, cx_ok = cy[order][okw], cx[order][okw]
    job_ok = job[order][okw]
    first = np.r_[0, np.flatnonzero(np.diff(k_ok)) + 1]
    rank = np.arange(k_ok.size) - np.repeat(first, np.diff(
        np.r_[first, k_ok.size]))
    grp = rank % n_grp                        # the group that takes it
    assert (grp < n_grp).all()
    # the item's G lanes, side by side: [items, G] -> flat records
    g = np.tile(np.arange(g_n), w_ok.size)
    rep = lambda a: np.repeat(a, g_n)         # noqa: E731
    w, cy, cx, job = rep(w_ok), rep(cy_ok), rep(cx_ok), rep(job_ok)
    live = rep(live_ok) if live_ok is not None else None
    jb = w // kk
    sbytes = np.ascontiguousarray(src).view(np.uint8).reshape(-1)
    kbytes = np.ascontiguousarray(stack).view(np.uint8).reshape(-1)
    plane = hp * wp
    n_chunks = ch if ch else -(-nc // 32)
    # the lane's chunks: source words (one aligned vector load) and plane
    # byte offsets
    chunks = []
    ssum = np.zeros(w.shape, np.int64)
    for i in range(n_chunks):
        ci = g + i * (g_n if ch else 32)
        has = ci < nc
        r, cc = ci >> lcpr, ci & (cpr - 1)
        sp = 2 * (jb * bs_y * bs_x + r * bs_x + cc * 2 * cw)
        assert (sp[has] % (4 * cw) == 0).all()
        sw = [np.where(has, _word(sbytes, np.where(has, sp + 4 * q, 0)), 0)
              for q in range(cw)]
        for v in sw:
            lo, hi = _halves(v)
            ssum = (ssum + lo + hi) & M32
        chunks.append((has, sw, 2 * (r * wp + cc * 2 * cw)))
    for d, (odx, ody) in enumerate(offsets):
        if few:
            on = (live >> d) & 1 == 1
        else:
            on = np.ones(w.shape, bool) if act is None else act[w, d]
        write(w[~on & (g == 0)] * dd + d, INT_MAX)
        px, py = cx + odx, cy + ody
        sub = (px & pelm) | ((py & pelm) << logp)
        r0 = 2 * (job * n_sub * plane + sub * plane + (py >> logp) * wp
                  + (px >> logp))
        acc_r = np.zeros(w.shape, np.int64)
        acc_m = np.zeros(w.shape, np.int64)
        for has, sw, roff in chunks:
            use = on & has
            a = np.where(use, r0 + roff, 0)
            sh = (a & 3) * 8
            if cw == 4:           # 8-byte loads, the third where a & 7
                a8 = a & ~7
                loads = [(a8, 8, use), (a8 + 8, 8, use),
                         (a8 + 16, 8, use & (a & 7 != 0))]
                w8 = [_word(kbytes, a8 + 4 * q) for q in range(6)]
                w8[4] = np.where(a & 7 != 0, w8[4], w8[2])
                w8[5] = np.where(a & 7 != 0, w8[5], w8[3])
                odd = (a >> 2) & 1 == 1
                v = [np.where(odd, w8[q + 1], w8[q]) for q in range(5)]
            else:                 # CW + 1 aligned 32-bit loads
                a4 = a & ~3
                loads = [(a4 + 4 * q, 4, use) for q in range(cw)] + [
                    ((a + 4 * cw - 1) & ~3, 4, use)]
                v = [_word(kbytes, ad) for ad, _, _ in loads]
            for ad, n, u in loads:    # each load holds a pixel of the chunk
                assert ((ad[u] + n > a[u]) & (ad[u] < a[u] + 4 * cw)).all()
            for q in range(cw):
                rw = ((v[q] | v[q + 1] << 32) >> sh) & M32
                rlo, rhi = _halves(rw)
                slo, shi = _halves(sw[q])
                acc_r = np.where(use, (acc_r + rlo + rhi) & M32, acc_r)
                acc_m = np.where(use, (acc_m + np.minimum(rlo, slo)
                                       + np.minimum(rhi, shi)) & M32, acc_m)
        t = (ssum + acc_r - 2 * acc_m) & M32
        # the xor shuffles leave the item's sum in each of its lanes
        tot = np.repeat(t.reshape(-1, g_n).sum(1) & M32, g_n)
        sel = on & (g == (d & (g_n - 1)))
        write(w[sel] * dd + d, tot[sel])
    assert (writes == 1).all(), "an entry written twice or never"
    assert (out < 1 << 31).all()
    return out.reshape(nj, nblk, kk, dd)


def _case(seed, bits, bs_y, bs_x, pel, kk, offsets, nbx=13, nby=2, nj=2,
          masked=True, extremes=False):
    """Random inputs on a [nby, nbx] grid of bs_y x bs_x blocks (pitch bs_x,
    rows not a multiple of the tile), candidates round the blocks, a
    twentieth of them thrown off their tile."""
    rng = np.random.default_rng(seed)
    pad, hpad = 16, 16
    ph, pw = nby * bs_y + 2 * hpad, nbx * bs_x + 2 * hpad + 64
    top = (1 << bits) - 1
    ref = rng.integers(0, top + 1, (nj, pel * pel, ph, pw)).astype(np.uint16)
    src = rng.integers(0, top + 1, (nj, nby * nbx, bs_y, bs_x)
                       ).astype(np.uint16)
    if extremes:
        ref[:] = top
        src[:] = 0
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    logp = pel.bit_length() - 1
    idx = np.arange(nby * nbx)
    base_y = (hpad + bs_y * (idx // nbx) + pad) << logp
    base_x = (hpad + bs_x * (idx % nbx) + pad) << logp
    vy = rng.integers(-5, 6, (nj, nby * nbx, kk))
    vx = rng.integers(-5, 6, (nj, nby * nbx, kk))
    far = rng.random((nj, nby * nbx, kk)) < 0.05
    far[0, 1, 0] = True
    vx = np.where(far, vx + 260 * pel, vx)
    vy = np.where(far, vy + 60 * pel, vy)
    cy = (base_y[None, :, None] + vy).astype(np.int32)
    cx = (base_x[None, :, None] + vx).astype(np.int32)
    active = None
    if masked:
        rows = rng.random((nj, nby * nbx, kk, 1)) < 0.5
        active = rows & (rng.random((nj, nby * nbx, kk, len(offsets))) < 0.6)
    return stack, cy, cx, src, active


def _check(seed, bits, bs_y, bs_x, pel, kk, offsets, **kw):
    stack, cy, cx, src, active = _case(seed, bits, bs_y, bs_x, pel, kk,
                                       offsets, **kw)
    nbx = kw.get("nbx", 13)
    tile = 8 if kk <= 2 else 4
    # the geometry of this launch (few items: a few a warp) and that of a
    # launch of many items (32 a warp, two warps a CTA)
    geom = probe_ops.probe16_launch_geom(bs_y, bs_x, kk, cy.size, IN_FLIGHT)
    wide = probe_ops.probe16_launch_geom(bs_y, bs_x, kk, 10 ** 8, IN_FLIGHT)
    assert geom["span"] < wide["span"] or kk > 32
    got = emulate_probe16(stack.numpy(), cy, cx, src, offsets, bs_y, bs_x,
                          pel, nbx, tile, active, geom)
    np.testing.assert_array_equal(
        got, emulate_probe16(stack.numpy(), cy, cx, src, offsets, bs_y,
                             bs_x, pel, nbx, tile, active, wide))
    t_active = None if active is None else torch.from_numpy(active)
    want = probe_ops.probe_sads_tiled(
        stack, torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs_y, bs_x, pel, row_len=nbx,
        pitch_x=bs_x, active=t_active).numpy()
    np.testing.assert_array_equal(got, want)
    n_invalid = int((want == INT_MAX).sum())
    assert 0 < n_invalid < want.size
    return geom, want


def test_probe16_launch_geom_fits_the_card():
    """For every block size the search admits (luma, and chroma under
    4:2:0, 4:2:2 and 4:4:0), K 1-8 and launches of 10^3 to 10^7 items:
    whole chunks of a power of two a row, every item's chunks held by its
    lanes (or strided over by the generic body's 32), a CTA of at most 256
    threads whose span of blocks gives each warp at most 32 items (4-32, a
    launch of fewer items fewer a warp), a (cw, ch) form that probe.cu
    instantiates, and a 1080p grid within the card's limits."""
    with open(CSRC) as f:
        forms = re.search(r"#define MVT_PROBE16_FORMS\(X\)(.*)", f.read())
    forms = {tuple(map(int, m)) for m in
             re.findall(r"X\((\d), (\d)\)", forms.group(1))}
    assert len(forms) == 6
    sizes = set()
    for bx, by_ in _VALID_BLOCK_SIZES:
        for rx, ry in ((1, 1), (2, 2), (2, 1), (1, 2)):
            sizes.add((by_ // ry, bx // rx))
    for bs_y, bs_x in sorted(sizes):
        for kk in range(1, 9):
            for n_items in (10 ** 3, 10 ** 5, 10 ** 7):
                geo = probe_ops.probe16_launch_geom(bs_y, bs_x, kk, n_items,
                                                    IN_FLIGHT)
                assert (geo["cw"], geo["ch"]) in forms
                wpr = bs_x // 2
                assert wpr % geo["cw"] == 0
                cpr = wpr // geo["cw"]
                assert cpr & (cpr - 1) == 0
                nc = bs_y * cpr
                g = geo["g"]
                assert g & (g - 1) == 0 and 1 <= g <= 32
                if geo["ch"]:
                    assert geo["ch"] in probe_ops.PROBE16_CH
                    assert g * geo["ch"] == nc
                else:
                    assert g == 32 and nc > 32 * max(probe_ops.PROBE16_CH)
                assert 1 <= geo["warps"] <= 8 and 32 * geo["warps"] <= 256
                assert 1 <= geo["span"]
                assert geo["span"] * kk <= 32 * geo["warps"] or kk > 4
                nbx = (1920 - bs_x // 2) // (bs_x // 2)
                nby = (1080 - bs_y // 2) // max(1, bs_y // 2)
                assert -(-nbx // geo["span"]) < 2 ** 31 and nby <= 65535
    g16 = probe_ops.probe16_launch_geom(16, 16, 1, 42 * 32026, IN_FLIGHT)
    assert (g16["cw"], g16["ch"], g16["g"], g16["span"]) == (4, 2, 16, 64)
    assert probe_ops.probe16_launch_geom(16, 16, 1, 42 * 435,
                                         IN_FLIGHT)["span"] == 4
    g8 = probe_ops.probe16_launch_geom(8, 8, 1, 42 * 32026, IN_FLIGHT)
    assert (g8["cw"], g8["ch"], g8["g"]) == (4, 2, 4)
    assert probe_ops.probe16_launch_geom(64, 64, 1, 10 ** 6,
                                         IN_FLIGHT)["ch"] == 0


def test_probe16_luma_16bit_hexagon_masked():
    """The YUV path's level-0 luma shape: 16x16, pel 2, K 1, the hexagon,
    16-bit samples, 30 %-live mask, off-tile candidates, 13-block rows."""
    geom, want = _check(1, 16, 16, 16, 2, 1, HEXAGON)
    assert geom["ch"] == 2 and geom["g"] == 16
    assert (want != INT_MAX).any()


def test_probe16_chroma_10bit_grid16():
    """The YUV path's chroma shape: 8x8 blocks, the 16 offsets of a 4x4
    grid, 10-bit samples, with and without a mask."""
    _check(2, 10, 8, 8, 2, 1, GRID16)
    _check(3, 10, 8, 8, 2, 1, GRID16, masked=False)


def test_probe16_extremes_and_pel1():
    """Blocks of 0 against 65 535: every valid entry is 16 * 16 * 65 535;
    and pel 1 with the walk's eight offsets."""
    _, want = _check(4, 16, 16, 16, 2, 1, WALK, masked=False, extremes=True)
    assert (want[want != INT_MAX] == 16 * 16 * 65535).all()
    _check(5, 16, 16, 16, 1, 2, WALK)


def test_probe16_small_and_generic_blocks():
    """Block widths of two and four pixels (one- and two-word chunks), 8x1
    chroma rows, and 64x64 blocks at 10 bits (the generic body's strided
    chunks)."""
    for seed, (bs_y, bs_x) in enumerate(((2, 2), (4, 4), (2, 4), (1, 8))):
        geom, _ = _check(10 + seed, 16, bs_y, bs_x, 2, 1, HEXAGON, nbx=21)
        assert geom["cw"] == min(4, bs_x // 2)
    geom, _ = _check(20, 10, 64, 64, 1, 1, HEXAGON, nbx=5, nby=1, nj=1)
    assert geom["ch"] == 0


def test_probe16_many_candidates():
    """K 6 with one offset (tiles of 4, the candidates side by side in a
    CTA) and K 6 with 40 offsets (more than a ballot's 32: the flags are
    read per offset)."""
    _check(30, 16, 16, 16, 2, 6, ((0, 0),))
    many = tuple((dx, dy) for dy in range(-2, 3) for dx in range(-4, 4))
    _check(31, 10, 8, 8, 2, 6, many)
