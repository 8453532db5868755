"""PyTorch port: the plain version of the dense SAD map (kernel K1)
against the JAX package's reference semantics (sadmap.sad_map_xla), bit
for bit.  The CUDA kernel itself is held against this plain version on
the card by chip_smoke.py.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers).

Some of its checks live in test_torch_sadmap_{geom,geom16,geom16b}.py, files
of at most six tests that pytest-xdist's loadfile scheduling hands out after
the suite's longest file."""
import itertools
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu  # noqa: F401  (enables x64)
from mvtools_tpu.ops import probe as jax_probe, sadmap as jax_sadmap

from mvtools_tpu_torch.ops import probe as probe_ops, sadmap


@pytest.mark.parametrize("pel,r_y,r_x,nbx,tile", [
    (2, 3, 4, 5, 4),     # ragged tail tile (one block)
    (1, 2, 3, 4, 2),
    (2, 7, 7, 3, 3),     # the finest level's radius
])
def test_sad_map_plain_matches_jax(pel, r_y, r_x, nbx, tile):
    rng = np.random.default_rng(10 + pel)
    bs, nby, pad, hpad = 16, 2, 16, 8
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad
    nj = 2
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, ph, pw), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    hp, wp = stack.shape[-2:]
    args = (r_y, r_x, bs, bs, pel, tile, bs)
    assert sadmap.map_geom(*args) == jax_sadmap.map_geom(*args)
    bounds = sadmap.anchor_bounds(*args, hp, wp)
    assert bounds == jax_sadmap.anchor_bounds(*args, hp, wp)
    (lo_y, hi_y), (lo_x, hi_x) = bounds
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (nj, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (nj, nby * ntx)).astype(np.int32)
    # both clamp ends
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    got = sadmap.sad_map(stack, torch.from_numpy(src),
                         torch.from_numpy(afy), torch.from_numpy(afx),
                         r_y, r_x, bs, bs, pel, tile, bs, bs, nbx, nby,
                         hpad, hpad).numpy()
    assert got.shape == (nj, nby * nbx, 2 * r_y + 1, 2 * r_x + 1)
    assert got.dtype == np.int32

    # JAX side: per-block anchors in pel units, per-block source blocks
    bx = np.arange(nbx)
    logp = pel.bit_length() - 1
    for j in range(nj):
        cy = np.repeat(afy[j].reshape(nby, ntx)[:, bx // tile], 1, 1)
        cx = afx[j].reshape(nby, ntx)[:, bx // tile] + (bx % tile) * bs
        blocks = (src[j, hpad:hpad + nby * bs, hpad:hpad + nbx * bs]
                  .reshape(nby, bs, nbx, bs).transpose(0, 2, 1, 3)
                  .reshape(nby * nbx, bs, bs))
        want = jax_sadmap.sad_map_xla(
            jnp.asarray(stack[j].numpy()),
            jnp.asarray((cy << logp).reshape(-1).astype(np.int32)),
            jnp.asarray((cx << logp).reshape(-1).astype(np.int32)),
            jnp.asarray(blocks.astype(np.int32)), r_y, r_x, bs, bs, pel)
        np.testing.assert_array_equal(
            got[j].reshape(nby * nbx, -1), np.asarray(want))


def test_grid_offsets_match_jax():
    assert sadmap.grid_offsets(2, 3) == jax_sadmap.grid_offsets(2, 3)
    assert probe_ops.INVALID_SAD == int(jax_probe.INVALID_SAD)
    assert (probe_ops.ALIGN_SLACK_Y, probe_ops.ALIGN_SLACK_X) == (
        jax_probe.ALIGN_SLACK_Y, jax_probe.ALIGN_SLACK_X)


def _admitted_map_shapes(family, bits=8):
    """Every (r_y, r_x, bs_y, bs_x, pel, tile, pitch_x) of a plain SAD map
    (luma and chroma) that MapProber builds at `bits` bits for a 1080p clip
    of `family`: every valid block size, overlap, pel 1 and 2, every level
    that map_supported admits."""
    from mvtools_tpu_torch import AnalyseConfig, SuperConfig
    from mvtools_tpu_torch import field_engine as fe
    from mvtools_tpu_torch.analyse import _level_ctx
    from mvtools_tpu_torch.core.config import _VALID_BLOCK_SIZES
    from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
    chroma = family != "GRAY"
    fmt = VideoFormat(1920, 1080, bits, ColorFamily[family])
    shapes = set()
    for (bw, bh), pel in itertools.product(sorted(_VALID_BLOCK_SIZES), (1, 2)):
        sspec = SuperConfig(pel=pel, levels=0, chroma=chroma).validate(fmt)
        for ov in range(bw // 2 + 1):
            try:
                aspec = AnalyseConfig(blksize=bw, blksizev=bh, overlap=ov,
                                      overlapv=min(ov, bh // 2), levels=0,
                                      chroma=chroma).validate(sspec)
            except ValueError:
                continue
            for lv in range(aspec.meta.lv_count):
                ctx = _level_ctx(sspec, aspec, lv)
                r = fe.map_radius(ctx)
                if not fe.map_supported(ctx, r):
                    continue
                tile = fe._map_tile(ctx)
                shapes.add((r, r, bh, bw, ctx.pel, tile, bw - ov))
                if chroma:
                    rc_y, rc_x, pit_c, _ = fe._chroma_map_geom(ctx, r)
                    shapes.add((rc_y, rc_x) + ctx.blk_size_c[::-1]
                               + (ctx.pel, tile, pit_c))
    return sorted(shapes)


def _map_items(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x, g, ppw=4):
    """The plain map kernel's items (csrc/sadmap.cu::sadmap_kernel) of a
    full CTA (g["nbc"] blocks of a tile, the whole tile unless the geometry
    splits it; ppw pixels a word), as arrays: the last reference word, the
    last staged row and the output entries each item writes."""
    logp, pelm = pel.bit_length() - 1, pel - 1
    wpr, nox, nws = -(-bs_x // ppw), g["nox"], g["nws"]
    nbc = g.get("nbc", tile)
    item = np.arange(nbc * g["n_rows"] * g["n_chunk"])
    b, rest = item % nbc, item // nbc
    chunk, rid = rest % g["n_chunk"], rest // g["n_chunk"]

    def first(r, q):
        return -r + ((q + r) & pelm)

    def count(r, d0):
        return np.maximum(0, ((r - d0) >> logp) + 1)

    per0 = count(r_y, first(r_y, 0)) << logp
    py = (rid >= per0).astype(np.int64)
    k = rid - py * per0
    px = k & pelm
    dy = first(r_y, py) + ((k >> logp) << logp)
    dx0 = first(r_x, px)
    ncol = np.minimum(nox, count(r_x, dx0) - chunk * nox)
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    col0 = b * pitch_x + (dx0 >> logp) + chunk * nox - min_ox
    nrw = (col0 % ppw + nox - 1 + ppw * nws - 1) // ppw + 1
    last_word = col0 // ppw + wpr - nws + nrw - 1
    sub = px | (py << logp)
    last_row = sub * g["wy"] + (dy >> logp) - min_oy + bs_y - 1
    entries = [(bb, (d + r_y) * (2 * r_x + 1) + x0 + (i << logp))
               for bb, d, x0, n in zip(b, dy, dx0 + ((chunk * nox) << logp)
                                       + r_x, ncol) for i in range(n)]
    return last_word[ncol > 0], last_row[ncol > 0], entries


def _map16_items(r_y, r_x, bs_y, bs_x, pel, tile, pitch_x, g):
    """The uint16 map kernel's items (csrc/sadmap.cu::sadmap16_kernel) of a
    full CTA (g["nbc"] blocks of a tile, the whole tile unless the geometry
    splits it), subplane by subplane, as arrays: the last reference word, the
    last staged row and the last column sum each item reads, and the output
    entries each writes."""
    logp, pelm = pel.bit_length() - 1, pel - 1
    min_oy, min_ox = (-r_y) >> logp, (-r_x) >> logp
    nox, nws, wpr, nbc = g["nox"], g["nws"], bs_x // 2, g["nbc"]
    words, rows, boxes, entries = [], [], [], []
    for s in range(pel * pel):
        py, px = s >> logp, s & pelm
        dy0 = -r_y + ((py + r_y) & pelm)
        dx0 = -r_x + ((px + r_x) & pelm)
        rows_s = max(0, ((r_y - dy0) >> logp) + 1)
        cols_s = max(0, ((r_x - dx0) >> logp) + 1)
        item = np.arange(rows_s * nbc * g["n_chunk"])
        kr, rest = item % rows_s, item // rows_s
        b, chunk = rest % nbc, rest // nbc
        ncol = np.minimum(nox, cols_s - chunk * nox)
        dy = dy0 + (kr << logp)
        oy = (dy >> logp) - min_oy
        col0 = b * pitch_x + (dx0 >> logp) - min_ox + chunk * nox
        nrw = ((col0 % 2 + nox - 1 + 2 * (nws - 1)) >> 1) + 2
        keep = ncol > 0
        words.append((col0 // 2 + wpr - nws + nrw - 1)[keep])
        rows.append((oy + bs_y - 1)[keep])
        boxes.append((col0 + ncol - 2 + bs_x)[keep])
        entries += [(bb, (d + r_y) * (2 * r_x + 1) + dx0 + ((c * nox + i)
                                                            << logp) + r_x)
                    for bb, d, c, n in zip(b, dy, chunk, ncol)
                    for i in range(n)]
    return (np.concatenate(words), np.concatenate(rows),
            np.concatenate(boxes), entries)


