"""PyTorch port: K1''s kernel emulated word for word against the plain version;
split from test_torch_sadmap3.py (whose docstring says how the inputs are
made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
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
from mvtools_tpu_torch.ops import probe as probe_ops, sadmap
from test_torch_sadmap3 import _emulate_map3  # noqa: E402


@pytest.mark.parametrize("pel,r,bs_y,bs_x,pitch,nbx,tile", [
    (2, 7, 16, 16, 8, 5, 3),      # overlap 8, a ragged last tile
    (2, 7, 16, 16, 16, 3, 3),     # no overlap
    (1, 6, 8, 8, 8, 4, 4),        # pel 1, two passes of items
    (2, 8, 4, 8, 8, 3, 2),        # 8x4 blocks, r 8: two column chunks
    (2, 6, 32, 32, 16, 2, 2),     # 32x32, eight tile rows
])
def test_map3_kernel_emulation_matches_plain(pel, r, bs_y, bs_x, pitch, nbx,
                                             tile):
    """The emulated kernel == sad_map_plain(stats="sad_satd_luma"), with
    anchors at both clamp ends, and every item reads inside the staged
    rows, words, H(R) positions and box sums the geometry lays out."""
    rng = np.random.default_rng(62 + pel + r + bs_x + pitch)
    nby, pad, hpad = 2, 16, 8
    ph = (nby - 1) * pitch + bs_y + 2 * hpad
    pw = (nbx - 1) * pitch + bs_x + 2 * hpad
    nj = 1
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, ph, pw), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    hp, wp = stack.shape[-2:]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bs_y, bs_x, pel, tile, pitch, hp, wp)
    ntx = -(-nbx // tile)
    afy = rng.integers(lo_y, hi_y + 1, (nj, nby * ntx)).astype(np.int32)
    afx = rng.integers(lo_x, hi_x + 1, (nj, nby * ntx)).astype(np.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    args = (r, r, bs_y, bs_x, pel, tile, pitch, pitch, nbx, nby, hpad, hpad)
    want = sadmap.sad_map_plain(stack, torch.from_numpy(src),
                                torch.from_numpy(afy), torch.from_numpy(afx),
                                *args, stats="sad_satd_luma").numpy()
    got, reach, g = _emulate_map3(stack.numpy(), src, afy, afx, *args)
    np.testing.assert_array_equal(got, want)
    assert reach["word"] < g["ref_pitch"] // 4
    assert reach["pos"] < g["npos"] and reach["box"] < g["nbox"]

