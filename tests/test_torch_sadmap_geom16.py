"""PyTorch port: K1 u16's launch geometry walked on the CPU (10 and 16 bits,
gray and YUV); split from test_torch_sadmap.py (whose docstring says how the
inputs are made) into a file of at most six tests, which pytest-xdist's
loadfile scheduling hands out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.ops import sadmap
from test_torch_sadmap import _admitted_map_shapes, _map16_items  # noqa: E402


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("family", ["GRAY", "YUV420"])
def test_map_launch_geom_fits_the_card_at_deep_bits(family, bits):
    """The same for the uint16 form (sadmap16_kernel: one subplane's window
    staged at a time with its block-high column sums, each block's source
    sum) over every map shape the search admits at 10 and 16 bits (16-bit:
    blocks up to 16x16; 10-bit: every size): every tile or part of one fits
    a CTA, the parts cover the tile, the regions lie in order, and the items
    of every subplane read only staged words, rows and column sums and
    write each entry of the CTA's blocks once; the YUV420 level-0 luma map
    leaves room for three CTAs an SM, and its chroma maps split their tile
    in two.  The 4:2:2 and 4:4:4
    families: test_torch_sadmap_geom16b.py."""
    check_map16_launch_geom(family, bits)


def check_map16_launch_geom(family, bits):
    shapes = _admitted_map_shapes(family, bits)
    assert len(shapes) > 20
    assert all(bs_y * bs_x <= 256 for _, _, bs_y, bs_x, *_ in shapes) == (
        bits == 16)
    for shape in shapes:
        r_y, r_x, bs_y, bs_x, pel, tile, pitch_x = shape
        g = sadmap.map_launch_geom(*shape, 2)
        assert g == sadmap.map16_launch_geom(*shape)
        assert g["n_part"] in (1, 2) and g["nbc"] * g["n_part"] >= tile
        assert (g["n_part"] - 1) * g["nbc"] < tile
        assert g["smem"] <= sadmap.SMEM_LIMIT, (shape, g)
        assert g["threads"] % 32 == 0, (shape, g)
        assert 32 <= g["threads"] <= sadmap.MAP16_MAX_THREADS, (shape, g)
        assert g["passes"] * g["threads"] >= g["items"], (shape, g)
        assert g["nws"] in sadmap.MAP_NWS and g["nox"] in sadmap.MAP_NOX
        assert (bs_x // 2) % g["nws"] == 0
        last_word, last_row, last_box, entries = _map16_items(*shape, g)
        assert last_word.max() < g["ref_pitch"] // 4, (shape, g)
        assert last_row.max() < g["wy"], (shape, g)
        assert last_box.max() < g["wx"] <= 2 * g["ref_pitch"] // 4, (shape,
                                                                     g)
        d = (2 * r_y + 1) * (2 * r_x + 1)
        nbc = g["nbc"]
        assert len(entries) == nbc * d, (shape, g)
        assert len(set(entries)) == nbc * d, (shape, g)
        assert g["ref_pitch"] // 4 % 2 == 1 and g["src_stride"] // 4 % 2 == 1
        assert (g["src_off"] >= g["wy"] * g["ref_pitch"]
                and g["out_off"] >= g["src_off"] + nbc * g["src_stride"]
                and g["col_off"] >= g["out_off"] + 4 * nbc * d
                and g["ss_off"] >= g["col_off"] + 4 * g["ny"] * g["wx"]
                and g["smem"] >= g["ss_off"] + 4 * nbc)
    if family == "YUV420":
        luma = sadmap.map_launch_geom(8, 8, 16, 16, 2, 31, 8, 2)
        assert luma["smem"] <= sadmap.MAP16_SMEM_3CTA and luma["n_part"] == 1
        assert sadmap.map_launch_geom(5, 5, 8, 8, 2, 31, 4, 2)["n_part"] == 2
        assert (8, 8, 16, 16, 2, 31, 8) in shapes

