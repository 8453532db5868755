"""PyTorch port: K1's launch geometry walked on the CPU (8-bit); split from
test_torch_sadmap.py (whose docstring says how the inputs are made) into a
file of at most six tests, which pytest-xdist's loadfile scheduling hands
out after the suite's longest file."""
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
from test_torch_sadmap import _admitted_map_shapes, _map_items  # noqa: E402


@pytest.mark.parametrize("family", ["GRAY", "YUV420", "YUV422", "YUV444"])
def test_map_launch_geom_fits_the_card(family):
    """For every map shape the search admits at 8-bit, the plain map
    kernel's launch geometry (ops/sadmap.py::map_launch_geom) fits a CTA's
    227 KB of shared memory and a legal thread count (a multiple of 32, at
    most the kernel's launch bound), and its items read only staged words
    and rows and write every output entry of a tile exactly once."""
    shapes = _admitted_map_shapes(family)
    assert len(shapes) > 20
    for shape in shapes:
        r_y, r_x, bs_y, bs_x, pel, tile, pitch_x = shape
        g = sadmap.map_launch_geom(*shape)
        assert g["smem"] <= sadmap.SMEM_LIMIT, (shape, g)
        assert g["threads"] % 32 == 0, (shape, g)
        assert 32 <= g["threads"] <= sadmap.MAP_MAX_THREADS, (shape, g)
        assert g["nws"] in sadmap.MAP_NWS and g["nox"] in sadmap.MAP_NOX
        assert -(-bs_x // 4) % g["nws"] == 0
        last_word, last_row, entries = _map_items(*shape, g)
        assert last_word.max() < g["ref_pitch"] // 4, (shape, g)
        assert last_row.max() < pel * pel * g["wy"], (shape, g)
        d = (2 * r_y + 1) * (2 * r_x + 1)
        assert len(entries) == tile * d, (shape, g)
        assert len(set(entries)) == tile * d, (shape, g)
        assert g["src_off"] >= pel * pel * g["wy"] * g["ref_pitch"]
        assert g["out_off"] >= g["src_off"] + tile * bs_y * -(-bs_x // 4) * 4

