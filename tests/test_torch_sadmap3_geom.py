"""PyTorch port: K1''s launch geometry walked on the CPU; split from
test_torch_sadmap3.py (whose docstring says how the inputs are made) into a
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
from test_torch_sadmap3 import (_admitted_stats3_shapes, _parity)  # noqa: E402


@pytest.mark.parametrize("family", ["GRAY", "YUV420"])
def test_map3_launch_geom_fits_the_card(family):
    """For every three-stat map shape the search admits at 8-bit (block
    sizes 8x4 to 128x128, pel 1 and 2, the map radii, pitches 8 to 128),
    the kernel's launch geometry fits a CTA's 227 KB of shared memory and a
    legal thread count, its regions do not overlap, the template column
    count exists, and the items of every subplane cover each output entry
    once, in the passes the geometry counts."""
    shapes = _admitted_stats3_shapes(family)
    assert len(shapes) > 20
    for shape in shapes:
        r_y, r_x, bs_y, bs_x, pel, tile, pitch_x = shape
        g = sadmap.map3_launch_geom(*shape)
        assert g["smem"] <= sadmap.SMEM_LIMIT, (shape, g)
        assert g["threads"] % 32 == 0, (shape, g)
        assert 32 <= g["threads"] <= sadmap.MAP3_MAX_THREADS, (shape, g)
        assert g["nox"] in sadmap.MAP3_NOX, (shape, g)
        assert g["passes"] * g["threads"] >= g["items"], (shape, g)
        assert (g["src_off"] >= g["wy"] * g["ref_pitch"]
                and g["hs_off"] >= g["src_off"] + bs_y * g["span_pitch"]
                and g["sc_off"] >= g["hs_off"] + bs_y // 4 * g["nxs"] * 32
                and g["hr_off"] >= g["sc_off"] + 4 * tile
                and g["box_off"] >= g["hr_off"] + sadmap.MAP3_BAND
                * g["hr_pitch"]
                and g["box_off"] >= g["hr_off"] + 4 * g["ny"] * g["wx"]
                and g["smem"] >= g["box_off"] + 4 * g["ny"] * g["nbox"])
        assert g["hr_pitch"] >= 32 * g["npos"]
        assert g["n_band"] * sadmap.MAP3_BAND >= g["nyp"]
        logp = pel.bit_length() - 1
        entries = 0
        for s in range(pel * pel):
            _, rows = _parity(r_y, s >> logp, pel)
            _, cols = _parity(r_x, s & (pel - 1), pel)
            assert rows * g["n_chunk"] * tile <= g["items"]
            assert g["n_chunk"] * g["nox"] >= cols
            entries += rows * cols
        assert entries == (2 * r_y + 1) * (2 * r_x + 1)

