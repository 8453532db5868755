"""PyTorch port: the fetch kernel's launch geometry; split from
test_torch_fetch.py (whose docstring says how the inputs are made) into a
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
from mvtools_tpu_torch.ops import probe as probe_ops


GEOM_CASES = [
    (16, 16, 16, 5), (8, 8, 8, 4), (4, 4, 4, 2), (4, 8, 8, 3),
    (32, 32, 32, 5), (16, 32, 32, 5), (2, 16, 16, 3), (8, 4, 4, 3),
    (2, 2, 0, 2), (4, 2, 0, 3), (64, 64, 0, 5), (128, 128, 0, 5),
    (12, 12, 0, 5), (6, 6, 0, 5),
]


@pytest.mark.parametrize("bs_y,bs_x,bsx_t,log_t", GEOM_CASES[:5])
def test_fetch_launch_geom(bs_y, bs_x, bsx_t, log_t):
    """The fetch kernel's template width and lanes per candidate: the
    widths 4, 8, 16, 32 have bodies of their own, the rest the generic one;
    a candidate gets the fewest power-of-two lanes that cover its int4
    groups (its pixels where the width is not a multiple of 4), at most a
    warp (more shapes: test_torch_fetch_geom2.py and
    test_torch_fetch_geom3.py)."""
    check_fetch_launch_geom(bs_y, bs_x, bsx_t, log_t)


def check_fetch_launch_geom(bs_y, bs_x, bsx_t, log_t):
    g = probe_ops.fetch_launch_geom(bs_y, bs_x)
    assert (g["bsx_t"], g["log_t"]) == (bsx_t, log_t)
    units = bs_y * bs_x // 4 if bs_x % 4 == 0 else bs_y * bs_x
    assert (1 << g["log_t"]) >= min(units, 32)
    assert g["log_t"] == 0 or (1 << (g["log_t"] - 1)) < units

