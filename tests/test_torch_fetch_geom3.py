"""PyTorch port: the fetch kernel's launch geometry at more block shapes;
split from test_torch_fetch_geom.py into a file of at most six tests, which
pytest-xdist's loadfile scheduling hands out after the suite's longest
file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from test_torch_fetch_geom import (GEOM_CASES,  # noqa: E402
                                   check_fetch_launch_geom)


@pytest.mark.parametrize("bs_y,bs_x,bsx_t,log_t", GEOM_CASES[10:])
def test_fetch_launch_geom(bs_y, bs_x, bsx_t, log_t):
    """The fetch kernel's launch geometry at these block shapes
    (test_torch_fetch_geom.py says what it holds)."""
    check_fetch_launch_geom(bs_y, bs_x, bsx_t, log_t)
