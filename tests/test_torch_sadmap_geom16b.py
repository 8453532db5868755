"""PyTorch port: K1 u16's launch geometry for the 4:2:2 and 4:4:4 families;
split from test_torch_sadmap_geom16.py into a file of at most six tests,
which pytest-xdist's loadfile scheduling hands out after the suite's longest
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
from test_torch_sadmap_geom16 import check_map16_launch_geom  # noqa: E402


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("family", ["YUV422", "YUV444"])
def test_map_launch_geom_fits_the_card_at_deep_bits(family, bits):
    """K1 u16's launch geometry over every map shape of the family
    (test_torch_sadmap_geom16.py says what it holds)."""
    check_map16_launch_geom(family, bits)
