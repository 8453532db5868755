"""PyTorch port: the DCT cost mix at the job weight 16, split from
test_torch_dct_mix.py (the same check, at the weight 0 there) into a file
of at most six tests, which pytest-xdist's loadfile scheduling hands out
after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from test_torch_dct_mix import check_mix_dct_cost  # noqa: E402


@pytest.mark.parametrize("w16", [16])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_mix_dct_cost_matches_jax(mode, w16):
    """mix_dct_cost and mix_dct_cost_sums against the JAX package at the
    job weight 16 (the second job's 15)."""
    check_mix_dct_cost(mode, w16)
