"""PyTorch port: the overlap windows' indices against the JAX package; split
from test_torch_overlap.py (whose docstring says how the inputs are made)
into a file of at most six tests, which pytest-xdist's loadfile scheduling
hands out after the suite's longest file."""
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
from mvtools_tpu.ops import overlap as jax_overlap
from mvtools_tpu_torch.ops import overlap as overlap_ops


@pytest.mark.parametrize("nbx,nby", [(1, 1), (2, 1), (1, 2), (2, 3), (7, 5)])
def test_window_indices_match_jax(nbx, nby):
    np.testing.assert_array_equal(overlap_ops.window_indices(nbx, nby),
                                  jax_overlap.window_indices(nbx, nby))

