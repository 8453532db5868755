"""PyTorch port: one pyramid level's DCT costs through FieldProber, modes 1-4,
split from test_torch_dct.py (whose docstring says how its inputs are made)
into a file of at most six tests, which pytest-xdist's loadfile scheduling
hands out after the suite's longest file."""
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
import mvtools_tpu as mvt  # (enables x64)
from test_torch_dct import _probers, level  # noqa: E402


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_field_prober_dct_cost_matches_jax(level, mode):
    """FieldProber._dct_cost (fetch -> DCT -> mix) at five candidates per
    block, job weights 16 and 3."""
    jax_probers, port = _probers(level, mode, False)
    got = port._dct_cost(torch.from_numpy(level["cy"]),
                         torch.from_numpy(level["cx"]))
    assert got.dtype == torch.int64 and tuple(got.shape) == level["cy"].shape
    for j, p in enumerate(jax_probers):
        want = p._dct_cost(jnp.asarray(level["cy"][j]),
                           jnp.asarray(level["cx"][j]))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))

