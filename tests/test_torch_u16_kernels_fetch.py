"""PyTorch port: K3 and K5 on uint16 stacks take the window slice everywhere;
split from test_torch_u16_kernels.py (whose docstring says how the inputs
are made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_u16_kernels import BS, PEL, _fetch_inputs  # noqa: E402


@pytest.mark.parametrize("bits", [10, 16])
def test_fetches_u16_take_the_window_slice_everywhere(bits):
    """K3's and K5's plain versions on a uint16 stack == the JAX package's
    CPU fetch, a window slice (lax.dynamic_slice), at every origin."""
    stack, cy, cx = _fetch_inputs(bits)
    logp = PEL.bit_length() - 1
    plane = jnp.asarray(stack[0])

    def one(y, x):
        sub = (x & (PEL - 1)) | ((y & (PEL - 1)) << logp)
        return jax.lax.dynamic_slice(plane, (sub, y >> logp, x >> logp),
                                     (1, BS, BS))[0].astype(jnp.int32)

    want = np.asarray(jax.vmap(one)(jnp.asarray(cy[0, :, 0]),
                                    jnp.asarray(cx[0, :, 0])))
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), BS, BS, PEL)
    np.testing.assert_array_equal(
        probe_ops.fetch_blocks(*args)[0, :, 0].numpy(), want)
    np.testing.assert_array_equal(
        probe_ops.fetch_blocks_tiled(*args, row_len=16,
                                     pitch_x=BS)[0, :, 0].numpy(), want)

