"""PyTorch port: the per-block probe's window before the stack against the JAX
package; split from test_torch_probe_block.py (whose docstring says how the
inputs are made) into a file of at most six tests, which pytest-xdist's
loadfile scheduling hands out after the suite's longest file."""
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
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_probe_block import (HEXAGON, _inputs)  # noqa: E402


@pytest.mark.parametrize("pel", [1, 2])
def test_probe_sads_window_before_the_stack_matches_jax(pel):
    """Windows that start left of or above the stack: the port takes the
    start the way the JAX package's window slice does (it wraps once round
    the plane, then the window is clamped inside it), bit for bit with
    probe_sads_xla, the JAX package's CPU path.  (The search bounds keep
    every candidate inside the padded stack; the JAX Pallas kernel run in
    interpret mode agrees as well: see
    test_torch_dct.py::test_fetch_and_probe_before_the_stack_match_pallas.)"""
    stack, cy, cx, src = _inputs(60 + pel, pel, 16, 2)
    cy[:, :, 0] = np.array([[-3, 5, -40, 2, 7, -1]])[:, :6] * pel + 1
    cx[:, :, 1] = np.array([[4, -9, -2, -35, 1, -1]])[:, :6] * pel
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), HEXAGON, 16, 16, pel).numpy()
    logp = pel.bit_length() - 1
    assert ((cy - 2 * pel) >> logp < 0).any() and ((cx - 2 * pel) >> logp < 0).any()
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), HEXAGON, 16, 16, pel))
        np.testing.assert_array_equal(got[j], want)

