"""PyTorch port: the three-stat tiled probe's plain version against the JAX
package, and FieldProber's masked check on the SATD costs; split from
test_torch_stats_kernels.py (whose docstring says how the inputs are made)
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
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu_torch.ops import probe as probe_ops
import torch_port_reference as tpr
from test_torch_stats_kernels import (HEXAGON, INVALID, RING,  # noqa: E402
                                      STATS)


@pytest.mark.parametrize("pel,bs,kk,offsets", [
    (2, 16, 1, HEXAGON),        # the rescue's hexagon, tile 8
    (2, 16, 1, ((0, 0),)),      # Recalculate's predictor cost
    (1, 16, 6, ((0, 0),)),      # six predictor candidates, tile 4
    (1, 8, 1, RING),
])
def test_probe_sads_tiled_stats_plain_matches_jax(pel, bs, kk, offsets):
    """Row length 6 is no multiple of the tile, so block rows are
    edge-padded; a tenth of the candidates is thrown off its tile and must
    come back as INVALID_SAD in all three stats on both sides."""
    rng = np.random.default_rng(60 + pel + kk + bs)
    nbx, nby, pad, hpad = 6, 3, 16, 16
    ph, pw = nby * bs + 2 * hpad, nbx * bs + 2 * hpad + 160
    nj = 2
    logp = pel.bit_length() - 1
    ref = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, nby * nbx, bs, bs), np.uint8)
    stack = probe_ops.pad_stack(torch.from_numpy(ref), pad)
    idx = np.arange(nby * nbx)
    base_y = (hpad + bs * (idx // nbx) + pad) << logp
    base_x = (hpad + bs * (idx % nbx) + pad) << logp
    vy = rng.integers(-5, 6, (nj, nby * nbx, kk))
    vx = rng.integers(-5, 6, (nj, nby * nbx, kk))
    far = rng.random((nj, nby * nbx, kk)) < 0.1
    vx = np.where(far, vx + 140 * pel, vx)
    vy = np.where(far, vy + 30 * pel, vy)
    cy = (base_y[None, :, None] + vy).astype(np.int32)
    cx = (base_x[None, :, None] + vx).astype(np.int32)
    args = (stack, torch.from_numpy(cy), torch.from_numpy(cx),
            torch.from_numpy(src), offsets, bs, bs, pel)
    got = probe_ops.probe_sads_tiled(*args, row_len=nbx, pitch_x=bs,
                                     stats=STATS).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets), 3)
    np.testing.assert_array_equal(
        got[..., 0],
        probe_ops.probe_sads_tiled(*args, row_len=nbx, pitch_x=bs).numpy())
    invalid = got[..., 0] == INVALID
    assert 0 < invalid.sum() < invalid.size
    assert (got[invalid] == INVALID).all()
    assert (got[~invalid] != INVALID).all()
    for j in range(nj):
        want = np.asarray(jax_probe.probe_sads_tiled(
            jnp.asarray(stack[j].numpy()), jnp.asarray(cy[j]),
            jnp.asarray(cx[j]), jnp.asarray(src[j].astype(np.int32)),
            offsets, bs, bs, pel, row_len=nbx, pitch_x=bs, stats=STATS))
        np.testing.assert_array_equal(got[j], want)


@pytest.mark.parametrize("dctmode", [5, 7])
def test_field_prober_check_with_a_mask_keeps_the_satd_state(dctmode):
    """With the SATD costs the masked check goes through the three-stat
    tiled probe (K2'), whose inactive entries report INVALID_SAD triples;
    the state equals the one the unmasked probes give.  Mode 7 mixes in the
    reference sums (the adaptive weight)."""
    tpr.check_masked_state("GRAY", dctmode, tpr.WALK, tpr.entry_mask)

