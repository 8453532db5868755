"""PyTorch port: the three-stat per-block probe's plain version against the JAX
package, and K2''s launch geometry for every SATD block size; split from
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
from test_torch_stats_kernels import (HEXAGON, INVALID, RING,  # noqa: E402
                                      STATS, _block_probe_inputs)


@pytest.mark.parametrize("pel,bs,kk,offsets", [
    (1, 16, 1, HEXAGON),
    (1, 16, 6, ((0, 0),)),
    (2, 8, 1, RING),
    (2, 16, 1, ((0, 0),)),
], ids=["p1-b16-hex", "p1-b16-k6", "p2-b8-ring", "p2-b16-one"])
def test_probe_sads_stats_plain_matches_jax(pel, bs, kk, offsets):
    stack, cy, cx, src = _block_probe_inputs(70 + pel + bs + kk, pel, bs, kk)
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), offsets, bs, bs, pel)
    got = probe_ops.probe_sads(*args, stats=STATS).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets), 3)
    np.testing.assert_array_equal(got[..., 0],
                                  probe_ops.probe_sads(*args).numpy())
    assert (got != INVALID).all()
    # the tiled wrapper hands a stack under its window to this probe
    np.testing.assert_array_equal(
        probe_ops.probe_sads_tiled(*args, row_len=3, pitch_x=bs,
                                   stats=STATS).numpy(), got)
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel,
            stats=STATS))
        np.testing.assert_array_equal(got[j], want)


def test_probe3_launch_geom_covers_every_satd_size():
    """The three-stat tiled probe kernel's launch geometry
    (ops/probe.py::probe3_launch_geom): every block size the SATD admits
    gets lanes an offset that divide a warp, and a lane's tiles in
    registers (tpl) where they are g * tpl, the generic body (tpl 0, 32
    lanes) elsewhere; a warp's candidates share its offset slots, the most
    that fit a power of two."""
    from mvtools_tpu_torch.core.config import _VALID_BLOCK_SIZES
    from mvtools_tpu_torch.ops import sad as sad_ops
    sizes = sorted((bw, bh) for bw, bh in _VALID_BLOCK_SIZES
                   if sad_ops.satd_supported(bw, bh))
    assert len(sizes) == 11
    for bw, bh in sizes:
        g = probe_ops.probe3_launch_geom(bh, bw, 6)
        n = (bh // 4) * (bw // 4)
        assert g["g"] in (1, 2, 4, 8, 16, 32) and 32 % g["g"] == 0
        if g["tpl"]:
            assert g["tpl"] in probe_ops.PROBE3_TPL and g["g"] * g["tpl"] == n
        else:
            assert g["g"] == 32 and n > 32 * max(probe_ops.PROBE3_TPL)
        for d in (1, 2, 3, 6, 8, 16, 32, 49):
            c = probe_ops.probe3_launch_geom(bh, bw, d)["cpw"]
            slots = 32 // g["g"]
            assert c & (c - 1) == 0 and (c == 1 or c * d <= slots)
            assert 2 * c * d > slots

