"""PyTorch port: the plain version of the per-block probe (kernel K4)
against the JAX package's probe_sads_xla on the CPU, bit for bit, with
candidates at and past the edges of the padded stack; plus the wrapper's
argument checks and the tiled probe's hand-over of small planes.  The CUDA
kernel itself is held against this plain version on the card by
chip_smoke.py.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers).

Some of its checks live in test_torch_probe_block_{checks,edge}.py, files of
at most six tests that pytest-xdist's loadfile scheduling hands out after
the suite's longest file."""
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
import mvtools_tpu  # noqa: F401  (enables x64)
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch.ops import probe as probe_ops

HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
RING = ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1))
WALK = ((-1, -2), (-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2),
        (-2, 0))
# the chroma delta grid that goes with the 8-entry walk at 2x subsampling
GRID16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))


def _inputs(seed, pel, bs, kk, nj=2, nbx=3, nby=2, pad=8, hpad=8):
    """Stack, candidates and source blocks of a small level.  Candidates
    spread a few pixels round each block; four of them sit at the corners
    of the stack or past its bottom/right edges, where the window has to be
    shifted in.  (Window starts left of or above the stack are left out:
    there the JAX slice wraps round Python-style while the port clamps, and
    the search bounds keep every candidate away from it.)"""
    rng = np.random.default_rng(seed)
    logp = pel.bit_length() - 1
    ph = nby * bs + 2 * (hpad + pad)
    pw = nbx * bs + 2 * (hpad + pad) + 24
    stack = rng.integers(0, 256, (nj, pel * pel, ph, pw), np.uint8)
    src = rng.integers(0, 256, (nj, nby * nbx, bs, bs), np.uint8)
    idx = np.arange(nby * nbx)
    base_y = (hpad + pad + bs * (idx // nbx)) << logp
    base_x = (hpad + pad + bs * (idx % nbx)) << logp
    lim = (hpad + pad) * pel
    cy = base_y[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    cx = base_x[None, :, None] + rng.integers(-lim, lim + 1,
                                              (nj, nby * nbx, kk))
    far_y, far_x = (ph - bs) << logp, (pw - bs) << logp
    cy = np.maximum(cy, 2 * pel)      # the offset sets reach 2 pel up/left
    cx = np.maximum(cx, 2 * pel)
    cy[0, 0, 0], cx[0, 0, 0] = 2 * pel, 2 * pel       # window at the origin
    cy[0, 1, 0], cx[0, 1, 0] = far_y, far_x           # bottom-right corner
    cy[1, 0, 0], cx[1, 0, 0] = 2 * pel, far_x + 5 * pel    # past the right
    cy[1, 1, 0], cx[1, 1, 0] = far_y + 4 * pel, 3 * pel    # past the bottom
    return stack, cy.astype(np.int32), cx.astype(np.int32), src


PLAIN_CASES = [
    (1, 16, 1, HEXAGON),
    (1, 16, 1, RING),
    (1, 16, 6, ((0, 0),)),
    (1, 8, 1, GRID16),
    (1, 8, 6, ((0, 0),)),
    (2, 16, 1, WALK),
    (2, 8, 1, HEXAGON),
    (2, 16, 6, ((0, 0),)),
]
PLAIN_IDS = ["p1-b16-hex", "p1-b16-ring", "p1-b16-k6", "p1-b8-grid16",
             "p1-b8-k6", "p2-b16-walk", "p2-b8-hex", "p2-b16-k6"]


@pytest.mark.parametrize("pel,bs,kk,offsets", PLAIN_CASES[:6],
                         ids=PLAIN_IDS[:6])
def test_probe_sads_plain_matches_jax(pel, bs, kk, offsets):
    """K4's plain version against the JAX package (the other cases:
    test_torch_probe_block_checks.py)."""
    check_probe_sads_plain(pel, bs, kk, offsets)


def check_probe_sads_plain(pel, bs, kk, offsets):
    stack, cy, cx, src = _inputs(40 + pel + bs + kk, pel, bs, kk)
    got = probe_ops.probe_sads(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), offsets, bs, bs, pel).numpy()
    assert got.dtype == np.int32
    assert got.shape == cy.shape + (len(offsets),)
    for j in range(stack.shape[0]):
        want = np.asarray(jax_probe.probe_sads_xla(
            jnp.asarray(stack[j]), jnp.asarray(cy[j]), jnp.asarray(cx[j]),
            jnp.asarray(src[j].astype(np.int32)), offsets, bs, bs, pel))
        np.testing.assert_array_equal(got[j], want)


