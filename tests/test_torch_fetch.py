"""PyTorch port: the tiled block fetch (kernel K3) against the JAX package
at origins inside and outside the plane, and the fetch kernel's launch
geometry.  The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.

The JAX package's Pallas tiled fetch (fetch_blocks_tiled_pallas) is run in
interpret mode, the way its own tests run Pallas kernels off the TPU, once
for the whole module: one row of 16 blocks (two tiles of FETCH_TILE) on a
stack larger than the tile window, so the tiled kernel runs and not its
hand-over.  Inputs are made with numpy from a seed; every comparison is
exact (tolerance 0: integers).

Some of its checks live in test_torch_fetch_{pallas,geom,geom2,geom3}.py,
files of at most six tests that pytest-xdist's loadfile scheduling hands out
after the suite's longest file."""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu  # noqa: F401  (enables x64)
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch.ops import probe as probe_ops

PEL, BS, H, W = 2, 16, 96, 640
# full-pel origins (row, column) of the 16 blocks; the tile anchors come
# from blocks 0, 4, 7 and 8, 12, 15, which sit inside the plane
_ORIGINS = {
    0: (30, 20), 1: (-3, 36), 2: (30, -5), 3: (101, 68), 4: (30, 84),
    5: (30, 630), 6: (2, 116), 7: (30, 132),
    8: (30, 300), 9: (30, 40), 10: (75, 332), 11: (-20, -30),
    12: (30, 364), 13: (30, 600), 14: (85, 630), 15: (30, 412),
}
_FALLBACK = ("the Pallas kernel fetches a block off its tile window through "
             "a private window aligned down to 8 rows and 128 columns, "
             "which the window slice clamps into the plane as a whole; the "
             "block then lies where that aligned window landed, not at the "
             "origin clamped into the plane (ROADMAP Q3-9: no caller of "
             "either package reaches such an origin)")
CASES = {
    # inside the tile window: the tiled kernel's own window
    "in_tile": ((0, 4, 7, 8, 12, 15), None),
    # off the tile window, inside the plane, the fallback window unclamped
    "fallback_in_plane": ((6, 9), None),
    # off the tile window within one fallback window of the bottom/right
    # edge, though inside the plane
    "fallback_near_bottom": ((10,), _FALLBACK),
    "fallback_near_right": ((13,), _FALLBACK),
    "above": ((1,), _FALLBACK),
    "left": ((2,), _FALLBACK),
    "below": ((3,), _FALLBACK),
    "right": ((5,), _FALLBACK),
    "corners": ((11, 14), _FALLBACK),
}


def _inputs():
    rng = np.random.default_rng(69)
    stack = rng.integers(0, 256, (1, PEL * PEL, H, W), np.uint8)
    fy = np.array([_ORIGINS[b][0] for b in range(16)])
    fx = np.array([_ORIGINS[b][1] for b in range(16)])
    cy = (fy * PEL + rng.integers(0, PEL, 16)).astype(np.int32)
    cx = (fx * PEL + rng.integers(0, PEL, 16)).astype(np.int32)
    return stack, cy[None, :, None], cx[None, :, None]


@pytest.fixture(scope="module")
def fetched(monkeypatch_module):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch_module.setattr(
        jax_probe.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    stack, cy, cx = _inputs()
    wy_total, wx_total, center_y, center_x = jax_probe.tile_params(
        ((0, 0),), BS, BS, PEL, probe_ops.FETCH_TILE, BS)
    assert (H, W) >= (wy_total, wx_total) and W > wx_total
    pallas = np.asarray(jax_probe.fetch_blocks_tiled_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]), BS,
        BS, PEL, probe_ops.FETCH_TILE, wy_total, wx_total, center_y,
        center_x))
    port = probe_ops.fetch_blocks_tiled(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        BS, BS, PEL, row_len=16, pitch_x=BS)[0].numpy()
    return stack, cy[0, :, 0], cx[0, :, 0], pallas, port


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def case_params(names):
    """The cases `names` of CASES as parameters, strict-xfail where the
    Pallas kernel's fallback window differs."""
    return [pytest.param(name, marks=[] if CASES[name][1] is None
                         else pytest.mark.xfail(strict=True,
                                                reason=CASES[name][1]))
            for name in names]


def check_case(fetched, case):
    _, _, _, pallas, port = fetched
    for b in CASES[case][0]:
        np.testing.assert_array_equal(port[b], pallas[b], err_msg=f"block {b}")


@pytest.mark.parametrize("case", case_params(list(CASES)[:5]))
def test_tiled_fetch_matches_pallas(fetched, case):
    """The port's tiled fetch (its plain version on the CPU, the contract
    of K3) == the JAX package's Pallas tiled fetch run in interpret mode,
    for the blocks of one case (the other cases:
    test_torch_fetch_pallas.py)."""
    check_case(fetched, case)


def test_tiled_fetch_takes_the_window_slice_everywhere(fetched):
    """At every one of those origins the port's tiled fetch is the JAX
    package's CPU fetch, a window slice (lax.dynamic_slice: a negative start
    wraps once round the plane, then the window is clamped inside it), and
    the per-block fetch (K5) computes the same function."""
    stack, cy, cx, _, port = fetched
    logp = PEL.bit_length() - 1
    plane = jnp.asarray(stack[0])

    def one(y, x):
        sub = (x & (PEL - 1)) | ((y & (PEL - 1)) << logp)
        return jax.lax.dynamic_slice(plane, (sub, y >> logp, x >> logp),
                                     (1, BS, BS))[0].astype(jnp.int32)

    want = np.asarray(jax.vmap(one)(jnp.asarray(cy), jnp.asarray(cx)))
    np.testing.assert_array_equal(port[:, 0], want)
    per_block = probe_ops.fetch_blocks(
        torch.from_numpy(stack), torch.from_numpy(cy[None, :, None]),
        torch.from_numpy(cx[None, :, None]), BS, BS, PEL)[0].numpy()
    np.testing.assert_array_equal(per_block, port)


