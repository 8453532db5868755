"""PyTorch port: the per-block probe's plain version inside the stack, its
hand-over from the tiled probe, its argument checks and launch count; split
from test_torch_probe_block.py (whose docstring says how the inputs are
made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
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
from test_torch_probe_block import (HEXAGON, RING, _inputs)  # noqa: E402
from test_torch_probe_block import (PLAIN_CASES, PLAIN_IDS,  # noqa: E402
                                  check_probe_sads_plain)


def test_probe_sads_inside_the_stack_is_the_plain_block_sad():
    """Away from the edges the window rule is the identity: the SAD is that
    of the block at the candidate's own subplane and full-pel origin."""
    pel, bs = 2, 8
    stack, cy, cx, src = _inputs(3, pel, bs, 1)
    cy, cx = cy[:, 2:], cx[:, 2:]                     # drop the edge cases
    src = src[:, 2:]
    cy = np.clip(cy, 4 * pel, None)
    cx = np.clip(cx, 4 * pel, None)
    got = probe_ops.probe_sads_plain(
        torch.from_numpy(stack), torch.from_numpy(cy), torch.from_numpy(cx),
        torch.from_numpy(src), HEXAGON, bs, bs, pel).numpy()
    for j, b, d in ((0, 0, 0), (1, 3, 5), (0, 2, 2)):
        ay, ax = cy[j, b, 0] + HEXAGON[d][1], cx[j, b, 0] + HEXAGON[d][0]
        sub = (ax & 1) | ((ay & 1) << 1)
        blk = stack[j, sub, ay >> 1:(ay >> 1) + bs, ax >> 1:(ax >> 1) + bs]
        want = np.abs(blk.astype(np.int64) - src[j, b].astype(np.int64)).sum()
        assert got[j, b, 0, d] == want


def test_tiled_probe_hands_small_planes_to_the_block_probe():
    """Same condition as the JAX package: a stack under the tile window
    goes to the per-block probe, so no entry is INVALID_SAD."""
    pel, bs, kk = 1, 8, 1
    stack, cy, cx, src = _inputs(5, pel, bs, kk)
    wy_t, wx_t, _, _ = probe_ops.tile_params(RING, bs, bs, pel, 8, 4)
    assert stack.shape[-1] < wx_t
    args = (torch.from_numpy(stack), torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(src), RING, bs, bs, pel)
    got = probe_ops.probe_sads_tiled(*args, row_len=3, pitch_x=4)
    assert torch.equal(got, probe_ops.probe_sads_plain(*args))
    assert int((got == probe_ops.INVALID_SAD).sum()) == 0
    want = np.asarray(jax_probe.probe_sads_tiled(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        jnp.asarray(src[0].astype(np.int32)), RING, bs, bs, pel, row_len=3,
        pitch_x=4))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_probe_sads_checks_its_arguments():
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _inputs(6, 1, 8, 1))
    ok = (stack, cy, cx, src, RING, 8, 8, 1)
    assert probe_ops.probe_sads(*ok).shape == (2, 6, 1, 8)
    with pytest.raises(NotImplementedError, match="8-bit"):
        probe_ops.probe_sads(stack.to(torch.int16), *ok[1:])
    with pytest.raises(ValueError, match="pel"):
        probe_ops.probe_sads(*ok[:7], 3)
    with pytest.raises(ValueError, match="cand_y"):
        probe_ops.probe_sads(stack, cy.to(torch.int64), *ok[2:])
    with pytest.raises(ValueError, match="inconsistent"):
        probe_ops.probe_sads(stack, cy, cx, src[:, :5].contiguous(),
                             *ok[4:])
    with pytest.raises(ValueError, match="inconsistent"):
        probe_ops.probe_sads(*ok[:7], 2)              # stack has 1 subplane


def test_probe_sads_counts_launches_only_on_the_card():
    """On the CPU the wrapper takes the plain version and counts no launch;
    the plain version counts itself only when it is run on a CUDA tensor."""
    stack, cy, cx, src = (torch.from_numpy(a)
                          for a in _inputs(7, 1, 8, 1))
    before = dict(probe_ops.launches), probe_ops.plain_calls_on_cuda
    probe_ops.probe_sads(stack, cy, cx, src, RING, 8, 8, 1)
    assert (dict(probe_ops.launches), probe_ops.plain_calls_on_cuda) == before
    assert "probe_sads" in probe_ops.launches


@pytest.mark.parametrize("pel,bs,kk,offsets", PLAIN_CASES[6:],
                         ids=PLAIN_IDS[6:])
def test_probe_sads_plain_matches_jax(pel, bs, kk, offsets):
    """The other cases of test_torch_probe_block.py's check."""
    check_probe_sads_plain(pel, bs, kk, offsets)
