"""PyTorch port: the DCT cost mix (one job weight), the per-block fetch's plain
version against the Pallas kernel in interpret mode, and the tiled fetch's
hand-over, split from test_torch_dct.py (whose docstring says how its inputs
are made) into a file of at most six tests, which pytest-xdist's loadfile
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
import mvtools_tpu as mvt  # (enables x64)
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu_torch.analyse import mix_dct_cost, mix_dct_cost_sums
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_dct import (_fetch_inputs, _mix_inputs,  # noqa: E402
                            jax_analyse)


@pytest.mark.parametrize("w16", [0])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_mix_dct_cost_matches_jax(mode, w16):
    """mix_dct_cost and mix_dct_cost_sums against the JAX package, per job
    weight [J] (the second job's one lower); modes 3 and 4 with their switch
    both on and off.  The weight 16: test_torch_dct_mix16.py."""
    check_mix_dct_cost(mode, w16)


def check_mix_dct_cost(mode, w16):
    rng = np.random.default_rng(10 * mode + w16)
    s, dct_src, dct_ref, src_l, ref_l = _mix_inputs(mode, rng)
    w = np.array([w16, max(w16 - 1, 0)], np.int32)
    t = torch.from_numpy
    got = mix_dct_cost(mode, t(s), t(dct_src), t(dct_ref), t(src_l), t(ref_l),
                       t(w)[:, None], 8)
    ds = np.abs(dct_src - dct_ref).sum(axis=(-2, -1))
    dc = np.abs(dct_src[..., 0, 0] - dct_ref[..., 0, 0])
    got_sums = mix_dct_cost_sums(mode, t(s), t(ds), t(dc), t(src_l), t(ref_l),
                                 t(w)[:, None], 8)
    assert got.dtype == got_sums.dtype == torch.int64
    for j in range(2):
        want = np.asarray(jax_analyse.mix_dct_cost(
            mode, jnp.asarray(s[j]), jnp.asarray(dct_src[j]),
            jnp.asarray(dct_ref[j]), jnp.asarray(src_l[j]),
            jnp.asarray(ref_l[j]), jnp.int32(w[j]), 8))
        np.testing.assert_array_equal(got[j].numpy(), want)
        want_sums = np.asarray(jax_analyse.mix_dct_cost_sums(
            mode, jnp.asarray(s[j]), jnp.asarray(ds[j]), jnp.asarray(dc[j]),
            jnp.asarray(src_l[j]), jnp.asarray(ref_l[j]), jnp.int32(w[j]), 8))
        np.testing.assert_array_equal(got_sums[j].numpy(), want_sums)
    if mode in (3, 4):
        adapt = np.abs(src_l - ref_l) > ((src_l + ref_l) >> 5)
        assert adapt.any() and not adapt.all()
        np.testing.assert_array_equal(got.numpy()[~adapt], s[~adapt])
    if mode == 2 and w16 == 0:
        np.testing.assert_array_equal(got[0].numpy(), s[0])
    with pytest.raises(ValueError, match="dctmode"):
        mix_dct_cost_sums(5, t(s), t(ds), t(dc), None, None, None, 8)


def test_fetch_blocks_plain_matches_jax_fetch_kernel(monkeypatch):
    """K5's plain version == the JAX package's Pallas fetch kernel run in
    interpret mode (a frame-batched launch, pel 2: the subplane follows each
    candidate's parity) on candidates whose window lies inside the stack."""
    pel = 2
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(40 + pel)
    stack, cy, cx = _fetch_inputs(rng, pel, nblk=6, kk=2)
    got = probe_ops.fetch_blocks(torch.from_numpy(stack), torch.from_numpy(cy),
                                 torch.from_numpy(cx), 16, 16, pel)
    want = np.asarray(jax_probe.fetch_blocks_pallas(
        jnp.asarray(stack), jnp.asarray(cy), jnp.asarray(cx), 16, 16, pel))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_fetch_blocks_tiled_hands_small_stacks_to_fetch_blocks():
    """A stack under the tiled fetch's window goes to fetch_blocks (the
    origin clamped as a whole); a wide one stays with the tiled fetch."""
    rng = np.random.default_rng(60)
    calls = []
    plain = probe_ops.fetch_blocks_plain
    try:
        probe_ops.fetch_blocks_plain = lambda *a: calls.append(1) or plain(*a)
        for pw, handed in ((40, True), (160, False)):
            stack, cy, cx = _fetch_inputs(rng, 2, nblk=6, ph=40, pw=pw)
            calls.clear()
            args = (torch.from_numpy(stack), torch.from_numpy(cy),
                    torch.from_numpy(cx), 16, 16, 2)
            got = probe_ops.fetch_blocks_tiled(*args, row_len=3, pitch_x=16)
            assert bool(calls) == handed
            assert torch.equal(got, plain(*args))
        wy, wx = probe_ops.tile_params(((0, 0),), 16, 16, 2,
                                       probe_ops.FETCH_TILE, 16)[:2]
        assert (wy, wx) == jax_probe.tile_params(((0, 0),), 16, 16, 2, 8,
                                                 16)[:2]
        assert stack.shape[-1] >= wx > 40 + 32 + 384
    finally:
        probe_ops.fetch_blocks_plain = plain

