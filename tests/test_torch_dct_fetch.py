"""PyTorch port: the per-block fetch's plain version against the JAX CPU path,
the cost keywords of every mode, and the fetch and probe of windows before
the stack against Pallas, split from test_torch_dct.py (whose docstring says
how its inputs are made) into a file of at most six tests, which pytest-
xdist's loadfile scheduling hands out after the suite's longest file."""
import os
import sys

from types import SimpleNamespace
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
from mvtools_tpu import field_engine as jax_fe
from mvtools_tpu.ops import probe as jax_probe
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.ops import probe as probe_ops
from test_torch_dct import (_fetch_inputs, _gray_specs,  # noqa: E402
                            port_analyse)


@pytest.mark.parametrize("edge", [False, True], ids=["inside", "past_edge"])
@pytest.mark.parametrize("pel", [1, 2])
def test_fetch_blocks_plain_matches_jax_cpu_path(pel, edge):
    """K5's plain version == the window slices of the JAX package's CPU
    path (FieldProber._fetch_ref_blocks), origins past the bottom or right
    edge included: both clamp the full-pel origin as a whole."""
    rng = np.random.default_rng(50 + pel + 2 * edge)
    stack, cy, cx = _fetch_inputs(rng, pel, edge=edge)
    got = probe_ops.fetch_blocks(torch.from_numpy(stack), torch.from_numpy(cy),
                                 torch.from_numpy(cx), 16, 8, pel)
    assert tuple(got.shape) == cy.shape + (16, 8)
    for j in range(stack.shape[0]):
        prober = SimpleNamespace(bs=(8, 16), pel=pel, logp=pel.bit_length() - 1,
                                 stack=jnp.asarray(stack[j]))
        want = jax_fe.FieldProber._fetch_ref_blocks(
            prober, jnp.asarray(cy[j]), jnp.asarray(cx[j]))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))
    if edge:
        hp, wp = stack.shape[-2:]
        logp = pel.bit_length() - 1
        assert ((cy >> logp) > hp - 16).any() and ((cx >> logp) > wp - 8).any()


def test_cost_keywords_cover_every_mode():
    """cost_keywords builds what each cost mode reads: the DCT of the
    source blocks for 1-4 only, their sums for the adaptive modes."""
    rng = np.random.default_rng(70)
    src = torch.from_numpy(rng.integers(0, 256, (2, 6, 8, 8), np.uint8))
    w16 = torch.zeros(2, dtype=torch.int32)
    for mode in range(11):
        kw = fe.cost_keywords(mode, src, w16, 8)
        assert kw["dctmode"] == mode and kw["dctweight16"] is w16
        assert (kw["dct_src"] is not None) == (1 <= mode <= 4)
        if mode in (3, 4, 7, 8, 10):
            assert torch.equal(kw["src_luma"], src.to(torch.int64).sum((-2, -1)))
        elif mode:
            assert not kw["src_luma"].any()
        else:
            assert kw["src_luma"] is None
    assert fe.map_supported(port_analyse._level_ctx(
        *_gray_specs(dct=2), 0), 7, 2)


def test_fetch_and_probe_before_the_stack_match_pallas(monkeypatch):
    """Origins and windows that start left of or above the stack: the
    port's per-block fetch (K5) and per-block probe (K4) take such a start
    the way the JAX package's Pallas kernels do when run in interpret mode,
    and the way its CPU path's window slice does: a negative start wraps
    once round the plane, then the window is clamped inside it."""
    pel = 2
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(jax_probe.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(45)
    stack, cy, cx = _fetch_inputs(rng, pel, nj=1, nblk=6, kk=1)
    cy[0, :, 0] = np.array([-2, -5, -17, 40, -1, 60], np.int32)
    cx[0, :, 0] = np.array([40, -3, -17, -6, -1, -19], np.int32)
    st, y, x = (torch.from_numpy(a) for a in (stack, cy, cx))
    got = probe_ops.fetch_blocks(st, y, x, 16, 16, pel)[0].numpy()
    want = np.asarray(jax_probe.fetch_blocks_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]), 16,
        16, pel, chunk=2))
    np.testing.assert_array_equal(got, want)
    offsets = ((0, 0), (1, -2), (-2, 3))
    src = rng.integers(0, 256, (1, 6, 16, 16), np.uint8)
    got = probe_ops.probe_sads(st, y, x, torch.from_numpy(src), offsets, 16,
                               16, pel)[0].numpy()
    want = np.asarray(jax_probe.probe_sads_pallas(
        jnp.asarray(stack[0]), jnp.asarray(cy[0]), jnp.asarray(cx[0]),
        jnp.asarray(src[0].astype(np.int32)), offsets, 16, 16, pel, chunk=2))
    np.testing.assert_array_equal(got, want)

