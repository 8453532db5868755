"""PyTorch port: the SATD block cost and the SATD cost mix (dct 5-10)
against the JAX package on the CPU, bit for bit (Analyse with dct 6 on a
pair whose brightness changes: test_torch_satd_dct6.py).

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — integers)."""
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
from mvtools_tpu.analyse import mix_satd_cost as jax_mix_satd_cost
from mvtools_tpu.ops import sad as jax_sad

from mvtools_tpu_torch.analyse import mix_satd_cost
from mvtools_tpu_torch.ops import sad as sad_ops

import torch_port_reference as tpr

SIZES = [(4, 4), (8, 4), (8, 8), (16, 8), (16, 16), (32, 16), (32, 32)]


@pytest.fixture(scope="module", autouse=True)
def _references_ahead():
    """Under pytest-xdist, start making the JAX references that the port's
    slice tests compare with (torch_port_reference._prefetch) as this file
    starts: pytest-xdist hands it out in its first round, and the files
    that need the references, which hold at most six tests each, last."""
    tpr._prefetch()


@pytest.mark.parametrize("bw,bh", SIZES)
def test_satd_matches_jax_on_noise(bw, bh):
    """Noise, not smooth data, so that every coefficient of every tile
    counts."""
    rng = np.random.default_rng(100 + bw + bh)
    src = rng.integers(0, 256, (3, 5, bh, bw), np.uint8)
    ref = rng.integers(0, 256, (3, 5, bh, bw), np.uint8)
    got = sad_ops.satd(torch.from_numpy(src), torch.from_numpy(ref))
    want = np.asarray(jax_sad.satd(jnp.asarray(src), jnp.asarray(ref)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_satd_broadcasts_and_takes_int32_blocks():
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, (4, 1, 16, 16)).astype(np.int32)
    ref = rng.integers(0, 256, (4, 6, 16, 16)).astype(np.int32)
    got = sad_ops.satd(torch.from_numpy(src), torch.from_numpy(ref))
    want = np.asarray(jax_sad.satd(jnp.asarray(np.broadcast_to(src, ref.shape)),
                                   jnp.asarray(ref)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(sad_ops.satd(torch.from_numpy(ref), torch.from_numpy(ref))
               .abs().max()) == 0


@pytest.mark.parametrize("bw,bh", SIZES + [(16, 2), (4, 8), (12, 8), (64, 32)])
def test_satd_supported_matches_jax(bw, bh):
    assert sad_ops.satd_supported(bw, bh) == jax_sad.satd_supported(bw, bh)
    if not sad_ops.satd_supported(bw, bh):
        z = torch.zeros((bh, bw), dtype=torch.uint8)
        with pytest.raises(ValueError, match="SATD unsupported"):
            sad_ops.satd(z, z)


@pytest.mark.parametrize("w16", [0, 1, 2, 8, 16])
@pytest.mark.parametrize("mode", [5, 6, 7, 8, 9, 10])
def test_mix_satd_cost_matches_jax(mode, w16):
    """Luma pairs on both sides of the adaptive modes' switch
    (|src - ref| > (src + ref) >> 5, >> 4 for mode 10), SADs up to the
    INVALID_SAD sentinel, and a per-job weight."""
    rng = np.random.default_rng(10 * mode + w16)
    nj, n = 2, 400
    s = rng.integers(0, 70000, (nj, n))
    satd_v = rng.integers(0, 300000, (nj, n))
    s[:, -1] = satd_v[:, -1] = 2 ** 31 - 1
    src_l = rng.integers(0, 65281, (nj, n))
    # differences from well under to well over a 32nd / a 16th of the sum
    ref_l = np.clip(src_l + rng.integers(-1, 2, (nj, n))
                    * (src_l >> rng.integers(2, 8, (nj, n))), 0, 65280)
    ref_l[:, -1] = 2 ** 31 - 1
    w = np.array([w16, max(w16 - 1, 0)], np.int32)
    got = mix_satd_cost(mode, torch.from_numpy(s).to(torch.int32),
                        torch.from_numpy(satd_v).to(torch.int32),
                        torch.from_numpy(src_l), torch.from_numpy(ref_l),
                        torch.from_numpy(w)[:, None])
    assert got.dtype == torch.int64
    for j in range(nj):
        want = np.asarray(jax_mix_satd_cost(
            mode, jnp.asarray(s[j].astype(np.int32)),
            jnp.asarray(satd_v[j].astype(np.int32)), jnp.asarray(src_l[j]),
            jnp.asarray(ref_l[j]), jnp.int32(w[j])))
        np.testing.assert_array_equal(got[j].numpy(), want)
    if mode in (7, 8, 10):
        sh = 4 if mode == 10 else 5
        adapt = np.abs(src_l - ref_l) > ((src_l + ref_l) >> sh)
        assert adapt.any() and not adapt.all()
    if mode == 6 and w16 == 0 or mode == 9 and w16 <= 1:
        np.testing.assert_array_equal(got[0].numpy(), s[0])


def test_mix_satd_cost_rejects_other_modes():
    z = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="dctmode"):
        mix_satd_cost(3, z, z, z, z, z)
