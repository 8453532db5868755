"""PyTorch port: the SATD block cost and the SATD cost mix (dct 5-10)
against the JAX package on the CPU, bit for bit; and Analyse with dct 6 on a
pair whose brightness changes, so that the mix's per-job weight is not 0.

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
import mvtools_tpu as mvt  # (enables x64)
from mvtools_tpu.analyse import mix_satd_cost as jax_mix_satd_cost
from mvtools_tpu.core import config as jax_config, types as jax_types
from mvtools_tpu.ops import sad as jax_sad

from mvtools_tpu_torch import analyse_batch
from mvtools_tpu_torch.analyse import (_level_ctx, _level_plan,
                                       mix_satd_cost, search_level_lockstep)
from mvtools_tpu_torch.core import config as port_config, types as port_types
from mvtools_tpu_torch.ops import sad as sad_ops
from mvtools_tpu_torch.super import build_super

SIZES = [(4, 4), (8, 4), (8, 8), (16, 8), (16, 16), (32, 16), (32, 32)]


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


# ---------------------------------------------------------------------------
# dctweight16 > 0: Analyse with dct 6 on a pair whose brightness differs


def test_analyse_dct6_with_a_brightness_change_matches_jax():
    """Mode 6 mixes SATD into the SAD by dctweight16 = min(16, |mean luma
    change of the coarsest level| / block area), which is 0 on a calm pair.
    Job 0's reference frame is 6 brighter than its source, job 1's is not:
    the weight is per job, and both jobs must come out as the JAX package's
    analyse() gives them one at a time."""
    w, h, levels = 128, 96, 2
    rng = np.random.default_rng(77)
    base = rng.integers(0, 230, (h + 8, w + 8)).astype(np.uint8)
    f0 = base[:h, :w]
    f1 = base[1:h + 1, 2:w + 2]
    grain = rng.integers(-3, 4, (h, w))
    frames = np.stack([
        f0, np.clip(f1.astype(np.int64) + grain + 6, 0, 255).astype(np.uint8),
        np.clip(f1.astype(np.int64) + grain, 0, 255).astype(np.uint8)])

    def specs(config, types):
        fmt = types.VideoFormat(w, h, 8, types.ColorFamily.GRAY)
        sspec = config.SuperConfig(pel=2, levels=levels,
                                   chroma=False).validate(fmt)
        return sspec, config.AnalyseConfig(
            blksize=16, levels=levels, chroma=False, truemotion=True,
            dct=6).validate(sspec)

    sspec_j, aspec_j = specs(jax_config, jax_types)
    sups_j = [mvt.build_super([jnp.asarray(f)], sspec_j) for f in frames]
    want = [mvt.analyse(sups_j[0], sups_j[r], aspec_j, engine="lockstep")
            for r in (1, 2)]

    sspec, aspec = specs(port_config, port_types)
    sups = build_super([torch.from_numpy(frames)], sspec)
    got = analyse_batch(sups.map(lambda a: a[[0, 0]]),
                        sups.map(lambda a: a[[1, 2]]), aspec)
    for lv in range(levels):
        for key in ("x", "y", "sad"):
            for j in (0, 1):
                np.testing.assert_array_equal(
                    getattr(got.levels[lv], key)[j].numpy(),
                    np.asarray(getattr(want[j].levels[lv], key)))
    # the weight the finest level saw: 5 or 6 for job 0, 0 for job 1
    ctx = _level_ctx(sspec, aspec, 1, sups.map(lambda a: a[[0, 0]]),
                     sups.map(lambda a: a[[1, 2]]))
    nblk = ctx.nblk[0] * ctx.nblk[1]
    zero = torch.zeros((2, nblk), dtype=torch.int32)
    _, mlc = search_level_lockstep(
        ctx, _level_plan(aspec, 1), (zero, zero, zero.to(torch.int64)),
        (torch.zeros(2, dtype=torch.int32),) * 2,
        torch.zeros(2, dtype=torch.int32))
    w16 = (mlc.abs() // 256).tolist()
    assert w16[0] in (5, 6) and w16[1] == 0
    # and the mix changed job 0's costs: its SADs are not the dct 0 ones
    plain = analyse_batch(
        sups.map(lambda a: a[[0, 0]]), sups.map(lambda a: a[[1, 2]]),
        port_config.AnalyseConfig(blksize=16, levels=levels, chroma=False,
                         truemotion=True).validate(sspec))
    assert not torch.equal(plain.levels[0].sad[0], got.levels[0].sad[0])
    assert torch.equal(plain.levels[0].sad[1], got.levels[0].sad[1])
