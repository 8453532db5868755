"""PyTorch port: the pel-4 subplanes (ops/interp.py: the Wiener planes and
the Average2 schedule between them, the last column and row left 0),
Super at pel 4 (gray 8-bit, YUV420 16-bit) and divide_extra (divide 1 and
2, with a job axis) against the JAX package on seeded inputs, tolerance
0."""
import os
import sys

import numpy as np
import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mvtools_tpu as mvt
from mvtools_tpu.core.config import SuperConfig as JSuperConfig
from mvtools_tpu.core.types import ColorFamily as JColorFamily
from mvtools_tpu.core.types import VideoFormat as JVideoFormat
from mvtools_tpu.ops import interp as jinterp
from mvtools_tpu_torch.analyse import divide_extra
from mvtools_tpu_torch.core.config import SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, MVPlaneField, VideoFormat
from mvtools_tpu_torch.ops import interp
from mvtools_tpu_torch.super import build_super


@pytest.mark.parametrize("bits", [8, 16])
def test_refine_subplanes_pel4(bits):
    import jax.numpy as jnp
    rng = np.random.default_rng(bits)
    plane = rng.integers(0, 1 << bits, (2, 40, 56)).astype(np.int32)
    for b in range(2):
        want = jinterp.refine_subplanes(jnp.asarray(plane[b]), 4, 2, bits)
        got = interp.refine_subplanes(torch.from_numpy(plane), 4, 2, bits)
        assert len(got) == 16
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g[b].numpy(), np.asarray(w)), i
    # the shifted averages leave the last column (3, 7, 11, 15) and the
    # last row (12-15) at 0
    assert all(int(got[i][..., -1].abs().sum()) == 0 for i in (3, 7, 11))
    assert int(got[13][..., -1, :].abs().sum()) == 0


@pytest.mark.parametrize("family,bits", [("GRAY", 8), ("YUV420", 16)])
def test_super_pel4(family, bits):
    import jax
    import jax.numpy as jnp
    w, h = 96, 64
    rng = np.random.default_rng(3)
    dtype = np.uint8 if bits == 8 else np.uint16
    shapes = [(h, w)] + ([(h // 2, w // 2)] * 2 if family != "GRAY" else [])
    planes = [rng.integers(0, 1 << bits, (2,) + s).astype(dtype)
              for s in shapes]
    jspec = JSuperConfig(pel=4, levels=0).validate(
        JVideoFormat(w, h, bits, getattr(JColorFamily, family)))
    spec = SuperConfig(pel=4, levels=0).validate(
        VideoFormat(w, h, bits, getattr(ColorFamily, family)))
    got = build_super([torch.from_numpy(p) for p in planes], spec)
    assert tuple(got.planes[0][0].shape[:2]) == (2, 16)
    # jitted: an eager pel-4 Super costs seconds of op dispatch a frame
    jbuild = jax.jit(lambda *f: mvt.build_super(list(f), jspec))
    for f in range(2):
        want = jbuild(*(jnp.asarray(p[f]) for p in planes))
        for p, (gp, wp) in enumerate(zip(got.planes, want.planes)):
            for lv, (g, wl) in enumerate(zip(gp, wp)):
                assert np.array_equal(g[f].numpy(), np.asarray(wl)), (p, lv)


@pytest.mark.parametrize("mode", [1, 2])
def test_divide_extra(mode):
    import jax.numpy as jnp
    from mvtools_tpu.analyse import divide_extra as jdivide
    rng = np.random.default_rng(mode)
    nby, nbx = 5, 7
    vx = rng.integers(-9, 10, (3, nby, nbx)).astype(np.int32)
    vy = rng.integers(-9, 10, (3, nby, nbx)).astype(np.int32)
    sad = rng.integers(0, 9000, (3, nby, nbx)).astype(np.int64)
    vx[1] = 4                      # a uniform job: the medians are inputs
    got = divide_extra(MVPlaneField(*(torch.from_numpy(a)
                                      for a in (vx, vy, sad))), mode)
    for j in range(3):
        want = jdivide(tuple(jnp.asarray(a[j].reshape(-1))
                             for a in (vx, vy, sad)), nbx, nby, mode)
        for g, w in zip((got.x, got.y, got.sad), want):
            assert np.array_equal(g[j].numpy(),
                                  np.asarray(w).reshape(2 * nby, 2 * nbx))
