"""PyTorch port: Recalculate against the JAX package's
recalculate(engine="lockstep") on the CPU, bit for bit: the interpolation
of the old field onto the new grid, the configuration and the refusals.
The refined field's x / y / sad with dct 0, 5 and 7 on a clip that leaves
blocks on both sides of thsad, against one cached JAX run
(torch_port_reference.load_recalc), are in
test_torch_recalculate_{fields,exhaustive,thsad,chroma}.py: files that wait
for a JAX reference hold at most six tests, so that pytest-xdist hands them
out after the suite's longest file.  Inputs are made with numpy from a
seed; every comparison is assert_array_equal (tolerance 0 — the pipeline is
integer).

Some of its checks live in test_torch_recalculate_refusals{,2}.py, files of
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
from mvtools_tpu import recalculate as jax_recalc
from mvtools_tpu.core import config as jax_config, types as jax_types

from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, MVPlaneField, VideoFormat
from mvtools_tpu_torch.recalculate import _interpolate_old_vectors

import torch_port_reference as tpr

W, H, PEL = tpr.RC_W, tpr.RC_H, tpr.RC_PEL


def _specs(pkg_config, pkg_types):
    """(sspec, old 16x16 overlap-0 AnalyseSpec) in either package."""
    return tpr.recalc_specs(pkg_config, pkg_types)


@pytest.mark.parametrize("smooth", [0, 1])
@pytest.mark.parametrize("new", [dict(blksize=16, overlap=8),
                                 dict(blksize=8, overlap=0),
                                 dict(blksize=32, blksizev=16, overlap=8,
                                      overlapv=4)],
                         ids=["16ov8", "8ov0", "32x16ov8x4"])
def test_interpolate_old_vectors_matches_jax(new, smooth):
    """Old 16x16 overlap 0 at pel 2 onto three new grids: negative and large
    vectors, SADs up to 2^40 (the bilinear form's SAD runs in 64 bits),
    indices clamped at the old grid's edge."""
    rng = np.random.default_rng(30 + smooth)
    sspec_j, old_j = _specs(jax_config, jax_types)
    new_j = jax_config.AnalyseConfig(levels=1, chroma=False,
                                     **new).validate(sspec_j)
    nby, nbx = old_j.meta.blk_y, old_j.meta.blk_x
    x = rng.integers(-300, 301, (2, nby, nbx)).astype(np.int32)
    y = rng.integers(-300, 301, (2, nby, nbx)).astype(np.int32)
    sad = rng.integers(0, 2 ** 40, (2, nby, nbx)).astype(np.int64)
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=PEL, levels=1, chroma=False).validate(fmt)
    old_meta = AnalyseConfig(blksize=16, levels=1,
                             chroma=False).validate(sspec).meta
    new_meta = AnalyseConfig(levels=1, chroma=False,
                             **new).validate(sspec).meta
    for log_pel in (1, 0):
        got = _interpolate_old_vectors(
            MVPlaneField(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(sad)), old_meta, new_meta, smooth,
            log_pel)
        assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                          torch.int64]
        for j in range(2):
            want = jax_recalc._interpolate_old_vectors(
                jax_types.MVPlaneField(jnp.asarray(x[j]), jnp.asarray(y[j]),
                                       jnp.asarray(sad[j])),
                old_j.meta, new_j.meta, smooth, log_pel)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[j].numpy(), np.asarray(w))


