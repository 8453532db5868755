"""PyTorch port: the YUV420 slice against one cached run of the JAX package
(torch_port_reference.load_yuv): the probe-based and map-based field probers,
and overlapped three-plane Degrain (split out of test_torch_yuv_slice.py:
files that wait for a JAX reference hold at most six tests, so that
pytest-xdist hands them out after the suite's longest file).

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
import os
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _level_ctx
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_yuv(tmp_path_factory)


@pytest.fixture(scope="module")
def port_run(ref):
    """The port's own supers and its analyse_batch over the jobs of both
    directions, with every per-block probe call noted."""
    return tpr.yuv_port_run(ref)


@pytest.fixture(scope="module")
def degrain_run(ref, port_run):
    """Overlapped three-plane Degrain2, batched over the clip's frames, on
    the JAX side's vectors, clip-edge validity included."""
    return tpr.yuv_degrain_run(ref, port_run[0])


def test_field_prober_agrees_with_the_maps(ref, port_run):
    """The probe-based prober and the map-based one return the same luma +
    chroma SADs for candidates inside the map (level 1, both directions of
    the chroma rounding)."""
    sspec, aspec = tpr.specs(ref)
    sups = port_run[0]
    src, rf = tpr.yuv_job_indices()
    ctx = _level_ctx(sspec, aspec, 1, sups.map(lambda a: a[src[:2]]),
                     sups.map(lambda a: a[rf[:2]]))
    nbx, nby = ctx.nblk
    from mvtools_tpu_torch.analyse import _blocks_of
    idx = torch.arange(nbx * nby, dtype=torch.int32)
    x0 = ctx.hpad[0] + 8 * (idx % nbx)
    y0 = ctx.vpad[0] + 8 * (idx // nbx)
    xc = ctx.hpad[1] + 4 * (idx % nbx)
    yc = ctx.vpad[1] + 4 * (idx // nbx)
    blocks = [_blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0], nby,
                         nbx, 16, 16, 8, 8)]
    blocks += [_blocks_of(ctx.src_planes[p], ctx.vpad[1], ctx.hpad[1], nby,
                          nbx, 8, 8, 4, 4) for p in (1, 2)]
    big = torch.full((nbx * nby,), 1 << 20, dtype=torch.int32)
    bounds = (-big, big, -big, big)
    zero = torch.zeros((2, nbx * nby), dtype=torch.int32)
    args = (ctx, blocks, x0, y0, xc, yc, bounds, 50)
    fp = fe.FieldProber(*args)
    mp = fe.MapProber(*args, pred_vx=zero, pred_vy=zero)
    rng = np.random.default_rng(2)
    vxs = [torch.from_numpy(rng.integers(-5, 6, (2, nbx * nby)).astype(
        np.int32)) for _ in range(3)]
    vys = [torch.from_numpy(rng.integers(-5, 6, (2, nbx * nby)).astype(
        np.int32)) for _ in range(3)]
    a = fp.plain_sads_multi(vxs, vys)
    b = mp.plain_sads_multi(vxs, vys)
    valid = a < probe_ops.INVALID_SAD
    assert valid.float().mean() > 0.9
    assert torch.equal(torch.where(valid, a, 0), torch.where(valid, b, 0))
    ring = tuple(fe._ring_offsets(1, 1))
    ca = fp.chroma_sads(vxs[0], vys[0], ring)
    cb = mp.chroma_sads(vxs[0], vys[0], ring)
    ok = ca < probe_ops.INVALID_SAD
    assert torch.equal(torch.where(ok, ca, 0), torch.where(ok, cb, 0))
    one = fp.chroma_sads(vxs[0], vys[0], ((-1, 1),))
    np.testing.assert_array_equal(
        torch.where(ok[..., 5], one[..., 0], 0).numpy(),
        torch.where(ok[..., 5], ca[..., 5], 0).numpy())


@pytest.mark.parametrize("plane", range(3))
def test_degrain_yuv_matches_jax(ref, degrain_run, plane):
    out = degrain_run
    assert out[plane].dtype == torch.uint8
    np.testing.assert_array_equal(out[plane].numpy(), ref[f"degrain{plane}"])
