"""PyTorch port: the YUV420 slice — three-plane supers, batched lockstep
Analyse with chroma and overlap 8 over the full pyramid, overlapped
three-plane Degrain and the whole-clip denoise degrain_clip (radius 2,
clip-edge frames included) — the tests that need no JAX reference run:
the clip-edge neighbours, the test clip's recipe, the refusals and the
wrappers' dispatch.

The comparisons with the JAX package, against ONE cached run
(torch_port_reference.load_yuv: supers per frame, one analyse_batch call
holding the jobs of both directions, degrain per frame with the clip-edge
validity — the composition that the JAX package's staged degrain_clip is),
are in test_torch_yuv_slice_{super,levels,coarse,degrain,clip}.py: files
that wait for a JAX reference hold at most six tests, so that pytest-xdist
hands them out after the suite's longest file.

Some of its checks live in test_torch_yuv_slice_refusals{,2}.py, files of at
most six tests that pytest-xdist's loadfile scheduling hands out after the
suite's longest file."""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.models.denoise import (degrain_clip, edge_validity,
                                              make_test_clip_yuv,
                                              neighbour_index)
from mvtools_tpu_torch.ops import probe as probe_ops

import torch_port_reference as tpr

T = tpr.YUV_FRAMES


def test_edge_validity_and_neighbours():
    prev_ok, next_ok = edge_validity(4, 2, "cpu")
    assert prev_ok.tolist() == [[False, False], [True, False], [True, True],
                                [True, True]]
    assert next_ok.tolist() == [[True, True], [True, True], [True, False],
                                [False, False]]
    assert neighbour_index(4, 2, +1, "cpu").tolist() == [1, 2, 3, 3,
                                                         2, 3, 3, 3]
    assert neighbour_index(4, 2, -1, "cpu").tolist() == [0, 0, 1, 2,
                                                         0, 0, 0, 1]
    src, rf = tpr.yuv_job_indices(4, 2)
    assert rf == (neighbour_index(4, 2, +1, "cpu").tolist()
                  + neighbour_index(4, 2, -1, "cpu").tolist())


def test_yuv_test_clip_recipe():
    """make_test_clip_yuv is the numpy recipe of the shared reference clip."""
    mine = make_test_clip_yuv(T, tpr.YUV_W, tpr.YUV_H, seed=tpr.YUV_SEED,
                              flash=tpr.YUV_FLASH, noise=tpr.YUV_NOISE,
                              pan=tpr.YUV_PAN, device="cpu")
    for a, b in zip(mine, tpr.make_yuv_frames()):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), b)
    calm = make_test_clip_yuv(2, 64, 48, seed=1, device="cpu")
    assert [tuple(p.shape) for p in calm] == [(2, 48, 64), (2, 24, 32),
                                              (2, 24, 32)]
    y, u, v = tpr.make_yuv_frames(2, 64, 48, 1, None, 0, (2, 3))
    np.testing.assert_array_equal(calm[2].numpy(), v)
    assert int(mine[1][1, 8:88, 8:120].min()) >= 192 - tpr.YUV_NOISE
    assert int(mine[1][0, 8:88, 8:120].max()) <= 63 + tpr.YUV_NOISE


def _tiny_clip(bits=8):
    dt = torch.uint8 if bits == 8 else torch.int16
    return [torch.zeros((2, 48, 64), dtype=dt),
            torch.zeros((2, 24, 32), dtype=dt),
            torch.zeros((2, 24, 32), dtype=dt)]


def test_degrain_clip_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        degrain_clip(_tiny_clip(), VideoFormat(64, 48, 8, ColorFamily.YUV420),
                     engine="fast")


def test_port_imports_without_jax_installed():
    """`import mvtools_tpu_torch` and every module of the slice work in an
    interpreter where jax and triton cannot be imported, and pull in
    neither jax nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['triton'] = None; "
            "import mvtools_tpu_torch, mvtools_tpu_torch.convert, "
            "mvtools_tpu_torch.models.denoise, mvtools_tpu_torch.ops.sadmap, "
            "mvtools_tpu_torch.ops.overlap, mvtools_tpu_torch.ops.probe, "
            "mvtools_tpu_torch.degrain, mvtools_tpu_torch.field_engine; "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "(m == 'jax' or m.startswith('jax.') or m == 'mvtools_tpu' "
            "or m.startswith('mvtools_tpu.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_kernel_wrappers_dispatch_on_the_tensor_device_alone():
    """On a CUDA tensor the per-block probe launches its kernel or raises:
    the only dispatch is on `is_cuda`, no wrapper catches an error, and the
    tiled probe hands small planes to the wrapper, not to the plain
    version."""
    import inspect
    src = inspect.getsource(probe_ops.probe_sads)
    assert "if not stack.is_cuda:" in src
    assert "try:" not in src and "except" not in src
    # one count per kernel: the plain form's or the three-stat form's
    assert ('name = "probe_sads[stats3]" if stats3 else "probe_sads"' in src
            and "launches[name] += 1" in src)
    tiled = inspect.getsource(probe_ops.probe_sads_tiled)
    assert "return probe_sads(" in tiled
    assert "probe_sads_plain" not in tiled
