"""PyTorch port: the YUV420 slice against one cached run of the JAX package
(torch_port_reference.load_yuv): the whole slice through its entry point
degrain_clip (split out of test_torch_yuv_slice.py: files that wait for a JAX
reference hold at most six tests, so that pytest-xdist hands them out after
the suite's longest file).

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


import torch_port_reference as tpr

T, R = tpr.YUV_FRAMES, tpr.YUV_RADIUS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_yuv(tmp_path_factory)


@pytest.fixture(scope="module")
def clip_run(ref):
    """degrain_clip with the jobs of a direction (6) split over two
    analyse_batch calls, as a long clip's are."""
    return tpr.yuv_clip_run(ref)


@pytest.mark.parametrize("plane", range(3))
def test_degrain_clip_matches_jax(ref, clip_run, plane):
    """The whole slice through its entry point; frames 0 and 2 are clip
    edges (two missing neighbours each), frame 1 has none at distance 2."""
    out, _ = clip_run
    assert len(out) == 3 and out[plane].dtype == torch.uint8
    np.testing.assert_array_equal(out[plane].numpy(), ref[f"degrain{plane}"])


def test_degrain_clip_fields_and_pixels(ref, clip_run):
    """degrain_clip's analyse calls (two per direction here) give the fields
    of the one JAX call (a job's result does not depend on its batch), and
    the dark frames,
    which have one usable neighbour each, come out changed while the bright
    frame, whose neighbours are all behind a scene change, does not."""
    out, info = clip_run
    nj = T * R
    for lv in range(tpr.YUV_LEVELS):
        for key in ("x", "y", "sad"):
            want = ref[f"mv_{key}{lv}"]
            np.testing.assert_array_equal(
                getattr(info["fields_b"].levels[lv], key).numpy(), want[:nj])
            np.testing.assert_array_equal(
                getattr(info["fields_f"].levels[lv], key).numpy(), want[nj:])
    assert info["fields_b"].meta.is_backward
    assert not info["fields_f"].meta.is_backward
    y = ref["y"]
    assert not np.array_equal(out[0][0].numpy(), y[0])
    assert not np.array_equal(out[0][2].numpy(), y[2])
    np.testing.assert_array_equal(out[0][1].numpy(), y[1])


@pytest.mark.slow
def test_degrain_clip_matches_jax_degrain_clip(ref, clip_run):
    """The port's entry point against the JAX package's own degrain_clip
    (engine="lockstep"), which compiles the search once more per direction:
    minutes on the CPU, so outside the default run."""
    import jax.numpy as jnp
    from mvtools_tpu.core.config import AnalyseConfig as JA, SuperConfig as JS
    from mvtools_tpu.core.types import ColorFamily as JC, VideoFormat as JV
    from mvtools_tpu.degrain import DegrainConfig as JD
    from mvtools_tpu.models.denoise import degrain_clip as jax_degrain_clip
    want = jax_degrain_clip(
        [jnp.asarray(ref[k]) for k in "yuv"],
        JV(tpr.YUV_W, tpr.YUV_H, 8, JC.YUV420),
        JS(pel=2, levels=0, chroma=True),
        JA(blksize=tpr.YUV_BLK, levels=0, overlap=tpr.YUV_OVERLAP,
           truemotion=True, chroma=True),
        JD(thsad=400), radius=R, engine="lockstep")
    for p in range(3):
        np.testing.assert_array_equal(clip_run[0][p].numpy(),
                                      np.asarray(want[p]))
