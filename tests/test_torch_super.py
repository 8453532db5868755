"""PyTorch port: Super pyramid against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer)."""
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
import mvtools_tpu as mvt
from mvtools_tpu.core.config import SuperConfig as JaxSuperConfig
from mvtools_tpu.ops import probe as jax_probe

from mvtools_tpu_torch import convert
from mvtools_tpu_torch.core.config import SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super

import torch_port_reference as tpr


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load(tmp_path_factory)


@pytest.mark.parametrize("level", range(tpr.LEVELS))
def test_super_matches_jax_on_shared_clip(ref, level):
    """Frame-batched pyramid + pel-2 Wiener subplanes == per-frame JAX."""
    sspec, _ = tpr.specs(ref)
    sup = build_super([torch.from_numpy(ref["frames"])], sspec)
    np.testing.assert_array_equal(sup.planes[0][level].numpy(),
                                  ref[f"super{level}"])


@pytest.mark.parametrize("w,h,pel,levels", [(130, 98, 2, 3), (72, 50, 1, 2)])
def test_super_matches_jax_odd_sizes(w, h, pel, levels):
    """Odd sizes hit the reduce filter's edge rows/columns; unbatched."""
    rng = np.random.default_rng(3)
    f = rng.integers(0, 256, (h, w), np.uint8)
    cfg = dict(pel=pel, levels=levels, chroma=False)
    want = mvt.build_super([jnp.asarray(f)], JaxSuperConfig(**cfg))
    got = build_super([torch.from_numpy(f)], SuperConfig(**cfg))
    assert got.spec.levels == want.spec.levels
    for lv in range(levels):
        np.testing.assert_array_equal(got.planes[0][lv].numpy(),
                                      np.asarray(want.planes[0][lv]))


def test_pad_stack_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 256, (4, 20, 24), np.uint8)
    np.testing.assert_array_equal(
        probe_ops.pad_stack(torch.from_numpy(s), 5).numpy(),
        np.asarray(jax_probe.pad_stack(jnp.asarray(s), 5)))


def test_super_roundtrips_through_convert(ref):
    sspec, _ = tpr.specs(ref)
    planes = [[ref[f"super{lv}"] for lv in range(tpr.LEVELS)]]
    sup = convert.super_from_numpy(planes, sspec, device="cpu")
    back = convert.super_to_numpy(sup)
    for lv in range(tpr.LEVELS):
        np.testing.assert_array_equal(back[0][lv], planes[0][lv])
    assert convert.super_spec_from_dict(convert.spec_to_dict(sspec)) == sspec


@pytest.mark.parametrize("cfg,fmt,what", [
    (dict(pel=4), (64, 48, 8, ColorFamily.GRAY), "pel"),
    (dict(sharp=1), (64, 48, 8, ColorFamily.GRAY), "sharp"),
    (dict(rfilter=0, levels=2), (64, 48, 8, ColorFamily.GRAY), "rfilter"),
    (dict(), (64, 48, 16, ColorFamily.GRAY), "16-bit"),
])
def test_super_unported_options_raise(cfg, fmt, what):
    """Options outside the slice raise NotImplementedError; a deep-bit spec
    (ported) given uint8 planes raises ValueError naming the depth."""
    spec = SuperConfig(**cfg).validate(VideoFormat(*fmt))
    exc = ValueError if fmt[2] > 8 else NotImplementedError
    with pytest.raises(exc, match=what):
        build_super([torch.zeros((48, 64), dtype=torch.uint8)], spec)


def test_entry_points_default_to_the_card():
    """Entry points that create tensors run on the card unless asked
    otherwise, and say so when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mvtools_tpu_torch.models.denoise import make_test_clip
    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_clip(2, 32, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.super_from_numpy([[np.zeros((1, 4, 4), np.uint8)]], None)
