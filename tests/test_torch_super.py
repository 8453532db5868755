"""PyTorch port: Super pyramid against the JAX package, bit for bit (on the
clip of the shared JAX reference run: test_torch_super_shared_clip.py).

Inputs are made with numpy from a seed and handed to both sides; every
comparison is assert_array_equal (tolerance 0 — the pipeline is integer).

Some of its checks live in test_torch_super_refusals.py, files of at most
six tests that pytest-xdist's loadfile scheduling hands out after the
suite's longest file."""
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
from mvtools_tpu_torch.ops import probe as probe_ops
from mvtools_tpu_torch.super import build_super


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
