"""PyTorch port: the exact sequential engine (analyse_exact_jobs and
analyse(engine="exact"), exact_engine.py on CPU tensors) against the JAX
package's analyse with its default engine, "exact", on CPU, bit for bit:
every level's x, y and SAD.

The inputs (tests/torch_port_reference.py, EX_ANALYSES, load_exact) are
64x48 clips made with numpy from a seed: gray with a flashing region that
fires the UMH rescue, at 8 and 16 bits, and YUV420 with chroma in the
search; the JAX side runs in the reference's own process, not here.
Cases: gray pel 2 HEX2 truemotion over three levels (backward and forward
pairs), YUV420 with chroma, overlap 4, global_ and meander (isb=False),
16 bits at pel 1 with EXHAUSTIVE, and pel 4 with trymany (on the coarse
level), the ring rescue (badrange -6) and divide 2."""
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_reference as tpr  # noqa: E402
from mvtools_tpu_torch.analyse import analyse_exact_jobs  # noqa: E402
from mvtools_tpu_torch.core import config, types  # noqa: E402
from mvtools_tpu_torch.ops import exact_scan  # noqa: E402
from mvtools_tpu_torch.super import build_super  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


def port_analysis(name, field_shift=0):
    """The port's exact analysis of EX_ANALYSES[name]'s jobs."""
    clip, _, _, _, jobs = tpr.EX_ANALYSES[name]
    sspec, aspec = tpr.exact_specs(config, types, name)
    planes = [torch.from_numpy(p) for p in tpr.exact_planes(clip)]
    sups = build_super(planes, sspec)
    src = sups.take(torch.tensor([a for a, _ in jobs]))
    rs = sups.take(torch.tensor([b for _, b in jobs]))
    return analyse_exact_jobs(src, rs, aspec, field_shift)


def assert_field(ref, prefix, mv):
    assert len(mv.levels) == sum(1 for k in ref if k.startswith(prefix + "x"))
    for lv, level in enumerate(mv.levels):
        for k in ("x", "y", "sad"):
            np.testing.assert_array_equal(
                getattr(level, k).numpy(), ref[f"{prefix}{k}{lv}"],
                err_msg=f"{prefix} level {lv} {k}")


@pytest.mark.parametrize("name", ["gray_b", "yuv", "deep", "opts"])
def test_exact_analyse_matches_jax(ref, name):
    exact_scan.rescued_blocks = 0
    assert_field(ref, f"{name}_", port_analysis(name))
    # the flash sends blocks through the bad-SAD rescue
    assert int(exact_scan.rescued_blocks) > 0
