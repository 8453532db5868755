"""PyTorch port: the Super options outside the port raise; split from
test_torch_super.py (whose docstring says how the inputs are made) into a
file of at most six tests, which pytest-xdist's loadfile scheduling hands
out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu as mvt
from mvtools_tpu_torch.core.config import SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.super import build_super


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

