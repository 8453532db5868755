"""PyTorch port: degrain_clip's options outside the slice raise; split from
test_torch_yuv_slice.py (whose docstring says how the inputs are made) into
a file of at most six tests, which pytest-xdist's loadfile scheduling hands
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
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.models.denoise import degrain_clip
from test_torch_yuv_slice import _tiny_clip  # noqa: E402


# pel 4 (with dct 1-4 at 8 bits), trymany, fields and the exact engine
# with dct 0 are ported: the cases "exact", "fields", "pel4", "dct" and
# "trymany" keep their ids and combine the option with one that is still
# refused (the exact engine with dct 1-10, sharp 0, a cost at 16 bits),
# which must name itself.
DEGRAIN_CLIP_REFUSALS_CASES = [
    (dict(engine="exact", acfg=AnalyseConfig(dct=1)),
     'engine="exact" with dct=1'),
    (dict(mesh=object()), "mesh"),
    (dict(spatial="space"), "mesh"),
    (dict(bits=16, acfg=AnalyseConfig(fields=True, tff=True, dct=5)),
     "16-bit"),
    (dict(scfg=SuperConfig(pel=4, sharp=0)), "sharp=0 at pel 4"),
    (dict(bits=16, acfg=AnalyseConfig(dct=5)), "16-bit"),
    (dict(bits=16, acfg=AnalyseConfig(dct=1), scfg=SuperConfig(pel=4)),
     "dct=1 with 16-bit"),
    (dict(bits=16, acfg=AnalyseConfig(trymany=True, fields=True, tff=True,
                                      dct=6)), "dct=6 with 16-bit"),
]
DEGRAIN_CLIP_REFUSALS_IDS = ["exact", "mesh", "spatial", "fields", "pel4",
                             "16bit", "dct", "trymany"]


@pytest.mark.parametrize("kw,what", DEGRAIN_CLIP_REFUSALS_CASES[:4],
                         ids=DEGRAIN_CLIP_REFUSALS_IDS[:4])
def test_degrain_clip_refusals(kw, what):
    """Nothing outside the port falls back silently: each option names
    itself in a NotImplementedError."""
    check_degrain_clip_refusals(kw, what)


def check_degrain_clip_refusals(kw, what):
    bits = kw.pop("bits", 8)
    fmt = VideoFormat(64, 48, bits, ColorFamily.YUV420)
    with pytest.raises(NotImplementedError, match=what):
        degrain_clip(_tiny_clip(bits), fmt, **kw)

