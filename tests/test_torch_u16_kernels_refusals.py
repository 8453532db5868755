"""PyTorch port: what stays refused at deep bits; split from
test_torch_u16_kernels.py (whose docstring says how the inputs are made)
into a file of at most six tests, which pytest-xdist's loadfile scheduling
hands out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch import AnalyseConfig, analyse_batch
from mvtools_tpu_torch import recalculate as port_recalculate
from mvtools_tpu_torch.analyse import batch_supported
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.models.denoise import (degrain_clip, flagship_configs,
                                              make_test_clip_yuv)
from mvtools_tpu_torch.recalculate import RecalculateConfig
from test_torch_u16_kernels import _deep_supers  # noqa: E402


@pytest.mark.parametrize("case", ["dct1", "dct5", "dct8", "blk32_16bit",
                                  "recalculate"])
def test_deep_bits_refusals(case):
    """What stays refused at deep bits raises NotImplementedError before
    any work: the DCT (1-4) and SATD (5-10) costs, blocks whose SAD can
    reach 2^24 at 16 bits (32x32: the probe-only level search), and
    Recalculate."""
    if case == "recalculate":
        src, ref, sspec, aspec = _deep_supers()
        mv = analyse_batch(src, ref, aspec)
        rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                 chroma=False)
        with pytest.raises(NotImplementedError, match="16-bit"):
            port_recalculate(src, ref, mv, rcfg.to_analyse_config().validate(
                sspec), rcfg)
        return
    if case == "blk32_16bit":
        src, ref, sspec, aspec = _deep_supers(16, 128, 96, blksize=32)
        assert not batch_supported(aspec, sspec)
        match = "dense SAD map"
    else:
        dct = int(case[3:])
        src, ref, sspec, aspec = _deep_supers(dct=dct)
        match = f"dct={dct} with 16-bit"
    with pytest.raises(NotImplementedError, match=match):
        analyse_batch(src, ref, aspec)
    if case != "blk32_16bit":
        scfg, acfg, dcfg, _ = flagship_configs()
        clip = make_test_clip_yuv(3, 64, 48, bits=16, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            degrain_clip(clip, VideoFormat(64, 48, 16, ColorFamily.YUV420),
                         scfg, AnalyseConfig(blksize=16, dct=dct,
                                             chroma=True), dcfg, 1)

