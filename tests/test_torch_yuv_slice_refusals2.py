"""PyTorch port: more of degrain_clip's options outside the slice; split from
test_torch_yuv_slice_refusals.py into a file of at most six tests, which
pytest-xdist's loadfile scheduling hands out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from test_torch_yuv_slice_refusals import (  # noqa: E402
                                           DEGRAIN_CLIP_REFUSALS_CASES,
                                           DEGRAIN_CLIP_REFUSALS_IDS,
                                           check_degrain_clip_refusals)


@pytest.mark.parametrize("kw,what", DEGRAIN_CLIP_REFUSALS_CASES[4:],
                         ids=DEGRAIN_CLIP_REFUSALS_IDS[4:])
def test_degrain_clip_refusals(kw, what):
    """The other cases of test_torch_yuv_slice_refusals.py's
    test_degrain_clip_refusals."""
    check_degrain_clip_refusals(kw, what)
