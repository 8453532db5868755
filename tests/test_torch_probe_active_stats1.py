"""PyTorch port: the tiled probe's `active` mask, stats 'sad_satd_luma' at pel
1; split from test_torch_probe.py into a file of at most six tests, which
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
from test_torch_probe_mask import check_active_mask  # noqa: E402


@pytest.mark.parametrize("handover", [False, True], ids=["tiled", "handover"])
@pytest.mark.parametrize("kk", [1, 6])
@pytest.mark.parametrize("pel", [1])
@pytest.mark.parametrize("stats", ["sad_satd_luma"])
def test_probe_sads_tiled_active_mask(stats, pel, kk, handover):
    """With `active`, probe_sads_tiled equals the unmasked output where
    active and is INVALID_SAD elsewhere
    (test_torch_probe_mask.check_active_mask)."""
    check_active_mask(stats, pel, kk, handover)
