"""PyTorch port: the other cases of test_torch_searches.py (whose docstring
says what they hold), in a file of its own so that pytest-xdist hands the
two halves to two workers."""
import os
import sys

import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_searches import (CASES, IDS, check_search_level,  # noqa: E402
                                 ref)  # noqa: F401


@pytest.mark.parametrize("level,pel,family,bits,plan", CASES[3:],
                         ids=IDS[3:])
def test_search_level_matches_jax(ref, level, pel, family, bits, plan):
    check_search_level(ref, level, pel, family, bits, plan)
