"""PyTorch port: more of the Recalculate options outside the port; split from
test_torch_recalculate_refusals.py into a file of at most six tests, which
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
from test_torch_recalculate_refusals import (  # noqa: E402
                                             UNPORTED_OPTIONS_RAISE_CASES,
                                             UNPORTED_OPTIONS_RAISE_IDS,
                                             check_unported_options_raise)


@pytest.mark.parametrize("kw,what", UNPORTED_OPTIONS_RAISE_CASES[5:],
                         ids=UNPORTED_OPTIONS_RAISE_IDS[5:])
def test_unported_options_raise(kw, what):
    """The other cases of test_torch_recalculate_refusals.py's
    test_unported_options_raise."""
    check_unported_options_raise(kw, what)
