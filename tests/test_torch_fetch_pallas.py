"""PyTorch port: the tiled fetch against the JAX package's Pallas tiled
fetch in interpret mode, the cases test_torch_fetch.py does not hold; split
from it into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from test_torch_fetch import (CASES, case_params, check_case,  # noqa: E402
                              fetched, monkeypatch_module)


@pytest.mark.parametrize("case", case_params(list(CASES)[5:]))
def test_tiled_fetch_matches_pallas(fetched, case):
    """The port's tiled fetch (its plain version on the CPU, the contract
    of K3) == the JAX package's Pallas tiled fetch run in interpret mode,
    for the blocks of one case."""
    check_case(fetched, case)
