"""PyTorch port: the Analyse options outside the port raise; split from
test_torch_analyse.py (whose docstring says how the inputs are made) into a
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
from mvtools_tpu_torch import analyse_batch
from mvtools_tpu_torch.core.types import SearchType
from mvtools_tpu_torch.super import Super
from test_torch_analyse import _spec  # noqa: E402


UNPORTED_OPTIONS_RAISE_CASES = [
    (dict(bits=16, dct=5), "16-bit"),
    (dict(dct=1, pel=4), "dct"),
    (dict(pel=4), "pel=4"),
    (dict(trymany=True), "trymany"),
    (dict(divide=1), "divide"),
    (dict(search=SearchType.UMH), "search=UMH"),
    (dict(search_coarse=SearchType.NSTEP), "search=NSTEP"),
    (dict(search=SearchType.ONETIME), "search=ONETIME"),
]
UNPORTED_OPTIONS_RAISE_IDS = [
    f"kw{i}-{what}"
    for i, (_, what) in enumerate(UNPORTED_OPTIONS_RAISE_CASES)]


@pytest.mark.parametrize("kw,what", UNPORTED_OPTIONS_RAISE_CASES[:4],
                         ids=UNPORTED_OPTIONS_RAISE_IDS[:4])
def test_unported_options_raise(kw, what):
    """Nothing falls back silently: every option outside the slice names
    itself in a NotImplementedError before any work is done."""
    check_unported_options_raise(kw, what)


def check_unported_options_raise(kw, what):
    sspec, aspec = _spec(**kw)
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match=what):
        analyse_batch(dummy, dummy, aspec)

