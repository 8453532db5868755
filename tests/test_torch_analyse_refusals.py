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
from mvtools_tpu_torch.ops import pixels
from mvtools_tpu_torch.super import Super
from test_torch_analyse import _spec  # noqa: E402


# (keywords, what the error must name, the case's id word).  pel 4 (with
# dct 1-4 at 8 bits), trymany, divide, every search and the field shift are
# ported (test_torch_pel4_*.py, test_torch_opts_slice.py,
# test_torch_searches*.py, test_torch_fields_*.py): their cases keep their
# ids and combine the option with one that is still refused (a cost at 16
# bits), which must name itself.
UNPORTED_OPTIONS_RAISE_CASES = [
    (dict(bits=16, dct=5), "16-bit", "16-bit"),
    (dict(dct=1, pel=4, bits=16), "dct=1 with 16-bit", "dct"),
    (dict(pel=4, dct=5, bits=16), "pel=4", "pel=4"),
    (dict(trymany=True, field_shift=1, bits=16, dct=5), "16-bit",
     "trymany"),
    (dict(divide=1, field_shift=2, bits=16, dct=2), "dct=2 with 16-bit",
     "divide"),
    (dict(search=SearchType.UMH, bits=16, dct=6), "dct=6 with 16-bit",
     "search=UMH"),
    (dict(search_coarse=SearchType.NSTEP, bits=16, dct=2),
     "dct=2 with 16-bit", "search=NSTEP"),
    (dict(search=SearchType.ONETIME, field_shift=-1, bits=16, dct=7),
     "dct=7 with 16-bit", "search=ONETIME"),
]
UNPORTED_OPTIONS_RAISE_IDS = [
    f"kw{i}-{word}"
    for i, (_, _, word) in enumerate(UNPORTED_OPTIONS_RAISE_CASES)]
UNPORTED_OPTIONS_RAISE_CASES = [c[:2] for c in UNPORTED_OPTIONS_RAISE_CASES]


@pytest.mark.parametrize("kw,what", UNPORTED_OPTIONS_RAISE_CASES[:4],
                         ids=UNPORTED_OPTIONS_RAISE_IDS[:4])
def test_unported_options_raise(kw, what):
    """Nothing falls back silently: every option outside the port names
    itself in a NotImplementedError before any work is done."""
    check_unported_options_raise(kw, what)


def check_unported_options_raise(kw, what):
    kw = dict(kw)
    field_shift = kw.pop("field_shift", 0)
    sspec, aspec = _spec(**kw)
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=pixels.dtype_of(
        sspec.bits)),),), sspec)
    with pytest.raises(NotImplementedError, match=what):
        analyse_batch(dummy, dummy, aspec, field_shift=field_shift)

