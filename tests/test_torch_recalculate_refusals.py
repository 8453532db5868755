"""PyTorch port: RecalculateConfig against the JAX package, and the Recalculate
options outside the port raise; split from test_torch_recalculate.py (whose
docstring says how the inputs are made) into a file of at most six tests,
which pytest-xdist's loadfile scheduling hands out after the suite's longest
file."""
import os
import sys

import dataclasses
import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu import recalculate as jax_recalc
import mvtools_tpu_torch as port
from mvtools_tpu_torch.core.config import SuperConfig
from mvtools_tpu_torch.core.types import (ColorFamily, MVField, MVPlaneField,
                                          SearchType, VideoFormat)
from mvtools_tpu_torch.super import Super
from test_torch_recalculate import H, PEL, W  # noqa: E402


def test_recalculate_config_matches_jax():
    a = port.RecalculateConfig(blksize=16, overlap=8, thsad=200, chroma=False,
                               truemotion=True, dct=5)
    b = jax_recalc.RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                     chroma=False, truemotion=True, dct=5)
    da, db = (dataclasses.asdict(c.to_analyse_config()) for c in (a, b))
    assert {k: int(v) if isinstance(v, SearchType) else v
            for k, v in da.items()} == \
        {k: int(v) if hasattr(v, "value") else v for k, v in db.items()}
    assert dataclasses.asdict(port.RecalculateConfig()) == {
        k: (int(v) if hasattr(v, "value") else v)
        for k, v in dataclasses.asdict(jax_recalc.RecalculateConfig()).items()}


UNPORTED_OPTIONS_RAISE_CASES = [
    (dict(dct=1, pel=4), "dct=1"),
    (dict(dct=4, pel=4), "dct=4"),
    (dict(divide=1), "divide"),
    (dict(fields=True), "fields"),
    (dict(search=SearchType.UMH), "search=UMH"),
    (dict(search=SearchType.NSTEP), "search=NSTEP"),
    (dict(field_shift=1), "field_shift"),
    (dict(engine="exact"), "exact"),
]
UNPORTED_OPTIONS_RAISE_IDS = [
    f"kw{i}-{what}"
    for i, (_, what) in enumerate(UNPORTED_OPTIONS_RAISE_CASES)]


@pytest.mark.parametrize("kw,what", UNPORTED_OPTIONS_RAISE_CASES[:5],
                         ids=UNPORTED_OPTIONS_RAISE_IDS[:5])
def test_unported_options_raise(kw, what):
    """Nothing falls back silently: every option outside the slice names
    itself in a NotImplementedError before any work is done."""
    check_unported_options_raise(kw, what)


def check_unported_options_raise(kw, what):
    kw = dict(kw)
    call = {k: kw.pop(k) for k in ("field_shift", "engine") if k in kw}
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=kw.pop("pel", PEL), levels=1,
                        chroma=False).validate(fmt)
    rcfg = port.RecalculateConfig(blksize=16, overlap=8, chroma=False, **kw)
    rspec = rcfg.to_analyse_config().validate(sspec)
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    z = torch.zeros((1, 2, 2), dtype=torch.int32)
    old = MVField((MVPlaneField(z, z, z.to(torch.int64)),),
                  torch.ones((1,), dtype=torch.int32), rspec.meta)
    with pytest.raises(NotImplementedError, match=what):
        port.recalculate(dummy, dummy, old, rspec, rcfg, **call)
    with pytest.raises(ValueError, match="unknown engine"):
        port.recalculate(dummy, dummy, old, rspec, rcfg, engine="fast")

