"""PyTorch port: the searches other than HEX2 and EXHAUSTIVE (ONETIME, NSTEP,
LOGARITHMIC, UMH, HORIZONTAL, VERTICAL), trymany and the ring rescue
(badrange < 0), one pyramid level at a time, against the JAX package's
search_level_lockstep on the same supers and prediction (tolerance 0): at
pel 4 every candidate goes through the probes, at pel 2 and on the coarse
level (pel 1) through the dense map's lookups, where LOGARITHMIC with
searchparam 8 walks past the map's window; UMH holds the probe-only level
search at pel 4 on a 16-bit clip (the uint16 probes), VERTICAL on YUV420
(chroma, overlap 8) with the default rescue. The clip's flashing region
turns blocks bad, so the rescue runs (tests/torch_search_cases.py says how
the inputs are made; the JAX side is computed with
torch_port_reference.load_opts())."""
import os
import sys

import pytest

import torch

# Small tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_port_reference as tpr
import torch_search_cases as tsc

CASES, IDS = tsc.CASES, tsc.IDS


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_opts(tmp_path_factory)


@pytest.mark.parametrize("level,pel,family,bits,plan", CASES[:3],
                         ids=IDS[:3])
def test_search_level_matches_jax(ref, level, pel, family, bits, plan):
    """The first three cases; test_torch_searches2.py holds the others."""
    check_search_level(ref, level, pel, family, bits, plan)


def check_search_level(ref, level, pel, family, bits, plan):
    name = IDS[CASES.index((level, pel, family, bits, plan))]
    want = tuple(ref[f"search_{name}_{k}"] for k in ("x", "y", "sad"))
    got, rescued, _ = tsc.port_case(level, pel, family, bits, plan)
    tsc.assert_equal(want, got, name)
    if level == 0:
        assert rescued > 0          # the flash's blocks went to the rescue
