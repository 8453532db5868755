"""PyTorch port: the other Recalculates at pel 4 on the pel-4 reference
clip's fields (torch_port_reference.load_pel4()'s P4_RECALC), against the
JAX package bit for bit: UMH with the SATD cost dct 5 on the field path,
and NSTEP and LOGARITHMIC with the DCT cost dct 2, which take the JAX
package's per-block engine (exact SADs, every block refined, a block under
thsad keeping its predictor). test_torch_pel4_slice.py holds HEX2 with
divide 1 and ONETIME."""
import os
import sys

import pytest

import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_port_reference as tpr
from test_torch_pel4_slice import check_recalculate, ref, run  # noqa: E402,F401


@pytest.mark.parametrize("name", ["umh-dct5", "nstep", "log-dct2"])
def test_pel4_recalculate_other(ref, run, name):
    assert name in tpr.P4_RECALC
    check_recalculate(ref, run, name)
