"""PyTorch port: the exact sequential engine with the search types other
than HEX2, EXHAUSTIVE and LOGARITHMIC (ONETIME, NSTEP, UMH, HORIZONTAL,
VERTICAL; one level, searchparam 3) against the JAX package's analyse with
its default engine, "exact", on CPU, bit for bit; the one-time search walks
while a step improves.  The diamond search (LOGARITHMIC, which checks the
diagonals of its switch case in case order) is held in Recalculate's exact
engine (test_torch_exact_recalc.py).  Inputs and JAX side:
test_torch_exact_analyse.py, load_exact."""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_reference as tpr  # noqa: E402
from test_torch_exact_analyse import assert_field, port_analysis  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


@pytest.mark.parametrize("search", [0, 1, 5, 6, 7],
                         ids=["onetime", "nstep", "umh", "horizontal",
                              "vertical"])
def test_exact_search_matches_jax(ref, search):
    name = f"search{search}"
    assert_field(ref, f"{name}_", port_analysis(name))
