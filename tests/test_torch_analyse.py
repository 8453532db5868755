"""PyTorch port: batched lockstep Analyse, the tests that need no JAX
reference run: ties, the global motion estimate and the refusals.  The
comparisons with the JAX package's analyse_batch on a clip whose flashing
region drives the bad-SAD rescue are in test_torch_analyse_levels.py,
test_torch_analyse_coarse.py and test_torch_analyse_single.py (files that
wait for a JAX reference hold at most six tests, so that pytest-xdist hands
them out after the suite's longest file).

Some of its checks live in test_torch_analyse_refusals{,2}.py, files of at
most six tests that pytest-xdist's loadfile scheduling hands out after the
suite's longest file."""
import os
import sys

import pytest

import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from mvtools_tpu_torch import analyse, analyse_batch
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import estimate_global_mv_doubled
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.super import Super


def test_first_minimum_wins_ties():
    cost = torch.tensor([[5, 3, 3, 9], [7, 7, 7, 7], [4, 2, 8, 2]])
    m, k = fe._first_min(cost)
    assert m.tolist() == [3, 7, 2] and k.tolist() == [1, 0, 1]


@pytest.mark.parametrize("nb_y,nb_x,step", [(1, 3, 8), (1, 3, 16),
                                             (2, 3, 8)])
def test_blocks_of_is_contiguous(nb_y, nb_x, step):
    """The source blocks the probes take are contiguous, a grid of one row
    (a coarse level's, which reshape leaves a view) included, and hold the
    plane's pixels."""
    from mvtools_tpu_torch.analyse import _blocks_of
    plane = torch.arange(3 * 40 * 80, dtype=torch.int32).reshape(3, 40, 80)
    blocks = _blocks_of(plane, 2, 4, nb_y, nb_x, 16, 16, step, step)
    assert blocks.is_contiguous()
    assert tuple(blocks.shape) == (3, nb_y * nb_x, 16, 16)
    for i in range(nb_y * nb_x):
        y, x = 2 + step * (i // nb_x), 4 + step * (i % nb_x)
        assert torch.equal(blocks[:, i], plane[:, y:y + 16, x:x + 16])


def test_global_mv_first_mode_wins():
    """Two equally frequent values: the smaller is the mode, as in the
    reference histogram's first argmax."""
    vx = torch.tensor([[4, 4, -2, -2, 9, 30]], dtype=torch.int32)
    vy = torch.tensor([[1, 1, 1, 0, 0, 0]], dtype=torch.int32)
    gx, gy = estimate_global_mv_doubled(vx, vy)
    # modes -2 / 0; inliers |vx+2| < 6 & |vy| < 6 are the two -2 blocks:
    # 2 * (-4) / 2 = -4 and 2 * (1 + 0) / 2 = 1
    assert gx.tolist() == [-4] and gy.tolist() == [1]


def _spec(**kw):
    fmt = VideoFormat(kw.pop("w", 256), kw.pop("h", 192), kw.pop("bits", 8),
                      kw.pop("family", ColorFamily.GRAY))
    sspec = SuperConfig(pel=kw.pop("pel", 2), levels=3,
                        chroma=kw.pop("schroma", False)).validate(fmt)
    base = dict(blksize=16, levels=3, chroma=False)
    base.update(kw)
    return sspec, AnalyseConfig(**base).validate(sspec)


def test_field_shift_and_exact_engine_raise():
    sspec, aspec = _spec()
    dummy = Super(((torch.zeros((1, 4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match="field_shift"):
        analyse_batch(dummy, dummy, aspec, field_shift=1)
    one = Super(((torch.zeros((4, 8, 8), dtype=torch.uint8),),), sspec)
    with pytest.raises(NotImplementedError, match="exact"):
        analyse(one, one, aspec, engine="exact")
    # chroma in the search needs a super clip that carries chroma planes
    _, aspec_c = _spec(family=ColorFamily.YUV420, schroma=True, chroma=True)
    with pytest.raises(ValueError, match="chroma"):
        analyse_batch(dummy, dummy, aspec_c)
