"""PyTorch port: one pyramid level's DCT costs through DenseEvaluator, modes
1-4, split from test_torch_dct.py (whose docstring says how its inputs are
made) into a file of at most six tests, which pytest-xdist's loadfile
scheduling hands out after the suite's longest file."""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import mvtools_tpu as mvt  # (enables x64)
from mvtools_tpu.ops import dct as jax_dct
from mvtools_tpu.ops import sad as jax_sad
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import DenseEvaluator, _blocks_of
from test_torch_dct import jax_analyse, level  # noqa: E402


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_dense_evaluator_dct_matches_jax(level, mode):
    """DenseEvaluator.luma_sads (the rescue's uniform displacements) with a
    DCT cost, at four displacements of both pel parities."""
    ctx, ctx_j = level["ctx"], level["ctx_j"]
    nbx, nby = ctx.nblk
    src = _blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0], nby, nbx,
                     16, 16)
    cost = fe.cost_keywords(mode, src, torch.from_numpy(level["w16"]), 8)
    dense = DenseEvaluator(ctx, 6, **cost)
    x0, y0 = jnp.asarray(level["x0"]), jnp.asarray(level["y0"])
    for j, cj in enumerate(ctx_j):
        src_j = jnp.asarray(src[j].numpy())
        jd = jax_analyse.DenseEvaluator(
            cj, x0, y0, x0, y0, 6, dctmode=mode,
            src_luma=jax.vmap(jax_sad.luma)(src_j),
            dctweight16=jnp.int32(level["w16"][j]),
            dct_src=jax.vmap(lambda b: jax_dct.dct_block(b, 8))(src_j))
        for vx, vy in ((0, 0), (3, -2), (-8, 5), (12, 12)):
            want = jd.luma_sads(jnp.int32(vx), jnp.int32(vy))
            np.testing.assert_array_equal(
                dense.luma_sads(vx, vy)[j].numpy(), np.asarray(want))

