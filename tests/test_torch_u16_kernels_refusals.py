"""PyTorch port: what stays refused at deep bits; split from
test_torch_u16_kernels.py (whose docstring says how the inputs are made)
into a file of at most six tests, which pytest-xdist's loadfile scheduling
hands out after the suite's longest file."""
import os
import sys

import pytest
import torch

# Tiny tensors: intra-op threads buy nothing and fight the other test
# workers' threads for the cores.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch import AnalyseConfig, analyse_batch
from mvtools_tpu_torch import recalculate as port_recalculate
from mvtools_tpu_torch.analyse import batch_supported
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.models.denoise import (degrain_clip, flagship_configs,
                                              make_test_clip_yuv)
from mvtools_tpu_torch.recalculate import RecalculateConfig
from test_torch_u16_kernels import _deep_supers  # noqa: E402


@pytest.mark.parametrize("case", ["dct1", "dct5", "dct8", "blk32_16bit",
                                  "recalculate"])
def test_deep_bits_refusals(case):
    """What stays refused at deep bits raises NotImplementedError before
    any work: the DCT (1-4) and SATD (5-10) costs and Recalculate.  Blocks
    whose SAD can reach 2^24 at 16 bits (32x32) are no longer refused: the
    probe-only level search serves them (check_blk32_16bit)."""
    if case == "recalculate":
        src, ref, sspec, aspec = _deep_supers()
        mv = analyse_batch(src, ref, aspec)
        rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                 chroma=False)
        with pytest.raises(NotImplementedError, match="16-bit"):
            port_recalculate(src, ref, mv, rcfg.to_analyse_config().validate(
                sspec), rcfg)
        return
    if case == "blk32_16bit":
        # ported: the levels the map cannot serve probe every candidate,
        # as in the JAX package (held to it here)
        check_blk32_16bit()
        return
    dct = int(case[3:])
    src, ref, sspec, aspec = _deep_supers(dct=dct)
    match = f"dct={dct} with 16-bit"
    with pytest.raises(NotImplementedError, match=match):
        analyse_batch(src, ref, aspec)
    scfg, acfg, dcfg, _ = flagship_configs()
    clip = make_test_clip_yuv(3, 64, 48, bits=16, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        degrain_clip(clip, VideoFormat(64, 48, 16, ColorFamily.YUV420),
                     scfg, AnalyseConfig(blksize=16, dct=dct, chroma=True),
                     dcfg, 1, engine="lockstep")



def check_blk32_16bit():
    """32x32 blocks at 16 bits: no level rides the dense map; the port's
    analyse_batch equals the JAX package's on the same clip (tolerance
    0)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import mvtools_tpu as mvt
    from mvtools_tpu.core.config import AnalyseConfig as JAnalyseConfig
    from mvtools_tpu.core.config import SuperConfig as JSuperConfig
    from mvtools_tpu.core.types import ColorFamily as JColorFamily
    from mvtools_tpu.core.types import VideoFormat as JVideoFormat
    src, ref, sspec, aspec = _deep_supers(16, 128, 96, blksize=32)
    assert not batch_supported(aspec, sspec)
    got = analyse_batch(src, ref, aspec)
    clip = make_test_clip_yuv(3, 128, 96, noise=4, pan=(1, 1), bits=16,
                              device="cpu")[0].numpy()
    jsspec = JSuperConfig(pel=2, levels=0, chroma=False).validate(
        JVideoFormat(128, 96, 16, JColorFamily.GRAY))
    jaspec = JAnalyseConfig(blksize=32, levels=0,
                            chroma=False).validate(jsspec)
    # jitted: an eager Super costs seconds of op dispatch a frame
    jbuild = jax.jit(lambda f: mvt.build_super([f], jsspec))
    sups = [jbuild(jnp.asarray(f)) for f in clip]
    stack = jax.tree_util.tree_map
    want = mvt.analyse_batch(stack(lambda *a: jnp.stack(a), sups[1], sups[1]),
                             stack(lambda *a: jnp.stack(a), sups[2], sups[0]),
                             jaspec)
    for lv, (g, w) in enumerate(zip(got.levels, want.levels)):
        for k in ("x", "y", "sad"):
            assert np.array_equal(getattr(g, k).numpy(),
                                  np.asarray(getattr(w, k))), (lv, k)
