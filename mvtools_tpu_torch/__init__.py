"""mvtools_tpu_torch — the PyTorch / CUDA port of the JAX package.

Block-based hierarchical motion search plus its motion-compensated
consumers, after vapoursynth-mvtools: frames, pyramids and motion-vector
fields are torch tensors with an explicit leading batch axis, the plain
array work is eager PyTorch, and the hot operations (dense SAD map, tiled
candidate probe, per-block candidate probe, each also in a three-stat form
that yields SAD, SATD and the reference block's sum, and the tiled and the
per-block reference-block fetch) are hand-written CUDA kernels under csrc/,
compiled with nvcc at first use.

This package imports torch and numpy only.  Ported so far: Super -> batched
lockstep Analyse -> Recalculate -> Degrain for 8-bit GRAY and YUV clips (pel
1/2, chroma, overlapped blocks, any pyramid depth and radius, searches HEX2
and EXHAUSTIVE), with the plain-SAD cost (dct 0), the DCT costs (dct 1-4)
and the SATD costs (dct 5-10), and the entry points analyse / analyse_batch,
recalculate, degrain.degrain, models.denoise.degrain_window and
models.denoise.degrain_clip.  Not ported: the other searches (UMH, ONETIME,
NSTEP, LOGARITHMIC, HORIZONTAL, VERTICAL), trymany, divide, engine="exact",
pel 4, 16-bit clips, fields.  Each raises NotImplementedError.

Precision: the pipeline is integer (pixels uint8, block math int32, costs
int64) with three float64 islands (lambda adaptation, degrain weights, the
DCT of the dct 1-4 costs), kept in float64 on the device.
"""

from .core.types import (  # noqa: F401
    AnalysisMeta,
    MVField,
    MVPlaneField,
    SearchType,
)
from .core.config import SuperConfig, AnalyseConfig  # noqa: F401
from .super import Super, build_super  # noqa: F401
from .analyse import analyse, analyse_batch  # noqa: F401
from .recalculate import RecalculateConfig, recalculate  # noqa: F401

__all__ = [
    "AnalysisMeta", "MVField", "MVPlaneField", "SearchType", "SuperConfig",
    "AnalyseConfig", "Super", "build_super", "analyse", "analyse_batch",
    "RecalculateConfig", "recalculate",
]

__version__ = "0.1.0"
