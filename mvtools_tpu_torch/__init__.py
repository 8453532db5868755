"""mvtools_tpu_torch — the PyTorch / CUDA port of the JAX package.

Block-based hierarchical motion search plus its motion-compensated
consumers, after vapoursynth-mvtools: frames, pyramids and motion-vector
fields are torch tensors with an explicit leading batch axis, the plain
array work is eager PyTorch, and the four hot operations (dense SAD map,
tiled candidate probe, per-block candidate probe, reference-block fetch) are
hand-written CUDA kernels under csrc/, compiled with nvcc at first use.

This package imports torch and numpy only.  Ported so far: Super -> batched
lockstep Analyse -> Degrain for 8-bit GRAY and YUV clips (pel 1/2, dct 0,
chroma, overlapped blocks, any pyramid depth and radius), with the entry
points models.denoise.degrain_window and models.denoise.degrain_clip.
Options outside that raise NotImplementedError.

Precision: the pipeline is integer (pixels uint8, block math int32, costs
int64) with two float64 islands (lambda adaptation, degrain weights), kept
in float64 on the device.
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

__all__ = [
    "AnalysisMeta", "MVField", "MVPlaneField", "SearchType", "SuperConfig",
    "AnalyseConfig", "Super", "build_super", "analyse", "analyse_batch",
]

__version__ = "0.1.0"
