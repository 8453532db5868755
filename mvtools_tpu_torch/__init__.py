"""mvtools_tpu_torch — the PyTorch / CUDA port of the JAX package.

Block-based hierarchical motion search plus its motion-compensated
consumers, after vapoursynth-mvtools: frames, pyramids and motion-vector
fields are torch tensors with an explicit leading batch axis, the plain
array work is eager PyTorch, and the three hot operations (dense SAD map,
tiled candidate probe, reference-block fetch) are hand-written CUDA kernels
under csrc/, compiled with nvcc at first use.

This package imports torch and numpy only.  Ported so far: the headline
path Super -> batched lockstep Analyse -> Degrain (gray 8-bit, pel 1/2, no
overlap, dct 0).  Options outside that path raise NotImplementedError.

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
