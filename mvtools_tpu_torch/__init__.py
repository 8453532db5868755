"""mvtools_tpu_torch — the PyTorch / CUDA port of the JAX package.

Block-based hierarchical motion search plus its motion-compensated
consumers, after vapoursynth-mvtools: frames, pyramids and motion-vector
fields are torch tensors with an explicit leading batch axis, the plain
array work is eager PyTorch, and the hot operations (dense SAD map, tiled
candidate probe, per-block candidate probe, each also in a three-stat form
that yields SAD, SATD and the reference block's sum, the tiled and the
per-block reference-block fetch, and the exact engine's block scan) are
hand-written CUDA kernels under csrc/, compiled with nvcc at first use.

This package imports torch and numpy only.  Ported so far: Super -> batched
lockstep Analyse -> Recalculate -> Degrain for 8-bit GRAY and YUV clips (pel
1/2/4, chroma, overlapped blocks, any pyramid depth and radius, every search
type, trymany, the bad-SAD rescue for any badrange, divide 1/2; a level the
dense SAD map cannot serve, such as every pel-4 level, probes each
candidate), with the plain-SAD cost (dct 0), the DCT costs (dct 1-4)
and the SATD costs (dct 5-10), and the entry points analyse / analyse_batch,
recalculate, degrain.degrain, models.denoise.degrain_window,
models.denoise.degrain_clip / degrain1_clip and the per-frame
models.denoise.degrain1_frame / degrain_n_frame; the exact sequential engine
(engine="exact": the reference's block scan bit for bit, the default of
analyse, degrain_clip and degrain1_clip as in the JAX package; the CUDA
kernel K6 on the card, exact_engine.py on the CPU) with the plain-SAD cost
at 8 to 16 bits, in Analyse, Recalculate, the denoise entry points and
flowfps_clip; interlaced input (fields=True, tff, the field shift of
analyse, analyse_batch, degrain_clip, degrain_n_frame, compensate and flow;
core/fields.py); Super -> batched lockstep Analyse (dct 0) -> Degrain for
clips of 9 to 16 bits (uint16 pixels); frame-rate conversion,
models.frc.flowfps_clip (Super -> Analyse in both directions -> FlowFPS);
and the motion-compensated consumers, each one frame at a time:
flowfps.flowfps_frame, flowinter.flowinter, flow.flow (fetch and shift),
flowblur.flowblur, blockfps.blockfps_frame, compensate.compensate,
scdetect.scdetect and mask.mask, over finest.finest, flowutils and
ops/{resize,maskfun}.py.  The consumers' per-pixel gathers are plain torch
ops; their block fetches go through the fetch kernels.  The Depan quartet
(depan_analyse, depan_estimate, depan_compensate, depan_stabilise, over
ops/warp.py) and models.stabilize.stabilize_clip: the transform algebra on
the host in numpy float32, the warps, the FFT correlation and the
least-squares fit in plain torch on the device.  The host side: the MV blob
codec (core/codec.py, the JAX codec's bytes), y4m I/O (io/, a ctypes
binding to native/y4m.cc built at first use), pipelines.DegrainPipeline,
and the command line, `python -m mvtools_tpu_torch.cli`, with the 18
pipelines of tools/mvtools_run.py.  Not ported: the exact engine with dct
1-10; Super's sharp 0/1, rfilter 0/1/3/4 and pelclip; at 9 to 16 bits
Recalculate and dct 1-10; utils/profiling.py and the mesh.  Each raises
NotImplementedError or is absent.

Precision: the pipeline is integer (pixels uint8 or uint16, block math
int32, costs
int64) with three float64 islands (lambda adaptation, degrain weights, the
DCT of the dct 1-4 costs, the mask values of the flow consumers), kept in
float64 on the device.  The consumers whose function shares its module's
name (flowinter, flow, flowblur, compensate, scdetect, mask) are reached
through their modules, e.g. mvtools_tpu_torch.compensate.compensate, so
that the modules stay importable by name.
"""

from .core.types import (  # noqa: F401
    AnalysisMeta,
    MVField,
    MVPlaneField,
    SearchType,
)
from .core.config import SuperConfig, AnalyseConfig  # noqa: F401
from .super import Super, SuperClip, build_super  # noqa: F401
from .analyse import analyse, analyse_batch  # noqa: F401
from .recalculate import RecalculateConfig, recalculate  # noqa: F401
from .flowfps import FlowFPSConfig, flowfps_frame  # noqa: F401
from .flowinter import FlowInterConfig  # noqa: F401
from .flow import FlowConfig  # noqa: F401
from .flowblur import FlowBlurConfig  # noqa: F401
from .blockfps import BlockFPSConfig, blockfps_frame  # noqa: F401
from .compensate import CompensateConfig  # noqa: F401
from .scdetect import SCDetectionConfig  # noqa: F401
from .mask import MaskConfig  # noqa: F401
from .models.frc import flowfps_clip  # noqa: F401
from .depan import (  # noqa: F401
    DepanAnalyseConfig,
    DepanCompensateConfig,
    DepanEstimateConfig,
    DepanStabiliseConfig,
    depan_analyse,
    depan_compensate,
    depan_estimate,
    depan_stabilise,
)

__all__ = [
    "AnalysisMeta", "MVField", "MVPlaneField", "SearchType", "SuperConfig",
    "AnalyseConfig", "Super", "build_super", "analyse", "analyse_batch",
    "RecalculateConfig", "recalculate", "FlowFPSConfig", "flowfps_frame",
    "flowfps_clip", "FlowInterConfig", "FlowConfig", "FlowBlurConfig",
    "BlockFPSConfig", "blockfps_frame", "CompensateConfig",
    "SCDetectionConfig", "MaskConfig", "SuperClip", "DepanAnalyseConfig",
    "DepanCompensateConfig", "DepanEstimateConfig", "DepanStabiliseConfig",
    "depan_analyse", "depan_compensate", "depan_estimate", "depan_stabilise",
]

__version__ = "0.1.0"
