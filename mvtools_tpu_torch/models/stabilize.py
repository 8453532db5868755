"""Global-motion stabilisation model: DepanEstimate -> DepanStabilise.

The canonical Depan chain (readme.rst Depan* usage): estimate per-frame
global translation/zoom by FFT phase correlation over the whole clip in
one batched pass, then apply the inertial or windowed-average stabiliser
with border filling.  Runs on the frames' device; the motions pass through
the host, as the reference's frame props do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..depan import (
    DepanEstimateConfig,
    DepanStabiliseConfig,
    depan_estimate,
    depan_stabilise,
)


def stabilize_clip(frames: Sequence[Sequence[torch.Tensor]],
                   ecfg: DepanEstimateConfig = DepanEstimateConfig(),
                   scfg: DepanStabiliseConfig = DepanStabiliseConfig(),
                   sub_w: int = 0, sub_h: int = 0, bits: int = 8,
                   info: Optional[dict] = None
                   ) -> List[List[torch.Tensor]]:
    """frames: list of per-frame plane lists.  Returns stabilised frames.
    `info`, if given, receives the [N, 4] float32 motions under "motions"
    and, on a CUDA device, CUDA events around the two stages under
    "events" ("estimate", "stabilise": (start, end))."""
    cuda = frames[0][0].is_cuda
    if cuda:
        t0, t1, t2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        t0.record()
    luma = torch.stack([f[0] for f in frames]).to(torch.float32)
    dx, dy, zoom, _trust = depan_estimate(luma, ecfg)
    motions = torch.stack([dx, dy, zoom, torch.zeros_like(dx)],
                          dim=1).cpu().numpy()
    if cuda:
        t1.record()
    out = depan_stabilise(frames, motions, scfg, sub_w=sub_w, sub_h=sub_h,
                          bits=bits)
    if info is not None:
        info["motions"] = motions
        if cuda:
            t2.record()
            info["events"] = dict(estimate=(t0, t1), stabilise=(t1, t2))
    return out
