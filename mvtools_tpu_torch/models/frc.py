"""Frame-rate conversion model: the canonical FlowFPS graph over a clip.

The reference's QTGMC/SVP-style usage: Super, Analyse backward and forward
(at both endpoints of an interval for maskmode 2), FlowFPS per output
frame (MVFlowFPS.c graph construction :693-908).  Every input frame's
super is built once, in one batch; the intervals' fields of each direction
are one analyse_batch call, or on the exact engine both directions' one
analyse_exact_jobs call (a job comes out exactly as if it had been
searched alone); then each output frame is synthesised from its interval's
supers and fields.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..analyse import _check_ported
from ..convert import require_device
from ..core.config import AnalyseConfig, SuperConfig
from ..core.types import VideoFormat
from ..flowfps import FlowFPSConfig, flowfps_frame, output_frame_mapping
from ..super import build_super
from .denoise import _analyse_both, field_job


def frame_plan(t_in: int, fa: Fraction, num_out: int, maskmode: int):
    """The output frames' sources: a list of (nleft, nright, time256, extra)
    per output frame (time256 0: frame nleft passes through; extra: whether
    maskmode 2's mv_bb / mv_ff are used), and the interval keys k, each the
    pair (k, k + 1), whose backward and forward fields the frames read."""
    plan, keys_b, keys_f = [], set(), set()
    for n in range(num_out):
        nleft, nright, time256 = output_frame_mapping(n, fa, 1)
        nleft = min(nleft, t_in - 1)
        nright = min(nright, t_in - 1)
        if time256 == 0 or nleft == nright:
            plan.append((nleft, nleft, 0, False))
            continue
        # mvbw at nright / mvfw at nleft (MVFlowFPS.c:333-397)
        extra = maskmode == 2 and nleft > 0 and nright + 1 < t_in
        keys_b.add(nleft)
        keys_f.add(nleft)
        if extra:
            keys_b.add(nright)
            keys_f.add(nleft - 1)
        plan.append((nleft, nright, time256, extra))
    return plan, sorted(keys_b), sorted(keys_f)


def flowfps_clip(clip_planes: Sequence, fmt: VideoFormat,
                 in_fps: Fraction, out_fps: Fraction,
                 scfg: SuperConfig = SuperConfig(),
                 acfg: AnalyseConfig = AnalyseConfig(),
                 fcfg: FlowFPSConfig = FlowFPSConfig(),
                 engine: str = "lockstep",
                 num_out: Optional[int] = None, device=None,
                 info: Optional[dict] = None) -> List[List[torch.Tensor]]:
    """Retime a clip from in_fps to out_fps.

    clip_planes: per-plane [T, H, W] uint8 (uint16 for 9 to 16 bits) numpy
    arrays or tensors.  Numpy planes go to `device` (default "cuda");
    tensors stay where they are.  Returns a list of output frames, each a
    list of planes on that device.  Output frame n maps to the interval
    (nleft, nleft + 1) at time256 (output_frame_mapping); time256 0 passes
    frame nleft through.

    engine: "lockstep" (the default, as in the JAX package) or "exact"
    (every pair its own sequential block scan).  With acfg.fields the clip
    is taken as separated fields, and, as in the JAX package, no field
    shift is applied.  `info`, if given, receives the
    batched fields under "fields_b" / "fields_f" (job i is the interval
    keys_b[i] / keys_f[i]: backward field of frame k against k + 1, forward
    field of frame k + 1 against k), the keys under "keys_b" / "keys_f", and
    on a CUDA device events around the stages under "events" ("super",
    "analyse", "synthesis": (start, end))."""
    sspec = scfg.validate(fmt)
    aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
    _check_ported(aspec_b, sspec, engine)    # before any work is done
    if isinstance(clip_planes[0], np.ndarray):
        dev = require_device("cuda" if device is None else device)
        clip_planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                       for p in clip_planes]
    clip_planes = list(clip_planes)
    dev = clip_planes[0].device
    t_in = clip_planes[0].shape[0]
    fa = Fraction(in_fps) / Fraction(out_fps)
    if num_out is None:
        num_out = max(int(np.floor(t_in / float(fa))) - 1, 0)
    plan, keys_b, keys_f = frame_plan(t_in, fa, num_out, fcfg.maskmode)

    def mark():
        if info is None or dev.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    t0 = mark()
    sups = build_super(clip_planes, sspec)
    t1 = mark()
    mvs_b = mvs_f = None
    if keys_b:
        kb = torch.tensor(keys_b, device=dev)
        kf = torch.tensor(keys_f, device=dev)
        mvs_b, mvs_f = _analyse_both(sups, (kb, kb + 1, aspec_b, 0),
                                     (kf + 1, kf, aspec_f, 0), engine)
    t2 = mark()
    job_b = {k: i for i, k in enumerate(keys_b)}
    job_f = {k: i for i, k in enumerate(keys_f)}

    def frame(n):
        return [p[n] for p in clip_planes]

    def sup(n):
        return sups.map(lambda a: a[n])

    out = []
    for nleft, nright, time256, extra in plan:
        if time256 == 0:
            out.append(frame(nleft))
            continue
        kw = {}
        if extra:
            kw = dict(mv_bb=field_job(mvs_b, job_b[nright]),
                      mv_ff=field_job(mvs_f, job_f[nleft - 1]))
        out.append(flowfps_frame(
            frame(nleft), frame(nright), sup(nleft), sup(nright),
            field_job(mvs_b, job_b[nleft]), field_job(mvs_f, job_f[nleft]),
            aspec_b.meta, fcfg, time256, **kw))
    t3 = mark()
    if info is not None:
        info.update(fields_b=mvs_b, fields_f=mvs_f, keys_b=keys_b,
                    keys_f=keys_f)
        if t0 is not None:
            info["events"] = dict(super=(t0, t1), analyse=(t1, t2),
                                  synthesis=(t2, t3))
    return out


def fps_configs():
    """(SuperConfig, AnalyseConfig, FlowFPSConfig, in_fps, out_fps) of the
    frame-rate conversion path: gray 8-bit, pel 2, blk 16, truemotion, the
    full pyramid (levels=0), maskmode 2, 30 -> 60 fps."""
    return (SuperConfig(pel=2, levels=0, chroma=False),
            AnalyseConfig(blksize=16, levels=0, truemotion=True,
                          chroma=False),
            FlowFPSConfig(maskmode=2), Fraction(30), Fraction(60))
