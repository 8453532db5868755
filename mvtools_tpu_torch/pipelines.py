"""Staged pipelines: Super, Analyse (backward, forward) and Degrain as
separate stages, each frame's super built once and reused.

The JAX package compiles each stage once with jax.jit so that the search
engine is traced twice whatever the radius; here each stage is a plain call
(eager PyTorch, the hand-written kernels on the card) into
models/denoise.py's degrain path, and the structure that stays is the
reuse: every frame's pyramid is built once and read by up to 2*radius
consumers, as VapourSynth caches each filter node's output per frame
(MVDegrains.cpp arInitial requests, MVFlowFPS.c helper nodes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from .analyse import _check_ported
from .core.config import AnalyseConfig, SuperConfig
from .core.types import VideoFormat
from .degrain import DegrainConfig
from .models.denoise import degrain_clip, degrain_n_supers
from .super import Super, build_super


class DegrainPipeline:
    """Super -> Analyse xN -> DegrainN, stage by stage, on the frames'
    device."""

    def __init__(self, fmt: VideoFormat, scfg: SuperConfig,
                 acfg: AnalyseConfig, dcfg: DegrainConfig,
                 radius: int = 1, engine: str = "lockstep"):
        self.fmt, self.scfg, self.acfg = fmt, scfg, acfg
        self.radius = radius
        self.engine = engine
        self.sspec = scfg.validate(fmt)
        self.aspec_b = dataclasses.replace(acfg, isb=True).validate(
            self.sspec)
        self.aspec_f = dataclasses.replace(acfg, isb=False).validate(
            self.sspec)
        self.dcfg = dcfg
        _check_ported(self.aspec_b, self.sspec, engine)

    def super(self, planes):
        return build_super(list(planes), self.sspec)

    def frame(self, cur_planes, cur_super, ref_supers_prev,
              ref_supers_next):
        """Denoise one frame.  ref_supers_prev/next[i] = super of frame
        n-(i+1) / n+(i+1) (precomputed, typically cached across frames).
        Both directions' analyses are one call on the exact engine
        (models.denoise.degrain_n_supers)."""
        order = [cur_super] + list(ref_supers_next) + list(ref_supers_prev)
        sups = Super(tuple(tuple(torch.stack([s.planes[p][lv] for s in order])
                                 for lv in range(len(cur_super.planes[p])))
                           for p in range(cur_super.num_planes)), self.sspec)
        return degrain_n_supers(list(cur_planes), sups, len(ref_supers_prev),
                                self.aspec_b, self.aspec_f, self.dcfg,
                                self.engine)

    def run_clip(self, frames: Sequence[Sequence]) -> List[List]:
        """Denoise a whole clip: models.denoise.degrain_clip over the
        stacked frames (each frame's pyramid built once, in one batch, and
        read by up to 2*radius consumers), a neighbour past the clip's
        edge being the edge frame at full weight.  The whole clip and its
        pyramids lie on the device at once."""
        planes = [torch.stack([f[p] for f in frames])
                  for p in range(len(frames[0]))]
        out = degrain_clip(planes, self.fmt, self.scfg, self.acfg,
                           self.dcfg, self.radius, self.engine,
                           clamp_edges=True)
        return [[o[t] for o in out] for t in range(len(frames))]
