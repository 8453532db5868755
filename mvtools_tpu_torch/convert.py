"""State carried between the JAX package and this one.

The system has no weights; its state is specs, Super pyramids and MV
fields.  These helpers rebuild this package's objects from plain Python
and numpy values (``dataclasses.asdict`` of a spec, pyramid levels and
vector fields as numpy arrays) and turn them back, so a pyramid or a field
made by one package can be fed to the other without either importing the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .core.config import AnalyseSpec, SuperSpec
from .core.types import (AnalysisMeta, ColorFamily, MVField, MVPlaneField,
                         SearchType)
from .super import Super


def require_device(device) -> torch.device:
    """torch.device(device); asking for a card that is not there raises
    instead of landing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "present; pass device='cpu' explicitly")
    return dev


def clip_from_numpy(planes: Sequence[np.ndarray], device="cuda"):
    """[Y] or [Y, U, V] numpy planes ([T, H, W] uint8 each) -> the list of
    tensors on `device` that build_super and degrain_clip take."""
    dev = require_device(device)
    return [torch.from_numpy(np.ascontiguousarray(p)).to(dev) for p in planes]


def clip_to_numpy(planes: Sequence[torch.Tensor]):
    return [p.cpu().numpy() for p in planes]


def super_spec_from_dict(d: dict) -> SuperSpec:
    return SuperSpec(**dict(d, family=ColorFamily(int(d["family"]))))


def analysis_meta_from_dict(d: dict) -> AnalysisMeta:
    return AnalysisMeta(**d)


def analyse_spec_from_dict(d: dict) -> AnalyseSpec:
    return AnalyseSpec(**dict(
        d, meta=analysis_meta_from_dict(d["meta"]),
        search=SearchType(int(d["search"])),
        search_coarse=SearchType(int(d["search_coarse"]))))


def spec_to_dict(spec) -> dict:
    """Plain dict of a SuperSpec / AnalyseSpec / AnalysisMeta (enums as
    ints)."""
    return {k: (int(v) if isinstance(v, (ColorFamily, SearchType)) else v)
            for k, v in dataclasses.asdict(spec).items()}


def super_from_numpy(planes: Sequence[Sequence[np.ndarray]], spec: SuperSpec,
                     device="cuda") -> Super:
    """planes[p][level] numpy arrays, one entry per color plane (level 0
    [(F,) pel^2, PH, PW], deeper levels [(F,) PH, PW]) -> Super on
    `device`."""
    dev = require_device(device)
    return Super(tuple(tuple(torch.from_numpy(np.ascontiguousarray(lv)).to(dev)
                             for lv in p) for p in planes), spec)


def super_to_numpy(sup: Super):
    return tuple(tuple(lv.cpu().numpy() for lv in p) for p in sup.planes)


def mvfield_from_numpy(levels: Sequence[Sequence[np.ndarray]], meta: dict,
                       device="cuda", validity=None) -> MVField:
    """levels[lv] = (x, y, sad) numpy arrays, finest first; meta: the
    AnalysisMeta as a dict -> MVField on `device`."""
    dev = require_device(device)
    out = []
    for x, y, sad in levels:
        out.append(MVPlaneField(
            torch.from_numpy(np.asarray(x, np.int32)).to(dev),
            torch.from_numpy(np.asarray(y, np.int32)).to(dev),
            torch.from_numpy(np.asarray(sad, np.int64)).to(dev)))
    lead = tuple(out[0].x.shape[:-2])
    if validity is None:
        validity = np.ones(lead, np.int32)
    return MVField(tuple(out),
                   torch.from_numpy(np.asarray(validity, np.int32)).to(dev),
                   analysis_meta_from_dict(meta))


def mvfield_to_numpy(mv: MVField):
    """(levels, meta dict, validity) of an MVField as numpy / plain values."""
    levels = [(l.x.cpu().numpy(), l.y.cpu().numpy(), l.sad.cpu().numpy())
              for l in mv.levels]
    return levels, spec_to_dict(mv.meta), mv.validity.cpu().numpy()
