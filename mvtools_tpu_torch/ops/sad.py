"""Block cost helpers: SAD and block luma sum over the trailing two axes
(reference: sad_c SADFunctions.cpp:354-367, luma_c Luma.cpp:14-25).
Inputs are widened to int32 first: uint8 arithmetic wraps in torch."""

from __future__ import annotations

import torch


def sad(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d = src.to(torch.int32) - ref.to(torch.int32)
    return d.abs().sum(dim=(-2, -1))


def luma(src: torch.Tensor) -> torch.Tensor:
    return src.to(torch.int32).sum(dim=(-2, -1))
