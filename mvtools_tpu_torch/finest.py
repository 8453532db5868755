"""mv.Finest equivalent: interleave pel subplanes into one fine grid.

Equivalent of MVFinest.c + Merge4/16PlanesToBig (MaskFun.cpp:207-336).
Output planes have padded dimensions times pel: the per-pixel "finest"
image the Flow family samples from.
"""

from __future__ import annotations

from typing import List

import torch

from .super import Super


def interleave_stack(stack: torch.Tensor) -> torch.Tensor:
    """[(F,) pel^2, ph, pw] -> [(F,) ph*pel, pw*pel] with out[y, x] =
    stack[(x & m) | ((y & m) << log_pel)][y >> log_pel, x >> log_pel]
    (a permuted copy: any pixel dtype)."""
    pel2, ph, pw = stack.shape[-3:]
    pel = int(round(pel2 ** 0.5))
    lead = stack.shape[:-3]
    if pel == 1:
        return stack[..., 0, :, :]
    # stack index = xfrac | (yfrac << log_pel): [.., yfrac, xfrac, ph, pw]
    s = stack.reshape(lead + (pel, pel, ph, pw))
    n = len(lead)
    # out[.., yb*pel + yf, xb*pel + xf] = s[.., yf, xf, yb, xb]
    perm = tuple(range(n)) + (n + 2, n, n + 3, n + 1)
    return s.permute(perm).reshape(lead + (ph * pel, pw * pel))


def finest(sup: Super) -> List[torch.Tensor]:
    """The pel-interleaved full planes of a super frame (dims = padded *
    pel, MVFinest.c:198-199); a batched Super gives batched planes."""
    return [interleave_stack(sup.planes[p][0]) for p in range(sup.num_planes)]
