"""Pyramid downscale (RB2) filter.

Equivalent of the reference's bilinear reduce filter (RB2BilinearFiltered,
MVFrame.cpp:575-1014, `rfilter` 2 in mvpReduceTo MVFrame.cpp:1634-1683): a
2x decimator run as a vertical pass producing an intermediate of width
2*w_dst followed by a horizontal pass.  Arithmetic is int32 and matches the
C code bit for bit (all intermediate values are non-negative, so C's `/2`
and `>>` agree with floor division).  The other four rfilter values are not
ported yet and raise.

Boundary semantics: the reference reads up to two rows/columns beyond the
unpadded source region.  When reducing level 0 the surrounding bytes are the
zero-initialised super frame (MVSuper.c:75 memset happens before any
padding); when reducing level k>=1 the source was already replicate-padded
(mvgofReduce pads each level right after filling it, MVFrame.cpp:1928-1933).
Callers express this via `zero_context`.

All functions take [..., H, W] tensors; leading axes are a frame batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pad import edge_pad

RFILTER_BILINEAR = 2

_CONTEXT = 4  # rows/cols of context appended beyond the unpadded region


def _extend(src: torch.Tensor, zero_context: bool) -> torch.Tensor:
    """Append bottom/right context the reference would read past the region."""
    if zero_context:
        return F.pad(src, (0, _CONTEXT, 0, _CONTEXT))
    return edge_pad(src, 0, _CONTEXT, 0, _CONTEXT)


def _avg_rows(s, y, w2):
    return (s[..., 2 * y, :w2] + s[..., 2 * y + 1, :w2] + 1) // 2


def _vertical_taps(s, h: int, w2: int, taps, rnd: int, shift: int,
                   first_avg_rows: int, last_avg_rows: int):
    """`first_avg_rows` top rows and `last_avg_rows` bottom rows are 2-tap
    averages, the middle rows use the symmetric filter `taps` whose first
    tap reads source row 2y - 1."""
    rows = [_avg_rows(s, y, w2).unsqueeze(-2)
            for y in range(min(first_avg_rows, h))]
    y_mid_end = max(h - last_avg_rows, first_avg_rows)
    if h > first_avg_rows:
        n_mid = y_mid_end - first_avg_rows
        if n_mid > 0:
            acc = 0
            for t, coef in enumerate(taps):
                lo = 2 * first_avg_rows - 1 + t
                acc = acc + coef * s[..., lo:lo + 2 * n_mid:2, :w2]
            rows.append((acc + rnd) >> shift)
        rows += [_avg_rows(s, y, w2).unsqueeze(-2)
                 for y in range(y_mid_end, h)]
    return torch.cat(rows, dim=-2)


def _horizontal_taps(v, w: int, taps, rnd: int, shift: int,
                     last_avg_cols: int):
    """Horizontal pass over the vertical intermediate `v` [..., h, 2*w]:
    column 0 is the 2-tap average of cols 0..1, `last_avg_cols` final
    columns are 2-tap averages, the middle uses `taps` centred on source
    cols 2x..2x+1."""
    def avg(x):
        return ((v[..., 2 * x] + v[..., 2 * x + 1] + 1) // 2).unsqueeze(-1)

    cols = [avg(0)]
    x_mid_end = max(w - last_avg_cols, 1)
    if w > 1:
        n_mid = x_mid_end - 1
        if n_mid > 0:
            acc = 0
            for t, coef in enumerate(taps):
                lo = 1 + t
                acc = acc + coef * v[..., lo:lo + 2 * n_mid:2]
            cols.append((acc + rnd) >> shift)
        cols += [avg(x) for x in range(x_mid_end, w)]
    return torch.cat(cols, dim=-1)


def rb2(src: torch.Tensor, h_dst: int, w_dst: int, rfilter: int,
        zero_context: bool) -> torch.Tensor:
    """Reduce the unpadded [..., H, W] source region to
    [..., h_dst, w_dst].  Returns int32."""
    if rfilter != RFILTER_BILINEAR:
        raise NotImplementedError(
            f"rfilter={rfilter}: only the bilinear reduce filter "
            "(rfilter=2) is ported")
    s = _extend(src.to(torch.int32), zero_context)
    v = _vertical_taps(s, h_dst, 2 * w_dst, (1, 3, 3, 1), 4, 3,
                       first_avg_rows=1, last_avg_rows=1)
    return _horizontal_taps(v, w_dst, (1, 3, 3, 1), 4, 3, last_avg_cols=1)
