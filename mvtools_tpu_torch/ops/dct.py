"""2-D DCT block transform for the DCT cost modes (dct 1-4).

Equivalent of DCTFFTW (DCTFFTW.cpp): an unnormalised DCT-II (FFTW REDFT10
convention, output = 2 * sum(x * cos(...)) per axis) followed by
requantisation to the pixel range (Float2Pixels_C DCTFFTW.cpp:30-54):

    f     = coef * sqrt(2)/2          (DC: coef * 0.5)
    integ = nearbyint(f)              (round half to even)
    out   = clamp((integ >> dctshift) + pixelHalf, 0, pixelMax)
    dctshift  = ceil(log2(blkArea)), dctshift0 = dctshift + 2 (DC)

The transform is two cosine-matrix products accumulated in float64; each
coefficient is cast to float32 before the sqrt(2)/2 scale, exactly as the
JAX package's dct_block does.  The products are written out as float64
multiplies and adds in a fixed order: first t = C_y @ x summed over the rows
j = 0, 1, ..., then t @ C_x^T summed over the columns k = 0, 1, ...  That is
the grouping and the order in which the JAX package's einsum sums on XLA:CPU,
and identical IEEE operations give identical bits on the CPU and on the card.
A library matrix product sums in an order of its own: its float64 result can
differ in the last bit, and such a difference reaches the output wherever it
crosses a float32 rounding boundary, then a half-integer, then a multiple of
2^dctshift (tests/test_torch_dct.py holds the port to the JAX package bit for
bit; chip_smoke.py holds the card to the CPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct2_matrix_np(n: int) -> np.ndarray:
    """Unnormalised DCT-II matrix: out[k] = 2 * sum_j in[j]*cos(pi*(j+.5)*k/n)."""
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    return 2.0 * np.cos(np.pi * (j + 0.5) * k / n)


@functools.lru_cache(maxsize=None)
def _dct2_matrix(n: int, device) -> torch.Tensor:
    """The float64 DCT-II matrix of _dct2_matrix_np, made once per device."""
    return torch.from_numpy(_dct2_matrix_np(n)).to(device)


def dct_shift(sizex: int, sizey: int) -> int:
    """ceil(log2(blkArea)) (reference: dctInit DCTFFTW.cpp:146-153)."""
    return max(sizex * sizey - 1, 0).bit_length()


_SQRT2_DIV2 = math.sqrt(2.0) / 2.0


def _requantise(coefs: torch.Tensor, scale: float, shift: int,
                bits: int) -> torch.Tensor:
    """float64 coefficients -> int64 pixels: float32 cast, float32 scale,
    round half to even, arithmetic shift, clamp to the pixel range."""
    f = coefs.to(torch.float32) * torch.tensor(scale, dtype=torch.float32)
    integ = torch.round(f).to(torch.int64)
    return ((integ >> shift) + (1 << (bits - 1))).clamp_(0, (1 << bits) - 1)


def dct_block(block: torch.Tensor, bits: int) -> torch.Tensor:
    """DCT-transform blocks [..., bh, bw] (any integer type) and requantise
    to the pixel range.  Returns int32 in [0, pixelMax]; the cost modes take
    SADs of these blocks like pixel blocks (pobLumaSAD dctmode 1-4,
    PlaneOfBlocks.cpp:123-163)."""
    bh, bw = block.shape[-2], block.shape[-1]
    cy = _dct2_matrix(bh, block.device)
    cx = _dct2_matrix(bw, block.device)
    x = block.to(torch.float64)
    t = cy[:, 0, None] * x[..., 0, None, :]
    for j in range(1, bh):
        t += cy[:, j, None] * x[..., j, None, :]
    del x
    coefs = t[..., :, 0, None] * cx[:, 0]
    for k in range(1, bw):
        coefs += t[..., :, k, None] * cx[:, k]
    del t
    shift = dct_shift(bw, bh)
    out = _requantise(coefs, _SQRT2_DIV2, shift, bits)
    out[..., 0, 0] = _requantise(coefs[..., 0, 0], 0.5, shift + 2, bits)
    return out.to(torch.int32)
