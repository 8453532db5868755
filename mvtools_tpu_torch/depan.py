"""Depan quartet: global-motion analysis, estimation, compensation and
stabilisation, after the JAX package's depan.py (MVDepan.cpp).

* depan_analyse — global pan/zoom/rot from an MV field by iterative
  weighted least squares with outlier rejection (TrasformUpdate
  MVDepan.cpp:145-199, RejectBadBlocks :203-234, main loop :297-346): the
  per-block loops are whole-field reductions on the field's device; phase
  2's convergence test is one host read a step (counted in `host_syncs`).
* depan_estimate — FFT phase-correlation global translation (+zoom from a
  left/right window split) for a whole clip at once (get_plane_fft
  :887-893, mult_conj_data2d :681-697, get_motion_vector :700-883,
  stages :956-1243), with torch.fft (pocketfft on the CPU, cuFFT on the
  card), scaled as fftw's unnormalised inverse is.
* depan_compensate — warp by accumulated fractional-offset transforms
  (:2588-2735) with ops/warp.py's nearest/bilinear/bicubic warps.
* depan_stabilise — method 0 inertial damped-oscillator smoothing, method
  1 windowed average, adaptive zoom, soft limits, fitlast, prev/next border
  filling (:2945-3885).  The per-frame transforms are host numpy float32
  (stabilise_transforms), the warps run on the frames' device.

Motion conventions shared with the reference: per-frame motion record
(dx, dy, zoom, rot) where frame 0 is (0,0,1,0); dx == 0.0 marks a scene
change (MOTIONBAD); all float math is float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.thscd import is_usable, scale_thscd
from .core.types import AnalysisMeta, MVField
from .ops import pixels
from .ops.warp import (
    MOTION_BAD,
    Transform,
    as_transform,
    inversetransform,
    motion2transform,
    null_transform,
    sumtransform,
    transform2motion,
    transform_for_plane,
    warp_plane,
)

F32 = np.float32
TF32 = torch.float32

host_syncs = 0   # scalar reads the host waited for in depan_analyse


# ---------------------------------------------------------------------------
# DepanAnalyse


@dataclasses.dataclass(frozen=True)
class DepanAnalyseConfig:
    """mv.DepanAnalyse parameters (MVDepan.cpp:473-614)."""
    zoom: bool = True
    rot: bool = True
    pixaspect: float = 1.0
    error: float = 15.0
    info: bool = False
    wrong: float = 10.0
    zerow: float = 0.05
    thscd1: int = 400
    thscd2: int = 130
    fields: bool = False
    tff: Optional[bool] = None

    def __post_init__(self):
        if self.pixaspect <= 0.0:
            raise ValueError("DepanAnalyse: pixaspect must be positive.")


def _transform_update(tr, bdx, bdy, bx, by, bw, safety, if_zoom, if_rot,
                      pixaspect):
    """One gradient-descent step (TrasformUpdate MVDepan.cpp:145-199) on a
    transform of six 0-d float32 tensors.  Returns (new_tr, error)."""
    xdif = tr.dxc + tr.dxx * bx + tr.dxy * by - bx - bdx
    ydif = tr.dyc + tr.dyx * bx + tr.dyy * by - by - bdy
    norm = 0.1 + bw.sum()
    x2 = 0.1 + (bx * bx * bw).sum()
    y2 = 0.1 + (by * by * bw).sum()
    error2 = 0.1 + ((xdif * xdif + ydif * ydif) * bw).sum()

    zf = float(if_zoom)
    rf = float(if_rot)
    d_dxc = (2 * xdif * bw).sum() / (norm * 2)
    d_dxx = zf * (2 * bx * xdif * bw).sum() / (x2 * 2 * 1.5)
    d_dxy = rf * (2 * by * xdif * bw).sum() / (y2 * 2 * 3)
    d_dyc = (2 * ydif * bw).sum() / (norm * 2)
    d_dyx = rf * (2 * bx * ydif * bw).sum() / (x2 * 2 * 3)
    d_dyy = zf * (2 * by * ydif * bw).sum() / (y2 * 2 * 1.5)

    error = torch.sqrt(error2 / norm)

    dxc = tr.dxc - safety * d_dxc
    dxx = tr.dxx - safety * 0.5 * (d_dxx + d_dyy) if if_zoom else tr.dxx
    dxy = tr.dxy - safety * 0.5 * (d_dxy - d_dyx / (pixaspect * pixaspect))
    dyc = tr.dyc - safety * d_dyc
    dyy = dxx if if_zoom else tr.dyy
    dyx = -pixaspect * pixaspect * dxy
    return Transform(dxc, dxx, dxy, dyc, dyx, dyy), error


def _reject_bad_blocks(tr, bdx, bdy, bsad, bx, by, wmask, nbx, nby,
                       wrong_dif, global_dif, thscd1, zerow, ignored_border):
    """Vectorized RejectBadBlocks (MVDepan.cpp:203-234)."""
    dev = bdx.device
    j = torch.arange(nby, device=dev)[:, None]
    i = torch.arange(nbx, device=dev)[None, :]
    bdx2 = bdx.reshape(nby, nbx)
    bdy2 = bdy.reshape(nby, nbx)
    rows = torch.arange(-1, nby + 1, device=dev).clamp(0, nby - 1)
    cols = torch.arange(-1, nbx + 1, device=dev).clamp(0, nbx - 1)

    def nbr_mean(a):
        p = a[rows][:, cols]                    # edge padding by one
        s = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
             + p[1:-1, :-2] + p[1:-1, 2:]
             + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:])
        return s / 8

    border = ((i < ignored_border) | (i >= nbx - ignored_border)
              | (j < ignored_border) | (j >= nby - ignored_border))
    big_sad = bsad.reshape(nby, nbx) > thscd1
    interior_x = (i > 0) & (i < nbx - 1)
    interior_y = (j > 0) & (j < nby - 1)
    wrong_x = interior_x & ((nbr_mean(bdx2) - bdx2).abs() > wrong_dif)
    wrong_y = interior_y & ((nbr_mean(bdy2) - bdy2).abs() > wrong_dif)
    glob_x = (tr.dxc + tr.dxx * bx + tr.dxy * by - bx
              - bdx).abs().reshape(nby, nbx) > global_dif
    glob_y = (tr.dyc + tr.dyx * bx + tr.dyy * by - by
              - bdy).abs().reshape(nby, nbx) > global_dif
    zero_mv = (bdx2 == 0.0) & (bdy2 == 0.0)

    bad = border | big_sad | wrong_x | wrong_y | glob_x | glob_y
    wm = wmask.reshape(nby, nbx)
    w = torch.where(bad, 0.0, torch.where(zero_mv, zerow * wm, wm))
    return w.reshape(-1)


def depan_analyse(mv: MVField, meta: AnalysisMeta, cfg: DepanAnalyseConfig,
                  mask_plane: Optional[torch.Tensor] = None,
                  top_field: Optional[bool] = None):
    """Estimate global motion (dx, dy, zoom, rot) from one MV field (no job
    axis), on the field's device.

    Returns four numpy float32 scalars, (0,0,1,0) on failure/scene change
    (depanAnalyseGetFrame MVDepan.cpp:237-427).  Phase 2 reads its stop
    test on the host once a step and the result once: each read adds one to
    `host_syncs`.
    """
    global host_syncs
    nscd1, nscd2 = scale_thscd(cfg.thscd1, cfg.thscd2, meta, "DepanAnalyse")
    nbx, nby = meta.blk_x, meta.blk_y
    nfields = 2 if cfg.fields else 1
    pixaspect_h = F32(cfg.pixaspect / nfields)
    pixaspect = float(pixaspect_h)

    finest = mv.levels[0]
    dev = finest.x.device
    usable = is_usable(mv, nscd1, nscd2)

    d_pel = float(F32(1.0 / meta.pel))
    bdx = finest.x.reshape(-1).to(TF32) * d_pel
    bdy = finest.y.reshape(-1).to(TF32) * d_pel
    bsad = finest.sad.reshape(-1)
    jj, ii = torch.meshgrid(torch.arange(nby, device=dev),
                            torch.arange(nbx, device=dev), indexing="ij")
    bx = ((ii * (meta.blk_size_x - meta.overlap_x))
          + meta.blk_size_x // 2).reshape(-1).to(TF32)
    by = ((jj * (meta.blk_size_y - meta.overlap_y))
          + meta.blk_size_y // 2).reshape(-1).to(TF32)

    if mask_plane is not None:
        bxi, byi = bx.to(torch.int32), by.to(torch.int32)
        mx = bxi.clamp(0, meta.width - 1).long()
        my = byi.clamp(0, meta.height - 1).long()
        in_frame = (bxi < meta.width) & (byi < meta.height)
        wmask = torch.where(in_frame,
                            pixels.widen(mask_plane)[my, mx].to(TF32), 1.0)
        ignored_border = 0
    else:
        wmask = torch.ones_like(bx)
        ignored_border = 4

    def reject(tr, global_dif):
        return _reject_bad_blocks(tr, bdx, bdy, bsad, bx, by, wmask, nbx,
                                  nby, cfg.wrong, global_dif, nscd1,
                                  cfg.zerow, ignored_border)

    tr = Transform(*(torch.tensor(v, dtype=TF32, device=dev)
                     for v in null_transform()))
    w = wmask

    # phase 1: translation only, 5 iterations (MVDepan.cpp:317-328)
    for _ in range(5):
        tr, err = _transform_update(tr, bdx, bdy, bx, by, w, float(F32(0.3)),
                                    False, False, pixaspect)
        w = reject(tr, 1000.0)

    # phase 2: full model until convergence (MVDepan.cpp:331-346)
    half_errordif = float(F32(0.01) * F32(0.5))
    errordif = float(F32(0.01))
    errcur = err
    it = 5
    while it < 100:
        safety = float(F32(0.3 if it < 8 else 0.6 if it < 10 else 1.0))
        errprev = errcur
        tr, errcur = _transform_update(tr, bdx, bdy, bx, by, w, safety,
                                       cfg.zoom, cfg.rot, pixaspect)
        done = ((((errprev - errcur) < half_errordif) & (it > 9))
                | (errcur < errordif))
        host_syncs += 1
        it += 1
        if bool(done):
            break
        w = reject(tr, errcur * 2)

    # convert to motion (MVDepan.cpp:353-399), on the host
    host = torch.stack([*tr, errcur, usable.to(TF32)]).cpu().numpy()
    host_syncs += 1
    tr = as_transform(host[:6])
    errcur, usable = host[6], bool(host[7])
    xcenter = F32(meta.width / 2)
    ycenter = F32(meta.height / 2)
    if meta.is_backward:
        dx, dy, rot, zoom = transform2motion(inversetransform(tr), False,
                                             xcenter, ycenter, pixaspect_h)
    else:
        dx, dy, rot, zoom = transform2motion(tr, True, xcenter, ycenter,
                                             pixaspect_h)

    if cfg.fields and top_field is not None:
        dy = dy + F32((0.5 if top_field else -0.5) * 2)

    # tiny-dx nudged off exact zero (scene-change marker); the reference
    # randomizes the sign (rand(), :398) — fixed +0.011, as the JAX package
    if abs(dx) < F32(0.01):
        dx = F32(0.011)

    if not (usable and errcur < F32(cfg.error)):
        return F32(0.0), F32(0.0), F32(1.0), F32(0.0)
    return F32(dx), F32(dy), F32(zoom), F32(rot)


# ---------------------------------------------------------------------------
# DepanEstimate


@dataclasses.dataclass(frozen=True)
class DepanEstimateConfig:
    """mv.DepanEstimate parameters (MVDepan.cpp:1271-1434)."""
    trust: float = 4.0
    winx: int = 0
    winy: int = 0
    wleft: int = -1
    wtop: int = -1
    dxmax: int = -1
    dymax: int = -1
    zoommax: float = 1.0
    stab: float = 1.0
    pixaspect: float = 1.0
    info: bool = False
    show: bool = False
    fields: bool = False
    tff: Optional[bool] = None

    def __post_init__(self):
        if not 0.0 <= self.trust <= 100.0:
            raise ValueError(
                "DepanEstimate: trust must be between 0.0 and 100.0 "
                "(inclusive).")
        if self.pixaspect <= 0.0:
            raise ValueError("DepanEstimate: pixaspect must be positive.")

    def resolve(self, width: int, height: int):
        """Window geometry auto-sizing (MVDepan.cpp:1356-1428)."""
        wleft = max(self.wleft, 0)
        winx = self.winx
        if winx > width - wleft:
            raise ValueError(
                "DepanEstimate: winx must not be greater than width-wleft.")
        if winx == 0:
            winx = width - wleft
            wx = 1
            while wx * 2 <= winx:
                wx *= 2
            winx = wx
        if self.zoommax != 1.0:
            winx //= 2
            if self.wleft < 0:
                wleft = (width - winx * 2) // 4
        elif self.wleft < 0:
            wleft = (width - winx) // 2

        wtop = max(self.wtop, 0)
        winy = self.winy
        if winy > height - wtop:
            raise ValueError(
                "DepanEstimate: winy must not be greater than height-wtop.")
        if winy == 0:
            winy = height - wtop
            wy = 1
            while wy * 2 <= winy:
                wy *= 2
            winy = wy
        if self.wtop < 0:
            wtop = (height - winy) // 2

        dxmax = self.dxmax if self.dxmax >= 0 else winx // 4
        dymax = self.dymax if self.dymax >= 0 else winy // 4
        if dxmax >= winx // 2:
            raise ValueError("DepanEstimate: dxmax must be less than winx/2.")
        if dymax >= winy // 2:
            raise ValueError("DepanEstimate: dymax must be less than winy/2.")
        return winx, winy, wleft, wtop, dxmax, dymax


def _corr_motion(correl, winx, winy, dxmax, dymax, trust_limit, stab,
                 pixaspect):
    """Peak search + sub-pixel parabola on correlation surfaces
    (get_motion_vector MVDepan.cpp:700-883, without field logic), one per
    frame.  correl: [N, winy, winx] float32.  Returns (fdx, fdy, trust),
    [N] each."""
    n = correl.shape[0]
    dev = correl.device
    j = torch.arange(winy, device=dev)[:, None]
    i = torch.arange(winx, device=dev)[None, :]
    corner = (((j <= dymax) | (j >= winy - dymax))
              & ((i <= dxmax) | (i >= winx - dxmax)))
    masked = torch.where(corner, correl, float(F32(-3.4e38)))
    flat = masked.reshape(n, -1)
    k = torch.argmax(flat, dim=1)               # the first maximum
    correlmax = flat.gather(1, k[:, None])[:, 0]
    jmax = torch.div(k, winx, rounding_mode="floor")
    imax = k % winx
    count = corner.sum()
    correlmean = torch.where(corner, correl, 0.0).sum(dim=(1, 2)) / count

    area = float(F32(winx * winy))
    correlmax_n = correlmax / area
    correlmean_n = correlmean / area
    trust = (correlmax_n - correlmean_n) * 100.0 / (correlmax_n + 0.1)

    dx = torch.where(imax * 2 < winx, imax, imax - winx).to(TF32)
    dy = torch.where(jmax * 2 < winy, jmax, jmax - winy).to(TF32)

    trust = trust * ((dxmax + 1) / (dxmax + 1 + stab * dx.abs())
                     * (dymax + 1) / (dymax + 1 + stab * dy.abs()))

    imaxp1 = torch.where(imax + 1 < winx, imax + 1, imax + 1 - winx)
    imaxm1 = torch.where(imax - 1 >= 0, imax - 1, imax - 1 + winx)
    jmaxp1 = torch.where(jmax + 1 < winy, jmax + 1, jmax + 1 - winy)
    jmaxm1 = torch.where(jmax - 1 >= 0, jmax - 1, jmax - 1 + winy)
    f = torch.arange(n, device=dev)

    def parabola(c_plus, c_minus, c_mid, d, dmax):
        f1 = (c_plus - c_minus) / 2.0
        f2 = c_plus + c_minus - c_mid * 2.0
        add = torch.where(f2 == 0.0, 0.0, torch.clamp(
            -f1 / torch.where(f2 == 0.0, 1.0, f2), -1.0, 1.0))
        return torch.where((d + add).abs() > dmax, 0.0, add)

    c_mid = correl[f, jmax, imax]
    xadd = parabola(correl[f, jmax, imaxp1], correl[f, jmax, imaxm1], c_mid,
                    dx, dxmax)
    yadd = parabola(correl[f, jmaxp1, imax], correl[f, jmaxm1, imax], c_mid,
                    dy, dymax)

    fdx = dx + xadd
    fdy = (dy + yadd) / pixaspect
    fdx = torch.where(fdx.abs() < float(F32(0.01)), float(F32(0.011)), fdx)

    good = trust >= trust_limit
    fdx = torch.where(good, fdx, 0.0)
    fdy = torch.where(good, fdy, 0.0)
    return fdx, fdy, trust


def depan_estimate(frames: torch.Tensor, cfg: DepanEstimateConfig,
                   return_correl: bool = False):
    """Global translation (+zoom) for a whole clip by FFT correlation, on
    the frames' device.

    frames: [N, H, W] luma planes.  Returns (dx, dy, zoom, trust) float32
    tensors of shape [N]; frame 0 and low-trust frames get the scene-change
    record (0, 0, 1) (depanEstimateStage2/3 MVDepan.cpp:1000-1243).
    With return_correl=True, additionally returns the per-frame
    correlation surface(s) [N, winy, winx] (the `show` debug surface,
    MVDepan.cpp:1072-1124) — one per window, (surface,) or
    (surface_left, surface_right) for the zoom split.
    """
    n, height, width = frames.shape
    winx, winy, wleft, wtop, dxmax, dymax = cfg.resolve(width, height)
    pixaspect = float(F32(cfg.pixaspect))  # field logic handled by caller
    correls = []

    def windows(off):
        return frames[:, wtop:wtop + winy, off:off + winx].to(TF32)

    def motion_for(win_stack):
        fft = torch.fft.rfft2(win_stack)              # [N, winy, winx//2+1]
        prev = torch.cat([fft[:1], fft[:-1]], dim=0)
        cross = torch.conj(fft) * prev                # conj(cur) * prev
        # (mult_conj_data2d MVDepan.cpp:681-697: conj(fftnext)*fftsrc with
        # fftnext=cur, fftsrc=prev — peak at the motion of cur vs prev);
        # fftw's c2r is unnormalised (a factor winx*winy against torch's
        # normalised inverse): reproduce fftw's scale for the trust values
        correl = torch.fft.irfft2(cross, s=(winy, winx)) * (winx * winy)
        correls.append(correl)
        return _corr_motion(correl, winx, winy, dxmax, dymax, cfg.trust,
                            cfg.stab, pixaspect)

    if cfg.zoommax == 1.0:
        dx, dy, trust = motion_for(windows(wleft))
        zoom = torch.ones((n,), dtype=TF32, device=frames.device)
    else:
        wleft2 = wleft + width // 2
        dx1, dy1, trust1 = motion_for(windows(wleft))
        dx2, dy2, trust2 = motion_for(windows(wleft2))
        zoom = 1.0 + (dx2 - dx1) / (wleft2 - wleft)
        good = ((dx1 != 0.0) & (dx2 != 0.0)
                & ((zoom - 1.0).abs() < float(F32(cfg.zoommax - 1.0))))
        dx = torch.where(good, (dx1 + dx2) / 2.0, 0.0)
        dy = torch.where(good, (dy1 + dy2) / 2.0, 0.0)
        zoom = torch.where(good, zoom, 1.0)
        trust = torch.minimum(trust1, trust2)

    # frame 0 has no predecessor (MVDepan.cpp:1137-1140)
    first = torch.arange(n, device=frames.device) == 0
    dx = torch.where(first, 0.0, dx)
    dy = torch.where(first, 0.0, dy)
    zoom = torch.where(first, 1.0, zoom)
    trust_out = torch.where(first, 0.0, trust)

    # stage 3: sharp trust drop vs neighbours => scene change
    # (MVDepan.cpp:1201-1212)
    t_prev = torch.cat([trust_out[:1], trust_out[:-1]])
    t_next = torch.cat([trust_out[1:], trust_out[-1:]])
    sharp = ((trust_out < float(F32(cfg.trust * 2.0)))
             & ((trust_out < 0.5 * t_prev) | (trust_out < 0.5 * t_next)))
    dx = torch.where(sharp, 0.0, dx)
    dy = torch.where(sharp, 0.0, dy)
    zoom = torch.where(sharp, 1.0, zoom)
    if return_correl:
        return dx, dy, zoom, trust_out, tuple(correls)
    return dx, dy, zoom, trust_out


def render_correlation(planes: torch.Tensor, correl: torch.Tensor,
                       winleft: int, wintop: int, pixel_max: int
                       ) -> torch.Tensor:
    """Paint correlation surfaces into frame planes — the reference's
    `show` debug view (showcorrelation, MVDepan.cpp:895-952): min-max
    normalise each surface to [0, pixel_max] and overwrite the window
    region of its plane.  planes: [N, H, W]; correl: [N, winy, winx]."""
    _, winy, winx = correl.shape
    cmin = correl.amin(dim=(1, 2), keepdim=True)
    cmax = correl.amax(dim=(1, 2), keepdim=True)
    norm = pixel_max / torch.clamp(cmax - cmin, min=float(F32(1e-30)))
    img = ((correl - cmin) * norm).to(torch.int32).clamp(0, pixel_max)
    out = planes.clone()
    out[:, wintop:wintop + winy, winleft:winleft + winx] = pixels.narrow(
        img, planes.dtype)
    return out


def depan_estimate_show(frames: torch.Tensor, cfg: DepanEstimateConfig):
    """DepanEstimate with show=True: the clip with each frame's window
    region replaced by its normalised correlation surface
    (MVDepan.cpp:1072-1124).  Returns (shown_frames, dx, dy, zoom,
    trust)."""
    n, height, width = frames.shape
    winx, winy, wleft, wtop, _, _ = cfg.resolve(width, height)
    dx, dy, zoom, trust, correls = depan_estimate(frames, cfg,
                                                  return_correl=True)
    pixel_max = 255 if frames.dtype == torch.uint8 else 65535
    shown = frames
    offsets = [wleft] if len(correls) == 1 else [wleft, wleft + width // 2]
    for corr, off in zip(correls, offsets):
        shown = render_correlation(shown, corr, off, wtop, pixel_max)
    return shown, dx, dy, zoom, trust


def depan_analyse_info(n, iter_, error, dx, dy, rot, zoom) -> str:
    """DepanAnalyse_info frame prop text (MVDepan.cpp:401-408)."""
    return (f"fn={n} iter={iter_} error={error:.3f} dx={dx:.2f} "
            f"dy={dy:.2f} rot={rot:.3f} zoom={zoom:.5f}")


def depan_estimate_info(n, dx, dy, zoom, trust) -> str:
    """DepanEstimate_info frame prop text (MVDepan.cpp:1229-1236)."""
    return f"fn={n} dx={dx:.2f} dy={dy:.2f} zoom={zoom:.5f} trust={trust:.2f}"


def depan_compensate_info(offset, nsrc, ndest, dx, dy, rot, zoom) -> str:
    """DepanCompensate_info frame prop text (MVDepan.cpp:2717-2728)."""
    return (f"offset={offset:.2f}, {nsrc} to {ndest}, dx={dx:.2f}, "
            f"dy={dy:.2f}, rot={rot:.3f} zoom={zoom:.5f}")


def depan_stabilise_info(ndest, nbase, dx, dy, rot, zoom) -> str:
    """DepanStabilise_info frame prop text (MVDepan.cpp:3549-3557)."""
    base = "BASE!" if nbase == ndest else "base "
    return (f"frame={ndest} {base}={nbase} dx={dx:.2f} dy={dy:.2f} "
            f"rot={rot:.3f} zoom={zoom:.5f}")


# ---------------------------------------------------------------------------
# DepanCompensate


@dataclasses.dataclass(frozen=True)
class DepanCompensateConfig:
    """mv.DepanCompensate parameters (MVDepan.cpp:2750-2857)."""
    offset: float = 0.0
    subpixel: int = 2
    pixaspect: float = 1.0
    matchfields: bool = True
    mirror: int = 0
    blur: int = 0
    info: bool = False
    fields: bool = False
    tff: Optional[bool] = None

    def __post_init__(self):
        if not -10.0 <= self.offset <= 10.0:
            raise ValueError(
                "DepanCompensate: offset must be between -10.0 and 10.0 "
                "(inclusive).")
        if not 0 <= self.subpixel <= 2:
            raise ValueError(
                "DepanCompensate: subpixel must be between 0 and 2 "
                "(inclusive).")
        if self.pixaspect <= 0.0:
            raise ValueError(
                "DepanCompensate: pixaspect must be greater than 0.")
        if not 0 <= self.mirror <= 15:
            raise ValueError(
                "DepanCompensate: mirror must be between 0 and 15 "
                "(inclusive).")
        if self.blur < 0:
            raise ValueError("DepanCompensate: blur must not be negative.")

    @property
    def intoffset(self) -> int:
        return (math.ceil(self.offset) if self.offset > 0
                else math.floor(self.offset))


def _accumulate_transform(motions, frames_range, forward, fractoffset,
                          pixaspect, xcenter, ycenter):
    """Sum motion transforms over a frame interval; a MOTIONBAD record
    resets to identity (DepanCompensate loop MVDepan.cpp:2630-2656).
    motions: host-side list/array of (dx, dy, zoom, rot) rows."""
    tr = null_transform()
    bad = False
    for nf in frames_range:
        dx, dy, zoom, rot = (motions[nf][0], motions[nf][1],
                             motions[nf][2], motions[nf][3])
        bad = bad or dx == MOTION_BAD
        cur = motion2transform(dx, dy, rot, zoom, pixaspect, xcenter,
                               ycenter, forward, fractoffset)
        tr = sumtransform(tr, cur)
    return null_transform() if bad else tr


def depan_compensate(src_planes: Sequence[torch.Tensor],
                     motions: Sequence[Sequence],
                     ndest: int, num_frames: int,
                     cfg: DepanCompensateConfig,
                     sub_w: int = 0, sub_h: int = 0,
                     bits: int = 8,
                     top_field: Optional[bool] = None):
    """Compensate frame `ndest` by the accumulated global transform, on the
    planes' device.

    src_planes: planes of the *source* frame n = ndest - intoffset.
    motions: per-frame motion records indexed by absolute frame number
    (host numbers).  Returns the warped planes (depanCompensateGetFrame
    MVDepan.cpp:2588-2732).
    """
    intoff = cfg.intoffset
    nsrc = ndest - intoff
    if intoff == 0 or nsrc < 0 or nsrc > num_frames - 1:
        return list(src_planes)

    forward = intoff > 0
    fractoffset = cfg.offset + (1 if forward else -1) - intoff
    nfields = 2 if cfg.fields else 1
    pixaspect = cfg.pixaspect / nfields
    h, w = src_planes[0].shape
    xcenter = w / 2.0
    ycenter = h / 2.0

    start = min(nsrc, ndest)
    end = max(nsrc, ndest)
    trsum = _accumulate_transform(motions, range(start + 1, end + 1),
                                  forward, fractoffset, pixaspect,
                                  xcenter, ycenter)

    if cfg.fields and cfg.matchfields and top_field is not None:
        trsum = trsum._replace(
            dyc=trsum.dyc + F32(-0.5 if top_field else 0.5))

    pixel_max = (1 << bits) - 1
    out = []
    for p, plane in enumerate(src_planes):
        tr_p = transform_for_plane(trsum, sub_w, sub_h) if p else trsum
        border = 0 if p == 0 else 1 << (bits - 1)
        blur_p = cfg.blur if p == 0 else cfg.blur // 2
        out.append(warp_plane(plane, tr_p, cfg.subpixel, cfg.mirror,
                              border, blur_p, pixel_max))
    return out


# ---------------------------------------------------------------------------
# DepanStabilise


@dataclasses.dataclass(frozen=True)
class DepanStabiliseConfig:
    """mv.DepanStabilise parameters (MVDepan.cpp:3909-4182)."""
    cutoff: float = 1.0
    damping: float = 0.9
    initzoom: float = 1.0
    addzoom: bool = False
    prev: int = 0
    next: int = 0
    mirror: int = 0
    blur: int = 0
    dxmax: float = 60.0
    dymax: float = 30.0
    zoommax: float = 1.05
    rotmax: float = 1.0
    subpixel: int = 2
    pixaspect: float = 1.0
    fitlast: int = 0
    tzoom: float = 3.0
    info: bool = False
    method: int = 0
    fields: bool = False
    fps: float = 25.0

    def __post_init__(self):
        if self.cutoff <= 0.0:
            raise ValueError(
                "DepanStabilise: cutoff must be greater than 0.")
        if self.prev < 0:
            raise ValueError("DepanStabilise: prev must not be negative.")
        if self.next < 0:
            raise ValueError("DepanStabilise: next must not be negative.")
        if not 0 <= self.subpixel <= 2:
            raise ValueError(
                "DepanStabilise: subpixel must be between 0 and 2 "
                "(inclusive).")
        if self.pixaspect <= 0.0:
            raise ValueError(
                "DepanStabilise: pixaspect must be greater than 0.")
        if not 0 <= self.mirror <= 15:
            raise ValueError(
                "DepanStabilise: mirror must be between 0 and 15 "
                "(inclusive).")
        if self.blur < 0:
            raise ValueError("DepanStabilise: blur must not be negative.")
        if self.method not in (0, 1):
            raise ValueError(
                "DepanStabilise: method must be between 0 and 1 (inclusive).")

    @property
    def freqnative(self) -> float:
        """Native oscillator frequency (MVDepan.cpp:4088-4090)."""
        lam = math.sqrt(1 + 6 * self.damping ** 2
                        + math.sqrt((1 + 6 * self.damping ** 2) ** 2 + 3))
        return self.cutoff / lam

    @property
    def wintsize(self) -> int:
        return int(self.fps / (4 * self.cutoff))

    def nonlinfactor(self):
        """Approximate nonlinear-member factors (MVDepan.cpp:4112-4135)."""
        zoommax = (max(self.zoommax, self.initzoom) if self.zoommax > 0
                   else -max(-self.zoommax, self.initzoom))
        dxc = 5 / abs(self.dxmax) if self.dxmax != 0.0 else 0.0
        dxx = (5 / (abs(zoommax) - 1)) if abs(zoommax) != 1.0 else 0.0
        dyc = 5 / abs(self.dymax) if self.dymax != 0.0 else 0.0
        dxy = 5 / abs(self.rotmax) if self.rotmax != 0.0 else 0.0
        return as_transform((dxc, dxx, dxy, dyc, dxy, dxx))


def _adaptive_zoom(trcur, initzoom, width, height, xcenter, ycenter):
    """Adaptive zoom to hide borders (MVDepan.cpp:3040-3052)."""
    az = F32(initzoom)
    az = min(az, 1 + (trcur.dxc + trcur.dxy * ycenter) / xcenter)
    az = min(az, 1 - (trcur.dxc + trcur.dxx * width
                      + trcur.dxy * ycenter - width) / xcenter)
    az = min(az, 1 + (trcur.dyc + trcur.dyx * xcenter) / ycenter)
    az = min(az, 1 - (trcur.dyc + trcur.dyx * xcenter
                      + trcur.dyy * height - height) / ycenter)
    return F32(az)


def stabilise_transforms(motions: np.ndarray, cfg: DepanStabiliseConfig,
                         width: int, height: int,
                         num_frames: int) -> List[Transform]:
    """Compute the per-frame stabilisation transform trdif for every frame.

    motions: [N, 4] float32 host array of (dx, dy, zoom, rot).  Pure
    host-side float32 numpy (per-frame scalars; the heavy work is the warp).
    Method 0 = Inertial (MVDepan.cpp:2945-3115 + getFrame0 :3562-3666),
    method 1 = windowed Average (:3118-3246 + getFrame1 :3712-3841).
    """
    nfields = 2 if cfg.fields else 1
    pixaspect = np.float32(cfg.pixaspect / nfields)
    xcenter = np.float32(width / 2.0)
    ycenter = np.float32(height / 2.0)
    initzoom = np.float32(1.0 / cfg.initzoom)  # internal def (:4138)
    fps = np.float32(cfg.fps)
    freqnative = np.float32(cfg.freqnative)
    nonlin = cfg.nonlinfactor()
    cdamp = np.float32(12.56 * cfg.damping / fps)
    cquad = np.float32(39.44 / (fps * fps))

    def m2t(nf, fract=1.0, forward=True):
        dx, dy, zoom, rot = motions[nf]
        return motion2transform(dx, dy, rot, zoom, pixaspect, xcenter,
                                ycenter, forward, fract)

    results: List[Transform] = []
    for ndest in range(num_frames):
        if cfg.method == 0:
            nbase = max(0, int(ndest - 10 * fps / cfg.cutoff))
        else:
            nbase = max(0, ndest - cfg.wintsize)
            nmax = min(ndest + cfg.wintsize, num_frames - 1)
        # scan back for scene change (MOTIONBAD)
        for nf in range(ndest, nbase, -1):
            if motions[nf][0] == MOTION_BAD:
                nbase = nf
                break
        if cfg.method == 1:
            for nf in range(ndest + 1, nmax + 1):
                if motions[nf][0] == MOTION_BAD:
                    nmax = max(nf - 1, ndest)
                    break
            dist = min(nmax - ndest, ndest - nbase)
            nmax = ndest + dist
            nbase = ndest - dist

        if cfg.method == 0 and nbase == ndest:
            results.append(motion2transform(0.0, 0.0, 0.0, initzoom,
                                            pixaspect, xcenter, ycenter,
                                            True, 1.0))
            continue

        last = ndest if cfg.method == 0 else nmax
        ncount = last - nbase + 1
        trcumul = [null_transform()]
        for nf in range(nbase + 1, last + 1):
            trcumul.append(sumtransform(trcumul[-1], m2t(nf)))

        if cfg.method == 0:
            trdif = _inertial(trcumul, cfg, nonlin, cdamp, cquad, freqnative,
                              pixaspect, initzoom, xcenter, ycenter, width,
                              height)
            dx, dy, rot, zoom = transform2motion(trdif, True, xcenter,
                                                 ycenter, pixaspect)
            if num_frames < cfg.fitlast + ndest + 1:
                end_factor = np.float32(
                    (num_frames - ndest - 1) / cfg.fitlast)
                dx *= end_factor
                dy *= end_factor
                rot *= end_factor
                zoom = initzoom + (zoom - initzoom) * end_factor
            # limits (InertialLimit :3249-3329)
            reset = not (np.isfinite(dx) and np.isfinite(dy)
                         and np.isfinite(zoom) and np.isfinite(rot))
            if not reset and abs(dx) > abs(cfg.dxmax):
                if cfg.dxmax >= 0:
                    dx = np.float32(_host_soft(dx, cfg.dxmax))
                else:
                    reset = True
            if not reset and abs(dy) > abs(cfg.dymax):
                if cfg.dymax >= 0:
                    dy = np.float32(_host_soft(dy, cfg.dymax))
                else:
                    reset = True
            zoommax = (max(cfg.zoommax, cfg.initzoom) if cfg.zoommax > 0
                       else -max(-cfg.zoommax, cfg.initzoom))
            if not reset and abs(zoom - 1) > abs(zoommax) - 1:
                if zoommax >= 0:
                    s = math.sqrt(abs(zoom - 1) * abs(zoommax - 1))
                    zoom = np.float32(1 + s if zoom >= 1 else 1 - s)
                else:
                    reset = True
            if not reset and abs(rot) > abs(cfg.rotmax):
                if cfg.rotmax >= 0:
                    rot = np.float32(_host_soft(rot, cfg.rotmax))
                else:
                    reset = True
            if reset:
                dx = dy = rot = np.float32(0.0)
                zoom = initzoom
            trdif = motion2transform(dx, dy, rot, zoom, pixaspect, xcenter,
                                     ycenter, True, 1.0)
        else:
            trdif = _average(trcumul, cfg, ndest - nbase, ncount - 1,
                             pixaspect, initzoom, xcenter, ycenter,
                             width, height)
            dx, dy, rot, zoom = transform2motion(trdif, True, xcenter,
                                                 ycenter, pixaspect)
            trdif = motion2transform(dx, dy, rot, zoom, pixaspect, xcenter,
                                     ycenter, True, 1.0)
        results.append(trdif)
    return results


def _host_soft(v, vmax):
    """Soft square-root limiting (InertialLimit MVDepan.cpp:3264-3273)."""
    s = math.sqrt(abs(v) * abs(vmax))
    return s if v >= 0 else -s


def _inertial(trcumul, cfg, nonlin, cdamp, cquad, freqnative, pixaspect,
              initzoom, xcenter, ycenter, width, height):
    """Damped-oscillator predictor-corrector smoothing over the cumulative
    transforms (Inertial MVDepan.cpp:2945-3115).  trcumul indexed 0..K."""
    K = len(trcumul) - 1
    sm = [None] * (K + 1)
    sm[0] = null_transform()
    if K >= 1:
        sm[1] = sm[0]

    def pc(sm1, sm2, cu, cu1, cu2, nl, freq_mul=1.0):
        """One predictor-corrector update of a scalar component."""
        fm = np.float32(freq_mul)
        pred = (2 * sm1 - sm2
                - cdamp * fm * freqnative * (sm1 - sm2 - cu1 + cu2)
                * (1 + 0.5 * nl / freqnative
                   * abs(sm1 - sm2 - cu1 + cu2))
                - cquad * fm * fm * freqnative * freqnative * (sm1 - cu1)
                * (1 + nl * abs(sm1 - cu1)))
        corr = (2 * sm1 - sm2
                - cdamp * fm * freqnative * 0.5 * (pred - sm2 - cu + cu2)
                * (1 + 0.5 * nl / freqnative * 0.5
                   * abs(pred - sm2 - cu + cu2))
                - cquad * fm * fm * freqnative * freqnative * (sm1 - cu1)
                * (1 + nl * abs(sm1 - cu1)))
        return np.float32(corr)

    for nf in range(2, K + 1):
        cu, cu1, cu2 = trcumul[nf], trcumul[nf - 1], trcumul[nf - 2]
        s1, s2 = sm[nf - 1], sm[nf - 2]
        dxc = pc(s1.dxc, s2.dxc, cu.dxc, cu1.dxc, cu2.dxc, nonlin.dxc)
        dxx = np.float32(0.5 * (cu.dxx + s1.dxx))
        dxy = pc(s1.dxy, s2.dxy, cu.dxy, cu1.dxy, cu2.dxy, nonlin.dxy,
                 freq_mul=2.0)
        dyx = np.float32(-dxy * pixaspect * pixaspect)
        dyc = pc(s1.dyc, s2.dyc, cu.dyc, cu1.dyc, cu2.dyc, nonlin.dyc)
        sm[nf] = Transform(dxc, dxx, dxy, dyc, dyx, dxx)

    if cfg.addzoom and K >= 2:
        azoom = [initzoom, initzoom] + [None] * (K - 1)
        azs = [initzoom, initzoom] + [None] * (K - 1)
        zf0 = np.float32(1 / (cfg.cutoff * cfg.tzoom))
        for nf in range(2, K + 1):
            trcur = sumtransform(inversetransform(trcumul[nf]), sm[nf])
            azoom[nf] = _adaptive_zoom(trcur, initzoom, width, height,
                                       xcenter, ycenter)

            def zsm(zf):
                pred = (2 * azs[nf - 1] - azs[nf - 2]
                        - zf * cdamp * freqnative
                        * (azs[nf - 1] - azs[nf - 2]
                           - azoom[nf - 1] + azoom[nf - 2])
                        - zf * zf * cquad * freqnative * freqnative
                        * (azs[nf - 1] - azoom[nf - 1]))
                corr = (2 * azs[nf - 1] - azs[nf - 2]
                        - zf * cdamp * freqnative * 0.5
                        * (pred - azs[nf - 2] - azoom[nf] + azoom[nf - 2])
                        - zf * zf * cquad * freqnative * freqnative
                        * (azs[nf - 1] - azoom[nf - 1]))
                return np.float32(corr)

            azs[nf] = zsm(zf0)
            if azs[nf] > azs[nf - 1]:
                azs[nf] = zsm(np.float32(zf0 * 0.7))
            azs[nf] = np.float32(min(azs[nf], 1.0))
            trtemp = motion2transform(0.0, 0.0, 0.0, azs[nf], pixaspect,
                                      xcenter, ycenter, True, 1.0)
            sm[nf] = sumtransform(sm[nf], trtemp)
    else:
        trtemp = motion2transform(0.0, 0.0, 0.0, initzoom, pixaspect,
                                  xcenter, ycenter, True, 1.0)
        sm[K] = sumtransform(sm[K], trtemp)

    return sumtransform(inversetransform(trcumul[K]), sm[K])


def _average(trcumul, cfg, kdest, kmax, pixaspect, initzoom, xcenter,
             ycenter, width, height):
    """Windowed-average smoothing (Average MVDepan.cpp:3118-3246).
    trcumul indexed 0..kmax with ndest at kdest."""
    wintsize = cfg.wintsize
    wint = np.array([math.cos(i * 0.5 * math.pi / wintsize)
                     if i < wintsize else 0.0
                     for i in range(wintsize + 1)], np.float32)
    norm = np.float32(0)
    dxc = dyc = dxy = np.float32(0)
    for k in range(0, kdest):
        wgt = wint[kdest - k]
        dxc += trcumul[k].dxc * wgt
        dyc += trcumul[k].dyc * wgt
        dxy += trcumul[k].dxy * wgt
        norm += wgt
    for k in range(kdest, kmax + 1):
        wgt = wint[k - kdest]
        dxc += trcumul[k].dxc * wgt
        dyc += trcumul[k].dyc * wgt
        dxy += trcumul[k].dxy * wgt
        norm += wgt
    dxc, dyc, dxy = dxc / norm, dyc / norm, dxy / norm
    dyx = -dxy * pixaspect * pixaspect
    norm = np.float32(0)
    dxx = np.float32(0)
    for k in range(max(0, kdest - 1), kdest):
        dxx += trcumul[k].dxx * wint[kdest - k]
        norm += wint[kdest - k]
    for k in range(kdest, min(kmax, kdest + 1) + 1):
        dxx += trcumul[k].dxx * wint[k - kdest]
        norm += wint[k - kdest]
    dxx /= norm
    sm = as_transform((dxc, dxx, dxy, dyc, dyx, dxx))

    if cfg.addzoom:
        wzsize = min(wintsize, int(cfg.fps * cfg.tzoom / 4))
        winz = np.array([math.cos(i * 0.5 * math.pi / wzsize)
                         if i < wzsize else 0.0
                         for i in range(wintsize + 1)], np.float32)
        kbasez = max(0, kdest - wzsize)
        kmaxz = min(kmax, kdest + wzsize)
        azoom = {kbasez: initzoom}
        for k in range(kbasez + 1, kmaxz + 1):
            trcur = sumtransform(inversetransform(trcumul[k]), trcumul[k])
            azoom[k] = _adaptive_zoom(trcur, initzoom, width, height,
                                      xcenter, ycenter)
        norm = np.float32(0)
        azs = np.float32(0)
        for k in range(kbasez, kdest):
            azs += azoom[k] * winz[kdest - k]
            norm += winz[kdest - k]
        for k in range(kdest, kmaxz + 1):
            azs += azoom[k] * winz[k - kdest]
            norm += winz[k - kdest]
        azs = np.float32(min(azs / norm, 1.0))
        trtemp = motion2transform(0.0, 0.0, 0.0, azs, pixaspect,
                                  xcenter, ycenter, True, 1.0)
    else:
        trtemp = motion2transform(0.0, 0.0, 0.0, initzoom, pixaspect,
                                  xcenter, ycenter, True, 1.0)
    sm = sumtransform(sm, trtemp)
    return sumtransform(inversetransform(trcumul[kdest]), sm)


def depan_stabilise(frames: Sequence[Sequence[torch.Tensor]],
                    motions: np.ndarray, cfg: DepanStabiliseConfig,
                    sub_w: int = 0, sub_h: int = 0, bits: int = 8):
    """Stabilise a whole clip, on the frames' device.

    frames: list of per-frame plane lists; motions: [N, 4] host float32
    (dx, dy, zoom, rot).  Border filling from prev/next frames
    (fillBorderPrev/Next MVDepan.cpp:3395-3546) warps neighbour frames
    with the nearest kernel under the current transform.  Returns the list
    of stabilised frames.
    """
    num_frames = len(frames)
    h, w = frames[0][0].shape
    trdifs = stabilise_transforms(motions, cfg, w, h, num_frames)
    nfields = 2 if cfg.fields else 1
    pixaspect = np.float32(cfg.pixaspect / nfields)
    xcenter, ycenter = np.float32(w / 2), np.float32(h / 2)
    pixel_max = (1 << bits) - 1

    def warp_frame(nframe, tr, subpixel, mirror_on, base, border_fill):
        planes = []
        for p, plane in enumerate(frames[nframe]):
            tr_p = transform_for_plane(tr, sub_w, sub_h) if p else tr
            if border_fill:
                border = 0 if p == 0 else 1 << (bits - 1)
            else:
                border = -1
            blur_p = cfg.blur if p == 0 else cfg.blur // 2
            planes.append(warp_plane(
                plane, tr_p, subpixel, cfg.mirror if mirror_on else 0,
                border, blur_p, pixel_max,
                base=None if base is None else base[p]))
        return planes

    out = []
    for ndest in range(num_frames):
        trdif = trdifs[ndest]
        base_planes: Optional[List[torch.Tensor]] = None
        notfilled = True

        if cfg.prev > 0:
            # fillBorderPrev (:3395-3455): pick the best previous frame;
            # the reference accumulates the summary transform all the way
            # to nprev and warps frame nprevbest with it (:3410-3450)
            nprev = max(ndest - cfg.prev, 0)
            tr = trdif
            nprevbest = nprev
            dabsmin = np.float32(10000.0)
            for nf in range(ndest - 1, nprev - 1, -1):
                trcur = motion2transform(
                    motions[nf + 1][0], motions[nf + 1][1],
                    motions[nf + 1][3], motions[nf + 1][2], pixaspect,
                    xcenter, ycenter, True, 1.0)
                tr = sumtransform(tr, trcur)
                dxt, dyt, _, _ = transform2motion(tr, True, xcenter,
                                                  ycenter, pixaspect)
                score = abs(float(dxt)) + abs(float(dyt)) + ndest - nf
                if score < dabsmin:
                    dabsmin = score
                    nprevbest = nf
            base_planes = warp_frame(nprevbest, tr, 0, True, None, True)
            notfilled = False

        if cfg.next > 0:
            nnext = min(ndest + cfg.next, num_frames - 1)
            tr = trdif
            nnextbest = nnext
            dabsmin = np.float32(1000.0)
            tr_best = trdif
            for nf in range(ndest + 1, nnext + 1):
                if motions[nf][0] == MOTION_BAD:
                    nnextbest = nf - 1
                    break
                trcur = motion2transform(
                    motions[nf][0], motions[nf][1], motions[nf][3],
                    motions[nf][2], pixaspect, xcenter, ycenter, True, 1.0)
                tr = sumtransform(inversetransform(trcur), tr)
                dxt, dyt, _, _ = transform2motion(tr, True, xcenter,
                                                  ycenter, pixaspect)
                score = abs(float(dxt)) + abs(float(dyt)) + nf - ndest
                if score < dabsmin:
                    dabsmin = score
                    nnextbest = nf
                    tr_best = tr
            if nnextbest > ndest:
                base_planes = warp_frame(nnextbest, tr_best, 0, notfilled,
                                         base_planes, notfilled)
                notfilled = False

        out.append(warp_frame(ndest, trdif, cfg.subpixel, notfilled,
                              base_planes, notfilled))
    return out
