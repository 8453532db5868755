"""Global-motion transform algebra and affine plane warping.

Equivalents of the Depan family's transform math and
`compensate_plane_{nearest,bilinear,bicubic}` warps (MVDepan.cpp:63-142,
:1554-1615, :1627-2586), after the JAX package's ops/warp.py.

A transform is six float32 numbers a frame, so its algebra runs on the host
in numpy float32, one rounding an operation in the JAX package's order, and
`warp_plane` takes plain numbers.  Knowing the transform on the host, the
warp computes only the branch the reference's runtime dispatch takes
(translation, zoom or rotation); each branch gives the same pixels as the
JAX package, which computes all three and selects with a traced mask.

Source coordinates are made on the host in numpy float32 and uploaded:
the translation and zoom branches' `dxc + dxx*x` is one float32 multiply
and one float32 add (a row vector and a column vector), and the rotation
branch accumulates `xsrc += dxx` along each row in float32, one add a
column, as the reference walks its rows (MVDepan.cpp:1800-1830) and the JAX
package's scan does.  No fused multiply-add and no reordered sum can enter.
The rest (floors, coefficient tables, integer blends, borders) is plain
torch on the plane's device, in int32 and int64 as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import pixels

F32 = np.float32
I32 = torch.int32
I64 = torch.int64

MIRROR_TOP = 1
MIRROR_BOTTOM = 2
MIRROR_LEFT = 4
MIRROR_RIGHT = 8

MOTION_BAD = 0.0


class Transform(NamedTuple):
    """Affine global-motion transform: xsrc = dxc + dxx*x + dxy*y,
    ysrc = dyc + dyx*x + dyy*y (MVDepan.cpp:63-75).  Fields are numpy
    float32 scalars."""
    dxc: np.float32
    dxx: np.float32
    dxy: np.float32
    dyc: np.float32
    dyx: np.float32
    dyy: np.float32


def as_transform(values) -> Transform:
    """Six numbers as a float32 Transform."""
    return Transform(*(F32(v) for v in values))


def null_transform() -> Transform:
    """Identity transform (setNull, MVDepan.cpp:78-85)."""
    return as_transform((0.0, 1.0, 0.0, 0.0, 0.0, 1.0))


def motion2transform(dx, dy, rot, zoom, pixaspect, xcenter, ycenter,
                     forward: bool, fractoffset) -> Transform:
    """Motion (dx, dy, rot-degrees, zoom) -> transform at a fractional
    offset (MVDepan.cpp:1554-1591)."""
    dx, dy, rot, zoom1, fract, pixaspect, xcenter, ycenter = (
        F32(v) for v in (dx, dy, rot, zoom, fractoffset, pixaspect, xcenter,
                         ycenter))
    ddx = fract * dx
    ddy = fract * dy
    rotradian = fract * rot * (F32(np.pi) / F32(180))
    if abs(rotradian) < F32(1e-6):
        rotradian = F32(0.0)
    z = np.exp(fract * np.log(zoom1))
    if abs(z - F32(1.0)) < F32(1e-6):
        z = F32(1.0)
    s = np.sin(rotradian)
    c = np.cos(rotradian)

    if forward:
        dxc = xcenter + (-xcenter * c + ycenter / pixaspect * s) * z + ddx
        dyc = ycenter + (((-ycenter) / pixaspect * c + (-xcenter) * s) * z
                         + ddy) * pixaspect
    else:
        dxc = xcenter + ((-xcenter + ddx) * c
                         - ((-ycenter) / pixaspect + ddy) * s) * z
        dyc = ycenter + (((-ycenter) / pixaspect + ddy) * c
                         + (-xcenter + ddx) * s) * z * pixaspect
    dxx = c * z
    dxy = -s / pixaspect * z
    dyx = s * z * pixaspect
    dyy = c * z
    return as_transform((dxc, dxx, dxy, dyc, dyx, dyy))


def transform2motion(tr: Transform, forward: bool, xcenter, ycenter,
                     pixaspect):
    """Transform -> motion (dx, dy, rot-degrees, zoom), four float32
    scalars (MVDepan.cpp:88-122)."""
    pixaspect, xcenter, ycenter = F32(pixaspect), F32(xcenter), F32(ycenter)
    rotradian = -np.arctan(pixaspect * tr.dxy / tr.dxx)
    rot = rotradian * (F32(180) / F32(np.pi))
    s = np.sin(rotradian)
    c = np.cos(rotradian)
    zoom = tr.dxx / c
    if forward:
        dx = tr.dxc - xcenter - (-xcenter * c + ycenter / pixaspect * s) * zoom
        dy = (tr.dyc / pixaspect - ycenter / pixaspect
              - ((-ycenter) / pixaspect * c + (-xcenter) * s) * zoom)
    else:
        dx = (tr.dxc / zoom * c + tr.dyc / zoom / pixaspect * s
              - xcenter / zoom * c + xcenter - ycenter / zoom / pixaspect * s)
        dy = (-tr.dxc / zoom * s + tr.dyc / zoom / pixaspect * c
              + xcenter / zoom * s - (-ycenter / pixaspect)
              - ycenter / zoom / pixaspect * c)
    return F32(dx), F32(dy), F32(rot), F32(zoom)


def sumtransform(ta: Transform, tb: Transform) -> Transform:
    """Composition tb(ta) (MVDepan.cpp:1599-1615)."""
    return Transform(
        dxc=tb.dxc + tb.dxx * ta.dxc + tb.dxy * ta.dyc,
        dxx=tb.dxx * ta.dxx + tb.dxy * ta.dyx,
        dxy=tb.dxx * ta.dxy + tb.dxy * ta.dyy,
        dyc=tb.dyc + tb.dyx * ta.dxc + tb.dyy * ta.dyc,
        dyx=tb.dyx * ta.dxx + tb.dyy * ta.dyx,
        dyy=tb.dyx * ta.dxy + tb.dyy * ta.dyy)


def inversetransform(ta: Transform) -> Transform:
    """Inverse transform (MVDepan.cpp:128-142)."""
    pixaspect = (np.sqrt(-ta.dyx / ta.dxy) if ta.dxy != F32(0.0)
                 else F32(1.0))
    dxx = ta.dxx / (ta.dxx * ta.dxx
                    + ta.dxy * ta.dxy * pixaspect * pixaspect)
    dxy = -dxx * ta.dxy / ta.dxx
    dyx = -dxy * pixaspect * pixaspect
    dxc = -dxx * ta.dxc - dxy * ta.dyc
    dyc = -dyx * ta.dxc - dxx * ta.dyc
    return as_transform((dxc, dxx, dxy, dyc, dyx, dxx))


def transform_for_plane(tr: Transform, sub_w: int, sub_h: int) -> Transform:
    """Chroma transform adjustment (MVDepan.cpp:2688-2700): 420 halves the
    offsets; 422 halves dxc/dxy and doubles dyx."""
    two = F32(2)
    if sub_w == 1 and sub_h == 1:      # 420
        return tr._replace(dxc=tr.dxc / two, dyc=tr.dyc / two)
    if sub_w == 1 and sub_h == 0:      # 422
        return tr._replace(dxc=tr.dxc / two, dxy=tr.dxy / two,
                           dyx=tr.dyx * two)
    return tr


def is_rotation(tr: Transform) -> bool:
    """The reference's dispatch: the rotation branch where dxy or dyx is
    not zero."""
    return bool(tr.dxy != F32(0.0) or tr.dyx != F32(0.0))


def rotation_coords(tr: Transform, h: int, w: int):
    """The rotation branch's incremental source coordinates, two [h, w]
    float32 numpy arrays: row y starts at dxc + dxy*y (dyc + dyy*y) and
    adds dxx (dyx) once a column in float32 (MVDepan.cpp:1800-1830,
    :2131-2180, :2523-2581)."""
    hs = np.arange(h, dtype=F32)
    x = tr.dxc + tr.dxy * hs
    y = tr.dyc + tr.dyy * hs
    xs = np.empty((w, h), F32)
    ys = np.empty((w, h), F32)
    for col in range(w):
        xs[col] = x
        ys[col] = y
        x = x + tr.dxx
        y = y + tr.dyx
    return np.ascontiguousarray(xs.T), np.ascontiguousarray(ys.T)


def source_coords(tr: Transform, h: int, w: int, device):
    """(xsrc, ysrc) float32 tensors on `device` that broadcast to [h, w]:
    [1, w] and [h, 1] for the translation and zoom branches (dxy and dyx
    are zero there, so x depends on the column alone and y on the row),
    [h, w] each for the rotation branch."""
    if is_rotation(tr):
        xs, ys = rotation_coords(tr, h, w)
    else:
        xs = (tr.dxc + tr.dxx * np.arange(w, dtype=F32))[None, :]
        ys = (tr.dyc + tr.dyy * np.arange(h, dtype=F32))[:, None]
    return (torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device))


def _mirror_coord(v, size, do_low, do_high):
    """hlow<0 -> -hlow; hlow>=size -> 2*size-hlow-2, gated by mirror bits
    (MVDepan.cpp:1678-1681)."""
    if do_low:
        v = torch.where(v < 0, -v, v)
    if do_high:
        v = torch.where(v >= size, 2 * size - v - 2, v)
    return v


def _edge_blur_lookup(src, rows, rowleft, mleft, mright, blurmax, width,
                      right_trigger=None, right_len_off=1):
    """Left/right mirrored edge fill with optional directional blur
    (MVDepan.cpp:1697-1716): blur = mean of `blurlen` pixels ending at the
    mirrored position, from per-row prefix sums (integer, so any order
    gives the JAX package's values).

    The nearest/bicubic ladders trigger the right mirror at
    rowleft >= width with blur length rowleft-width+1; the BILINEAR
    ladder triggers one column earlier (rowleft >= width-1, length
    rowleft-width+2; MVDepan.cpp:1991-2004) — right_trigger /
    right_len_off select the convention."""
    if right_trigger is None:
        right_trigger = width
    rows = rows.clamp(0, src.shape[0] - 1)
    mirror_left_x = (-rowleft).clamp(0, width - 1)
    mirror_right_x = (2 * width - rowleft - 2).clamp(0, width - 1)
    if blurmax <= 0:
        left_val = src[rows, mirror_left_x]
        right_val = src[rows, mirror_right_x]
    else:
        csum = torch.cumsum(src, dim=-1, dtype=I32)  # inclusive prefix sums

        def seg_sum(a, b):                     # sum of a row's [a..b]
            hi = csum[rows, b.clamp(0, width - 1)]
            lo = torch.where(a > 0, csum[rows, (a - 1).clamp(0, width - 1)],
                             0)
            return hi - lo

        def floordiv(a, b):
            return torch.div(a, b, rounding_mode="floor")

        blen_l = torch.clamp(torch.clamp(-rowleft, max=blurmax), min=1)
        a_l = -rowleft - blen_l + 1
        left_val = floordiv(seg_sum(a_l, -rowleft), blen_l)
        blen_r = torch.clamp(torch.clamp(rowleft - width + right_len_off,
                                         max=blurmax), min=1)
        a_r = 2 * width - rowleft - 2
        right_val = floordiv(seg_sum(a_r, a_r + blen_r - 1), blen_r)
    use_left = (rowleft < 0) & mleft
    use_right = (rowleft >= right_trigger) & mright
    return use_left, left_val, use_right, right_val


def _mirror_both(rowleft, hlow, w, h, mleft, mright, mtop, mbottom):
    """The rotation branch's fallback: mirror each coordinate, then a
    plain bounds check (MVDepan.cpp:1810-1823)."""
    hm = _mirror_coord(hlow, h, mtop, mbottom)
    rm = _mirror_coord(rowleft, w, mleft, mright)
    ok = (rm >= 0) & (rm < w) & (hm >= 0) & (hm < h)
    return rm, hm, ok


def _bicubic_coefs(i):
    """The integer coefficient table of MVDepan.cpp:2248-2253; the
    numerators are non-negative, the negation comes after the division."""
    c0 = -((i * (256 - i) * (256 - i)) // 8192)
    c1 = (256 * 256 * 256 - 2 * 256 * i * i + i * i * i) // 8192
    c2 = (i * (256 * 256 + 256 * i - i * i)) // 8192
    c3 = -((i * i * (256 - i)) // 8192)
    return c0, c1, c2, c3


def _tdiv2048(a):
    """C truncation toward zero of a coefficient product / 2048."""
    return torch.div(a, 2048, rounding_mode="trunc")


def warp_plane(plane: torch.Tensor, tr: Transform, subpixel: int,
               mirror: int, border: int, blur: int, pixel_max: int,
               base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp one plane ([H, W] uint8 or uint16) by the affine transform, on
    the plane's device.

    subpixel: 0 nearest (compensate_plane_nearest MVDepan.cpp:1627-1847),
    1 bilinear (:1856-2193), 2 bicubic (:2203-2586).  `border < 0` keeps
    `base` (or the untouched source) outside; >= 0 fills with the constant.
    `blur` smears mirrored left/right edges (blurmax).

    The reference dispatches on the transform at runtime — translation
    (dxy==dyx==0, dxx==dyy==1), zoom (dxy==dyx==0), rotation (general) —
    with different coordinate generation, rounding and edge ladders per
    branch; the branch is chosen here on the host."""
    if subpixel not in (0, 1, 2):
        raise ValueError(f"subpixel {subpixel}")
    tr = as_transform(tr)
    h, w = plane.shape
    src = pixels.widen(plane)
    xsrc, ysrc = source_coords(tr, h, w, plane.device)
    is_rot = is_rotation(tr)
    is_trans = (not is_rot) and tr.dxx == F32(1.0) and tr.dyy == F32(1.0)

    mtop = bool(mirror & MIRROR_TOP)
    mbottom = bool(mirror & MIRROR_BOTTOM)
    mleft = bool(mirror & MIRROR_LEFT)
    mright = bool(mirror & MIRROR_RIGHT)

    def cx_(v):
        return v.clamp(0, w - 1).long()

    def cy_(v):
        return v.clamp(0, h - 1).long()

    def floor_i(v):
        return torch.floor(v).to(I32)

    def mirrored_nearest(rowleft, hlow):
        # the rotation branches' fallback (a source position inside the
        # plane is left as it is by the mirror, so it reads its own pixel)
        rm, hm, ok = _mirror_both(rowleft, hlow, w, h, mleft, mright, mtop,
                                  mbottom)
        return src[cy_(hm), cx_(rm)], ok

    zero = torch.zeros((), dtype=I32, device=plane.device)
    if subpixel == 0 and is_rot:
        # (int)(xsrc + 0.5f) truncates toward zero, then in-range nearest,
        # else mirror both coordinates, no blur (:1800-1830)
        rl = torch.trunc(xsrc + 0.5).to(I32)
        hl = torch.trunc(ysrc + 0.5).to(I32)
        near, valid = mirrored_nearest(rl, hl)
        out = torch.where(valid, near, zero)
    elif subpixel == 0:
        # floorf(+0.5), mirrored hlow, blurred mirrors
        rowleft = floor_i(xsrc + 0.5)
        hlow = floor_i(ysrc + 0.5)
        hlow_m = _mirror_coord(hlow, h, mtop, mbottom)
        y_ok = (hlow_m >= 0) & (hlow_m < h)
        nearest = src[cy_(hlow_m), cx_(rowleft)]
        x_in = (rowleft >= 0) & (rowleft < w)
        use_l, lv, use_r, rv = _edge_blur_lookup(
            src, hlow_m, rowleft, mleft, mright, blur, w)
        out = torch.where(x_in, nearest, zero)
        out = torch.where(use_l, lv, out)
        out = torch.where(use_r, rv, out)
        valid = y_ok & (x_in | use_l | use_r)
    elif subpixel == 1:
        rowleft = floor_i(xsrc)
        hlow = floor_i(ysrc)
        # 1/32 quantized coefficients, product >> 10 (MVDepan.cpp:1907-1913)
        ix = floor_i((xsrc - rowleft.float()) * 32)
        iy = floor_i((ysrc - hlow.float()) * 32)
        cx, cx1 = cx_(rowleft), cx_(rowleft + 1)

        def bilinear(rows):
            cy, cy1 = cy_(rows), cy_(rows + 1)
            p00 = src[cy, cx]
            return ((32 - iy) * ((32 - ix) * p00 + ix * src[cy, cx1])
                    + iy * ((32 - ix) * src[cy1, cx]
                            + ix * src[cy1, cx1])) >> 10, p00

        if is_rot:
            # raw (unmirrored) coords interpolate, the fallback is a
            # both-axis mirrored nearest (:2131-2180)
            rot_ok = ((rowleft >= 0) & (rowleft < w - 1)
                      & (hlow >= 0) & (hlow < h - 1))
            interp, _ = bilinear(hlow)
            near, ok_m = mirrored_nearest(rowleft, hlow)
            out = torch.where(rot_ok, interp, torch.where(ok_m, near, zero))
            valid = rot_ok | ok_m
        else:
            hlow_m = _mirror_coord(hlow, h, mtop, mbottom)
            interp, p00 = bilinear(hlow_m)
            interp_ok = ((rowleft >= 0) & (rowleft < w - 1)
                         & (hlow_m >= 0) & (hlow_m < h - 1))
            # bottom line falls back to nearest (MVDepan.cpp:2006-2018)
            near_ok = (hlow_m == h - 1) & (rowleft >= 0) & (rowleft < w)
            use_l, lv, use_r, rv = _edge_blur_lookup(
                src, hlow_m, rowleft, mleft, mright, blur, w,
                right_trigger=w - 1, right_len_off=2)
            y_ok = (hlow_m >= 0) & (hlow_m < h)
            inner = interp_ok | near_ok
            out = torch.where(interp_ok, interp,
                              torch.where(near_ok, p00, zero))
            out = torch.where(~inner & use_l, lv, out)
            out = torch.where(~inner & use_r, rv, out)
            valid = y_ok & (inner | use_l | use_r)
    else:
        rowleft = floor_i(xsrc)
        hlow = floor_i(ysrc)
        # (int)(frac * 256): frac in [0, 1) so C truncation == floor
        sx = torch.floor((xsrc - rowleft.float()) * 256).clamp(0, 256).to(I32)
        sy = torch.floor((ysrc - hlow.float()) * 256).clamp(0, 256).to(I32)
        cxs = _bicubic_coefs(sx)
        cys = _bicubic_coefs(sy)
        cxi = [cx_(rowleft + (i - 1)) for i in range(4)]
        rows = hlow if is_rot else _mirror_coord(hlow, h, mtop, mbottom)
        if is_trans:
            # per-coefficient (cy*cx)/2048 truncated, pixel sum (+1024) >>
            # 11, clamp (MVDepan.cpp:2268-2311)
            acc = torch.zeros((), dtype=I32, device=plane.device)
            for j in range(4):
                cyj = cy_(rows + (j - 1))
                for i in range(4):
                    acc = acc + _tdiv2048(cys[j] * cxs[i]) * src[cyj, cxi[i]]
            interp = ((acc + 1024) >> 11).clamp(0, pixel_max)
        else:
            # zoom and rotation: separable row taps, then (sum cy*ts) >> 22
            # in int64, no rounding bias (:2404-2415, :2536-2551); rotation
            # reads the raw (unmirrored) hlow
            acc = torch.zeros((), dtype=I64, device=plane.device)
            for j in range(4):
                cyj = cy_(rows + (j - 1))
                ts = torch.zeros((), dtype=I64, device=plane.device)
                for i in range(4):
                    ts = ts + (cxs[i] * src[cyj, cxi[i]]).to(I64)
                acc = acc + cys[j].to(I64) * ts
            interp = (acc >> 22).to(I32).clamp(0, pixel_max)

        if is_rot:
            # raw-coord bicubic region, else mirrored nearest
            rot_ok = ((rowleft >= 1) & (rowleft < w - 2)
                      & (hlow >= 1) & (hlow < h - 2))
            near, ok_m = mirrored_nearest(rowleft, hlow)
            out = torch.where(rot_ok, interp, torch.where(ok_m, near, zero))
            valid = rot_ok | ok_m
        else:
            hlow_m = rows
            mid_y = (hlow_m >= 1) & (hlow_m < h - 2)
            interp_ok = mid_y & (rowleft >= 1) & (rowleft < w - 2)
            # middle rows, columns 0 / w-2 / w-1: nearest copy (:2332-2334)
            near_mid = mid_y & ((rowleft == 0) | (rowleft == w - 2)
                                | (rowleft == w - 1))
            # near-edge rows (hlow 0 / h-2): float bilinear for rowleft in
            # [0, w-2], nearest at w-1 (:2341-2359)
            cy, cy1 = cy_(hlow_m), cy_(hlow_m + 1)
            cx, cx1 = cxi[1], cxi[2]
            fx = xsrc - torch.floor(xsrc)
            fy = ysrc - torch.floor(ysrc)
            bl = ((1.0 - fy) * ((1.0 - fx) * src[cy, cx] + fx * src[cy, cx1])
                  + fy * ((1.0 - fx) * src[cy1, cx] + fx * src[cy1, cx1]))
            bl = bl.to(I32)            # C (int) truncation; values >= 0
            edge_y = (hlow_m == 0) | (hlow_m == h - 2)
            bl_ok = edge_y & (rowleft >= 0) & (rowleft < w - 1)
            near = src[cy, cx]
            near_edge = edge_y & (rowleft == w - 1)
            # bottom line: the translation branch copies the nearest pixel
            # (:2360-2369); the zoom branch averages with the row above
            # ((p + p_up) / 2, :2470-2473)
            near_bot_ok = (hlow_m == h - 1) & (rowleft >= 0) & (rowleft < w)
            bot_val = near if is_trans else torch.div(
                near + src[cy_(hlow_m - 1), cx], 2, rounding_mode="floor")
            use_l, lv, use_r, rv = _edge_blur_lookup(
                src, hlow_m, rowleft, mleft, mright, blur, w)
            y_ok = (hlow_m >= 0) & (hlow_m < h)
            out = torch.where(interp_ok, interp, zero)
            out = torch.where(bl_ok, bl, out)
            out = torch.where(near_mid | near_edge, near, out)
            out = torch.where(near_bot_ok, bot_val, out)
            out = torch.where(use_l & y_ok, lv, out)
            out = torch.where(use_r & y_ok, rv, out)
            valid = y_ok & (interp_ok | bl_ok | near_mid | near_edge
                            | near_bot_ok | use_l | use_r)

    if border >= 0:
        background = torch.full((), border, dtype=I32, device=plane.device)
    elif base is not None:
        background = pixels.widen(base)
    else:
        background = src
    out = torch.where(valid, out, background)
    return pixels.narrow(out, plane.dtype)
