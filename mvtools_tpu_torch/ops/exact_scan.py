"""K6, the exact sequential engine on the card (csrc/exact_scan.cu), and
the entry points that choose it or its plain version.

* scan_level — one pyramid level of the exact engine for a batch of jobs:
  every job walks its level's blocks in the reference's scan order, each
  block's predictors read from the vectors its job has just written
  (the JAX package's search_level, mvtools_tpu/analyse.py:801-975).  On
  CUDA tensors K6 runs it, a CTA of eight warps per job that evaluates
  each search step's candidates at once (exact_scan_kernel); on CPU
  tensors its plain version, exact_engine.search_level.
* search_blocks — Recalculate's exact search (mvtools_tpu/recalculate.py:
  191-230), every (job, block) an independent item: K6's second entry
  point (exact_search_kernel, one warp per item) on CUDA tensors,
  exact_engine.search_items on CPU tensors.

A wrapper launches its kernel when the tensors are on a CUDA device and
uses the plain version only for CPU tensors; a failed build or launch
raises.  scan_level_plain and search_blocks_plain run the plain versions
on tensors of any device (to hold the kernel against them on the card).
Each kernel counts its launches, its uint16 form under its name with
"[u16]" appended.  Costs: the plain SAD (dct 0) only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import exact_engine as ee
from ..core.types import SearchType
from . import cuda_build
from .probe import _on_device, _stream

I32 = torch.int32
I64 = torch.int64

# the kernels' ints, in the order of csrc/exact_scan.cu's P_* enum
PARAM_NAMES = (
    "n_jobs", "u16", "n_sub", "h", "w", "hc", "wc", "nbx", "nby", "bsx",
    "bsy", "bcx", "bcy", "ovx", "ovy", "logx", "logy", "hpad", "vpad",
    "hpad_c", "vpad_c", "pw", "ph", "logp", "bound_x", "bound_y", "chroma",
    "search", "param", "pzero", "pglobal", "badsad", "badrange", "trymany",
    "meander", "lsad", "lambda_level", "pnew", "verybig", "smallest",
    "thsad")

launches = {"exact_scan": 0, "exact_scan[u16]": 0, "exact_search": 0,
            "exact_search[u16]": 0}
plain_calls_on_cuda = 0    # plain versions run on CUDA tensors (comparisons)
# blocks the bad-SAD rescue took in scan_level, candidate blocks the
# kernels evaluated, and the dependent search steps K6's level scans walked
# (summed over jobs), since the last reset: device tensors (or 0), read by
# whoever wants them (reading one syncs)
rescued_blocks = 0
candidates = 0
serial_steps = 0


def scan_geom(ctx, recalculate: bool = False) -> ee.ScanGeom:
    """The ScanGeom of an analyse.LevelCtx: Analyse's bounds reach
    hpad >> level into the padding, Recalculate's all of it
    (PlaneOfBlocks.cpp:1274-1277)."""
    (bsx, bsy), (bcx, bcy) = ctx.blk_size, ctx.blk_size_c
    (hpad, hpad_c), (vpad, vpad_c) = ctx.hpad, ctx.vpad
    bound_x = 0 if recalculate else hpad - (hpad >> ctx.level)
    bound_y = 0 if recalculate else vpad - (vpad >> ctx.level)
    return ee.ScanGeom(
        nbx=ctx.nblk[0], nby=ctx.nblk[1], bsx=bsx, bsy=bsy, bcx=bcx, bcy=bcy,
        ovx=ctx.overlap[0], ovy=ctx.overlap[1], logx=ctx.log_ratio_uv[0],
        logy=ctx.log_ratio_uv[1], hpad=hpad, vpad=vpad, hpad_c=hpad_c,
        vpad_c=vpad_c, pw=ctx.padded[0], ph=ctx.padded[1], logp=ctx.log_pel,
        bound_x=bound_x, bound_y=bound_y, chroma=ctx.chroma)


def _planes(ctx):
    """(source planes [J, h, w], reference stacks [J, pel^2, h, w]) of the
    level's searched planes, contiguous."""
    return ([p.contiguous() for p in ctx.src_planes],
            [s.contiguous() for s in ctx.ref_stacks])


def _name(base: str, stack) -> str:
    return base + "[u16]" if stack.dtype == torch.uint16 else base


def _args(ctx, g: ee.ScanGeom, refs, **search) -> ctypes.Array:
    vals = dict(g._asdict(), **search)
    nj, nsub, h, w = refs[0].shape
    hc, wc = refs[1].shape[-2:] if g.chroma else (0, 0)
    vals.update(n_jobs=nj, u16=int(refs[0].dtype == torch.uint16),
                n_sub=nsub, h=h, w=w, hc=hc, wc=wc, chroma=int(g.chroma))
    if not g.chroma:
        vals.update(bcx=g.bsx, bcy=g.bsy)
    out = [int(vals[k]) for k in PARAM_NAMES]
    if any(not -2 ** 31 <= v < 2 ** 31 for v in out):
        raise ValueError("exact_scan: a parameter exceeds int32")
    return (ctypes.c_int * len(out))(*out)


def _plan_args(plan: dict) -> dict:
    return dict(search=int(plan["search"]), param=plan["param"],
                pzero=plan["pzero"], pglobal=plan["pglobal"],
                badsad=plan["badsad"], badrange=plan["badrange"],
                trymany=int(plan["trymany"]), meander=int(plan["meander"]),
                lsad=plan["lsad"], lambda_level=plan["lambda_level"],
                pnew=plan["pnew"], verybig=plan["verybig"],
                smallest=int(plan["smallest_plane"]), thsad=0)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(cuda_build.load("exact_scan"), name)
    n_ptr = 15 if name == "mvt_exact_scan" else 12
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def scan_level(ctx, plan: dict, vectors_in, gx, gy, zs):
    """One level of the exact engine for the batch of jobs of `ctx` (an
    analyse.LevelCtx): ((x, y, sad) [J, nblk], badcount [J] int32).
    vectors_in: the (x, y, sad) inter-level prediction; gx, gy: [J]
    pel-scaled global predictor, gy with the field shift; zs: [J] field
    shift.  K6 on CUDA tensors, the
    plain version on CPU tensors."""
    global rescued_blocks
    if not ctx.src_planes[0].is_cuda:
        out = scan_level_plain(ctx, plan, vectors_in, gx, gy, zs)
    else:
        out = _launch_scan(ctx, plan, vectors_in, gx, gy, zs)
    rescued_blocks = rescued_blocks + out[1].sum()
    return out


def scan_level_plain(ctx, plan: dict, vectors_in, gx, gy, zs):
    """scan_level's plain version on tensors of any device."""
    global plain_calls_on_cuda
    srcs, refs = _planes(ctx)
    if srcs[0].is_cuda:
        plain_calls_on_cuda += 1
    return ee.search_level(srcs, refs, scan_geom(ctx), plan, vectors_in,
                           gx.to(I32), gy.to(I32), zs.to(I32))


def _launch_scan(ctx, plan, vectors_in, gx, gy, zs):
    global candidates, serial_steps
    srcs, refs = _planes(ctx)
    g = scan_geom(ctx)
    dev = srcs[0].device
    vx, vy = (v.to(I32).contiguous().clone() for v in vectors_in[:2])
    vs = vectors_in[2].to(I64).contiguous().clone()
    gx, gy, zs = (t.to(I32).contiguous() for t in (gx, gy, zs))
    nj = vx.shape[0]
    badcount = torch.empty((nj,), dtype=I32, device=dev)
    n_eval = torch.empty((nj,), dtype=I64, device=dev)
    n_steps = torch.empty((nj,), dtype=I64, device=dev)
    args = _args(ctx, g, refs, **_plan_args(plan))
    chroma = g.chroma
    err = _on_device(dev, _fn("mvt_exact_scan"), srcs[0].data_ptr(),
                     _ptr(srcs[1] if chroma else None),
                     _ptr(srcs[2] if chroma else None), refs[0].data_ptr(),
                     _ptr(refs[1] if chroma else None),
                     _ptr(refs[2] if chroma else None), vx.data_ptr(),
                     vy.data_ptr(), vs.data_ptr(), gx.data_ptr(),
                     gy.data_ptr(), zs.data_ptr(), badcount.data_ptr(),
                     n_eval.data_ptr(), n_steps.data_ptr(), args,
                     _stream(dev))
    name = _name("exact_scan", refs[0])
    cuda_build.check_launch(err, name)
    launches[name] += 1
    candidates = candidates + n_eval.sum()
    serial_steps = serial_steps + n_steps.sum()
    return (vx, vy, vs), badcount


def search_blocks(ctx, search: SearchType, param: int, pred_x, pred_y,
                  lambda_level: int, pnew: int, thsad: int):
    """Recalculate's exact search of every block of every job of `ctx`
    (a level-0 analyse.LevelCtx): (x, y, sad) [J, nblk].  pred_x, pred_y:
    [J, nblk] int32 predictors before clipping.  K6's per-item entry point
    on CUDA tensors, the plain version on CPU tensors."""
    global candidates
    if not ctx.src_planes[0].is_cuda:
        return search_blocks_plain(ctx, search, param, pred_x, pred_y,
                                   lambda_level, pnew, thsad)
    srcs, refs = _planes(ctx)
    g = scan_geom(ctx, recalculate=True)
    dev = srcs[0].device
    px, py = (t.to(I32).contiguous() for t in (pred_x, pred_y))
    ox, oy = torch.empty_like(px), torch.empty_like(py)
    osad = torch.empty(px.shape, dtype=I64, device=dev)
    n_eval = torch.empty(px.shape, dtype=I32, device=dev)
    args = _args(ctx, g, refs, search=int(search), param=param, pzero=0,
                 pglobal=0, badsad=0, badrange=0, trymany=0, meander=0,
                 lsad=0, lambda_level=lambda_level, pnew=pnew, verybig=0,
                 smallest=0, thsad=thsad)
    chroma = g.chroma
    err = _on_device(dev, _fn("mvt_exact_search"), srcs[0].data_ptr(),
                     _ptr(srcs[1] if chroma else None),
                     _ptr(srcs[2] if chroma else None), refs[0].data_ptr(),
                     _ptr(refs[1] if chroma else None),
                     _ptr(refs[2] if chroma else None), px.data_ptr(),
                     py.data_ptr(), ox.data_ptr(), oy.data_ptr(),
                     osad.data_ptr(), n_eval.data_ptr(), args, _stream(dev))
    name = _name("exact_search", refs[0])
    cuda_build.check_launch(err, name)
    launches[name] += 1
    candidates = candidates + n_eval.sum(dtype=I64)
    return ox, oy, osad


def search_blocks_plain(ctx, search: SearchType, param: int, pred_x, pred_y,
                        lambda_level: int, pnew: int, thsad: int):
    """search_blocks' plain version on tensors of any device."""
    global plain_calls_on_cuda
    srcs, refs = _planes(ctx)
    if srcs[0].is_cuda:
        plain_calls_on_cuda += 1
    return ee.search_items(srcs, refs, scan_geom(ctx, recalculate=True),
                           SearchType(search), param, pred_x.to(I32),
                           pred_y.to(I32), lambda_level, pnew, thsad)
