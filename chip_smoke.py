#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA GPU, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from mvtools_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the shapes the main paths
give it (integers: tolerance 0; the tiled probe also with an `active` mask
that leaves about 30 % of the entries live, its uint16 form also at the
coarser levels' shapes and with the walk's offsets, the SAD map also at block
pitches 14 and 6 and at pel 1, its three-stat form also with 8x8 and 32x32
blocks and at pel 1, the tiled fetch also on the DCT path's map rows, at
origins outside the plane and with 8x8 blocks; the per-block probe also with
masks that leave about 30 %, 3 % and none of its entries live and at a
block size of each of its width classes, 2x2, 4x2, 8x1, 64x64 and 128x128,
at 8 and 10 bits, and its three-stat form also with masks that leave
about 30 %, 3 % and none of its entries live; K2, K3, K4 and K5 and their
uint16 forms also at pel 4, at the shapes bench.py config 2 gives them
(pel4_kernel_cases); the uint16 forms of K1-K5
at the deep-bit YUV420 path's shapes on 16-bit and on 10-bit data, with
blocks of 0 against the pixel maximum; the three-stat tiled probe also on
blocks of 0 against 255 and with 8x8, 32x32 and 64x64 blocks; the maps and
the tiled probes also timed by their device time in a torch.profiler
trace), prints the SASS opcode counts of every kernel form, checks small end-to-end runs on the card against the
same code on CPU tensors (at 8 and at 16 bits, degrain_clip and the gray
degrain_window; flowfps_clip and every motion-compensated consumer; the
pel-4 slice with every search type, trymany, the ring rescue, divide and
Recalculate: small_end_to_end_pel4), and drives eight main paths at full
width:

* the gray headline path (1920x1080 gray, blk 16, pel 2, 3 levels, Degrain1,
  batch 8) through degrain_window: first on a clip with a flashing region,
  whose bad blocks send the search through its rescue and the tiled probe
  kernel, then on the same clip without it;
* the flagship YUV420 path (1920x1080 YUV420, blk 16 overlap 8, pel 2, chroma,
  the full 7-level pyramid, MDegrain3) through degrain_clip on a 14-frame
  clip: first with a flash over most of the frame, which makes blocks bad
  down to the coarse levels whose planes only the per-block probe kernel can
  serve, then without it (neither probe kernel may launch);
* the same flagship path at 16 bits (uint16 planes whose low byte carries
  data too): the uint16 forms of the SAD map, both probes and the tiled
  fetch must launch on the clip with the flash, neither probe on the clip
  without it, and no 8-bit kernel on either;
* the Recalculate path (1920x1080 gray, pel 2, the full 7-level pyramid:
  Analyse blk 16 with the plain-SAD cost -> Recalculate blk 16 overlap 8 with
  the SATD cost dct 5 -> Degrain1 on the refined field), 8 frame pairs of a
  9-frame clip as one batch, through build_super, analyse_batch, recalculate
  and degrain: the three-stat forms of the SAD map and the tiled probe must
  launch;
* the SATD Analyse path (the same with dct 5 in Analyse as well, 4 frame
  pairs): first on a clip with a flash over most of the frame, whose bad
  blocks send the rescue through the three-stat forms of the tiled probe and,
  at level 5, of the per-block probe, then without it (the Analyse stage may
  launch neither probe kernel);
* the DCT Analyse path (the same chain with the block-DCT cost dct 1 in
  Analyse and in Recalculate, 4 frame pairs): the candidates' blocks come
  from the per-block fetch and, for the dense map of every level whose stack
  is wide enough, the tiled fetch; no SAD map or probe kernel may launch.
  First with the flash (the rescue must run), then without it (it must not);
* the frame-rate conversion path (bench.py config 5: 1920x1080 gray, pel 2,
  blk 16, the full pyramid, FlowFPS maskmode 2, 30 -> 60 fps) through
  flowfps_clip on 9 frames, with the flashing region (the SAD map and the
  tiled probe must launch) and without it (the SAD map must, neither probe
  may);
* the pel-4 path (bench.py config 2: 1920x1080 gray, pel 4, the full
  pyramid, HEX2 searchparam 2, truemotion, 8 pairs a window) through
  build_super and analyse_batch: the level-0 search probes every candidate
  through the tiled probe, the coarse levels ride the SAD map; with the
  flashing region (the rescue must run) and without it (it must not).

It also holds the block DCT on the card against the CPU on more than a
million blocks (dct_vs_cpu: not one coefficient may differ) and runs the
DCT chain at 256x192 on the card against the CPU for each of dct 1-4.

Then the Depan quartet, stabilisation and the command line, at full width
(the clips made from --seed, default 0):

* stabilise_main_path: models.stabilize.stabilize_clip on 24 frames of
  1920x1080 YUV420 (a noise texture under a random-walk pan of 1-6 px a
  frame with fractional steps, a scene cut at frame 12), method 0 and
  method 1 (prev 1, next 1, mirror 15, bicubic): output frames/s, the
  CUDA-event ms of estimation and stabilisation, device launches, peak
  memory; the card's motions against the CPU's (equal correlation peaks,
  the CPU tests' tolerances, the same untrusted frames) and
  depan_stabilise given the same motions torch.equal on the card and the
  CPU;
* depan_analyse_path: 8 frames of 1920x1080 YUV420 warped by a known
  motion with rotation and zoom (ops/warp.py), Super -> analyse_batch
  (lockstep; the SAD map must launch) -> depan_analyse -> depan_compensate:
  the fitted motion against the known one, host syncs and ms a frame, the
  motions card against CPU within the CPU tests' tolerance, the
  compensated planes and the rotation-branch warp torch.equal;
* cli_main_path: a 10-frame 1080p YUV420 y4m through
  `python3 -m mvtools_tpu_torch.cli` on the card for degrain3, flowfps,
  stabilise and depancompensate (frame counts and sizes checked; degrain3
  and stabilise byte for byte the in-process calls), seconds and frames/s
  of each; then the three phases' wall seconds (depan_seconds).

Every phase prints one JSON line; any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  The last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

additionally traces one more full-width run of each of the fifteen clips
with torch.profiler and prints where the device time went (busy share,
kernels by time, and the summed device time of every kernel form; for the
two flash clips also the per-block probe's time by launch grid, and for the
16-bit one the uint16 tiled probe's, which name the plane and the pyramid
level).

    python3 chip_smoke.py --paths-only [--profile] [--package-root DIR]
                          [--sass-out FILE] [--sass-reference FILE]
                          [--paths gray,yuv,yuv16,satd,dct,fps,pel4,
                                   exact,fields,depan] [--seed N]

times the 8-bit kernels at the YUV420 and DCT paths' shapes, the
three-stat per-block probe at the SATD path's level-5 shapes, masked and
not (phase redesigned_kernel_times), and drives the full-width paths (no other kernel comparison, no small runs, no
kernels line and no "ok" line), with the package of the checkout at DIR if
given: the way to compare two trees' kernels, paths and kernel sums in one
call; --paths runs only the named paths (satd: the Recalculate and the
SATD Analyse paths; fps: the frame-rate conversion path, skipped for a
package that has none; pel4: config 2, skipped for a package without
pel 4; depan: the stabilisation and Depan paths, skipped for a package
without them; the command line's phase runs only in the full run).  DIR must hold a package that has the uint16
kernel forms and Super.take.  --sass-out writes the sass phase's opcode counts as JSON;
--sass-reference reads such a file (another tree's) and fails unless every
kernel form of SASS_HELD (all but the three-stat per-block probe) counts
the same opcodes.
"""

import dataclasses
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

# --package-root DIR (with --paths-only) drives the mvtools_tpu_torch of
# another checkout, so that one script times two trees in one call, in turns
if "--package-root" in sys.argv:
    sys.path.insert(0, os.path.abspath(
        sys.argv[sys.argv.index("--package-root") + 1]))

import torch

from mvtools_tpu_torch import (AnalyseConfig, RecalculateConfig, SuperConfig,
                               analyse, analyse_batch, recalculate)
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
from mvtools_tpu_torch.core.types import (ColorFamily, MVField, MVPlaneField,
                                          SearchType, VideoFormat)
from mvtools_tpu_torch.degrain import DegrainConfig, degrain, gather_blocks
from mvtools_tpu_torch.models.denoise import (degrain_clip, degrain_window,
                                              flagship_configs,
                                              headline_specs, make_test_clip,
                                              make_test_clip_yuv)
from mvtools_tpu_torch.ops import cuda_build, probe, sadmap
from mvtools_tpu_torch.super import build_super

try:
    from mvtools_tpu_torch.ops import exact_scan
except ImportError:        # a package before the exact engine (--package-root)
    exact_scan = None

# Published dense peaks of one H100 SXM at its full 700 W limit.  The SAD
# kernels do integer abs-diff-accumulate outside the tensor cores; the data
# sheet's only rate for non-tensor-core arithmetic is 67 T/s, used here for
# one abs-diff and one add per pixel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Integer operations per pixel of a block: the SAD takes an abs-diff and an
# add (2); the three stats add the reference sum (1), the two butterfly
# passes of the 4x4 Hadamard (64 adds/subtracts per 16 pixels: 4) and an abs
# and an add per coefficient (2).
OPS_PER_PIXEL = {"sad": 2, "sad_satd_luma": 9}
STATS3 = "sad_satd_luma"

W, H, BATCH, RADIUS = 1920, 1080, 8, 1
# the times of the previous K1 / K2 bodies at the gray path's levels 0-2
# (ms on an H100 80GB HBM3 at 700 W, as PERF.md records them)
GRAY_K1_BEFORE = (2.879, 0.599, 0.172)
GRAY_K2_BEFORE = (0.374, 0.100, 0.067)
# K1 u16's first body at the deep-bit YUV level-0 luma, chroma and
# 0-against-maximum shapes, and K2''s at Recalculate's, the hexagon's, the
# ring's and the masked hexagon's (PERF.md, H100 80GB HBM3, 700 W)
K1_U16_BEFORE = {16: (3.280, 0.843, 3.299), 10: (3.277, 0.847, None)}
K2P_BEFORE = (0.158, 0.139, 0.176, 0.094)
# K2 u16's first body at the deep-bit YUV level-0 luma (unmasked, masked)
# and chroma (unmasked, masked) shapes (PERF.md, H100 80GB HBM3, 700 W)
K2_U16_BEFORE = {16: (0.585, 0.343, 0.832, 0.391),
                 10: (0.591, 0.348, 0.827, 0.388)}
# K4's and K4 u16's previous body at k4_cases's shapes, in its order (the
# nine YUV420-path shapes, then the three masked ones), by bit depth
# (CUDA-event ms, PERF.md, H100 80GB HBM3, 700 W)
# K4''s previous body at k4p_cases's three unmasked shapes (CUDA-event ms,
# PERF.md, H100 80GB HBM3, 700 W)
K4P_BEFORE = (0.039, 0.039, 0.027)
K4_BEFORE = {8: (0.0672, 0.0570, 0.0531, 0.0611, 0.0649, 0.0352, 0.0480,
                 0.0402, 0.0542, 0.1719, 0.0854, 0.1484),
             16: (0.0543, 0.0582, 0.0512, 0.0403, 0.0545, 0.0544, 0.0579,
                  0.0518, 0.0621, 0.1152, 0.0918, 0.1208),
             10: (0.0566, 0.0388, 0.0423, 0.0679, 0.0460, 0.0379, 0.0446,
                  0.0746, 0.1051, 0.0929, 0.1110, 0.0799)}
FLASH = (416, 832, 256, 256)
SMALL_W, SMALL_H, SMALL_FLASH = 256, 192, (32, 64, 96, 128)
# the YUV420 path: 14 frames, flash over most of the frame, noise of +-4 per
# frame, pan of one pixel per frame (a neighbour three frames away is then 3
# pixels off, so no border block of the clip without the flash turns bad)
YUV_T, YUV_NOISE, YUV_PAN = 14, 4, (1, 1)
YUV_FLASH = (64, 128, 952, 1664)
SMALL_YUV_T, SMALL_YUV_FLASH = 6, (16, 16, 160, 224)
KERNEL_JOBS = 12      # jobs in the YUV kernel comparisons
# the SATD paths: gray, 9 frames -> 8 pairs (Recalculate path), 5 frames -> 4
# pairs (SATD Analyse path).  With dct 5 the cost is the SATD alone, and the
# SATD of a pure brightness step is at most 8 * 255 per 4x4 tile (32 640 for
# a 16x16 block), under the default badsad's 40 000: no flash is "bad" at the
# default, so the paths that must reach the rescue set badsad to 5000.
RECALC_PAIRS, SATD_PAIRS, SATD_BADSAD = 8, 4, 5000
SATD_CLEAN = (256, 256, 512, 1024)       # no fresh noise: exact matches
SMALL_SATD_CLEAN = (64, 96, 96, 128)
HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
# the DCT path (dct 1): a brightness step costs about 8 * 4 * 96 (the DC step
# of the requantised DCT, weighted 1 + 3) plus the noise's AC terms, no more
# than the fresh noise of a calm pair does at level 0 (up to about 6 000 for
# a 16x16 block in CPU runs of this clip at 512x288 and 960x544); only the
# flash's mismatched edge blocks cost more.  2500 per 8x8 (10 000 for a
# 16x16 block, under the default's 40 000) lies between: the rescue runs at
# level 0 of the flash clip and nowhere on the calm one
DCT_BADSAD = 2500
# the kernels that serve a fetch of reference blocks; a stack under the
# tiled fetch's window (the small clips' and the coarse levels') goes to the
# per-block one
FETCH_KERNELS = ("fetch_blocks_tiled", "fetch_blocks")
# the deep-bit YUV420 path: the flagship configuration at 16 bits; its
# kernel comparisons also at 10 bits, with a region of 0 against the pixel
# maximum (EXTREME_REGION: y, x, h, w in luma pixels)
DEEP_BITS = 16
EXTREME_REGION = (256, 512, 256, 512)
U16_KERNELS = ("sad_map[u16]", "probe_sads_tiled[u16]", "probe_sads[u16]",
               "fetch_blocks_tiled[u16]", "fetch_blocks[u16]")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_cuda(fn, reps):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_device(fn, reps, kernel):
    """Mean device milliseconds a call of fn() spends in the kernels whose
    trace names match `kernel` (a regular expression), from a torch.profiler
    trace of `reps` calls after one warm-up: the kernel's own time, without
    the wrapper's host path that a short kernel's CUDA-event time holds.
    None where the trace shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and re.search(kernel, e.key))
    return us / 1e3 / reps if us > 0 else None


def time_plain(fn, warm=True):
    """(result, milliseconds) of a plain version: one warm-up call (unless
    warm is false), then one timed call that ends in a synchronise."""
    if warm:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(n_bytes, n_ops):
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare(name, got, want):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return err


def level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv):
    """(LevelCtx, padded stacks per plane) of the jobs (src_idx, ref_idx)."""
    ctx = _level_ctx(sspec, aspec, lv, sups.take(src_idx),
                     sups.take(ref_idx))
    return ctx, fe.pad_stacks(ctx)


def plane_geom(ctx, plane):
    """(bs_y, bs_x, pitch_y, pitch_x, origin_y, origin_x, probe pad) of the
    block grid of a color plane (0 luma, 1/2 chroma) at this level."""
    logx, logy = ctx.log_ratio_uv if plane else (0, 0)
    bsx, bsy = ctx.blk_size_c if plane else ctx.blk_size
    return (bsy, bsx, (ctx.blk_size[1] - ctx.overlap[1]) >> logy,
            (ctx.blk_size[0] - ctx.overlap[0]) >> logx,
            ctx.vpad[1 if plane else 0], ctx.hpad[1 if plane else 0],
            fe.chroma_pad(ctx) if plane else fe.FieldProber.PAD)


def case_label(ctx, plane, extra=""):
    kind = "chroma" if plane else "luma"
    ov = f" overlap {ctx.overlap[0]}" if ctx.overlap[0] else ""
    depth = f" {ctx.bits}-bit" if ctx.bits != 8 else ""
    return f"level {ctx.level} {kind}{ov}{extra}{depth}"


def stats_tag(stats):
    return "" if stats == "sad" else " three stats"


def bits_tag(sspec):
    return "" if sspec.bits == 8 else f" {sspec.bits}-bit"


def k1_case(ctx, stacks, gen, plane=0, stats="sad", extra="",
            before_ms=None):
    """sad_map at one level's main-path shape; anchors spread over the
    whole legal range, both clamp ends included.  before_ms: the previous
    kernel body's time at this shape, as PERF.md records it, printed beside
    this run's time."""
    bsy, bsx, pit_y, pit_x, oy, ox, _ = plane_geom(ctx, plane)
    stack = stacks[plane]
    nbx, nby = ctx.nblk
    tile, r = fe._map_tile(ctx), fe.map_radius(ctx)
    r_y, r_x = fe._chroma_map_geom(ctx, r)[:2] if plane else (r, r)
    ntx = -(-nbx // tile)
    nj = stack.shape[0]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r_y, r_x, bsy, bsx, ctx.pel, tile, pit_x, stack.shape[2],
        stack.shape[3])
    dev = stack.device
    afy = torch.randint(lo_y, hi_y + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    afx = torch.randint(lo_x, hi_x + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    src_plane = ctx.src_planes[plane]
    args = (stack, src_plane, afy, afx, r_y, r_x, bsy, bsx, ctx.pel, tile,
            pit_x, pit_y, nbx, nby, oy, ox, stats)
    out = sadmap.sad_map(*args)
    want, plain_ms = time_plain(lambda: sadmap.sad_map_plain(*args))
    label = case_label(ctx, plane, f" pel {ctx.pel} pitch {pit_x}"
                       + stats_tag(stats) + extra)
    err = compare(f"sad_map {label}", out, want)
    del want
    ms = time_cuda(lambda: sadmap.sad_map(*args), 5)
    device_ms = time_device(lambda: sadmap.sad_map(*args), 5, KERNEL_NAMES[
        kernel_name("sad_map", stack, stats)])
    n_entries = out.numel() // (1 if stats == "sad" else 3)
    n_ops = n_entries * bsy * bsx * OPS_PER_PIXEL[stats]
    n_bytes = ((stack.numel() + src_plane.numel()) * stack.element_size()
               + 4 * (afy.numel() + afx.numel()) + 4 * out.numel())
    b_ms, b_by = bound(n_bytes, n_ops)
    res = dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, min_entry=int(out.min()),
               max_entry=int(out.max()))
    if stats == "sad":
        g = sadmap.map_launch_geom(r_y, r_x, bsy, bsx, ctx.pel, tile, pit_x,
                                   stack.element_size())
        res["launch"] = {k: g[k] for k in ("threads", "smem", "nws", "nox",
                                           "n_chunk", "passes", "nbc",
                                           "n_part")
                         if k in g}
    else:
        g = sadmap.map3_launch_geom(r_y, r_x, bsy, bsx, ctx.pel, tile, pit_x)
        res["launch"] = {k: g[k] for k in ("threads", "smem", "passes", "nox",
                                           "n_chunk", "n_band")}
    if before_ms is not None:
        res["before_ms"] = before_ms
    return res


def k1_geometry_cases(gen, dev):
    """K1 at the geometries whose code paths the headline and YUV shapes do
    not reach: a block pitch that is not a multiple of 4 (blk 16 overlap 2:
    pitch 14; blk 8 overlap 2: pitch 6, 8x8 blocks) and pel 1, each on level
    0 of a 1080p gray clip, 4 jobs."""
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    clip = make_test_clip(5, W, H, seed=4, device=dev)
    src_idx = torch.tensor([1, 1, 3, 3], device=dev)
    ref_idx = torch.tensor([2, 0, 4, 2], device=dev)
    cases = []
    for pel, bs, ov in ((2, 16, 2), (2, 8, 2), (1, 16, 0)):
        sspec = SuperConfig(pel=pel, levels=1, chroma=False).validate(fmt)
        aspec = AnalyseConfig(blksize=bs, overlap=ov, levels=1,
                              chroma=False).validate(sspec)
        sups = build_super([clip], sspec)
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
        cases.append(k1_case(ctx, stacks, gen))
        del ctx, stacks, sups
    del clip
    torch.cuda.empty_cache()
    return cases


def probe_inputs(ctx, stacks, gen, plane, kk, spread=6, far_share=0.05):
    """Candidates round a smooth vector field for every block of a plane's
    grid, a share of them thrown far away, and the source blocks."""
    bsy, bsx, pit_y, pit_x, oy, ox, pad = plane_geom(ctx, plane)
    stack = stacks[plane]
    nbx, nby = ctx.nblk
    nblk = nbx * nby
    nj = stack.shape[0]
    dev = stack.device
    logp = ctx.log_pel
    idx = torch.arange(nblk, device=dev, dtype=torch.int32)
    base_y = (oy + pit_y * (idx // nbx) + pad) << logp
    base_x = (ox + pit_x * (idx % nbx) + pad) << logp
    vy = torch.randint(-spread, spread + 1, (nj, nblk, kk), generator=gen,
                       device=dev, dtype=torch.int32)
    vx = torch.randint(-spread, spread + 1, (nj, nblk, kk), generator=gen,
                       device=dev, dtype=torch.int32)
    far = torch.rand((nj, nblk, kk), generator=gen, device=dev) < far_share
    vx = torch.where(far, vx + 150 * ctx.pel, vx)
    vy = torch.where(far, vy - 40 * ctx.pel, vy)
    cy = (base_y[None, :, None] + vy).contiguous()
    cx = (base_x[None, :, None] + vx).contiguous()
    src_blocks = _blocks_of(ctx.src_planes[plane], oy, ox, nby, nbx, bsy,
                            bsx, pit_y, pit_x).contiguous()
    return stack, cy, cx, src_blocks, bsy, bsx, pit_x


def probe_bound(stack, cy, src_blocks, out, n_valid, d, bsy, bsx,
                stats="sad"):
    n_ops = n_valid * d * bsy * bsx * OPS_PER_PIXEL[stats]
    n_bytes = (8 * cy.numel() + 4 * out.numel()
               + (src_blocks.numel() + min(stack.numel(),
                                           n_valid * d * bsy * bsx))
               * stack.element_size())
    return bound(n_bytes, n_ops)


def kernel_name(base, stack, stats="sad"):
    """The launch count of a kernel's form for this stack and stats."""
    if stats != "sad":
        return base + "[stats3]"
    return base + "[u16]" if stack.dtype == torch.uint16 else base


def live_mask(shape, gen, dev, block_share=0.5, entry_share=0.6):
    """An `active` mask [J, nblk, K, D] with about block_share *
    entry_share of its entries live: whole (job, block, candidate) rows are
    dead (their warps end at once), the rest live entry by entry."""
    rows = torch.rand(shape[:3] + (1,), generator=gen, device=dev) < block_share
    return rows & (torch.rand(shape, generator=gen, device=dev) < entry_share)


def fits_tile_window(ctx, stacks, plane, offsets, kk):
    """Whether a plane's stack holds the tiled probe's window (else the
    per-block probe serves it)."""
    bsy, bsx, _, pit_x, _, _, _ = plane_geom(ctx, plane)
    wy_total, wx_total, _, _ = probe.tile_params(
        offsets, bsy, bsx, ctx.pel, 8 if kk <= 2 else 4, pit_x)
    return (stacks[plane].shape[2] >= wy_total
            and stacks[plane].shape[3] >= wx_total)


def k2_case(ctx, stacks, gen, offsets, kk, label, plane=0, stats="sad",
            masked=False, before_ms=None):
    """probe_sads_tiled around a smooth vector field; a twentieth of the
    candidates is thrown far off its tile so INVALID_SAD is exercised.
    masked: with an `active` mask that leaves about 30 % of the entries
    live and whole warps dead.  before_ms: the previous kernel body's time
    at this shape, as PERF.md records it."""
    stack, cy, cx, src_blocks, bsy, bsx, pit_x = probe_inputs(
        ctx, stacks, gen, plane, kk)
    active = (live_mask(tuple(cy.shape) + (len(offsets),), gen, stack.device)
              if masked else None)
    nbx = ctx.nblk[0]
    tile = 8 if kk <= 2 else 4
    geom = probe.tile_params(offsets, bsy, bsx, ctx.pel, tile, pit_x)
    if stack.shape[2] < geom[0] or stack.shape[3] < geom[1]:
        raise AssertionError(f"probe_sads_tiled {label}: the plane is under "
                             "the tile window; this case belongs to the "
                             "per-block probe")

    def run():
        return probe.probe_sads_tiled(stack, cy, cx, src_blocks, offsets,
                                      bsy, bsx, ctx.pel, row_len=nbx,
                                      pitch_x=pit_x, stats=stats,
                                      active=active)

    label += stats_tag(stats) + (" masked" if masked else "")
    counts0 = read_counts()
    out = run()
    name = kernel_name("probe_sads_tiled", stack, stats)
    if read_counts()[name] != counts0[name] + 1:
        raise AssertionError(f"{name} {label}: the kernel did not launch")
    want, plain_ms = time_plain(lambda: probe.probe_sads_tiled_plain(
        stack, cy, cx, src_blocks, offsets, bsy, bsx, ctx.pel, nbx, tile,
        *geom, stats, active))
    err = compare(f"probe_sads_tiled {label}", out, want)
    sads = out if stats == "sad" else out[..., 0]
    if masked and not bool((sads[~active] == probe.INVALID_SAD).all()):
        raise AssertionError(f"probe_sads_tiled {label}: an inactive entry "
                             "is not INVALID_SAD")
    if stats != "sad" and not torch.equal(
            (out == probe.INVALID_SAD).all(dim=-1),
            (out == probe.INVALID_SAD).any(dim=-1)):
        raise AssertionError(f"probe_sads_tiled {label}: a triple is only "
                             "partly INVALID_SAD")
    n_invalid = int((sads[..., 0] == probe.INVALID_SAD).sum())
    n_valid = sads[..., 0].numel() - n_invalid
    if n_invalid == 0 or n_valid == 0:
        raise AssertionError(f"probe_sads_tiled {label}: the case must hold "
                             f"valid and invalid candidates ({n_valid}, "
                             f"{n_invalid})")
    ms = time_cuda(run, 10)
    device_ms = time_device(run, 10, KERNEL_NAMES[name])
    # the entries this run's data needs: valid and live
    n_needed = int((sads != probe.INVALID_SAD).sum())
    b_ms, b_by = probe_bound(stack, cy, src_blocks, out,
                             n_needed / len(offsets), len(offsets), bsy, bsx,
                             stats)
    res = dict(case=label, shape=list(out.shape), invalid=n_invalid,
               max_abs_err=err, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    if masked:
        res["live_share"] = float(active.float().mean())
    if before_ms is not None:
        res["before_ms"] = before_ms
    return res


def k4_touched_pixels(stack, cy, cx, offsets, bsy, bsx, pel, active):
    """The stack pixels the live entries of a per-block probe read (each
    counted once), by the window rule of probe_sads_plain."""
    logp = pel.bit_length() - 1
    nj, n_sub, hp, wp = stack.shape
    min_dx, min_dy, wy, wx = probe._window_geom(offsets, bsy, bsx, pel)
    dev = stack.device
    wb_y = (cy + min_dy) >> logp
    wb_x = (cx + min_dx) >> logp
    sh_y = probe.wrap_clamp(wb_y, hp, wy) - wb_y
    sh_x = probe.wrap_clamp(wb_x, wp, wx) - wb_x
    seen = torch.zeros(stack.numel(), dtype=torch.bool, device=dev)
    job = torch.arange(nj, device=dev).reshape(nj, 1, 1)
    rows = torch.arange(bsy, device=dev)[:, None]
    cols = torch.arange(bsx, device=dev)
    for d, (dx, dy) in enumerate(offsets):
        ay, ax = cy + dy, cx + dx
        sub = (ax & (pel - 1)) | ((ay & (pel - 1)) << logp)
        fy = (ay >> logp) + sh_y
        fx = (ax >> logp) + sh_x
        base = ((job * n_sub + sub) * hp + fy) * wp + fx      # [J, nblk, K]
        if active is not None:
            base = base[active[..., d]]
        idx = base.reshape(-1, 1, 1).long() + rows * wp + cols
        seen[idx.reshape(-1)] = True
    return int(seen.sum())


def k4_bound(stack, cy, cx, src_blocks, offsets, bsy, bsx, pel, out,
             active, stats="sad"):
    """(bound ms, "bytes" or "operations", bytes, operations) of a
    per-block probe call: the live entries' block sums at OPS_PER_PIXEL
    operations a pixel; bytes: each stack pixel they read and each source
    block and candidate they need once, the offsets, the mask and the
    output."""
    d = len(offsets)
    eb = stack.element_size()
    live = (torch.ones(out.shape[:4], dtype=torch.bool, device=out.device)
            if active is None else active)
    n_live = int(live.sum())
    items = live.any(dim=-1)                             # [J, nblk, K]
    n_bytes = (k4_touched_pixels(stack, cy, cx, offsets, bsy, bsx, pel,
                                 active) * eb
               + int(items.any(dim=-1).sum()) * bsy * bsx * eb
               + 8 * int(items.sum()) + 8 * d
               + (0 if active is None else active.numel())
               + 4 * out.numel())
    n_ops = n_live * bsy * bsx * OPS_PER_PIXEL[stats]
    b_ms, b_by = bound(n_bytes, n_ops)
    return b_ms, b_by, n_bytes, n_ops


def k4_direct_case(label, stack, cy, cx, src_blocks, offsets, bsy, bsx, pel,
                   stats="sad", active=None, before_ms=None):
    """probe_sads (the per-block probe) at one shape against its plain
    version (tolerance 0); with `active` (a bool [J, nblk, K, D] mask) the
    output must hold INVALID_SAD on exactly the inactive entries.  Timed by
    CUDA events and by its device time; the bound counts what this run's
    live entries need (k4_bound)."""
    args = (stack, cy, cx, src_blocks, offsets, bsy, bsx, pel, stats)
    name = kernel_name("probe_sads", stack, stats)
    takes_mask = "active" in inspect.signature(probe.probe_sads).parameters

    def run():
        if active is None:
            return probe.probe_sads(*args)
        if takes_mask:
            return probe.probe_sads(*args, active=active)
        # a package from before the kernel took the mask: masked after it
        return probe._invalid_where(active, probe.probe_sads(*args))

    def plain():
        out = probe.probe_sads_plain(*args)
        return out if active is None else probe._invalid_where(active, out)

    before = probe.launches[name]
    out = run()
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name} {label}: the kernel did not launch")
    want, plain_ms = time_plain(plain)
    err = compare(f"probe_sads {label}", out, want)
    if active is not None:
        sads = out if stats == "sad" else out[..., 0]
        if not torch.equal(sads == probe.INVALID_SAD, ~active):
            raise AssertionError(f"probe_sads {label}: INVALID_SAD is not "
                                 "on exactly the inactive entries")
    ms = time_cuda(run, 20)
    device_ms = time_device(run, 20, KERNEL_NAMES[name])
    b_ms, b_by, n_bytes, n_ops = k4_bound(stack, cy, cx, src_blocks, offsets,
                                          bsy, bsx, pel, out, active, stats)
    res = dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=n_bytes, ops=n_ops)
    if active is not None:
        res["live_share"] = float(active.float().mean())
    n_sm = torch.cuda.get_device_properties(stack.device).multi_processor_count
    if stats == "sad" and hasattr(probe, "probe_block_launch_geom"):
        res["launch"] = probe.probe_block_launch_geom(
            bsy, bsx, out.numel(), stack.dtype == torch.uint16, n_sm)
    elif stats != "sad" and hasattr(probe, "probe_block3_launch_geom"):
        res["launch"] = probe.probe_block3_launch_geom(
            bsy, bsx, out.shape[:4].numel(), n_sm)
    if before_ms is not None:
        res["before_ms"] = before_ms
    return res


def k4_case(ctx, stacks, gen, offsets, kk, plane=0, stats="sad",
            live=None, before_ms=None):
    """probe_sads (the per-block probe) on a plane under the tile window;
    candidates reach a few pixels past the stack's bottom/right edges, where
    the window is shifted in.  live: None, or (block share, entry share) of
    an `active` mask (live_mask; (0, 0): every entry dead); before_ms: the
    previous body's time at this shape."""
    stack, cy, cx, src_blocks, bsy, bsx, _ = probe_inputs(
        ctx, stacks, gen, plane, kk, spread=10, far_share=0.0)
    logp = ctx.log_pel
    min_dx, min_dy, wy, wx = probe._window_geom(offsets, bsy, bsx, ctx.pel)
    cy.clamp_(min=-min_dy)
    cx.clamp_(min=-min_dx)
    cy[:, -1, 0] = (stack.shape[2] - bsy + 3) << logp
    cx[:, -1, 0] = (stack.shape[3] - bsx + 2) << logp
    label = case_label(ctx, plane, f" pel {ctx.pel} K={kk} D={len(offsets)}"
                       + stats_tag(stats))
    active = None
    if live is not None:
        active = live_mask(tuple(cy.shape) + (len(offsets),), gen,
                           stack.device, *live)
        label += " masked %d %%" % round(100 * live[0] * live[1])
    return k4_direct_case(label, stack, cy, cx, src_blocks, offsets, bsy,
                          bsx, ctx.pel, stats, active, before_ms)


# the masks of the masked per-block probe cases: (block share, entry share)
# of live_mask, about 30 % and 3 % of the entries live, and none
K4_MASKS = ((0.5, 0.6), (0.1, 0.3), (0.0, 0.0))


def k4_cases(cfgs, gen, dev, bits):
    """K4 (8 bits) or K4 u16 at the nine shapes the YUV420 path at `bits`
    bits gives it: level-4 chroma (8x8; D=16 and D=8 with K=1, D=1 with
    K=6), level-5 luma (16x16; D=6, D=8 and D=1 with K=1, D=1 with K=6), the
    finest level of a 256x192 clip at pel 2 (luma walk D=8 K=1, chroma
    hexagon K=6); then level-4 chroma D=16 with masks that leave about 30 %,
    about 3 % and none of its entries live.  The deep-bit clip holds a
    region of 0 against 2^bits - 1."""
    scfg, acfg, _, _ = cfgs
    fmt = VideoFormat(W, H, bits, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    n = KERNEL_JOBS // 2 + 1
    clip = make_test_clip_yuv(n, W, H, seed=1, flash=YUV_FLASH,
                              noise=YUV_NOISE, pan=YUV_PAN, bits=bits,
                              device=dev)
    if bits > 8:
        clip = with_extremes(clip, bits)
    sups = build_super(clip, sspec)
    src_idx = torch.arange(KERNEL_JOBS, device=dev) // 2
    ref_idx = (src_idx + 1 - 2 * (torch.arange(KERNEL_JOBS, device=dev) % 2)
               ).clamp(0, n - 1)
    ring = tuple(fe._ring_offsets(1, 1))
    walk = tuple(fe._HEXP)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    before = iter(K4_BEFORE[bits])
    cases = []
    for lv, plane, sets in ((4, 1, ((grid16, 1), (ring, 1), (((0, 0),), 6))),
                            (5, 0, ((HEXAGON, 1), (walk, 1),
                                    (((0, 0),), 6), (((0, 0),), 1)))):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        for offsets, kk in sets:
            cases.append(k4_case(ctx, stacks, gen, offsets, kk, plane,
                                 before_ms=next(before)))
        if lv == 4:
            masked = [k4_case(ctx, stacks, gen, grid16, 1, plane, live=m)
                      for m in K4_MASKS]
        del ctx, stacks
    del sups, clip
    # pel 2: the finest level of a small clip, both planes
    small_fmt = VideoFormat(SMALL_W, SMALL_H, bits, ColorFamily.YUV420)
    s_sspec = scfg.validate(small_fmt)
    s_aspec = dataclasses.replace(acfg, isb=True).validate(s_sspec)
    small = make_test_clip_yuv(3, SMALL_W, SMALL_H, seed=3, noise=YUV_NOISE,
                               bits=bits, device=dev)
    s_sups = build_super(small, s_sspec)
    ctx, stacks = level_inputs(s_sspec, s_aspec, s_sups,
                               torch.tensor([1, 1], device=dev),
                               torch.tensor([2, 0], device=dev), 0)
    cases.append(k4_case(ctx, stacks, gen, walk, 1, 0,
                         before_ms=next(before)))
    cases.append(k4_case(ctx, stacks, gen, HEXAGON, 6, 1,
                         before_ms=next(before)))
    del ctx, stacks, s_sups, small
    for case in masked:
        case["before_ms"] = next(before)
    torch.cuda.empty_cache()
    return cases + masked


# the block sizes of the per-block probe's width-class cases: (bs_y, bs_x,
# pel, offsets, K): 2x2 chroma (a 4x4 block at 4:2:0; half a word a row at
# 8 bits), 4x2 (8x4 at 4:2:0: one word a row, or two at 16 bits), 8x1
# (16x2 at 4:2:0: one lane an entry), 64x64 and 128x128 luma (several
# parts a lane)
K4_WIDTHS = ((2, 2, 2, HEXAGON, 1), (2, 4, 2, HEXAGON, 6),
             (1, 8, 2, tuple((dx, dy) for dy in range(-2, 2)
                             for dx in range(-2, 2)), 1),
             (64, 64, 1, HEXAGON, 1), (128, 128, 1, ((0, 0),), 6))


def k4_width_cases(gen, dev, bits):
    """K4 (8 bits) or K4 u16 at a block size of each width class of the
    kernel (K4_WIDTHS), on random `bits`-bit stacks of four jobs whose
    planes are a few blocks wide; candidates spread round each block, a
    few past the stack's bottom and right edges and before its top and
    left; the 2x2 case also with a mask that leaves about 30 % of the
    entries live."""
    from mvtools_tpu_torch.ops import pixels
    top = (1 << bits) - 1
    dtype = pixels.dtype_of(bits)
    cases = []
    for bsy, bsx, pel, offsets, kk in K4_WIDTHS:
        nj, pad = 4, 8
        nbx, nby = (4, 3) if bsx >= 64 else (40, 30)
        hp, wp = nby * bsy + 2 * pad + 3, nbx * bsx + 2 * pad + 5
        stack = pixels.narrow(torch.randint(
            0, top + 1, (nj, pel * pel, hp, wp), generator=gen, device=dev,
            dtype=torch.int32), dtype)
        src = pixels.narrow(torch.randint(
            0, top + 1, (nj, nbx * nby, bsy, bsx), generator=gen, device=dev,
            dtype=torch.int32), dtype)
        idx = torch.arange(nbx * nby, device=dev, dtype=torch.int32)
        base_y = (pad + bsy * (idx // nbx)) * pel
        base_x = (pad + bsx * (idx % nbx)) * pel
        spread = 6 * pel
        cy = (base_y[None, :, None] + torch.randint(
            -spread, spread + 1, (nj, nbx * nby, kk), generator=gen,
            device=dev, dtype=torch.int32)).contiguous()
        cx = (base_x[None, :, None] + torch.randint(
            -spread, spread + 1, (nj, nbx * nby, kk), generator=gen,
            device=dev, dtype=torch.int32)).contiguous()
        cy[:, -1, 0] = (hp - bsy + 3) * pel + 1
        cx[:, -2, 0] = (wp - bsx + 4) * pel
        cy[0, 0, 0], cx[0, 0, 0] = -3 * pel, -5 * pel + 1
        label = (f"{bsx}x{bsy} pel {pel} K={kk} D={len(offsets)}"
                 + ("" if bits == 8 else f" {bits}-bit"))
        cases.append(k4_direct_case(label, stack, cy, cx, src, offsets, bsy,
                                    bsx, pel))
        if bsx == 2:
            active = live_mask(tuple(cy.shape) + (len(offsets),), gen, dev)
            cases.append(k4_direct_case(label + " masked", stack, cy, cx,
                                        src, offsets, bsy, bsx, pel,
                                        active=active))
        del stack, src
    torch.cuda.empty_cache()
    return cases


def gather_index(stack, cy, cx, bsy, bsx, pel):
    """Broadcast int64 index tensors (job, subplane, row, column) that make
    one advanced-indexing gather stack[index] compute the blocks of the
    per-block fetch (the full-pel origin taken as a whole, the way a window
    slice takes it: probe.wrap_clamp)."""
    logp = pel.bit_length() - 1
    nj, _, hp, wp = stack.shape
    dev = stack.device
    sub = ((cx & (pel - 1)) | ((cy & (pel - 1)) << logp)).long()
    fy = probe.wrap_clamp(cy >> logp, hp, bsy).long()
    fx = probe.wrap_clamp(cx >> logp, wp, bsx).long()
    job = torch.arange(nj, device=dev).reshape(nj, 1, 1, 1, 1)
    return (job, sub[..., None, None],
            fy[..., None, None] + torch.arange(bsy, device=dev)[:, None],
            fx[..., None, None] + torch.arange(bsx, device=dev))


def library_gather_ms(stack, cy, cx, bsy, bsx, pel, want):
    """Milliseconds of one advanced-indexing gather stack[index] on
    precomputed index tensors (the yardstick PyTorch call: it writes pixels
    where the kernels write int32; a uint16 stack is gathered through its
    int16 view, since PyTorch's CUDA indexing takes no uint16); it must give
    the same blocks."""
    index = gather_index(stack, cy, cx, bsy, bsx, pel)
    if stack.dtype == torch.uint16:
        view = stack.view(torch.int16)
        got = view[index].to(torch.int32) & 0xFFFF
    else:
        view = stack
        got = stack[index].to(torch.int32)
    if not torch.equal(got, want):
        raise AssertionError("the library gather computes other blocks")
    return time_cuda(lambda: view[index], 10)


def fetch_bound(stack, cy, out):
    """(ms, by) of a fetch: each candidate's coordinates read, each block
    written as int32, and the stack bytes the blocks need, at most the whole
    stack once."""
    n_pix = out.numel()
    return bound(4 * n_pix + 8 * cy.numel()
                 + min(stack.numel(), n_pix) * stack.element_size(), 0)


def k3_case(sspec, meta, sups, gen, plane=0, frames=BATCH, before_ms=None):
    """fetch_blocks_tiled as degrain calls it: one block per grid block of
    `frames` frames, vectors running past the clamp on every side.
    before_ms: the first kernel body's time at this shape, as PERF.md
    records it, printed beside this run's time."""
    sub = 1 if plane else 0
    bsy, bsx = meta.blk_size_y >> sub, meta.blk_size_x >> sub
    stack = sups.planes[plane][0][:frames].contiguous()
    nb = stack.shape[0]
    dev = stack.device
    pos_y, pos_x = torch.meshgrid(
        torch.arange(meta.blk_y, dtype=torch.int32, device=dev)
        * (meta.blk_size_y - meta.overlap_y),
        torch.arange(meta.blk_x, dtype=torch.int32, device=dev)
        * (meta.blk_size_x - meta.overlap_x), indexing="ij")
    lim = (sspec.hpad + 24) * sspec.pel
    mvx = torch.randint(-lim, lim + 1, (nb, meta.blk_y, meta.blk_x),
                        generator=gen, device=dev, dtype=torch.int32)
    mvy = torch.randint(-lim, lim + 1, (nb, meta.blk_y, meta.blk_x),
                        generator=gen, device=dev, dtype=torch.int32)
    pad_x, pad_y = (sspec.hpad >> sub) * sspec.pel, (sspec.vpad >> sub) * sspec.pel
    pitch_x = (meta.blk_size_x - meta.overlap_x) >> sub
    lp = sspec.pel.bit_length() - 1
    name = kernel_name("fetch_blocks_tiled", stack)
    before = probe.launches[name]
    out = gather_blocks(stack, pos_x, pos_y, mvx, mvy, bsy, bsx, lp, pad_x,
                        pad_y, sub, sub, pitch_fp=pitch_x)
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch")
    # the same positions through the plain version
    xa = (((pos_x << lp) + mvx) >> sub) + pad_x
    ya = (((pos_y << lp) + mvy) >> sub) + pad_y
    fx = probe.wrap_clamp(xa >> lp, stack.shape[3], bsx)
    fy = probe.wrap_clamp(ya >> lp, stack.shape[2], bsy)
    m = sspec.pel - 1
    cx = ((fx << lp) | (xa & m)).reshape(nb, -1, 1).contiguous()
    cy = ((fy << lp) | (ya & m)).reshape(nb, -1, 1).contiguous()
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_tiled_plain(
        stack, cy, cx, bsy, bsx, sspec.pel))
    kind = "chroma" if plane else "luma"
    ov = f" overlap {meta.overlap_x}" if meta.overlap_x else ""
    label = (f"level 0 {kind} {bsy}x{bsx}{ov}, {nb} frames"
             f"{'' if sspec.pel == 2 else f' pel {sspec.pel}'}"
             f"{bits_tag(sspec)}")
    err = compare(f"fetch_blocks_tiled {label}", out.reshape(want.shape),
                  want)
    ms = time_cuda(lambda: probe.fetch_blocks_tiled(
        stack, cy, cx, bsy, bsx, sspec.pel, row_len=meta.blk_x,
        pitch_x=pitch_x), 10)
    lib_ms = library_gather_ms(stack, cy, cx, bsy, bsx, sspec.pel, want)
    n_bytes = want.numel() * (stack.element_size() + 4) + 8 * cy.numel()
    b_ms, b_by = bound(n_bytes, 0)
    return dict(case=label, shape=list(want.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, before_ms=before_ms,
                launch=probe.fetch_launch_geom(bsy, bsx))


def k3_direct_case(label, stack, cy, cx, bsy, bsx, pel, row_len):
    """fetch_blocks_tiled on given candidates of a block grid whose blocks
    lie bsx full pels apart, against its plain version, with the library
    gather beside it."""
    name = kernel_name("fetch_blocks_tiled", stack)
    before = probe.launches[name]
    out = probe.fetch_blocks_tiled(stack, cy, cx, bsy, bsx, pel,
                                   row_len=row_len, pitch_x=bsx)
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name} {label}: the kernel did not launch")
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_tiled_plain(
        stack, cy, cx, bsy, bsx, pel))
    err = compare(f"fetch_blocks_tiled {label}", out, want)
    ms = time_cuda(lambda: probe.fetch_blocks_tiled(
        stack, cy, cx, bsy, bsx, pel, row_len=row_len, pitch_x=bsx), 10)
    lib_ms = library_gather_ms(stack, cy, cx, bsy, bsx, pel, want)
    b_ms, b_by = fetch_bound(stack, cy, out)
    return dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, before_ms=None,
                launch=probe.fetch_launch_geom(bsy, bsx))


def k3_blk8_case(gen, dev):
    """fetch_blocks_tiled as degrain calls it on a 1080p gray clip with 8x8
    blocks (pel 2, 32 400 blocks a frame)."""
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=1, chroma=False).validate(fmt)
    aspec = AnalyseConfig(blksize=8, levels=1, chroma=False).validate(sspec)
    clip = make_test_clip(BATCH, W, H, seed=5, device=dev)
    sups = build_super([clip], sspec)
    case = k3_case(sspec, aspec.meta, sups, gen)
    del sups, clip
    torch.cuda.empty_cache()
    return case


def k5_case(label, stack, cy, cx, bsy, bsx, pel):
    """fetch_blocks (the per-block fetch) against its plain version, with
    the library gather beside it."""
    name = kernel_name("fetch_blocks", stack)
    before = probe.launches[name]
    out = probe.fetch_blocks(stack, cy, cx, bsy, bsx, pel)
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name} {label}: the kernel did not launch")
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_plain(
        stack, cy, cx, bsy, bsx, pel))
    err = compare(f"fetch_blocks {label}", out, want)
    ms = time_cuda(lambda: probe.fetch_blocks(stack, cy, cx, bsy, bsx, pel),
                   10)
    lib_ms = library_gather_ms(stack, cy, cx, bsy, bsx, pel, want)
    b_ms, b_by = fetch_bound(stack, cy, out)
    return dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def sass_opcodes(source, function):
    """{opcode with its modifiers: count} of the SASS of every
    instantiation of a kernel function (a regular expression searched in
    the mangled name) in a built source's library (cuobjdump -sass), or
    None where the toolkit has no cuobjdump."""
    exe = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", str(cuda_build._target(source))],
                          capture_output=True, text=True, check=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = re.search(function, line) is not None
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Za-z0-9_.]*)", line)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def kernel_split(prof, kernel):
    """{kernel form, launch grid and block: {"ms", "launches"}} of the
    kernels whose trace names match `kernel`, from a profile's trace: the
    grid names the shape a launch served (plane, pyramid level)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    split = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" or not re.search(kernel, name):
            continue
        m = re.search(r"\w+_kernel<[^>]*>", name)
        args = e.get("args", {})
        key = (f"{m.group(0) if m else name[:60]} grid {args.get('grid')} "
               f"block {args.get('block')}")
        row = split.setdefault(key, {"ms": 0.0, "launches": 0})
        row["ms"] += e.get("dur", 0) / 1e3
        row["launches"] += 1
    return dict(sorted(split.items(), key=lambda kv: -kv[1]["ms"]))


def profile_run(label, fn, split=()):
    """One traced run of fn(): device-busy share and the kernels by time;
    with `split` (KERNEL_NAMES keys) those kernels' time by kernel form and
    launch grid."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)

    def summed(kernel):
        sel = [r for r in rows if re.search(kernel, r[0])]
        return {"ms": sum(r[2] for r in sel),
                "launches": sum(r[1] for r in sel)}

    emit({"phase": "profile", "run": label, "traced_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_busy_share_of_traced_wall": busy_ms / wall_ms,
          "device_launches": sum(r[1] for r in rows),
          "kernel_sums": {name: summed(kernel)
                          for name, kernel in KERNEL_NAMES.items()},
          "top_kernels": [{"name": k[:60], "count": c, "ms": ms}
                          for k, c, ms in rows[:12]],
          **({"split": kernel_split(prof, "|".join(KERNEL_NAMES[name]
                                                   for name in split))}
             if split else {})})


# the device functions of the kernels that --profile sums, as the trace
# names them; the three-stat map and the fetches under their names in this
# tree and in its parent's, so that --package-root reads both
KERNEL_NAMES = {
    "sad_map": r"sadmap_kernel<(unsigned char, )?\d",
    "probe_sads_tiled": r"probe_kernel<(unsigned char, )?\d",
    "probe_sads": r"probe_block_kernel(<unsigned char[,>]|\()",
    "sad_map[stats3]": r"sadmap(3|_stats3)_kernel[<(]",
    "probe_sads_tiled[stats3]": r"probe_stats3_kernel[<(]",
    "probe_sads[stats3]": r"probe_block_stats3_kernel[<(]",
    "fetch_blocks_tiled": r"fetch_kernel<(unsigned char, )?-?\d+, 1>",
    "fetch_blocks": r"fetch_kernel<(unsigned char, )?-?\d+, 0>",
    "sad_map[u16]": r"sadmap(16_kernel<|_kernel<unsigned short)",
    "probe_sads_tiled[u16]": r"probe(16_kernel<|_kernel<unsigned short)",
    "probe_sads[u16]": r"probe_block_kernel<unsigned short[,>]",
    "fetch_blocks_tiled[u16]": r"fetch_kernel<unsigned short, -?\d+, 1>",
    "fetch_blocks[u16]": r"fetch_kernel<unsigned short, -?\d+, 0>",
}
# the mangled names of the kernels whose SASS the sass phase counts, by
# form; a uint8 form matches its name with the pixel type as its first
# template argument ("h") and without, and K2 u16 its name in this tree
# (probe16_kernel) and in a tree before its redesign (probe_kernel on
# uint16, "t"), so that --package-root reads both
SASS_FORMS = {
    "sad_map": ("sadmap", r"13sadmap_kernelI(h|Li)"),
    "probe_sads_tiled": ("probe", r"12probe_kernelI(h|Li)"),
    "probe_sads": ("probe_block", r"18probe_block_kernel(Ih|EPKh)"),
    "fetch_blocks_tiled/fetch_blocks": ("fetch", r"12fetch_kernelI(h|Li)"),
    "sad_map[u16]": ("sadmap", r"(13sadmap_kernelIt|15sadmap16_kernel)"),
    "probe_sads_tiled[u16]": ("probe", r"(12probe_kernelIt|14probe16_kernel)"),
    "probe_sads[u16]": ("probe_block", r"18probe_block_kernelIt"),
    "fetch_blocks_tiled/fetch_blocks[u16]": ("fetch",
                                             r"12fetch_kernelIt"),
    "sad_map[stats3]": ("sadmap", r"sadmap3_kernel"),
    "probe_sads_tiled[stats3]": ("probe", r"19probe_stats3_kernel"),
    "probe_sads[stats3]": ("probe_block", r"probe_block_stats3_kernel"),
}


# the forms whose SASS must stay another tree's (--sass-reference): all but
# the one this tree redesigned
SASS_HELD = tuple(f for f in SASS_FORMS if f != "probe_sads[stats3]")
# K6's forms (a package with the exact engine only), not held
SASS_EXACT = {
    "exact_scan": ("exact_scan", r"17exact_scan_kernelIh"),
    "exact_scan[u16]": ("exact_scan", r"17exact_scan_kernelIt"),
    "exact_search": ("exact_scan", r"19exact_search_kernelIh"),
    "exact_search[u16]": ("exact_scan", r"19exact_search_kernelIt"),
}


def arg_value(flag):
    """The value after `flag` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(flag) + 1] if flag in argv else None


def sass_phase():
    """The instructions of each kernel form (with --package-root, of the
    other tree's build).  --sass-out FILE writes them as JSON; with
    --sass-reference FILE (another tree's --sass-out) every form of
    SASS_HELD must count the same opcodes as there, or the phase fails."""
    forms = dict(SASS_FORMS, **(SASS_EXACT if exact_scan else {}))
    sass = {form: sass_opcodes(source, pattern)
            for form, (source, pattern) in forms.items()}
    emit({"phase": "sass", **sass})
    out = arg_value("--sass-out")
    if out:
        with open(out, "w") as f:
            json.dump(sass, f)
    ref = arg_value("--sass-reference")
    if ref:
        with open(ref) as f:
            want = json.load(f)
        differ = [form for form in SASS_HELD
                  if sass[form] is None or sass[form] != want.get(form)]
        if differ:
            raise AssertionError(f"sass: {differ} differ from {ref}")
        emit({"phase": "sass_held", "reference": ref,
              "forms": list(SASS_HELD)})


PLAIN_KERNELS = ("sad_map", "probe_sads_tiled", "fetch_blocks_tiled",
                 "probe_sads")


def reset_counts():
    mods = (sadmap, probe) + ((exact_scan,) if exact_scan else ())
    for mod in mods:
        for key in mod.launches:
            mod.launches[key] = 0
        mod.plain_calls_on_cuda = 0
    if exact_scan:
        exact_scan.rescued_blocks = 0
        exact_scan.candidates = 0
        exact_scan.serial_steps = 0
    fe.host_syncs = 0
    fe.rescued_blocks = 0


def read_counts():
    return dict(**sadmap.launches, **probe.launches,
                **(exact_scan.launches if exact_scan else {}))


def fetches(counts):
    """Launches of either fetch kernel."""
    return sum(counts[k] for k in FETCH_KERNELS)


def plain_calls_on_cuda():
    return (sadmap.plain_calls_on_cuda + probe.plain_calls_on_cuda
            + (exact_scan.plain_calls_on_cuda if exact_scan else 0))


def stage_ms(info):
    return {k: info["events"][k][0].elapsed_time(info["events"][k][1])
            for k in ("super", "analyse", "degrain")}


def run_windows(phase, windows, sspec, aspec, dcfg, changes_pixels):
    """Drive degrain_window over `windows` with every count set to 0 just
    before and read just after; check the outputs; print and return the
    phase's numbers.  changes_pixels: whether the denoised frames must
    differ from the input (a clip that is one plane panned compensates
    exactly and may come out as it went in)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    infos, outs = [], []
    t0 = time.perf_counter()
    for win in windows:
        info = {}
        outs.append(degrain_window(win, sspec, aspec, dcfg, RADIUS, info))
        infos.append(info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs = fe.host_syncs
    plain_on_cuda = plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    for win, out in zip(windows, outs):
        if tuple(out.shape) != (BATCH, H, W) or out.dtype != torch.uint8:
            raise AssertionError(f"{phase}: output {tuple(out.shape)} "
                                 f"{out.dtype}")
        if out.device.type != "cuda":
            raise AssertionError(f"{phase}: output not on the card")
        if changes_pixels and torch.equal(out, win[RADIUS:RADIUS + BATCH]):
            raise AssertionError(f"{phase}: output equals the input")
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version "
                             "calls on CUDA tensors")
    n = len(windows)
    per_stage = [stage_ms(i) for i in infos]
    res = {"phase": phase, "size": [W, H], "batch": BATCH, "windows": n,
           "frames_per_s": n * BATCH / seconds,
           "seconds_per_window": seconds / n,
           "stage_ms_per_window": {k: sum(st[k] for st in per_stage) / n
                                   for k in per_stage[0]},
           "host_syncs": syncs, "launches": counts,
           "peak_memory_bytes": peak, "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def run_yuv_clip(phase, clip, cfgs, bits=8):
    """Drive degrain_clip over a full-width YUV420 clip of `bits` bits once,
    with every count set to 0 just before and read just after; check the
    outputs (the input's dtype, on the card, every plane changed); print
    and return the phase's numbers."""
    scfg, acfg, dcfg, radius = cfgs
    fmt = VideoFormat(W, H, bits, ColorFamily.YUV420)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    out = degrain_clip(clip, fmt, scfg, acfg, dcfg, radius, info=info,
                       engine="lockstep")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs = fe.host_syncs
    plain_on_cuda = plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    for got, src in zip(out, clip):
        if got.shape != src.shape or got.dtype != src.dtype:
            raise AssertionError(f"{phase}: output {tuple(got.shape)} "
                                 f"{got.dtype}")
        if got.device.type != "cuda":
            raise AssertionError(f"{phase}: output not on the card")
        if torch.equal(got, src):
            raise AssertionError(f"{phase}: a plane came out as it went in")
    lv_count = len(info["fields_b"].levels)
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version "
                             "calls on CUDA tensors")
    frames = clip[0].shape[0]
    res = {"phase": phase, "size": [W, H], "format": "YUV420", "bits": bits,
           "dtype": str(out[0].dtype).replace("torch.", ""),
           "frames": frames, "radius": radius, "levels": lv_count,
           "analyse_jobs": 2 * radius * frames,
           "blocks_per_job_level0": info["fields_b"].levels[0].x[0].numel(),
           "frames_per_s": frames / seconds, "seconds": seconds,
           "stage_ms": stage_ms(info), "host_syncs": syncs,
           "launches": counts, "peak_memory_bytes": peak,
           "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def yuv_kernel_cases(cfgs, gen, dev):
    """K1-K3 at the shapes the YUV420 path gives them: level 0, luma
    (16x16, pitch 8) and chroma (8x8, pitch 4).  (K4: k4_cases.)"""
    scfg, acfg, _, _ = cfgs
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    n = KERNEL_JOBS // 2 + 1
    clip = make_test_clip_yuv(n, W, H, seed=1, flash=YUV_FLASH,
                              noise=YUV_NOISE, pan=YUV_PAN, device=dev)
    sups = build_super(clip, sspec)
    src_idx = torch.arange(KERNEL_JOBS, device=dev) // 2
    ref_idx = (src_idx + 1 - 2 * (torch.arange(KERNEL_JOBS, device=dev) % 2)
               ).clamp(0, n - 1)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    k1, k2, k3 = [], [], []
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
    for plane in (0, 1):
        k1.append(k1_case(ctx, stacks, gen, plane,
                          before_ms=13.096 if plane == 0 else 1.551))
        offsets = HEXAGON if plane == 0 else grid16
        label = case_label(ctx, plane, " K=1 D=%d" % len(offsets))
        k2.append(k2_case(ctx, stacks, gen, offsets, 1, label, plane,
                          before_ms=1.080 if plane == 0 else 1.159))
        k2.append(k2_case(ctx, stacks, gen, offsets, 1, label, plane,
                          masked=True))
        k3.append(k3_case(sspec, aspec.meta, sups, gen, plane, frames=n,
                          before_ms=0.332 if plane == 0 else 0.095))
    del ctx, stacks, sups, clip
    torch.cuda.empty_cache()
    return k1, k2, k3


def with_extremes(clip, bits):
    """A deep-bit YUV clip with a region that is 0 in the even frames and
    the pixel maximum in the odd ones (all planes): a job pairing frame i
    with i +- 1 then sums 0 against 2^bits - 1 over whole blocks, the
    largest SADs the kernels must hold exactly."""
    top = (1 << bits) - 1
    out = []
    for p, plane in enumerate(clip):
        sub = 1 if p else 0
        plane = plane.clone()
        y, x, h, w = (v >> sub for v in EXTREME_REGION)
        for i in range(plane.shape[0]):
            plane[i, y:y + h, x:x + w] = top if i % 2 else 0
        out.append(plane)
    return out


def deep_kernel_cases(cfgs, gen, dev, bits):
    """K1, K2, K3 and K5 in their uint16 forms at the shapes the deep-bit
    YUV420 path gives them (K1/K2/K3 at level 0, luma 16x16 pitch 8 and
    chroma 8x8 pitch 4; K5 as the tiled fetch's hand-over at level 5 and at
    origins past every edge; K4 u16: k4_cases), on a clip
    of `bits` bits whose samples use the low bits too, with a region of 0
    against 2^bits - 1.  At 10 bits also K1 with 128x128 blocks, the
    largest staging of any map the search admits.  K1's cases print its first
    uint16 body's time as before_ms (PERF.md)."""
    from mvtools_tpu_torch.ops import pixels
    scfg, acfg, _, _ = cfgs
    fmt = VideoFormat(W, H, bits, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    top = (1 << bits) - 1
    n = KERNEL_JOBS // 2 + 1
    clip = with_extremes(make_test_clip_yuv(
        n, W, H, seed=1, flash=YUV_FLASH, noise=YUV_NOISE, pan=YUV_PAN,
        bits=bits, device=dev), bits)
    if clip[0].dtype != pixels.dtype_of(bits):
        raise AssertionError(f"{bits}-bit clip made as {clip[0].dtype}")
    sups = build_super(clip, sspec)
    src_idx = torch.arange(KERNEL_JOBS, device=dev) // 2
    ref_idx = (src_idx + 1 - 2 * (torch.arange(KERNEL_JOBS, device=dev) % 2)
               ).clamp(0, n - 1)
    walk = tuple(fe._HEXP)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    k1, k2, k3, k5 = [], [], [], []
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
    for plane in (0, 1):
        k1.append(k1_case(ctx, stacks, gen, plane,
                          before_ms=K1_U16_BEFORE[bits][plane]))
        offsets = HEXAGON if plane == 0 else grid16
        label = case_label(ctx, plane, " K=1 D=%d" % len(offsets))
        before = K2_U16_BEFORE[bits][2 * plane:2 * plane + 2]
        k2.append(k2_case(ctx, stacks, gen, offsets, 1, label, plane,
                          before_ms=before[0]))
        k2.append(k2_case(ctx, stacks, gen, offsets, 1, label, plane,
                          masked=True, before_ms=before[1]))
        k3.append(k3_case(sspec, aspec.meta, sups, gen, plane, frames=n))
    # the flash clip's other K2 shapes: the walk's eight offsets on luma, and
    # both planes of the coarser levels whose stacks hold the tile window,
    # masked as the search masks them
    k2.append(k2_case(ctx, stacks, gen, walk, 1,
                      case_label(ctx, 0, " K=1 walk D=8"), 0, masked=True))
    # the largest sums: every source block 0, every reference pixel the
    # maximum, so every entry is 16 * 16 * (2^bits - 1)
    def full(t, v):
        return pixels.narrow(torch.full(t.shape, v, dtype=torch.int32,
                                        device=dev), t.dtype)

    xctx = ctx._replace(src_planes=tuple(full(p, 0)
                                         for p in ctx.src_planes))
    xstacks = tuple(full(t, top) for t in stacks)
    k1.append(k1_case(xctx, xstacks, gen, extra=" 0 against the maximum",
                      before_ms=K1_U16_BEFORE[bits][2]))
    k2.append(k2_case(xctx, xstacks, gen, HEXAGON, 1,
                      case_label(ctx, 0, " K=1 D=6 0 against the maximum")))
    if k1[-1]["max_entry"] != 16 * 16 * top or k1[-1]["min_entry"] != \
            16 * 16 * top:
        raise AssertionError(f"sad_map {k1[-1]['case']}: entries "
                             f"{k1[-1]['min_entry']}..{k1[-1]['max_entry']}"
                             f", not {16 * 16 * top}")
    del xctx, xstacks
    # K5: origins anywhere from 40 pixels before the stack to 40 past its
    # end, at level 0 (luma)
    stack, pel = stacks[0], ctx.pel
    hp, wp = stack.shape[2:]
    _, cy, _, _, _, _, _ = probe_inputs(ctx, stacks, gen, 0, 1)
    ey = torch.randint(-40 * pel, (hp + 40) * pel, cy.shape[:2] + (4,),
                       generator=gen, device=dev, dtype=torch.int32)
    ex = torch.randint(-40 * pel, (wp + 40) * pel, ey.shape, generator=gen,
                       device=dev, dtype=torch.int32)
    ey[:, :, 0] = (hp - 16 + 5) * pel + 1
    ex[:, :, 1] = (wp - 16 + 7) * pel + 1
    k5.append(k5_case(f"level 0 origins past every edge K=4 {bits}-bit",
                      stack, ey, ex, 16, 16, ctx.pel))
    k3.append(k3_direct_case(f"level 0 origins past every edge K=4 "
                             f"{bits}-bit", stack, ey, ex, 16, 16, ctx.pel,
                             ctx.nblk[0]))
    del ctx, stacks, stack
    for lv in (1, 2, 3):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        for plane, offsets in ((0, walk), (1, grid16)):
            if fits_tile_window(ctx, stacks, plane, offsets, 1):
                k2.append(k2_case(ctx, stacks, gen, offsets, 1, case_label(
                    ctx, plane, f" K=1 D={len(offsets)}"), plane,
                    masked=True))
        del ctx, stacks
    # K5 as the tiled fetch's hand-over: a map row on level 5's stack,
    # which is under the tiled fetch's window
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 5)
    stack = stacks[0]
    _, cy, cx, _, _, _, _ = probe_inputs(ctx, stacks, gen, 0, 1, spread=4,
                                         far_share=0.0)
    row = torch.arange(-7, 8, device=dev, dtype=torch.int32)
    rcx = (cx + row).contiguous()
    rcy = (cy + 3).expand_as(rcx).contiguous()
    before = read_counts()
    probe.fetch_blocks_tiled(stack, rcy, rcx, 16, 16, ctx.pel,
                             row_len=ctx.nblk[0], pitch_x=8)
    after = read_counts()
    if (after["fetch_blocks[u16]"] != before["fetch_blocks[u16]"] + 1
            or after["fetch_blocks_tiled[u16]"]
            != before["fetch_blocks_tiled[u16]"]):
        raise AssertionError(f"fetch_blocks_tiled: the level-5 {bits}-bit "
                             "stack was not handed to fetch_blocks")
    k5.append(k5_case(f"level 5 map row K=15 (the tiled fetch's hand-over) "
                      f"{bits}-bit", stack, rcy, rcx, 16, 16, ctx.pel))
    del ctx, stacks, stack, sups, clip
    if bits == 10:
        k1.append(k1_largest_blocks_case(gen, dev))
    torch.cuda.empty_cache()
    return k1, k2, k3, k5


def k1_largest_blocks_case(gen, dev):
    """K1 at 10 bits with 128x128 blocks (overlap 60: pitch 68, two blocks
    a tile) on level 0 of a 1080p gray clip, 4 jobs: the largest staging of
    any map the search admits (one subplane's window, both blocks' source
    rows)."""
    fmt = VideoFormat(W, H, 10, ColorFamily.GRAY)
    clip = make_test_clip_yuv(5, W, H, seed=4, noise=YUV_NOISE, pan=YUV_PAN,
                              bits=10, device=dev)[0]
    sspec = SuperConfig(pel=2, levels=1, chroma=False).validate(fmt)
    aspec = AnalyseConfig(blksize=128, overlap=60, levels=1,
                          chroma=False).validate(sspec)
    sups = build_super([clip], sspec)
    ctx, stacks = level_inputs(sspec, aspec, sups,
                               torch.tensor([1, 1, 3, 3], device=dev),
                               torch.tensor([2, 0, 4, 2], device=dev), 0)
    case = k1_case(ctx, stacks, gen, extra=" 128x128")
    del ctx, stacks, sups, clip
    return case


def small_end_to_end_yuv(cfgs, dev):
    """degrain_clip at 256x192 YUV420, the slice's configuration, on the
    card against the same code on CPU tensors."""
    scfg, acfg, dcfg, radius = cfgs
    fmt = VideoFormat(SMALL_W, SMALL_H, 8, ColorFamily.YUV420)
    small = make_test_clip_yuv(SMALL_YUV_T, SMALL_W, SMALL_H, seed=2,
                               flash=SMALL_YUV_FLASH, noise=YUV_NOISE,
                               device="cpu")
    reset_counts()
    info_gpu, info_cpu = {}, {}
    out_gpu = degrain_clip([p.to(dev) for p in small], fmt, scfg, acfg, dcfg,
                           radius, info=info_gpu, engine="lockstep")
    counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end yuv: a plain version ran on "
                             "CUDA tensors")
    out_cpu = degrain_clip(small, fmt, scfg, acfg, dcfg, radius,
                           info=info_cpu, engine="lockstep")
    for name in ("fields_b", "fields_f"):
        for lv, (lg, lc) in enumerate(zip(info_gpu[name].levels,
                                          info_cpu[name].levels)):
            for key in ("x", "y", "sad"):
                if not torch.equal(getattr(lg, key).cpu(), getattr(lc, key)):
                    raise AssertionError(
                        f"small end-to-end yuv: {name} level {lv} {key} "
                        "differs between the card and the CPU")
    for p, (a, b) in enumerate(zip(out_gpu, out_cpu)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"small end-to-end yuv: plane {p} differs "
                                 "between the card and the CPU")
        if torch.equal(b, small[p]):
            raise AssertionError(f"small end-to-end yuv: plane {p} came out "
                                 "as it went in")
    if (min(counts[k] for k in PLAIN_KERNELS if k not in FETCH_KERNELS) < 1
            or fetches(counts) < 1):
        raise AssertionError(f"small end-to-end yuv: a kernel never "
                             f"launched {counts}")
    emit({"phase": "small_end_to_end_yuv", "size": [SMALL_W, SMALL_H],
          "frames": SMALL_YUV_T, "radius": radius,
          "levels": len(info_gpu["fields_b"].levels),
          "bit_equal_to_cpu": True, "launches": counts})


def small_end_to_end_yuv16(cfgs, dev):
    """degrain_clip at 256x192 YUV420, 16 bits (the slice's configuration),
    on the card against the same code on CPU tensors; the uint16 forms of
    the map, both probes and the per-block fetch must launch, and no uint8
    kernel."""
    scfg, acfg, dcfg, radius = cfgs
    fmt = VideoFormat(SMALL_W, SMALL_H, DEEP_BITS, ColorFamily.YUV420)
    small = make_test_clip_yuv(SMALL_YUV_T, SMALL_W, SMALL_H, seed=2,
                               flash=SMALL_YUV_FLASH, noise=YUV_NOISE,
                               bits=DEEP_BITS, device="cpu")
    reset_counts()
    info_gpu, info_cpu = {}, {}
    out_gpu = degrain_clip([p.to(dev) for p in small], fmt, scfg, acfg, dcfg,
                           radius, info=info_gpu, engine="lockstep")
    counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end yuv16: a plain version ran "
                             "on CUDA tensors")
    out_cpu = degrain_clip(small, fmt, scfg, acfg, dcfg, radius,
                           info=info_cpu, engine="lockstep")
    for name in ("fields_b", "fields_f"):
        for lv, (lg, lc) in enumerate(zip(info_gpu[name].levels,
                                          info_cpu[name].levels)):
            for key in ("x", "y", "sad"):
                if not torch.equal(getattr(lg, key).cpu(), getattr(lc, key)):
                    raise AssertionError(
                        f"small end-to-end yuv16: {name} level {lv} {key} "
                        "differs between the card and the CPU")
    for p, (a, b) in enumerate(zip(out_gpu, out_cpu)):
        if a.dtype != torch.uint16 or not torch.equal(a.cpu(), b):
            raise AssertionError(f"small end-to-end yuv16: plane {p} differs "
                                 "between the card and the CPU")
        if torch.equal(b, small[p]):
            raise AssertionError(f"small end-to-end yuv16: plane {p} came "
                                 "out as it went in")
    # at this size every level-0 stack is under the tiled fetch's window,
    # so Degrain's fetches go to the per-block one
    needed = ("sad_map[u16]", "probe_sads_tiled[u16]", "probe_sads[u16]",
              "fetch_blocks[u16]")
    if min(counts[k] for k in needed) < 1:
        raise AssertionError(f"small end-to-end yuv16: a uint16 kernel "
                             f"never launched {counts}")
    u8 = {k: v for k, v in counts.items() if v and k not in U16_KERNELS}
    if u8:
        raise AssertionError(f"small end-to-end yuv16: an 8-bit kernel ran "
                             f"{u8}")
    # the gray headline entry point on the luma of the same clip
    g_sspec, g_aspec, g_dcfg = headline_specs(SMALL_W, SMALL_H,
                                              bits=DEEP_BITS)
    reset_counts()
    win_gpu = degrain_window(small[0].to(dev), g_sspec, g_aspec, g_dcfg,
                             RADIUS)
    win_counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end yuv16: a plain version ran "
                             "on CUDA tensors in degrain_window")
    win_cpu = degrain_window(small[0], g_sspec, g_aspec, g_dcfg, RADIUS)
    inner = small[0][RADIUS:SMALL_YUV_T - RADIUS]
    if (win_gpu.dtype != torch.uint16 or not torch.equal(win_gpu.cpu(),
                                                         win_cpu)
            or torch.equal(win_cpu, inner)):
        raise AssertionError("small end-to-end yuv16: degrain_window's "
                             "16-bit gray output differs between the card "
                             "and the CPU, or came out as it went in")
    # the flash sends the search through its rescue: a probe must launch
    u16 = {k: v for k, v in win_counts.items() if v and k in U16_KERNELS}
    if (not u16.get("sad_map[u16]")
            or not any(k.startswith("probe") for k in u16)
            or not any(k.startswith("fetch") for k in u16)
            or len(u16) < sum(1 for v in win_counts.values() if v)):
        raise AssertionError(f"small end-to-end yuv16: degrain_window "
                             f"missed a uint16 kernel or ran an 8-bit one "
                             f"{win_counts}")
    emit({"phase": "small_end_to_end_yuv16", "size": [SMALL_W, SMALL_H],
          "bits": DEEP_BITS, "frames": SMALL_YUV_T, "radius": radius,
          "levels": len(info_gpu["fields_b"].levels),
          "bit_equal_to_cpu": True, "launches": counts,
          "gray_window_bit_equal_to_cpu": True,
          "gray_window_launches": win_counts})


def chain_specs(width, height, dct_analyse, dct_recalculate=5,
                overlap_analyse=0):
    """(SuperSpec, AnalyseSpec, RecalculateConfig, its AnalyseSpec) of the
    Recalculate chains: gray 8-bit, pel 2, the full pyramid; Analyse blk 16
    with the plain-SAD cost (dct_analyse 0), a DCT cost (1-4) or the SATD
    cost (5); Recalculate blk 16 overlap 8, thsad 200, dct_recalculate."""
    fmt = VideoFormat(width, height, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=0, chroma=False).validate(fmt)
    akw = dict(blksize=16, levels=0, overlap=overlap_analyse,
               truemotion=True, chroma=False, isb=True)
    if dct_analyse:
        akw.update(dct=dct_analyse, badsad=(
            DCT_BADSAD if dct_analyse <= 4 else SATD_BADSAD))
    aspec = AnalyseConfig(**akw).validate(sspec)
    rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200, chroma=False,
                             truemotion=True, dct=dct_recalculate)
    return sspec, aspec, rcfg, rcfg.to_analyse_config().validate(sspec)


def satd_chain(clip, specs, info):
    """build_super -> analyse_batch -> recalculate -> degrain (Degrain1 on
    the refined field) over a gray clip [2n + 1, H, W]: the frames 1, 3, ...
    are denoised, each from its two neighbours, so the 2n frame pairs
    (c, c + 1), (c, c - 1) are one batch of jobs.  Returns the n denoised
    frames; `info` receives the analysed and the refined field, the launch
    counts read after each stage and, on the card, CUDA events around the
    stages."""
    sspec, aspec, rcfg, rspec = specs
    dev = clip.device
    n_out = (clip.shape[0] - 1) // 2
    centres = [2 * i + 1 for i in range(n_out)]
    src_t = torch.tensor([c for c in centres for _ in (0, 1)], device=dev)
    ref_t = torch.tensor([c + d for c in centres for d in (1, -1)],
                         device=dev)

    def mark():
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    t0 = mark()
    sups = build_super([clip], sspec)
    sup_s, sup_r = sups.take(src_t), sups.take(ref_t)
    t1 = mark()
    mvb = analyse_batch(sup_s, sup_r, aspec)
    t2 = mark()
    info["launches_after_analyse"] = read_counts()
    refined = recalculate(sup_s, sup_r, mvb, rspec, rcfg)
    t3 = mark()
    info["launches_after_recalculate"] = read_counts()

    def job(t, j):
        return t.reshape((n_out, 2) + t.shape[1:])[:, j]

    lv = refined.levels[0]
    mvs = [MVField((MVPlaneField(job(lv.x, j), job(lv.y, j), job(lv.sad, j)),),
                   job(refined.validity, j), refined.meta) for j in (0, 1)]
    sups_r = [sup_r.map(lambda a, j=j: job(a, j).contiguous())
              for j in (0, 1)]
    out = degrain([clip[1::2][:n_out]], sups_r, mvs, rspec.meta,
                  DegrainConfig(thsad=400))[0]
    t4 = mark()
    info["analysed"], info["refined"] = mvb, refined
    if t0 is not None:
        info["events"] = dict(super=(t0, t1), analyse=(t1, t2),
                              recalculate=(t2, t3), degrain=(t3, t4))
    return out


def run_satd_path(phase, clip, specs, calm):
    """Drive satd_chain over a full-width clip once, with every count set to
    0 just before and read just after; check the outputs; print and return
    the phase's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    out = satd_chain(clip, specs, info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs = fe.host_syncs
    rescued = fe.rescued_blocks
    plain_on_cuda = plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    n_out = (clip.shape[0] - 1) // 2
    if tuple(out.shape) != (n_out, H, W) or out.dtype != torch.uint8:
        raise AssertionError(f"{phase}: output {tuple(out.shape)} {out.dtype}")
    if out.device.type != "cuda":
        raise AssertionError(f"{phase}: output not on the card")
    if torch.equal(out, clip[1::2][:n_out]):
        raise AssertionError(f"{phase}: output equals the input")
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version calls "
                             "on CUDA tensors")
    # A predictor that lies off its tile's probe window costs INVALID_SAD
    # and, being off the map as well, keeps it (the JAX package does the
    # same): only a field as torn as the flash pairs' has such blocks.
    refined = info["refined"].levels[0]
    n_sentinel = int((refined.sad >= probe.INVALID_SAD).sum())
    if n_sentinel and calm:
        raise AssertionError(f"{phase}: {n_sentinel} refined blocks kept "
                             "the sentinel on a calm clip")
    thsad = specs[2].thsad * 16 * 16 // 64
    over_badsad = [int((lv.sad > specs[1].badsad).sum())
                   for lv in info["analysed"].levels]
    ev = info["events"]
    res = {"phase": phase, "size": [W, H], "pairs": 2 * n_out,
           "frames_out": n_out, "levels": len(info["analysed"].levels),
           "dct_analyse": specs[1].dct, "dct_recalculate": specs[3].dct,
           "blocks_per_job_recalculate": refined.x[0].numel(),
           "blocks_over_thsad": int((refined.sad > thsad).sum()),
           "blocks_under_thsad": int((refined.sad <= thsad).sum()),
           "blocks_with_sentinel_sad": n_sentinel,
           "analysed_blocks_over_badsad_by_level": over_badsad,
           "pairs_per_s": 2 * n_out / seconds, "seconds": seconds,
           "stage_ms": {k: ev[k][0].elapsed_time(ev[k][1]) for k in ev},
           "host_syncs": syncs, "rescued_blocks": rescued, "launches": counts,
           "launches_after_analyse": info["launches_after_analyse"],
           "peak_memory_bytes": peak, "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def satd_clip(frames, width, height, seed, flash, clean, device):
    """The luma plane of the YUV test clip: noise panned one pixel per frame
    with +-4 fresh noise per frame outside `clean`, and the flash."""
    return make_test_clip_yuv(frames, width, height, seed=seed, flash=flash,
                              noise=YUV_NOISE, pan=YUV_PAN, clean=clean,
                              device=device)[0]


def satd_kernel_cases(gen, dev):
    """K1', K2' and K4' at the shapes the two SATD paths give them: K1' at
    Recalculate's level 0 (16x16, pitch 8, 32 026 blocks) and at Analyse's
    level 0; K2' at Recalculate's level 0 (the predictor's cost: K = 1,
    D = 1; also on blocks of 0 against references of 255) and at Analyse's
    level 0 (the rescue's hexagon and ring); K4' on Analyse's level-5 plane,
    which is under the tile window.  Then K1' and K2' at block sizes the
    paths do not reach (K2': 8x8, one lane a tile and eight offsets a warp;
    32x32, two tiles a lane; 64x64, the generic body)."""
    sspec, aspec, _, rspec = chain_specs(W, H, 5)
    clip = satd_clip(RECALC_PAIRS + 1, W, H, 1, YUV_FLASH, SATD_CLEAN, dev)
    sups = build_super([clip], sspec)
    centres = torch.arange(1, RECALC_PAIRS, 2, device=dev)
    src_idx = centres.repeat_interleave(2)
    ref_idx = src_idx + 1 - 2 * (torch.arange(RECALC_PAIRS, device=dev) % 2)
    ring = tuple(fe._ring_offsets(1, 1))
    k1, k2, k4 = [], [], []
    ctx, stacks = level_inputs(sspec, rspec, sups, src_idx, ref_idx, 0)
    k1.append(k1_case(ctx, stacks, gen, stats=STATS3, before_ms=10.855))
    k2.append(k2_case(ctx, stacks, gen, ((0, 0),), 1,
                      case_label(ctx, 0, " K=1 D=1"), stats=STATS3,
                      before_ms=K2P_BEFORE[0]))
    # the largest sums: every source block 0, every reference pixel 255
    xctx = ctx._replace(src_planes=tuple(torch.zeros_like(p)
                                         for p in ctx.src_planes))
    xstacks = tuple(torch.full_like(t, 255) for t in stacks)
    k2.append(k2_case(xctx, xstacks, gen, HEXAGON, 1,
                      case_label(ctx, 0, " K=1 D=6 0 against 255"),
                      stats=STATS3))
    del ctx, stacks, xctx, xstacks
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
    k1.append(k1_case(ctx, stacks, gen, stats=STATS3, before_ms=2.914))
    for offsets, what, before in ((HEXAGON, "hexagon D=6", K2P_BEFORE[1]),
                                  (ring, "ring D=8", K2P_BEFORE[2])):
        k2.append(k2_case(ctx, stacks, gen, offsets, 1,
                          f"level 0 K=1 {what}", stats=STATS3,
                          before_ms=before))
    k2.append(k2_case(ctx, stacks, gen, HEXAGON, 1, "level 0 K=1 hexagon D=6",
                      stats=STATS3, masked=True, before_ms=K2P_BEFORE[3]))
    del ctx, stacks
    k4 += k4p_cases(sspec, aspec, sups, src_idx, ref_idx, gen)
    del sups
    # K1' at the geometries the two paths do not reach: 8x8 and 32x32
    # blocks, pitch 8 and 16, pel 1 (level 0 of the same clip, 4 jobs)
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    for pel, bs, ov in ((2, 8, 0), (2, 32, 16), (1, 16, 8), (1, 16, 0),
                        (2, 64, 0)):
        sspec = SuperConfig(pel=pel, levels=1, chroma=False).validate(fmt)
        aspec = AnalyseConfig(blksize=bs, overlap=ov, levels=1, chroma=False,
                              dct=5).validate(sspec)
        sups = build_super([clip], sspec)
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx[:4],
                                   ref_idx[:4], 0)
        if bs != 64:
            k1.append(k1_case(ctx, stacks, gen, stats=STATS3,
                              extra=f" {bs}x{bs}"))
        if pel == 2:
            k2.append(k2_case(ctx, stacks, gen, HEXAGON, 1,
                              case_label(ctx, 0, f" {bs}x{bs} K=1 D=6"),
                              stats=STATS3, masked=bs == 8))
        del ctx, stacks, sups
    del clip
    torch.cuda.empty_cache()
    return k1, k2, k4


def k4p_cases(sspec, aspec, sups, src_idx, ref_idx, gen):
    """K4' on the SATD Analyse path's level-5 plane (under the tile window)
    at the rescue's shapes [8, 6, 1, D, 3], D = 6 (hexagon), 8 (walk) and 1,
    then the hexagon with masks that leave about 30 %, 3 % and none of its
    entries live."""
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 5)
    before = iter(K4P_BEFORE)
    cases = [k4_case(ctx, stacks, gen, offsets, 1, stats=STATS3,
                     before_ms=next(before))
             for offsets in (HEXAGON, tuple(fe._HEXP), ((0, 0),))]
    cases += [k4_case(ctx, stacks, gen, HEXAGON, 1, stats=STATS3, live=m)
              for m in K4_MASKS]
    del ctx, stacks
    return cases


def small_end_to_end_satd(dev):
    """The SATD chain at 256x192 (Analyse blk 16 overlap 8 with dct 5, four
    levels, the level-3 stack under the tile window; Recalculate dct 5;
    Degrain1) on the card against the same code on CPU tensors."""
    specs = chain_specs(SMALL_W, SMALL_H, 5, overlap_analyse=8)
    small = satd_clip(SATD_PAIRS + 1, SMALL_W, SMALL_H, 2,
                      SMALL_YUV_FLASH, SMALL_SATD_CLEAN, "cpu")
    reset_counts()
    info_gpu, info_cpu = {}, {}
    out_gpu = satd_chain(small.to(dev), specs, info_gpu)
    counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end satd: a plain version ran on "
                             "CUDA tensors")
    out_cpu = satd_chain(small, specs, info_cpu)
    for name in ("analysed", "refined"):
        for lv, (lg, lc) in enumerate(zip(info_gpu[name].levels,
                                          info_cpu[name].levels)):
            for key in ("x", "y", "sad"):
                if not torch.equal(getattr(lg, key).cpu(), getattr(lc, key)):
                    raise AssertionError(
                        f"small end-to-end satd: {name} level {lv} {key} "
                        "differs between the card and the CPU")
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError("small end-to-end satd: denoised pixels differ "
                             "between the card and the CPU")
    if torch.equal(out_cpu, small[1::2][:out_cpu.shape[0]]):
        raise AssertionError("small end-to-end satd: output equals the input")
    needed = ("sad_map[stats3]", "probe_sads_tiled[stats3]",
              "probe_sads[stats3]")
    if min(counts[k] for k in needed) < 1 or fetches(counts) < 1:
        raise AssertionError(f"small end-to-end satd: a kernel never "
                             f"launched {counts}")
    emit({"phase": "small_end_to_end_satd", "size": [SMALL_W, SMALL_H],
          "pairs": SATD_PAIRS, "levels": len(info_gpu["analysed"].levels),
          "bit_equal_to_cpu": True, "launches": counts})


def dct_kernel_cases(gen, dev):
    """K5 (and K3 beside it) at the shapes the DCT path gives them, on the
    1080p gray super of
    the DCT path (pel 2, blk 16, 8040 blocks per job at level 0, four jobs):
    a row of level 0's dense map (15 candidates one pel apart round a
    per-block anchor), the rescue's hexagon (6 candidates), a row of the
    map at level 5, whose stack is under the tiled fetch's window (the
    hand-over), and origins past every edge of the stack (the clamp).  K3
    takes the level-0 map row (the tiled fetch of the DCT path's dense map,
    field_engine.MapProber) and the origins past every edge."""
    sspec, aspec, _, _ = chain_specs(W, H, 1, 1)
    clip = satd_clip(SATD_PAIRS + 1, W, H, 1, YUV_FLASH, SATD_CLEAN, dev)
    sups = build_super([clip], sspec)
    src_idx = torch.tensor([1, 1, 3, 3], device=dev)
    ref_idx = torch.tensor([2, 0, 4, 2], device=dev)
    bs, pel = aspec.meta.blk_size_x, sspec.pel
    cases, k3 = [], []
    narrow_level = 5
    for lv in (0, narrow_level):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        r = fe.map_radius(ctx)
        stack = stacks[0]
        nbx = ctx.nblk[0]
        tile = probe.tile_params(((0, 0),), bs, bs, ctx.pel,
                                   probe.FETCH_TILE, bs)[:2]
        narrow = stack.shape[2] < tile[0] or stack.shape[3] < tile[1]
        if narrow != (lv == narrow_level):
            raise AssertionError(f"fetch_blocks: level {lv}'s stack "
                                 f"{tuple(stack.shape)} against the tiled "
                                 f"window {tile}")
        # anchors: a smooth field of whole-pel vectors, one per block
        _, cy, cx, _, _, _, _ = probe_inputs(ctx, stacks, gen, 0, 1,
                                             spread=4, far_share=0.0)
        row = torch.arange(-r, r + 1, device=dev, dtype=torch.int32)
        rcx = (cx + row).contiguous()
        rcy = (cy + 3).expand_as(rcx).contiguous()
        label = f"level {lv} map row K={2 * r + 1}"
        if lv == narrow_level:
            before = read_counts()
            probe.fetch_blocks_tiled(stack, rcy, rcx, bs, bs, ctx.pel,
                                     row_len=nbx, pitch_x=bs)
            after = read_counts()
            if (after["fetch_blocks"] != before["fetch_blocks"] + 1
                    or after["fetch_blocks_tiled"]
                    != before["fetch_blocks_tiled"]):
                raise AssertionError(f"fetch_blocks_tiled: the level-{lv} "
                                     "stack was not handed to fetch_blocks")
            label += " (the tiled fetch's hand-over)"
        cases.append(k5_case(label, stack, rcy, rcx, bs, bs, ctx.pel))
        if lv == 0:
            k3.append(k3_direct_case(label + " (the DCT map row)", stack, rcy,
                                     rcx, bs, bs, ctx.pel, nbx))
            hy = torch.tensor([o[1] for o in HEXAGON], device=dev,
                              dtype=torch.int32)
            hx = torch.tensor([o[0] for o in HEXAGON], device=dev,
                              dtype=torch.int32)
            cases.append(k5_case("level 0 hexagon K=6", stack,
                                 (cy + hy).contiguous(),
                                 (cx + hx).contiguous(), bs, bs, ctx.pel))
            # origins anywhere from 40 pixels before the stack to 40 past
            # its end, both clamp ends included
            hp, wp = stack.shape[2:]
            ey = torch.randint(-40 * pel, (hp + 40) * pel, cy.shape[:2] + (4,),
                               generator=gen, device=dev, dtype=torch.int32)
            ex = torch.randint(-40 * pel, (wp + 40) * pel, ey.shape,
                               generator=gen, device=dev, dtype=torch.int32)
            ey[:, :, 0], ex[:, :, 1] = (hp - bs + 5) * pel + 1, \
                (wp - bs + 7) * pel + 1
            cases.append(k5_case("level 0 origins past every edge K=4",
                                 stack, ey, ex, bs, bs, ctx.pel))
            k3.append(k3_direct_case("level 0 origins past every edge K=4",
                                     stack, ey, ex, bs, bs, ctx.pel, nbx))
        del ctx, stacks, stack
    del sups, clip
    torch.cuda.empty_cache()
    return cases, k3


def special_blocks(n, bh, bw, gen):
    """[n, bh, bw] uint8 blocks on the CPU: half noise, the rest flat 0,
    flat 255, flat at any level, nearly flat (one level and the next),
    steps across a random row or column, checkerboards of period 1, 2 and 4,
    and ramps, whose DCTs hold AC coefficients near or at 0 and DC
    coefficients at the ends of the range."""
    kinds = 8
    k = torch.arange(n) % (2 * kinds)
    a = torch.randint(0, 256, (n, 1, 1), generator=gen)
    b = torch.randint(0, 256, (n, 1, 1), generator=gen)
    yy = torch.arange(bh).reshape(1, bh, 1)
    xx = torch.arange(bw).reshape(1, 1, bw)
    t = torch.randint(1, min(bh, bw), (n, 1, 1), generator=gen)
    per = 1 << torch.randint(0, 3, (n, 1, 1), generator=gen)
    horiz = torch.rand((n, 1, 1), generator=gen) < 0.5
    noise = torch.randint(0, 256, (n, bh, bw), generator=gen)
    special = [
        torch.zeros_like(noise),
        torch.full_like(noise, 255),
        a.expand_as(noise),
        (a + torch.randint(0, 2, (n, bh, bw), generator=gen)).clamp(0, 255),
        torch.where(torch.where(horiz, yy < t, xx < t), a, b),
        torch.where(((yy // per + xx // per) % 2) == 0, a, b),
        (a + (yy + xx) * (b % 9 - 4)).clamp(0, 255),
        torch.where(torch.where(horiz, yy < bh // 2, xx < bw // 2), a,
                    noise),
    ]
    out = noise.clone()
    for i, blk in enumerate(special):
        sel = k == kinds + i
        out[sel] = blk[sel]
    return out.to(torch.uint8)


def dct_vs_cpu(dev):
    """dct_block on the card against the CPU: 2^20 blocks of 16x16 and
    2^18 each of 8x8 and 16x8 (width x height), half noise, half the
    special blocks; every requantised coefficient must agree."""
    from mvtools_tpu_torch.ops import dct as dct_ops
    gen = torch.Generator().manual_seed(11)
    chunk = 1 << 16
    res = {"phase": "dct_vs_cpu", "sizes": {}}
    t0 = time.perf_counter()
    total_diff = 0
    for (bh, bw), n in (((16, 16), 1 << 20), ((8, 8), 1 << 18),
                        ((8, 16), 1 << 18)):
        blocks = special_blocks(n, bh, bw, gen)
        diff = 0
        for i in range(0, n, chunk):
            part = blocks[i:i + chunk]
            want = dct_ops.dct_block(part, 8)
            got = dct_ops.dct_block(part.to(dev), 8).cpu()
            diff += int((got != want).sum())
        res["sizes"][f"{bw}x{bh}"] = {"blocks": n,
                                      "coefficients": n * bh * bw,
                                      "differing": diff}
        total_diff += diff
    res["differing_coefficients"] = total_diff
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    if total_diff:
        raise AssertionError(f"dct_vs_cpu: {total_diff} requantised "
                             "coefficients differ between the card and the "
                             "CPU")


def small_end_to_end_dct(dev):
    """The DCT chain (Analyse and Recalculate with the same DCT cost, blk 16,
    then Degrain1) at 256x192 with a flash, on the card against the same
    code on CPU tensors, for each of dct 1-4."""
    small = satd_clip(SATD_PAIRS + 1, SMALL_W, SMALL_H, 2, SMALL_YUV_FLASH,
                      SMALL_SATD_CLEAN, "cpu")
    rescued, counts_by_mode = {}, {}
    for dct in (1, 2, 3, 4):
        specs = chain_specs(SMALL_W, SMALL_H, dct, dct)
        reset_counts()
        info_gpu, info_cpu = {}, {}
        out_gpu = satd_chain(small.to(dev), specs, info_gpu)
        counts = read_counts()
        rescued[dct] = fe.rescued_blocks
        if plain_calls_on_cuda():
            raise AssertionError(f"small end-to-end dct {dct}: a plain "
                                 "version ran on CUDA tensors")
        out_cpu = satd_chain(small, specs, info_cpu)
        for name in ("analysed", "refined"):
            for lv, (lg, lc) in enumerate(zip(info_gpu[name].levels,
                                              info_cpu[name].levels)):
                for key in ("x", "y", "sad"):
                    if not torch.equal(getattr(lg, key).cpu(),
                                       getattr(lc, key)):
                        raise AssertionError(
                            f"small end-to-end dct {dct}: {name} level {lv} "
                            f"{key} differs between the card and the CPU")
        if not torch.equal(out_gpu.cpu(), out_cpu):
            raise AssertionError(f"small end-to-end dct {dct}: denoised "
                                 "pixels differ between the card and the CPU")
        if counts["fetch_blocks"] < 1:
            raise AssertionError(f"small end-to-end dct {dct}: fetch_blocks "
                                 f"never launched {counts}")
        counts_by_mode[dct] = {k: v for k, v in counts.items() if v}
    if not any(rescued.values()):
        raise AssertionError("small end-to-end dct: the rescue ran in no "
                             "mode")
    emit({"phase": "small_end_to_end_dct", "size": [SMALL_W, SMALL_H],
          "pairs": SATD_PAIRS, "bit_equal_to_cpu": True,
          "rescued_blocks": rescued, "launches": counts_by_mode})


def check_dct_path(phase, res):
    """The DCT path's launch rules: both fetch kernels serve it, no SAD map
    or probe kernel in any form runs."""
    c = res["launches"]
    if c["fetch_blocks"] < 1 or c["fetch_blocks_tiled"] < 1:
        raise AssertionError(f"{phase}: a fetch kernel never launched {c}")
    luma = [k for k in c if k.startswith(("sad_map", "probe_sads")) and c[k]]
    if luma:
        raise AssertionError(f"{phase}: a SAD map or probe kernel ran on the "
                             f"DCT path {c}")


# bench.py config 2 (pel 4, the probe-only level search): 8 pairs a window
P4_PAIRS = 8


def pel4_specs(width, height, bits=8, family=ColorFamily.GRAY, **acfg):
    """(SuperSpec, AnalyseSpec) of bench.py config 2 (bench.py:114-135):
    pel 4, the full pyramid, blk 16, HEX2 searchparam 2, truemotion; gray
    unless `family` says otherwise (then chroma and overlap 8), `acfg`
    overriding the search's keywords."""
    chroma = family != ColorFamily.GRAY
    fmt = VideoFormat(width, height, bits, family)
    sspec = SuperConfig(pel=4, levels=0, chroma=chroma).validate(fmt)
    kw = dict(blksize=16, levels=0, search=SearchType.HEX2, searchparam=2,
              truemotion=True, chroma=chroma, overlap=8 if chroma else 0)
    kw.update(acfg)
    return sspec, AnalyseConfig(**kw).validate(sspec)


def pel4_kernel_cases(gen, dev, bits):
    """K2, K3, K4 and K5 (uint16 forms at 16 bits) at pel 4 against their
    plain versions: K2 at the shapes config 2's level-0 search gives it at
    1080p (8 jobs: the hexagon, the walk, the ring, the predictor trials
    K=6, the hexagon masked as the rescue masks it; a twentieth of the
    candidates off its tile), K3 as Degrain fetches at level 0 (vectors
    past the clamp on every side), K5 at origins from 40 pixels before the
    stack to 40 past its end, K4 on the level-0 stack of a 256x192 clip
    (candidates past its bottom and right edges; the walk, K=6, and a mask
    that leaves about 30 % live)."""
    sspec, aspec = pel4_specs(W, H, bits)
    if bits == 8:
        clip = make_test_clip(P4_PAIRS + 1, W, H, seed=1, flash=FLASH,
                              device=dev)
    else:
        clip = make_test_clip_yuv(P4_PAIRS + 1, W, H, seed=1, flash=FLASH,
                                  noise=YUV_NOISE, bits=bits, device=dev)[0]
    sups = build_super([clip], sspec)
    src_idx = torch.arange(P4_PAIRS, device=dev)
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, src_idx + 1, 0)
    tag = bits_tag(sspec)
    walk, ring = tuple(fe._HEXP), tuple(fe._ring_offsets(1, 1))
    k2 = [k2_case(ctx, stacks, gen, offsets, kk,
                  f"level 0 pel 4 K={kk} {what} D={len(offsets)}{tag}",
                  masked=masked)
          for offsets, kk, what, masked in (
              (HEXAGON, 1, "hexagon", False), (walk, 1, "walk", False),
              (ring, 1, "ring", False), (((0, 0),), 6, "trials", False),
              (HEXAGON, 1, "hexagon", True))]
    k3 = [k3_case(sspec, aspec.meta, sups, gen)]
    stack, pel = stacks[0], ctx.pel
    hp, wp = stack.shape[2:]
    ey = torch.randint(-40 * pel, (hp + 40) * pel, (P4_PAIRS, 4096, 4),
                       generator=gen, device=dev, dtype=torch.int32)
    ex = torch.randint(-40 * pel, (wp + 40) * pel, ey.shape, generator=gen,
                       device=dev, dtype=torch.int32)
    k5 = [k5_case(f"level 0 pel 4 origins past every edge K=4{tag}", stack,
                  ey, ex, 16, 16, pel)]
    del ctx, stacks, stack, sups, clip
    s_sspec, s_aspec = pel4_specs(SMALL_W, SMALL_H, bits)
    small = make_test_clip_yuv(3, SMALL_W, SMALL_H, seed=3, noise=YUV_NOISE,
                               bits=bits, device=dev)[0]
    s_sups = build_super([small], s_sspec)
    ctx, stacks = level_inputs(s_sspec, s_aspec, s_sups,
                               torch.tensor([1, 1], device=dev),
                               torch.tensor([2, 0], device=dev), 0)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    k4 = [k4_case(ctx, stacks, gen, walk, 1),
          k4_case(ctx, stacks, gen, ((0, 0),), 6),
          k4_case(ctx, stacks, gen, grid16, 1, live=K4_MASKS[0])]
    del ctx, stacks, s_sups, small
    torch.cuda.empty_cache()
    suffix = "" if bits == 8 else "[u16]"
    return {"probe_sads_tiled" + suffix: k2, "fetch_blocks_tiled" + suffix: k3,
            "fetch_blocks" + suffix: k5, "probe_sads" + suffix: k4}


def kernels_vs_plain(dev):
    """Every kernel against its plain version on the card at the main
    paths' shapes (tolerance 0); prints the phase and returns the case of
    each kernel that the kernels line reports."""
    sspec, aspec, _ = headline_specs(W, H)
    cfgs = flagship_configs()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    clip = make_test_clip(BATCH + 2 * RADIUS, W, H, seed=1, flash=FLASH,
                          device=dev)
    sups = build_super([clip], sspec)
    src_idx = torch.tensor([c for c in range(1, BATCH + 1) for _ in (0, 1)],
                           device=dev)
    ref_idx = torch.tensor([c + s for c in range(1, BATCH + 1)
                            for s in (1, -1)], device=dev)
    k1_cases, k2_cases = [], []
    for lv in range(aspec.meta.lv_count):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        k1_cases.append(k1_case(ctx, stacks, gen,
                                before_ms=GRAY_K1_BEFORE[lv]))
        k2_cases.append(k2_case(ctx, stacks, gen, HEXAGON, 1,
                                f"level {lv} K=1 hexagon D=6",
                                before_ms=GRAY_K2_BEFORE[lv]))
        if lv == 0:
            k2_cases.append(k2_case(ctx, stacks, gen, tuple(fe._HEXP), 1,
                                    "level 0 K=1 walk D=8",
                                    before_ms=0.477))
            k2_cases.append(k2_case(ctx, stacks, gen,
                                    tuple(fe._ring_offsets(1, 1)), 1,
                                    "level 0 K=1 ring D=8",
                                    before_ms=0.478))
            k2_cases.append(k2_case(ctx, stacks, gen, ((0, 0),), 6,
                                    "level 0 K=6 D=1", before_ms=0.574))
            k2_cases.append(k2_case(ctx, stacks, gen, ((0, 0),), 6,
                                    "level 0 K=6 D=1", masked=True))
        del ctx, stacks
    k3_cases = [k3_case(sspec, aspec.meta, sups, gen, before_ms=0.109)]
    del sups, clip
    torch.cuda.empty_cache()
    y1, y2, y3 = yuv_kernel_cases(cfgs, gen, dev)
    k4_list = k4_cases(cfgs, gen, dev, 8) + k4_width_cases(gen, dev, 8)
    k1_cases += k1_geometry_cases(gen, dev)
    s1, s2, s4 = satd_kernel_cases(gen, dev)
    k5_cases, k3_dct = dct_kernel_cases(gen, dev)
    k3_cases += k3_dct + [k3_blk8_case(gen, dev)]
    p4 = pel4_kernel_cases(gen, dev, 8)
    cases = {"sad_map": k1_cases + y1,
             "probe_sads_tiled": k2_cases + y2 + p4["probe_sads_tiled"],
             "fetch_blocks_tiled": k3_cases + y3 + p4["fetch_blocks_tiled"],
             "probe_sads": k4_list + p4["probe_sads"],
             "sad_map[stats3]": s1, "probe_sads_tiled[stats3]": s2,
             "probe_sads[stats3]": s4,
             "fetch_blocks": k5_cases + p4["fetch_blocks"]}
    emit({"phase": "kernels_vs_plain", "tolerance": 0, **cases})
    # the cases the kernels line reports: the main paths' shapes
    return {"sad_map": y1[0], "probe_sads_tiled": y2[0],
            "fetch_blocks_tiled": y3[0], "probe_sads": k4_list[0],
            "sad_map[stats3]": s1[0], "probe_sads_tiled[stats3]": s2[0],
            "probe_sads[stats3]": s4[0], "fetch_blocks": k5_cases[0]}


def deep_kernels_vs_plain(cfgs, dev):
    """The uint16 forms of K1-K5 against their plain versions on the card
    (tolerance 0) at the deep-bit YUV420 path's shapes, on 16-bit and on
    10-bit data (K4 u16 also at its width classes on 10-bit data); prints
    the phase and returns the 16-bit cases that the kernels line
    reports."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    by_bits = {bits: deep_kernel_cases(cfgs, gen, dev, bits)
               for bits in (DEEP_BITS, 10)}
    k4 = (k4_cases(cfgs, gen, dev, DEEP_BITS) + k4_cases(cfgs, gen, dev, 10)
          + k4_width_cases(gen, dev, 10))
    p4 = pel4_kernel_cases(gen, dev, DEEP_BITS)
    names = ("sad_map[u16]", "probe_sads_tiled[u16]",
             "fetch_blocks_tiled[u16]", "fetch_blocks[u16]")
    emit({"phase": "kernels_vs_plain_u16", "tolerance": 0,
          **{name: by_bits[DEEP_BITS][i] + by_bits[10][i] + p4.get(name, [])
             for i, name in enumerate(names)},
          "probe_sads[u16]": k4 + p4["probe_sads[u16]"]})
    k1, k2, k3, k5 = by_bits[DEEP_BITS]
    return {"sad_map[u16]": k1[0], "probe_sads_tiled[u16]": k2[0],
            "fetch_blocks_tiled[u16]": k3[0], "probe_sads[u16]": k4[0],
            "fetch_blocks[u16]": k5[-1]}


def u8_kernel_times(cfgs, dev):
    """The 8-bit kernels at the YUV420 and DCT paths' shapes (K1-K5),
    against their plain versions, for --paths-only: with --package-root the
    other tree's kernels, so that one call times both trees in turns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1, k2, k3 = yuv_kernel_cases(cfgs, gen, dev)
    k5, k3_dct = dct_kernel_cases(gen, dev)
    emit({"phase": "u8_kernel_times",
          **{name: [{k: c[k] for k in ("case", "ms", "bound_ms", "plain_ms")}
                    for c in cases]
             for name, cases in (("sad_map", k1), ("probe_sads_tiled", k2),
                                 ("fetch_blocks_tiled", k3 + k3_dct),
                                 ("fetch_blocks", k5))}})


def redesigned_kernel_times(dev):
    """K4' (redesigned in this tree) at the SATD Analyse path's level-5
    shapes and the masked ones (k4p_cases), against its plain version, for
    --paths-only: with --package-root the other tree's kernel, so that one
    call times both trees in turns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    keys = ("case", "ms", "device_ms", "bound_ms", "bound_by", "bytes",
            "ops", "plain_ms", "before_ms", "live_share", "launch")
    sspec, aspec, _, _ = chain_specs(W, H, 5)
    clip = satd_clip(RECALC_PAIRS + 1, W, H, 1, YUV_FLASH, SATD_CLEAN, dev)
    sups = build_super([clip], sspec)
    src_idx = torch.arange(1, RECALC_PAIRS, 2, device=dev).repeat_interleave(2)
    ref_idx = src_idx + 1 - 2 * (torch.arange(RECALC_PAIRS, device=dev) % 2)
    cases = k4p_cases(sspec, aspec, sups, src_idx, ref_idx, gen)
    del clip, sups
    torch.cuda.empty_cache()
    emit({"phase": "redesigned_kernel_times",
          "probe_sads[stats3]": [{k: c[k] for k in keys if k in c}
                                 for c in cases]})


def run_yuv16_paths(cfgs, dev, profile):
    """The flagship YUV420 path at 16 bits and full width through
    degrain_clip: first with the flash (K1, K2, K4 and K3 in their uint16
    forms must launch), then without it (neither probe kernel may); no
    8-bit kernel may launch on either."""
    fmt = VideoFormat(W, H, DEEP_BITS, ColorFamily.YUV420)
    flash_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, flash=YUV_FLASH,
                                    noise=YUV_NOISE, pan=YUV_PAN,
                                    bits=DEEP_BITS, device=dev)
    degrain_clip(flash_clip, fmt, *cfgs, engine="lockstep")       # warm-up
    res = run_yuv_clip("yuv16_main_path", flash_clip, cfgs, DEEP_BITS)
    c = res["launches"]
    needed = ("sad_map[u16]", "probe_sads_tiled[u16]", "probe_sads[u16]",
              "fetch_blocks_tiled[u16]")
    if min(c[k] for k in needed) < 1:
        raise AssertionError(f"yuv16 main path: a kernel never launched {c}")
    calm_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, noise=YUV_NOISE,
                                   pan=YUV_PAN, bits=DEEP_BITS, device=dev)
    calm = run_yuv_clip("yuv16_main_path_calm", calm_clip, cfgs, DEEP_BITS)
    cc = calm["launches"]
    if cc["probe_sads_tiled[u16]"] or cc["probe_sads[u16]"]:
        raise AssertionError(f"yuv16 main path without the flash: the "
                             f"rescue ran {cc}")
    if cc["sad_map[u16]"] < 1 or cc["fetch_blocks_tiled[u16]"] < 1:
        raise AssertionError(f"yuv16 main path without the flash: a kernel "
                             f"never launched {cc}")
    for phase, counts in (("yuv16_main_path", c),
                          ("yuv16_main_path_calm", cc)):
        u8 = {k: v for k, v in counts.items() if v and k not in U16_KERNELS}
        if u8:
            raise AssertionError(f"{phase}: an 8-bit kernel ran {u8}")
    if profile:
        profile_run("yuv16_main_path",
                    lambda: degrain_clip(flash_clip, fmt, *cfgs,
                                         engine="lockstep"),
                    split=("probe_sads[u16]", "probe_sads_tiled[u16]"))
        profile_run("yuv16_main_path_calm",
                    lambda: degrain_clip(calm_clip, fmt, *cfgs,
                                         engine="lockstep"))
    del flash_clip, calm_clip
    torch.cuda.empty_cache()
    return res, calm


def small_end_to_end(dev):
    """The gray headline path at 256x192 (degrain_window) on the card
    against the same code on CPU tensors."""
    s_sspec, s_aspec, s_dcfg = headline_specs(SMALL_W, SMALL_H)
    small = make_test_clip(6, SMALL_W, SMALL_H, seed=2, flash=SMALL_FLASH,
                           device="cpu")
    reset_counts()
    info_gpu, info_cpu = {}, {}
    out_gpu = degrain_window(small.to(dev), s_sspec, s_aspec, s_dcfg,
                             RADIUS, info_gpu)
    small_counts = read_counts()
    out_cpu = degrain_window(small, s_sspec, s_aspec, s_dcfg, RADIUS,
                             info_cpu)
    for lv, (lg, lc) in enumerate(zip(info_gpu["fields"].levels,
                                      info_cpu["fields"].levels)):
        for key in ("x", "y", "sad"):
            if not torch.equal(getattr(lg, key).cpu(), getattr(lc, key)):
                raise AssertionError(
                    f"small end-to-end: level {lv} {key} differs between "
                    "the card and the CPU")
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError("small end-to-end: denoised pixels differ "
                             "between the card and the CPU")
    if (min(small_counts[k] for k in ("sad_map", "probe_sads_tiled")) < 1
            or fetches(small_counts) < 1):
        raise AssertionError(f"small end-to-end: a kernel never launched "
                             f"{small_counts}")
    emit({"phase": "small_end_to_end", "size": [SMALL_W, SMALL_H],
          "frames": 6, "bit_equal_to_cpu": True, "launches": small_counts})


# the frame-rate conversion path (bench.py config 5): 9 input frames of
# 1920x1080 gray -> 17 output frames at twice the rate
FPS_T = 9


def has_fps():
    """Whether the package driven has the frame-rate conversion entry point
    (a tree given by --package-root may predate it)."""
    import importlib.util
    return importlib.util.find_spec("mvtools_tpu_torch.models.frc") \
        is not None


def run_fps_clip(phase, clip, cfgs):
    """Drive flowfps_clip over a full-width gray clip [T, H, W] once, with
    every count set to 0 just before and read just after; check the output
    (2T - 1 frames on the card, the even ones the sources, every
    interpolated one unlike both of its sources); print and return the
    phase's numbers."""
    from fractions import Fraction

    from mvtools_tpu_torch.core.thscd import is_usable, scale_thscd
    from mvtools_tpu_torch.models.frc import flowfps_clip, frame_plan
    scfg, acfg, fcfg, fps_in, fps_out = cfgs
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    out = flowfps_clip([clip], fmt, fps_in, fps_out, scfg, acfg, fcfg,
                       info=info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs = fe.host_syncs
    plain_on_cuda = plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    t_in = clip.shape[0]
    plan, _, _ = frame_plan(t_in, Fraction(fps_in) / Fraction(fps_out),
                            len(out), fcfg.maskmode)
    if len(out) != 2 * t_in - 1:
        raise AssertionError(f"{phase}: {len(out)} output frames")
    for n, ((nl, nr, time256, _), planes) in enumerate(zip(plan, out)):
        got = planes[0]
        if (tuple(got.shape) != (H, W) or got.dtype != torch.uint8
                or got.device.type != "cuda"):
            raise AssertionError(f"{phase}: frame {n} {tuple(got.shape)} "
                                 f"{got.dtype} {got.device}")
        if time256 == 0:
            if not torch.equal(got, clip[nl]):
                raise AssertionError(f"{phase}: passthrough frame {n} is "
                                     "not its source")
        elif torch.equal(got, clip[nl]) or torch.equal(got, clip[nr]):
            raise AssertionError(f"{phase}: interpolated frame {n} equals "
                                 "a source")
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version "
                             "calls on CUDA tensors")
    meta = info["fields_b"].meta
    n1, n2 = scale_thscd(fcfg.thscd1, fcfg.thscd2, meta)
    usable = (is_usable(info["fields_b"], n1, n2)
              & is_usable(info["fields_f"], n1, n2))
    ev = info["events"]
    res = {"phase": phase, "size": [W, H], "format": "GRAY",
           "frames_in": t_in, "frames_out": len(out),
           "interpolated": sum(1 for p in plan if p[2]),
           "fps_in": str(fps_in), "fps_out": str(fps_out),
           "maskmode": fcfg.maskmode, "levels": len(meta.level_blocks()),
           "analyse_jobs": 2 * len(info["keys_b"]),
           "scene_change_intervals": int((~usable).sum()),
           "output_frames_per_s": len(out) / seconds, "seconds": seconds,
           "stage_ms": {k: ev[k][0].elapsed_time(ev[k][1]) for k in ev},
           "host_syncs": syncs, "launches": counts,
           "peak_memory_bytes": peak, "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def run_fps_paths(dev, profile):
    """The frame-rate conversion path (bench.py config 5: gray, pel 2, blk
    16, truemotion, the full pyramid, FlowFPS maskmode 2, 30 -> 60 fps) at
    full width through flowfps_clip: first on a clip with the flashing
    region (the SAD map and the tiled probe must launch), then without it
    (the SAD map must, neither probe may)."""
    from mvtools_tpu_torch.models.frc import flowfps_clip, fps_configs
    cfgs = fps_configs()
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    res = []
    for phase, flash in (("fps_main_path", FLASH),
                         ("fps_main_path_calm", None)):
        clip = make_test_clip(FPS_T, W, H, seed=0, flash=flash, device=dev)
        flowfps_clip([clip], fmt, *cfgs[3:], *cfgs[:3])      # warm-up
        r = run_fps_clip(phase, clip, cfgs)
        c = r["launches"]
        if c["sad_map"] < 1:
            raise AssertionError(f"{phase}: the SAD map never launched {c}")
        if flash and c["probe_sads_tiled"] < 1:
            raise AssertionError(f"{phase}: the flash sent no block to the "
                                 f"rescue's tiled probe {c}")
        if not flash and (c["probe_sads_tiled"] or c["probe_sads"]):
            raise AssertionError(f"{phase}: the rescue ran on the clip "
                                 f"without the flash {c}")
        other = {k: v for k, v in c.items()
                 if v and ("[" in k or k.startswith("fetch"))}
        if other:
            raise AssertionError(f"{phase}: a kernel off the path ran "
                                 f"{other}")
        if profile:
            profile_run(phase, lambda: flowfps_clip(
                [clip], fmt, *cfgs[3:], *cfgs[:3]),
                split=("probe_sads",) if flash else ())
        res.append(r)
        del clip
    torch.cuda.empty_cache()
    return res


def fields_equal(name, a, b):
    """a (on the card) and b (on the CPU): MVFields equal level by level."""
    for lv, (la, lb) in enumerate(zip(a.levels, b.levels)):
        for key in ("x", "y", "sad"):
            if not torch.equal(getattr(la, key).cpu(), getattr(lb, key)):
                raise AssertionError(f"{name}: level {lv} {key} differs "
                                     "between the card and the CPU")
    if not torch.equal(a.validity.cpu(), b.validity):
        raise AssertionError(f"{name}: validity differs")


def planes_equal(name, a, b):
    for p, (x, y) in enumerate(zip(a, b)):
        if x.device.type != "cuda":
            raise AssertionError(f"{name}: plane {p} not on the card")
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"{name}: plane {p} differs between the "
                                 "card and the CPU")


def consumers_card_vs_cpu(dev, clip, fields, scfg, acfg):
    """The motion-compensated consumers of the frame-rate conversion slice
    on the small gray clip [5, H, W] (CPU) and the fields of its
    flowfps_clip run (fields: (card info, CPU info)), on the card against
    the same code on CPU tensors (torch.equal); returns the modules
    checked.  Mask also at gamma 2 and 0.5 and the occlusion mask at gamma
    2: float64 pow, where the card's and the CPU's libm may differ."""
    import dataclasses as dc

    from mvtools_tpu_torch import (blockfps, compensate, flow, flowblur,
                                   flowinter, mask, scdetect)
    from mvtools_tpu_torch.models.denoise import (degrain1_clip,
                                                  degrain1_frame,
                                                  degrain_n_frame, field_job)
    fmt = VideoFormat(SMALL_W, SMALL_H, 8, ColorFamily.GRAY)
    sspec = scfg.validate(fmt)
    aspec_b = dc.replace(acfg, isb=True).validate(sspec)
    aspec_f = dc.replace(acfg, isb=False).validate(sspec)
    sups = {"cuda": build_super([clip.to(dev)], sspec),
            "cpu": build_super([clip], sspec)}

    def job(info, name, key):
        return field_job(info["fields_" + name],
                         info["keys_" + name].index(key))

    def both(fn):
        """fn(device kind, its tensors) on the card and on the CPU."""
        out = []
        for k, info in zip(("cuda", "cpu"), fields):
            d = dev if k == "cuda" else torch.device("cpu")
            sup = sups[k]
            out.append(fn(
                lambda n: [clip[n].to(d)],
                lambda n: sup.map(lambda a, n=n: a[n]),
                lambda name, key: job(info, name, key), d))
        return out

    checked = []

    def check(name, fn):
        reset_counts()
        card, cpu = both(fn)
        if plain_calls_on_cuda():
            raise AssertionError(f"small end-to-end fps: {name} ran a plain "
                                 "version on CUDA tensors")
        if isinstance(card, torch.Tensor):
            card, cpu = [card], [cpu]
        planes_equal(f"small end-to-end fps: {name}", card, cpu)
        checked.append(name)

    mb, mf = aspec_b.meta, aspec_f.meta
    check("flowinter", lambda fr, sp, f, d: flowinter.flowinter(
        fr(1), fr(2), sp(1), sp(2), f("b", 1), f("f", 1), mb,
        flowinter.FlowInterConfig(time=40.0), f("b", 2), f("f", 0)))
    for mode in (0, 1):
        check(f"flow mode {mode}", lambda fr, sp, f, d, mode=mode: flow.flow(
            fr(1), sp(2), f("b", 1), mb, flow.FlowConfig(time=70.0,
                                                         mode=mode)))
    check("flowblur", lambda fr, sp, f, d: flowblur.flowblur(
        fr(2), sp(2), f("b", 2), f("f", 1), mb,
        flowblur.FlowBlurConfig(blur=100.0, thscd1=16320, thscd2=255)))
    for mode in range(9):
        check(f"blockfps mode {mode}", lambda fr, sp, f, d, mode=mode:
              blockfps.blockfps_frame(
                  fr(2), fr(3), sp(2), sp(3), f("b", 2), f("f", 2), mb,
                  blockfps.BlockFPSConfig(mode=mode), 96))
    for shift in (0, 1):
        check(f"compensate field shift {shift}",
              lambda fr, sp, f, d, shift=shift: compensate.compensate(
                  sp(0), sp(1), f("b", 0), mb,
                  compensate.CompensateConfig(thsad=300, time=60.0), shift))
    check("scdetect", lambda fr, sp, f, d: torch.stack([
        scdetect.scdetect(f(n, k), mb) for n in ("b", "f")
        for k in (0, 1, 2, 3)]))
    for kind in range(6):
        for gamma in (1.0, 2.0, 0.5):
            check(f"mask kind {kind} gamma {gamma}",
                  lambda fr, sp, f, d, kind=kind, gamma=gamma: mask.mask(
                      fr(2), f("f", 1), mf, mask.MaskConfig(
                          kind=kind, gamma=gamma, ml=60.0, time=70.0)))
    dcfg = DegrainConfig(thsad=400)
    check("degrain1_frame", lambda fr, sp, f, d: degrain1_frame(
        fr(2), fr(1), fr(3), sspec, aspec_b, aspec_f, dcfg))
    check("degrain_n_frame radius 2", lambda fr, sp, f, d: degrain_n_frame(
        fr(1), [fr(0), fr(0)], [fr(2), fr(3)], sspec, aspec_b, aspec_f, dcfg,
        valid_b=[True, True], valid_f=[True, False]))
    check("degrain1_clip", lambda fr, sp, f, d: degrain1_clip(
        [clip.to(d)], fmt, scfg, acfg, dcfg, engine="lockstep"))
    return checked


def small_end_to_end_fps(dev):
    """Every module of the frame-rate conversion slice and of its sibling
    consumers at 256x192 on the card against the same code on CPU tensors
    (torch.equal): flowfps_clip on a gray clip with a flash (maskmode 0, 1
    and 2) and on a YUV420 clip (chroma, overlap 8, maskmode 2); then the
    consumers on the gray run's fields (consumers_card_vs_cpu)."""
    from fractions import Fraction

    from mvtools_tpu_torch.flowfps import FlowFPSConfig
    from mvtools_tpu_torch.models.frc import flowfps_clip, fps_configs
    scfg, acfg, fcfg, fps_in, fps_out = fps_configs()
    gray = make_test_clip(5, SMALL_W, SMALL_H, seed=2, flash=SMALL_FLASH,
                          device="cpu")
    yuv = make_test_clip_yuv(5, SMALL_W, SMALL_H, seed=3,
                             flash=SMALL_YUV_FLASH, noise=YUV_NOISE,
                             pan=YUV_PAN, device="cpu")
    runs = [(f"gray maskmode {m}", [gray], ColorFamily.GRAY, scfg, acfg,
             FlowFPSConfig(maskmode=m)) for m in (2, 1, 0)]
    runs.append(("yuv420 maskmode 2", yuv, ColorFamily.YUV420,
                 SuperConfig(pel=2, levels=0, chroma=True),
                 AnalyseConfig(blksize=16, levels=0, overlap=8,
                               truemotion=True, chroma=True),
                 FlowFPSConfig(maskmode=2)))
    launches = {}
    for name, clip, family, sc, ac, fc in runs:
        fmt = VideoFormat(SMALL_W, SMALL_H, 8, family)
        reset_counts()
        info_gpu, info_cpu = {}, {}
        out_gpu = flowfps_clip([p.to(dev) for p in clip], fmt, fps_in,
                               fps_out, sc, ac, fc, info=info_gpu)
        counts = read_counts()
        if plain_calls_on_cuda():
            raise AssertionError(f"small end-to-end fps {name}: a plain "
                                 "version ran on CUDA tensors")
        out_cpu = flowfps_clip(clip, fmt, fps_in, fps_out, sc, ac, fc,
                               info=info_cpu)
        for d in ("fields_b", "fields_f"):
            fields_equal(f"small end-to-end fps {name} {d}", info_gpu[d],
                         info_cpu[d])
        if len(out_gpu) != len(out_cpu) or len(out_cpu) != 9:
            raise AssertionError(f"small end-to-end fps {name}: frames")
        for n, (a, b) in enumerate(zip(out_gpu, out_cpu)):
            planes_equal(f"small end-to-end fps {name} frame {n}", a, b)
        if counts["sad_map"] < 1:
            raise AssertionError(f"small end-to-end fps {name}: the SAD map "
                                 f"never launched {counts}")
        launches[name] = counts
        if name == "gray maskmode 2":
            fields = (info_gpu, info_cpu)
    modules = consumers_card_vs_cpu(dev, gray, fields, scfg, acfg)
    emit({"phase": "small_end_to_end_fps", "size": [SMALL_W, SMALL_H],
          "frames_in": 5, "frames_out": 9, "bit_equal_to_cpu": True,
          "runs": list(launches), "launches": launches,
          "modules_bit_equal_to_cpu": modules})

def pel4_analyse(clip, sspec, aspec, info=None):
    """bench.py config 2's step on a clip [P4_PAIRS + 1, H, W]: the supers
    of every frame, then one analyse_batch over the pairs (frame i against
    frame i + 1); with `info`, CUDA events around the two stages under
    "events"."""
    ev = {k: (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
          for k in ("super", "analyse")} if info is not None else None
    dev = clip.device
    if ev:
        ev["super"][0].record()
    sups = build_super([clip], sspec)
    if ev:
        ev["super"][1].record()
        ev["analyse"][0].record()
    src = torch.arange(clip.shape[0] - 1, device=dev)
    mv = analyse_batch(sups.take(src), sups.take(src + 1), aspec)
    if ev:
        ev["analyse"][1].record()
        info["events"] = ev
    return mv


def run_pel4_clip(phase, clip, sspec, aspec):
    """Drive config 2 over a full-width gray clip once, with every count set
    to 0 just before and read just after; check the fields (every level's
    shape, on the card, SADs non-negative; on the clip without the flash,
    nine in ten of job 0's level-0 vectors the clip's pan); print and return
    the phase's numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    mv = pel4_analyse(clip, sspec, aspec, info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs, rescued = fe.host_syncs, fe.rescued_blocks
    plain_on_cuda = plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    pairs = clip.shape[0] - 1
    meta = aspec.meta
    if len(mv.levels) != meta.lv_count:
        raise AssertionError(f"{phase}: {len(mv.levels)} levels")
    for lv, (nbx, nby) in enumerate(meta.level_blocks()):
        level = mv.levels[lv]
        for key in ("x", "y", "sad"):
            t = getattr(level, key)
            if tuple(t.shape) != (pairs, nby, nbx) or t.device.type != "cuda":
                raise AssertionError(f"{phase}: level {lv} {key} "
                                     f"{tuple(t.shape)} {t.device}")
        if bool((level.sad < 0).any()):
            raise AssertionError(f"{phase}: level {lv} has negative SADs")
    # make_test_clip pans by (2, 3) pixels a frame: frame 0's content sits
    # at (-3, -2) pixels in frame 1, (-12, -8) in quarter pels
    pan = float(((mv.levels[0].x[0] == -12)
                 & (mv.levels[0].y[0] == -8)).float().mean())
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version "
                             "calls on CUDA tensors")
    ev = info["events"]
    res = {"phase": phase, "size": [W, H], "format": "GRAY", "pel": 4,
           "search": "HEX2", "searchparam": 2, "levels": meta.lv_count,
           "pairs": pairs, "frames_per_s": pairs / seconds,
           "seconds": seconds,
           "stage_ms": {k: ev[k][0].elapsed_time(ev[k][1]) for k in ev},
           "host_syncs": syncs, "rescued_blocks": rescued,
           "job0_level0_share_at_pan": pan, "launches": counts,
           "peak_memory_bytes": peak, "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def has_pel4():
    """Whether the package driven builds pel-4 supers (a tree given by
    --package-root may predate them): it builds one of a tiny CPU plane, or
    refuses pel 4 with NotImplementedError."""
    from mvtools_tpu_torch.core import config, types
    from mvtools_tpu_torch.super import build_super
    try:
        sspec = config.SuperConfig(pel=4, levels=1, chroma=False).validate(
            types.VideoFormat(32, 32, 8, types.ColorFamily.GRAY))
        build_super([torch.zeros((1, 32, 32), dtype=torch.uint8)], sspec)
    except NotImplementedError:
        return False
    return True


def run_pel4_paths(dev, profile):
    """bench.py config 2 at full width (1920x1080 gray, pel 4, the full
    pyramid, HEX2 searchparam 2, truemotion, 8 pairs a window) through
    build_super and analyse_batch, after one warm-up: first on a clip with
    the 256x256 flashing region (the rescue must run), then without it (it
    must not).  In both the level-0 search probes through the tiled probe
    and the coarse levels ride the SAD map: both must launch, and no
    uint16, three-stat or fetch kernel may."""
    sspec, aspec = pel4_specs(W, H)
    res = []
    for phase, flash in (("pel4_main_path", FLASH),
                         ("pel4_main_path_calm", None)):
        clip = make_test_clip(P4_PAIRS + 1, W, H, seed=0, flash=flash,
                              device=dev)
        pel4_analyse(clip, sspec, aspec)                       # warm-up
        r = run_pel4_clip(phase, clip, sspec, aspec)
        c = r["launches"]
        if c["sad_map"] < 1 or c["probe_sads_tiled"] < 1:
            raise AssertionError(f"{phase}: a kernel never launched {c}")
        if flash and r["rescued_blocks"] < 1:
            raise AssertionError(f"{phase}: the flash made no block bad; the "
                                 "rescue never ran")
        if not flash and r["rescued_blocks"]:
            raise AssertionError(f"{phase}: the rescue took "
                                 f"{r['rescued_blocks']} blocks")
        if not flash and r["job0_level0_share_at_pan"] < 0.9:
            raise AssertionError(f"{phase}: job 0's level-0 vectors miss the "
                                 f"clip's pan {r['job0_level0_share_at_pan']}")
        other = {k: v for k, v in c.items()
                 if v and ("[" in k or k.startswith("fetch"))}
        if other:
            raise AssertionError(f"{phase}: a kernel off the path ran "
                                 f"{other}")
        if profile:
            profile_run(phase, lambda: pel4_analyse(clip, sspec, aspec),
                        split=("probe_sads_tiled", "probe_sads"))
        res.append(r)
        del clip
    torch.cuda.empty_cache()
    return res


def small_end_to_end_pel4(dev):
    """The pel-4 slice at 256x192 on the card against the same code on CPU
    tensors (torch.equal throughout): config 2's analyse_batch and
    analyse() on a gray clip with a flash; analyse_batch at pel 4 on YUV420
    (chroma, overlap 8) at 8 and 16 bits, with dct 1 (the per-block fetch)
    and with dct 5 (the three-stat tiled probe); 32x32 blocks at 16 bits,
    whose levels all probe (pel 2); one run of each search type
    (ONETIME, NSTEP, LOGARITHMIC, UMH, HORIZONTAL, VERTICAL); trymany with
    the ring rescue and divide 2, and divide 1 at pel 4; Recalculate at pel
    4 (HEX2 with divide 1, ONETIME on the per-block engine); degrain_clip
    at pel 4 (8 and 16 bits) and flowfps_clip at pel 4."""
    from mvtools_tpu_torch.flowfps import FlowFPSConfig
    from mvtools_tpu_torch.models.frc import flowfps_clip
    gray = make_test_clip(5, SMALL_W, SMALL_H, seed=2, flash=SMALL_FLASH,
                          device="cpu")
    # YUV420 clips with a flash over a 96x64 region (the rescue at pel 4),
    # and without one for Degrain
    yuv = {(bits, flash): make_test_clip_yuv(
        4, SMALL_W, SMALL_H, seed=2, flash=(16, 16, 64, 96) if flash else None,
        noise=YUV_NOISE, bits=bits, device="cpu")
        for bits in (8, DEEP_BITS) for flash in (True, False)}
    src, ref = torch.tensor([1, 1, 2, 2]), torch.tensor([2, 0, 3, 1])
    launches, rescued, seconds = {}, {}, {}

    def on_both(name, fn):
        """fn(device) on the card and on the CPU: (card's, CPU's result);
        the card's launches under `name`, the seconds of both runs."""
        t0 = time.perf_counter()
        reset_counts()
        got = fn(dev)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        rescued[name] = fe.rescued_blocks
        if plain_calls_on_cuda():
            raise AssertionError(f"small end-to-end pel4 {name}: a plain "
                                 "version ran on CUDA tensors")
        want = fn("cpu")
        seconds[name] = time.perf_counter() - t0
        return got, want

    def analysis(name, planes, sspec, aspec):
        def fn(d):
            sups = build_super([p.to(d) for p in planes], sspec)
            return sups, analyse_batch(sups.take(src.to(d)),
                                       sups.take(ref.to(d)), aspec)
        (sg, mg), (sc, mc) = on_both(name, fn)
        fields_equal(f"small end-to-end pel4 {name}", mg, mc)
        return sg, mg, sc, mc

    fmt = dict(width=SMALL_W, height=SMALL_H)
    g_sspec, g_aspec = pel4_specs(**fmt)
    sg, mg, sc, mc = analysis("gray config 2", [gray], g_sspec, g_aspec)
    one_g, one_c = on_both("gray config 2 analyse()", lambda d: analyse(
        (sg if d == dev else sc).map(lambda a: a[1]),
        (sg if d == dev else sc).map(lambda a: a[2]), g_aspec,
        engine="lockstep"))
    fields_equal("small end-to-end pel4 analyse()", one_g, one_c)
    for bits in (8, DEEP_BITS):
        analysis(f"yuv420 {bits}-bit", yuv[bits, True], *pel4_specs(
            **fmt, bits=bits, family=ColorFamily.YUV420))
    for dct in (1, 5):
        analysis(f"gray dct {dct}", [gray], *pel4_specs(**fmt, dct=dct))
    # 32x32 blocks at 16 bits (a SAD can reach 2^24): no level rides the
    # map, every one probes
    s16 = SuperConfig(pel=2, levels=0, chroma=False).validate(
        VideoFormat(SMALL_W, SMALL_H, DEEP_BITS, ColorFamily.GRAY))
    analysis("gray 16-bit 32x32", [yuv[DEEP_BITS, True][0]], s16,
             AnalyseConfig(blksize=32, levels=0,
                           chroma=False).validate(s16))
    sspec2 = SuperConfig(pel=2, levels=0, chroma=False).validate(
        VideoFormat(SMALL_W, SMALL_H, 8, ColorFamily.GRAY))
    for search, pel in ((SearchType.ONETIME, 4), (SearchType.NSTEP, 2),
                        (SearchType.LOGARITHMIC, 2), (SearchType.UMH, 4),
                        (SearchType.HORIZONTAL, 2), (SearchType.VERTICAL, 4)):
        kw = dict(search=search, searchparam=3, search_coarse=search)
        specs = (pel4_specs(**fmt, **kw) if pel == 4 else
                 (sspec2, AnalyseConfig(blksize=16, levels=0, chroma=False,
                                        **kw).validate(sspec2)))
        analysis(f"{search.name} pel {pel}", [gray], *specs)
    analysis("trymany ring rescue divide 2", [gray], sspec2, AnalyseConfig(
        blksize=16, levels=0, search=SearchType.UMH, pelsearch=4,
        search_coarse=SearchType.LOGARITHMIC, searchparam=4, trymany=True,
        badrange=-6, divide=2, chroma=False).validate(sspec2))
    analysis("divide 1 pel 4", [gray], *pel4_specs(**fmt, divide=1))
    for rc_name, rc_kw in (("recalculate hex2 divide 1",
                            dict(divide=1)),
                           ("recalculate onetime",
                            dict(search=SearchType.ONETIME, searchparam=2))):
        rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                 chroma=False, **rc_kw)
        rspec = rcfg.to_analyse_config().validate(g_sspec)
        got, want = on_both(rc_name, lambda d: recalculate(
            (sg if d == dev else sc).take(src.to(d)),
            (sg if d == dev else sc).take(ref.to(d)),
            mg if d == dev else mc, rspec, rcfg))
        fields_equal(f"small end-to-end pel4 {rc_name}", got, want)
    scfg = SuperConfig(pel=4, levels=0, chroma=True)
    acfg = AnalyseConfig(blksize=16, levels=0, overlap=8, truemotion=True,
                         chroma=True)
    for bits in (8, DEEP_BITS):
        f = VideoFormat(SMALL_W, SMALL_H, bits, ColorFamily.YUV420)
        # thsad 2000, thscd1 10000: the clip's fresh noise would make
        # every pair a scene change at the defaults (weight 0)
        got, want = on_both(f"degrain_clip {bits}-bit", lambda d: degrain_clip(
            [p.to(d) for p in yuv[bits, False]], f, scfg, acfg,
            DegrainConfig(thsad=2000, thscd1=10000), 1, engine="lockstep"))
        planes_equal(f"small end-to-end pel4 degrain_clip {bits}-bit", got,
                     want)
        if torch.equal(want[0], yuv[bits, False][0]):
            raise AssertionError("small end-to-end pel4: degrain_clip left "
                                 "the luma as it was")
    f = VideoFormat(SMALL_W, SMALL_H, 8, ColorFamily.GRAY)
    got, want = on_both("flowfps_clip", lambda d: flowfps_clip(
        [gray.to(d)], f, 30, 60, SuperConfig(pel=4, levels=0, chroma=False),
        AnalyseConfig(blksize=16, levels=0, truemotion=True, chroma=False),
        FlowFPSConfig(maskmode=2)))
    if len(got) != len(want) or len(want) != 9:
        raise AssertionError("small end-to-end pel4 flowfps_clip: frames")
    for n, (a, b) in enumerate(zip(got, want)):
        planes_equal(f"small end-to-end pel4 flowfps_clip frame {n}", a, b)
    # the pel-4 probes, the per-block fetch and the three-stat probe at
    # pel 4 launched, and the rescue ran on the flash
    c = launches
    checks = {"gray config 2": ("sad_map", "probe_sads_tiled"),
              "yuv420 16-bit": ("sad_map[u16]", "probe_sads_tiled[u16]"),
              "gray dct 1": ("fetch_blocks",),
              "gray dct 5": ("probe_sads_tiled[stats3]",),
              "gray 16-bit 32x32": ("probe_sads_tiled[u16]",),
              "degrain_clip 8-bit": ("fetch_blocks",),
              "degrain_clip 16-bit": ("fetch_blocks[u16]",)}
    for name, kernels in checks.items():
        if min(c[name][k] for k in kernels) < 1:
            raise AssertionError(f"small end-to-end pel4 {name}: a kernel "
                                 f"never launched {c[name]}")
    if c["gray 16-bit 32x32"]["sad_map[u16]"]:
        raise AssertionError("small end-to-end pel4: a 32x32 16-bit level "
                             "rode the SAD map")
    for name in ("gray config 2", "trymany ring rescue divide 2"):
        if rescued[name] < 1:
            raise AssertionError(f"small end-to-end pel4 {name}: the rescue "
                                 "never ran")
    emit({"phase": "small_end_to_end_pel4", "size": [SMALL_W, SMALL_H],
          "bit_equal_to_cpu": True, "runs": list(launches),
          "rescued_blocks": rescued, "seconds": seconds,
          "launches": launches})


# the full-width paths --paths may choose (with --paths-only)
# ---------------------------------------------------------------------------
# The exact sequential engine (K6) and interlaced input

# exact_main_path: bench.py config 4 at levels=0 on 8 frames (radius 3:
# 48 analyses a clip); its 16-bit run: 4 frames at radius 1
EXACT_T, EXACT16_T = 8, 4
# fields_main_path: 6 frames of 1080p split into 12 fields of 1920x540; the
# frames pan 4 rows down and 2 columns right a frame, so a field and the
# next field of its parity match 2 rows apart, in the chroma planes too
# (fields of opposite parity hold different rows of the noise)
FIELDS_FRAMES, FIELDS_PAN = 6, (4, 2)
# the exact_vs_plain strips: 8 block rows of each level of the main path,
# across the flash (the plain version takes ~15-18 ms a block
# on the card: 8 rows of 1080p level 0 took 34 s)
STRIP_ROWS = 8
EXACT_KERNELS = ("exact_scan", "exact_scan[u16]", "exact_search",
                 "exact_search[u16]")
EXACT_KERNEL_NAMES = {"exact_scan": r"exact_scan_kernel<unsigned char>",
                      "exact_scan[u16]": r"exact_scan_kernel<unsigned short>",
                      "exact_search": r"exact_search_kernel<unsigned char>",
                      "exact_search[u16]":
                          r"exact_search_kernel<unsigned short>"}


def has_exact():
    """Whether the package driven has the exact engine (a tree given by
    --package-root may predate it)."""
    return exact_scan is not None


def exact_bytes(ctx, n_cand):
    """Bytes of the candidates' pixels: n_cand candidate blocks (luma and,
    with chroma, both chroma blocks) read once each."""
    bsx, bsy = ctx.blk_size
    px = bsx * bsy
    if ctx.chroma:
        px += 2 * ctx.blk_size_c[0] * ctx.blk_size_c[1]
    return n_cand * px * ctx.ref_stacks[0].element_size()


def exact_case(label, ctx, plan, vin, gx, gy, zs, reps=1, plain_dev=None):
    """K6's level scan against its plain version on one level's inputs
    (torch.equal on x, y, SAD and the rescue counts): the case's numbers.  The plain version runs on
    the card, or on `plain_dev` (the same inputs copied there)."""
    torch.cuda.synchronize()
    before = exact_scan.candidates
    steps_before = getattr(exact_scan, "serial_steps", 0)
    got = exact_scan._launch_scan(ctx, plan, vin, gx, gy, zs)
    torch.cuda.synchronize()
    n_cand = int(exact_scan.candidates - before)
    n_steps = int(getattr(exact_scan, "serial_steps", 0) - steps_before)
    ms = time_cuda(lambda: exact_scan._launch_scan(ctx, plan, vin, gx, gy,
                                                   zs), reps)
    pargs = (ctx, plan, vin, gx, gy, zs)
    if plain_dev is not None:
        pargs = (ctx._replace(
            src_planes=tuple(p.to(plain_dev) for p in ctx.src_planes),
            ref_stacks=tuple(p.to(plain_dev) for p in ctx.ref_stacks)),
            plan, tuple(v.to(plain_dev) for v in vin), gx.to(plain_dev),
            gy.to(plain_dev), zs.to(plain_dev))
    threads = torch.get_num_threads()
    if plain_dev is not None:
        # tiny CPU ops: intra-op threads cost more than they give
        torch.set_num_threads(1)
    try:
        # no warm-up: a Python loop over the level's blocks, whose first
        # block's costs are a small share of the whole
        want, plain_ms = time_plain(
            lambda: exact_scan.scan_level_plain(*pargs), warm=False)
    finally:
        torch.set_num_threads(threads)
    dev = got[1].device
    err = 0
    for name, a, b in zip(("x", "y", "sad", "badcount"), got[0] + (got[1],),
                          want[0] + (want[1],)):
        err = max(err, compare(f"exact_vs_plain {label} {name}", a,
                               b.to(dev)))
    b_ms, b_by = bound(exact_bytes(ctx, n_cand),
                       n_cand * 2 * ctx.blk_size[0] * ctx.blk_size[1])
    nbx, nby = ctx.nblk
    return {"case": label, "jobs": vin[0].shape[0], "blocks": nbx * nby,
            "level": ctx.level, "candidates": n_cand, "serial_steps": n_steps,
            "rescued": int(got[1].sum()), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def capture_levels(fn):
    """Run fn() with exact_scan.scan_level recording each level's inputs:
    the list of (ctx, plan, vectors_in, gx, gy, zs)."""
    seen = []
    real = exact_scan.scan_level

    def hook(ctx, plan, vin, gx, gy, zs):
        seen.append((ctx, plan, vin, gx, gy, zs))
        return real(ctx, plan, vin, gx, gy, zs)

    exact_scan.scan_level = hook
    try:
        fn()
    finally:
        exact_scan.scan_level = real
    return seen


def strip_of(ctx, vin, rows, first=0):
    """Block rows first .. first + rows - 1 of the level as a level of its
    own: the planes' rows that those blocks and a padding's height above
    and below them cover, the predictions of those rows (a level of no
    more rows as it is), and the first row, clamped so that the strip
    fits."""
    nbx, nby = ctx.nblk
    if nby <= rows:
        return ctx, vin, 0
    r = rows
    bsy, ovy = ctx.blk_size[1], ctx.overlap[1]
    logy = ctx.log_ratio_uv[1]
    h = 2 * ctx.vpad[0] + (r - 1) * (bsy - ovy) + bsy
    h += h % 2
    first = max(0, min(first, nby - r))
    while first and first * (bsy - ovy) + h > ctx.padded[1]:
        first -= 1
    top = first * (bsy - ovy)
    if top % (1 << logy):
        raise ValueError("strip_of: the strip's first row splits a chroma "
                         "row")
    cut = [(top, h)] + [(top >> logy, h >> logy)] * (
        len(ctx.src_planes) - 1)
    return (ctx._replace(
        src_planes=tuple(p[:, a:a + c].contiguous()
                         for p, (a, c) in zip(ctx.src_planes, cut)),
        ref_stacks=tuple(s[:, :, a:a + c].contiguous()
                         for s, (a, c) in zip(ctx.ref_stacks, cut)),
        nblk=(nbx, r), padded=(ctx.padded[0], h)),
        tuple(v[:, first * nbx:(first + r) * nbx].contiguous()
              for v in vin), first)


def exact_option_runs(bits, w=SMALL_W, h=SMALL_H):
    """(name, planes (CPU), SuperSpec, AnalyseSpec, src, ref, field shift)
    of the exact engine's options at w x h: the tests' cases
    (tests/torch_port_reference.py, EX_ANALYSES) at blk 16."""
    yuv = make_test_clip_yuv(5, w, h, seed=4,
                             flash=(h // 12, w // 16, h * 5 // 6,
                                    w * 7 // 8), noise=YUV_NOISE,
                             pan=YUV_PAN, bits=bits, device="cpu")
    gfmt = VideoFormat(w, h, bits, ColorFamily.GRAY)
    yfmt = VideoFormat(w, h, bits, ColorFamily.YUV420)
    back, fwd = ([1, 2], [2, 3]), ([1, 2], [0, 1])
    runs = []

    def add(name, planes, fmt, skw, akw, jobs, isb=True, fs=0):
        sspec = SuperConfig(**skw).validate(fmt)
        aspec = dataclasses.replace(AnalyseConfig(**akw),
                                    isb=isb).validate(sspec)
        runs.append((name, planes, sspec, aspec, torch.tensor(jobs[0]),
                     torch.tensor(jobs[1]), fs))

    g = dict(chroma=False)
    add("gray hex2 truemotion 3 levels", [yuv[0]], gfmt,
        dict(pel=2, levels=3, **g),
        dict(blksize=16, levels=3, truemotion=True, **g), back)
    add("gray forward", [yuv[0]], gfmt, dict(pel=2, levels=3, **g),
        dict(blksize=16, levels=3, truemotion=True, **g), fwd, isb=False)
    add("yuv420 chroma overlap global meander", yuv, yfmt,
        dict(pel=2, levels=2, chroma=True),
        dict(blksize=16, overlap=8, levels=2, truemotion=True, chroma=True,
             global_=True, meander=True), fwd)
    add("pel 1 exhaustive", [yuv[0]], gfmt, dict(pel=1, levels=2, **g),
        dict(blksize=16, levels=2, search=SearchType.EXHAUSTIVE,
             searchparam=2, pelsearch=2, **g), back)
    add("pel 4 trymany rings divide 2", [yuv[0]], gfmt,
        dict(pel=4, levels=2, **g),
        dict(blksize=16, levels=2, trymany=True, badrange=-6, divide=2,
             truemotion=True, **g), back)
    for st in (SearchType.ONETIME, SearchType.NSTEP, SearchType.LOGARITHMIC,
               SearchType.UMH, SearchType.HORIZONTAL, SearchType.VERTICAL):
        add(st.name, [yuv[0]], gfmt, dict(pel=2, levels=1, **g),
            dict(blksize=16, levels=1, search=st, searchparam=3,
                 pelsearch=3, truemotion=True, **g), back)
    add("field shift", [yuv[0]], gfmt, dict(pel=2, levels=2, **g),
        dict(blksize=16, levels=2, truemotion=True, **g), back, fs=[1, -1])
    return runs


def exact_tie_runs(w, h):
    """(name, planes (CPU), SuperSpec, AnalyseSpec, src, ref, field shift)
    of the tie cases at w x h: flat frames (every SAD the same) and
    checkerboards of opposite phase (every odd full-pel candidate costs 0),
    truemotion off (the cost is the SAD alone), every search type at pel
    2, and trymany with the rescue on every block (badsad 0): where the
    steps' lowest costs tie, the fold must keep the first candidate."""
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    clips = {"flat": torch.stack([torch.full((h, w), v, dtype=torch.uint8)
                                  for v in (100, 100, 130, 100)]),
             "checkerboard": torch.stack([
                 (100 + 50 * ((xx + yy + t) % 2)).to(torch.uint8)
                 for t in range(4)])}
    fmt = VideoFormat(w, h, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=2, chroma=False).validate(fmt)
    src, ref = torch.tensor([1, 1]), torch.tensor([2, 0])
    runs = []
    for cname, clip in clips.items():
        for st in SearchType:
            aspec = dataclasses.replace(AnalyseConfig(
                blksize=16, levels=2, search=st, searchparam=2,
                truemotion=False, chroma=False), isb=True).validate(sspec)
            runs.append((f"ties {cname} {st.name}", [clip], sspec, aspec,
                         src, ref, 0))
        aspec = dataclasses.replace(AnalyseConfig(
            blksize=16, levels=2, trymany=True, badsad=0, truemotion=False,
            chroma=False), isb=True).validate(sspec)
        runs.append((f"ties {cname} trymany badsad 0", [clip], sspec, aspec,
                     src, ref, 0))
    return runs


def exact_vs_plain(dev):
    """K6 against its plain version, torch.equal: every option of the exact
    engine level by level (at 128x96, 8-bit; four of them also at 16
    bits; the three-level gray search also at 256x192), the plain version
    on CPU copies of the inputs, one thread; the tie cases
    (exact_tie_runs) at 128x96;
    the main path's level shapes (bench.py config 4 at 1080p) on strips of
    STRIP_ROWS block rows at every level, where the whole level's scan
    left the most blocks over badsad (the rescue runs in the level-0
    strip), the plain version on the card;
    Recalculate's per-item entry point at its 1080p
    shape (gray, blk 16 overlap 8, HEX2), and its uint16 form.  Returns
    the kernels line's case for each form."""
    from mvtools_tpu_torch.analyse import analyse_exact_jobs
    t0 = time.perf_counter()
    option_cases = []
    # every option at 128x96, 8-bit; at 16 bits the three-level gray
    # search, YUV420, pel 4 with trymany and the field shift; the
    # three-level gray search also at 256x192 (the plain version on the
    # card's host took ~100 s for every option at 256x192 at both depths)
    runs = [(8, r) for r in exact_option_runs(8, SMALL_W // 2, SMALL_H // 2)]
    runs += [(DEEP_BITS, r) for r in exact_option_runs(
        DEEP_BITS, SMALL_W // 2, SMALL_H // 2)
        if r[0].startswith(("gray hex2", "yuv420", "pel 4", "field"))]
    runs.append((8, exact_option_runs(8)[0]))
    runs += [(8, r) for r in exact_tie_runs(SMALL_W // 2, SMALL_H // 2)]
    for bits, (name, planes, sspec, aspec, src, ref, fs) in runs:
        sups = build_super([p.to(dev) for p in planes], sspec)
        levels = capture_levels(lambda: analyse_exact_jobs(
            sups.take(src.to(dev)), sups.take(ref.to(dev)), aspec, fs))
        w = planes[0].shape[-1]
        # the plain version on the CPU: the same function, faster there
        # at this size than a few hundred small launches a block
        for ctx, plan, vin, gx, gy, zs in levels:
            option_cases.append(exact_case(
                f"{name} {w}-wide {bits}-bit level {ctx.level}", ctx, plan,
                vin, gx, gy, zs, plain_dev="cpu"))
    # the main path's levels, 1080p, two jobs (a flash pair and a calm one)
    scfg, acfg, _, _ = flagship_configs()
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    clip = make_test_clip_yuv(4, W, H, seed=0, flash=FLASH, noise=YUV_NOISE,
                              pan=YUV_PAN, device=dev)
    sups = build_super(clip, sspec)
    src, ref = torch.tensor([1, 2], device=dev), torch.tensor([0, 3],
                                                               device=dev)
    levels = capture_levels(lambda: analyse_exact_jobs(
        sups.take(src), sups.take(ref), aspec))
    strips, full = [], []
    for ctx, plan, vin, gx, gy, zs in levels:
        out = []
        full.append({"level": ctx.level, "blocks": ctx.nblk[0] * ctx.nblk[1],
                     "ms": time_cuda(lambda: out.append(
                         exact_scan._launch_scan(ctx, plan, vin, gx, gy,
                                                 zs)), 1)})
        # the strip: the STRIP_ROWS block rows that hold the most blocks
        # the whole level's scan left over badsad (the flash's rows)
        nbx, nby = ctx.nblk
        bad = (out[0][0][2].reshape(-1, nby, nbx) > plan["badsad"]).sum(
            dim=(0, 2)).cpu()
        upto = torch.cat([torch.zeros(1, dtype=bad.dtype), bad.cumsum(0)])
        first = int(torch.argmax(upto[STRIP_ROWS:] - upto[:-STRIP_ROWS])) \
            if nby > STRIP_ROWS else 0
        sctx, svin, first = strip_of(ctx, vin, STRIP_ROWS, first)
        strips.append(exact_case(
            f"config 4 level {ctx.level} strip {sctx.nblk[0]}x"
            f"{sctx.nblk[1]} from row {first}", sctx, plan, svin, gx, gy,
            zs))
    # Recalculate's per-item search at 1080p: gray, blk 16 overlap 8 on a
    # blk 16 analysis, and at 16 bits (the entry point refuses 16-bit
    # clips; the kernel form is driven directly)
    item_cases = {}
    for bits in (8, DEEP_BITS):
        gfmt = VideoFormat(W, H, bits, ColorFamily.GRAY)
        gclip = make_test_clip_yuv(3, W, H, seed=1, flash=FLASH,
                                   noise=YUV_NOISE, pan=YUV_PAN, bits=bits,
                                   device=dev)[0]
        gs = SuperConfig(pel=2, levels=0, chroma=False).validate(gfmt)
        ga = AnalyseConfig(blksize=16, levels=0, truemotion=True,
                           chroma=False).validate(gs)
        rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200,
                                 chroma=False)
        rspec = rcfg.to_analyse_config().validate(gs)
        gsups = build_super([gclip], gs)
        s1, r1 = gsups.take(torch.tensor([1], device=dev)), gsups.take(
            torch.tensor([0], device=dev))
        old = analyse_batch(s1, r1, ga)
        ctx = _level_ctx(gs, rspec, 0, s1, r1)
        nbx, nby = ctx.nblk
        from mvtools_tpu_torch.recalculate import _interpolate_old_vectors
        px, py, _ = _interpolate_old_vectors(old.levels[0], ga.meta,
                                             rspec.meta, rcfg.smooth,
                                             ctx.log_pel)
        px, py = px.reshape(1, -1), py.reshape(1, -1)
        lam = rspec.lambda_ // (ctx.pel * ctx.pel)
        # recalculate's thsad, scaled by bit depth and block size
        thsad = int(rcfg.thsad * ((1 << bits) - 1) / 255.0 + 0.5) \
            * rspec.meta.blk_size_x * rspec.meta.blk_size_y // 64
        args = (ctx, rspec.search, rspec.n_search_param, px, py, lam,
                rspec.pnew, thsad)
        torch.cuda.synchronize()
        before = exact_scan.candidates
        got = exact_scan.search_blocks(*args)
        torch.cuda.synchronize()
        n_cand = int(exact_scan.candidates - before)
        ms = time_cuda(lambda: exact_scan.search_blocks(*args), 3)
        want, plain_ms = time_plain(
            lambda: exact_scan.search_blocks_plain(*args))
        err = max(compare(f"exact_vs_plain recalculate {bits}-bit {k}", a,
                          b) for k, a, b in zip("xys", got, want))
        b_ms, b_by = bound(exact_bytes(ctx, n_cand), n_cand * 2 * 256)
        name = "exact_search" + ("[u16]" if bits > 8 else "")
        item_cases[name] = {
            "case": f"recalculate 1080p {bits}-bit 1 job {nbx * nby} items",
            "candidates": n_cand, "max_abs_err": err, "ms": ms,
            "device_ms": time_device(lambda: exact_scan.search_blocks(*args),
                                     2, EXACT_KERNEL_NAMES[name]),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
    level0 = next(c for c in strips if c["level"] == 0)
    if level0["rescued"] < 1:
        raise RuntimeError("exact_vs_plain: no block of the level-0 strip "
                           "went through the rescue")
    shown = {"exact_scan": level0,
             "exact_scan[u16]": next(
                 c for c in option_cases if c["case"].startswith(
                     f"gray hex2 truemotion 3 levels {SMALL_W // 2}-wide 16")
                 and c["level"] == 0),
             **item_cases}
    emit({"phase": "exact_vs_plain", "bit_equal": True,
          "option_cases": len(option_cases),
          "tie_cases": sum(c["case"].startswith("ties ")
                           for c in option_cases),
          "option_case_max_ms": max(c["ms"] for c in option_cases),
          "strips": strips, "full_levels_ms": full,
          "recalculate_items": item_cases,
          "seconds": time.perf_counter() - t0})
    return shown


def small_end_to_end_exact(dev):
    """Every entry point of the exact engine at 128x96 on the card against
    the same code on CPU tensors (torch.equal): analyse with its default
    engine; analyse_exact_jobs on YUV420 (chroma, overlap, global_,
    meander), at 16 bits, at pel 4 with trymany, the ring rescue and
    divide 2, and with field shifts; recalculate(engine="exact") with the
    diamond; degrain_clip with its defaults (YUV420, radius 2),
    degrain1_clip, degrain1_frame and degrain_n_frame with engine="exact";
    flowfps_clip with engine="exact".  K6 must launch on the card and the
    plain version must not run there."""
    from fractions import Fraction

    from mvtools_tpu_torch.analyse import analyse_exact_jobs
    from mvtools_tpu_torch.flowfps import FlowFPSConfig
    from mvtools_tpu_torch.models.denoise import (degrain1_clip,
                                                  degrain1_frame,
                                                  degrain_n_frame)
    from mvtools_tpu_torch.models.frc import flowfps_clip
    launches, seconds = {}, {}

    def on_both(name, fn):
        t0 = time.perf_counter()
        reset_counts()
        got = fn(dev)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        if plain_calls_on_cuda():
            raise AssertionError(f"small end-to-end exact {name}: a plain "
                                 "version ran on CUDA tensors")
        if not any(launches[name][k] for k in EXACT_KERNELS):
            raise AssertionError(f"small end-to-end exact {name}: K6 never "
                                 "launched")
        want = fn("cpu")
        seconds[name] = time.perf_counter() - t0
        return got, want

    sw, sh = SMALL_W // 2, SMALL_H // 2
    runs = exact_option_runs(8, sw, sh)
    by_name = {r[0]: r for r in runs}
    for name in ("yuv420 chroma overlap global meander",
                 "pel 4 trymany rings divide 2", "field shift"):
        _, planes, sspec, aspec, src, ref, fs = by_name[name]

        def fn(d, planes=planes, sspec=sspec, aspec=aspec, src=src, ref=ref,
               fs=fs):
            sups = build_super([p.to(d) for p in planes], sspec)
            return analyse_exact_jobs(sups.take(src.to(d)),
                                      sups.take(ref.to(d)), aspec, fs)
        got, want = on_both(name, fn)
        fields_equal(f"small end-to-end exact {name}", got, want)
    name, planes, sspec, aspec, src, ref, fs = exact_option_runs(
        DEEP_BITS, sw, sh)[0]
    got, want = on_both("analyse() 16-bit", lambda d: analyse(
        build_super([planes[0].to(d)], sspec).map(lambda a: a[1]),
        build_super([planes[0].to(d)], sspec).map(lambda a: a[2]), aspec))
    fields_equal("small end-to-end exact analyse() 16-bit", got, want)
    _, planes, sspec, aspec, src, ref, _ = runs[0]
    gray = planes[0]
    rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=100, chroma=False,
                             search=SearchType.LOGARITHMIC, searchparam=2)
    rspec = rcfg.to_analyse_config().validate(sspec)

    def recalc(d):
        sups = build_super([gray.to(d)], sspec)
        s, r = sups.take(src.to(d)), sups.take(ref.to(d))
        return recalculate(s, r, analyse_exact_jobs(s, r, aspec), rspec,
                           rcfg, engine="exact")
    got, want = on_both("recalculate exact diamond", recalc)
    fields_equal("small end-to-end exact recalculate", got, want)
    yuv = make_test_clip_yuv(4, sw, sh, seed=5, flash=(8, 8, 80, 112),
                             noise=YUV_NOISE, pan=YUV_PAN, device="cpu")
    scfg, acfg, _, _ = flagship_configs()
    yfmt = VideoFormat(sw, sh, 8, ColorFamily.YUV420)
    dcfg = DegrainConfig(thsad=400)
    got, want = on_both("degrain_clip defaults radius 2", lambda d:
                        degrain_clip([p.to(d) for p in yuv], yfmt, scfg,
                                     acfg, dcfg, 2))
    planes_equal("small end-to-end exact degrain_clip", got, want)
    gfmt = VideoFormat(sw, sh, 8, ColorFamily.GRAY)
    gscfg = SuperConfig(pel=2, levels=0, chroma=False)
    gacfg = AnalyseConfig(blksize=16, levels=0, truemotion=True,
                          chroma=False)
    got, want = on_both("degrain1_clip exact", lambda d: degrain1_clip(
        [gray[:4].to(d)], gfmt, gscfg, gacfg, dcfg, engine="exact"))
    planes_equal("small end-to-end exact degrain1_clip", got, want)
    gs = gscfg.validate(gfmt)
    ab = dataclasses.replace(gacfg, isb=True).validate(gs)
    af = dataclasses.replace(gacfg, isb=False).validate(gs)
    got, want = on_both("degrain1_frame exact", lambda d: degrain1_frame(
        [gray[1].to(d)], [gray[0].to(d)], [gray[2].to(d)], gs, ab, af, dcfg,
        engine="exact"))
    planes_equal("small end-to-end exact degrain1_frame", got, want)
    got, want = on_both("degrain_n_frame exact", lambda d: degrain_n_frame(
        [gray[2].to(d)], [[gray[1].to(d)], [gray[0].to(d)]],
        [[gray[3].to(d)], [gray[4].to(d)]], gs, ab, af, dcfg,
        engine="exact", valid_b=[True, True], valid_f=[True, True]))
    planes_equal("small end-to-end exact degrain_n_frame", got, want)
    got, want = on_both("flowfps_clip exact", lambda d: flowfps_clip(
        [gray.to(d)], gfmt, Fraction(30), Fraction(60), gscfg, gacfg,
        FlowFPSConfig(maskmode=2), engine="exact"))
    if len(got) != len(want):
        raise AssertionError("small end-to-end exact flowfps_clip: frames")
    for n, (a, b) in enumerate(zip(got, want)):
        planes_equal(f"small end-to-end exact flowfps_clip frame {n}", a, b)
    emit({"phase": "small_end_to_end_exact", "size": [sw, sh],
          "bit_equal_to_cpu": True, "runs": list(launches),
          "seconds": seconds, "launches": launches})


def split_fields(frames):
    """A field-separated clip from frames ([T, H, W] per plane): field 2t
    the even rows of frame t (the top field), 2t + 1 the odd rows."""
    return [torch.stack([p[:, 0::2], p[:, 1::2]], 1).reshape(
        p.shape[0] * 2, p.shape[1] // 2, p.shape[2]).contiguous()
            for p in frames]


def small_end_to_end_fields(dev):
    """Interlaced input at 128x48 fields (of 128x96 frames) on the card
    against the same code on CPU tensors (torch.equal): degrain_clip with
    fields=True, tff=True on either engine (radius 2: shifted and
    unshifted pairs); analyse_batch with a shift per job; flowfps_clip with
    fields=True; Compensate and Flow with a field shift; Recalculate with a
    field shift (taken, not applied, as in the JAX package)."""
    from fractions import Fraction

    from mvtools_tpu_torch import compensate, flow
    from mvtools_tpu_torch.flowfps import FlowFPSConfig
    from mvtools_tpu_torch.models.denoise import field_job
    from mvtools_tpu_torch.models.frc import flowfps_clip
    sw, sh = SMALL_W // 2, SMALL_H // 2
    frames = make_test_clip_yuv(3, sw, sh, seed=6, flash=(8, 8, 80, 112),
                                noise=YUV_NOISE, pan=FIELDS_PAN,
                                device="cpu")
    fld = split_fields(frames)
    fh = sh // 2
    yfmt = VideoFormat(sw, fh, 8, ColorFamily.YUV420)
    scfg, acfg, dcfg, _ = flagship_configs()
    facfg = dataclasses.replace(acfg, fields=True, tff=True)
    launches = {}
    for engine in ("lockstep", "exact"):
        reset_counts()
        got = degrain_clip([p.to(dev) for p in fld], yfmt, scfg, facfg,
                           dcfg, 2, engine=engine)
        launches[f"degrain_clip {engine}"] = read_counts()
        if plain_calls_on_cuda():
            raise AssertionError("small end-to-end fields: a plain version "
                                 "ran on CUDA tensors")
        want = degrain_clip(fld, yfmt, scfg, facfg, dcfg, 2, engine=engine)
        planes_equal(f"small end-to-end fields degrain_clip {engine}", got,
                     want)
    gfmt = VideoFormat(sw, fh, 8, ColorFamily.GRAY)
    gs = SuperConfig(pel=2, levels=0, chroma=False).validate(gfmt)
    ga = AnalyseConfig(blksize=16, levels=0, truemotion=True, chroma=False,
                       fields=True, tff=True).validate(gs)
    src, ref, fs = [1, 1, 2, 3], [0, 2, 1, 1], [-1, -1, 0, 1]

    def batch(d):
        sups = build_super([fld[0].to(d)], gs)
        return sups, analyse_batch(sups.take(torch.tensor(src, device=d)),
                                   sups.take(torch.tensor(ref, device=d)),
                                   ga, field_shift=fs)
    (sg, mg), (sc, mc) = batch(dev), batch("cpu")
    fields_equal("small end-to-end fields analyse_batch", mg, mc)
    meta = ga.meta
    for shift in (1, -1):
        a = compensate.compensate(sg.map(lambda t: t[1]),
                                  sg.map(lambda t: t[0]),
                                  field_job(mg, 0), meta,
                                  compensate.CompensateConfig(),
                                  field_shift=shift)
        b = compensate.compensate(sc.map(lambda t: t[1]),
                                  sc.map(lambda t: t[0]),
                                  field_job(mc, 0), meta,
                                  compensate.CompensateConfig(),
                                  field_shift=shift)
        planes_equal(f"small end-to-end fields compensate {shift}", a, b)
        a = flow.flow([fld[0][1].to(dev)], sg.map(lambda t: t[0]),
                      field_job(mg, 0), meta, flow.FlowConfig(time=50.0),
                      shift)
        b = flow.flow([fld[0][1]], sc.map(lambda t: t[0]), field_job(mc, 0),
                      meta, flow.FlowConfig(time=50.0), shift)
        planes_equal(f"small end-to-end fields flow {shift}", a, b)
    rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=100, chroma=False)
    rspec = rcfg.to_analyse_config().validate(gs)
    s2 = sg.take(torch.tensor(src, device=dev))
    r2 = sg.take(torch.tensor(ref, device=dev))
    a = recalculate(s2, r2, mg, rspec, rcfg, field_shift=1)
    b = recalculate(s2, r2, mg, rspec, rcfg)
    for la, lb in zip(a.levels, b.levels):
        if not torch.equal(la.x, lb.x) or not torch.equal(la.sad, lb.sad):
            raise AssertionError("small end-to-end fields: Recalculate "
                                 "applied a field shift")
    got = flowfps_clip([fld[0].to(dev)], gfmt, Fraction(30), Fraction(60),
                       SuperConfig(pel=2, levels=0, chroma=False),
                       AnalyseConfig(blksize=16, levels=0, truemotion=True,
                                     chroma=False, fields=True, tff=True),
                       FlowFPSConfig(maskmode=2))
    want = flowfps_clip([fld[0]], gfmt, Fraction(30), Fraction(60),
                        SuperConfig(pel=2, levels=0, chroma=False),
                        AnalyseConfig(blksize=16, levels=0, truemotion=True,
                                      chroma=False, fields=True, tff=True),
                        FlowFPSConfig(maskmode=2))
    for n, (a, b) in enumerate(zip(got, want)):
        planes_equal(f"small end-to-end fields flowfps_clip frame {n}", a, b)
    emit({"phase": "small_end_to_end_fields", "size": [sw, fh],
          "fields": fld[0].shape[0], "bit_equal_to_cpu": True,
          "launches": launches})


def k6_device_ms(fn, name=None):
    """((device ms of K6's form `name`, its launches, the device ms of
    every kernel, every kernel's launches) in one traced run of fn(), the
    run's output): torch.profiler; None where the trace shows no device
    time.  With no `name`, the first two are None and 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k6 = [e for e in rows
          if name is not None and re.search(EXACT_KERNEL_NAMES[name], e.key)]
    us = sum(e.self_device_time_total for e in k6)
    busy = sum(e.self_device_time_total for e in rows)
    return (us / 1e3 if us > 0 else None, sum(e.count for e in k6),
            busy / 1e3 if busy > 0 else None,
            sum(e.count for e in rows)), out


def merged_directions():
    """Whether the package driven hands both directions' jobs to one
    exact-engine call (a tree given by --package-root may predate it)."""
    from mvtools_tpu_torch.models import denoise
    return hasattr(denoise, "_analyse_both")


def run_exact_clip(phase, clip, cfgs, bits, radius):
    """degrain_clip with its default engine (exact) over a full-width
    YUV420 clip: a warm-up traced by torch.profiler (K6's device ms), then
    one run with every count set to 0 just before and read just
    after; checks the output (the input's shape and dtype, on the card,
    the luma changed, at 8 bits every plane; K6 launched, no lockstep
    search kernel); prints and returns the phase's numbers."""
    scfg, acfg, dcfg, _ = cfgs
    fmt = VideoFormat(W, H, bits, ColorFamily.YUV420)
    name = "exact_scan" + ("[u16]" if bits > 8 else "")
    (k6_ms, k6_launches, busy_ms, device_launches), _ = k6_device_ms(
        lambda: degrain_clip(clip, fmt, scfg, acfg, dcfg, radius), name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    out = degrain_clip(clip, fmt, scfg, acfg, dcfg, radius, info=info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    plain_on_cuda = plain_calls_on_cuda()
    rescued = int(exact_scan.rescued_blocks)
    candidates = int(exact_scan.candidates)
    steps = int(exact_scan.serial_steps)
    peak = torch.cuda.max_memory_allocated()
    digest = hashlib.sha1()
    for got in out:
        digest.update(got.cpu().numpy().tobytes())
    changed = []
    for got, src in zip(out, clip):
        if got.shape != src.shape or got.dtype != src.dtype:
            raise AssertionError(f"{phase}: output {tuple(got.shape)} "
                                 f"{got.dtype}")
        if got.device.type != "cuda":
            raise AssertionError(f"{phase}: output not on the card")
        changed.append(not torch.equal(got, src))
    # at 16 bits the clip's fresh low bits can keep a chroma plane's pairs
    # over thsad; the luma must change at any depth
    if not changed[0] or (bits == 8 and not all(changed)):
        raise AssertionError(f"{phase}: planes changed {changed}")
    if plain_on_cuda:
        raise AssertionError(f"{phase}: {plain_on_cuda} plain-version "
                             "calls on CUDA tensors")
    if counts[name] < 1:
        raise AssertionError(f"{phase}: K6 never launched {counts}")
    levels = len(info["fields_b"].levels)
    # both directions' jobs in one call: one launch a level (a package
    # given by --package-root may predate that: one a level a direction)
    per_level = 1 if merged_directions() else 2
    if counts[name] != per_level * levels:
        raise AssertionError(f"{phase}: {counts[name]} K6 launches for "
                             f"{levels} levels")
    lockstep = {k: counts[k] for k in counts
                if k.startswith(("sad_map", "probe_sads")) and counts[k]}
    if lockstep:
        raise AssertionError(f"{phase}: a lockstep search kernel ran "
                             f"{lockstep}")
    if rescued < 1:
        raise AssertionError(f"{phase}: the flash made no block bad")
    frames = clip[0].shape[0]
    res = {"phase": phase, "size": [W, H], "format": "YUV420", "bits": bits,
           "engine": "exact", "frames": frames, "radius": radius,
           "levels": levels, "planes_changed": changed,
           "output_sha1": digest.hexdigest(),
           "analyse_jobs": 2 * radius * frames,
           "frames_per_s": frames / seconds, "seconds": seconds,
           "stage_ms": stage_ms(info), "k6_device_ms": k6_ms,
           "k6_launches_traced": k6_launches,
           "device_busy_ms_traced": busy_ms,
           "device_launches_traced": device_launches,
           "rescued_blocks": rescued,
           "candidates": candidates, "serial_steps": steps,
           "k6_launches": counts[name], "launches": counts,
           "peak_memory_bytes": peak, "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


def run_exact_paths(dev):
    """exact_main_path: degrain_clip with its default engine on bench.py
    config 4 at levels=0 (1920x1080 YUV420, blk 16 overlap 8, pel 2,
    chroma, radius 3) on 8 frames with the gray headline's 256x256 flash;
    exact_main_path16: the same at 16 bits on 4 frames at radius 1;
    exact_recalc_path: Recalculate(engine="exact") at 1080p (blk 16
    overlap 8) on the main path's level-0 fields of 8 jobs."""
    cfgs = flagship_configs()
    res = {}
    for phase, bits, frames, radius in (("exact_main_path", 8, EXACT_T, 3),
                                        ("exact_main_path16", DEEP_BITS,
                                         EXACT16_T, 1)):
        clip = make_test_clip_yuv(frames, W, H, seed=0, flash=FLASH,
                                  noise=YUV_NOISE, pan=YUV_PAN, bits=bits,
                                  device=dev)
        res[phase] = run_exact_clip(phase, clip, cfgs, bits, radius)
        if bits == 8:
            keep = clip
        del clip
    # Recalculate's exact engine on the first 8 backward jobs
    scfg, acfg, _, _ = cfgs
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=True).validate(sspec)
    from mvtools_tpu_torch.analyse import analyse_exact_jobs
    sups = build_super(keep, sspec)
    src = torch.arange(0, EXACT_T - 1, device=dev)
    s, r = sups.take(src), sups.take(src + 1)
    old = analyse_exact_jobs(s, r, aspec)
    rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200, chroma=True)
    rspec = rcfg.to_analyse_config().validate(sspec)
    recalculate(s, r, old, rspec, rcfg, engine="exact")      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mv = recalculate(s, r, old, rspec, rcfg, engine="exact")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if counts["exact_search"] < 1 or plain_calls_on_cuda():
        raise AssertionError(f"exact_recalc_path: {counts}")
    res["exact_recalc_path"] = {
        "phase": "exact_recalc_path", "size": [W, H], "jobs": s.planes[0][0]
        .shape[0], "blocks_per_job": mv.levels[0].x[0].numel(),
        "pairs_per_s": s.planes[0][0].shape[0] / seconds,
        "seconds": seconds, "candidates": int(exact_scan.candidates),
        "launches": counts}
    emit(res["exact_recalc_path"])
    del keep, sups
    torch.cuda.empty_cache()
    return res


def run_fields_path(dev):
    """fields_main_path: config 4 (1920x540 fields, blk 16 overlap 8, pel
    2, chroma, levels=0) with fields=True, tff=True, radius 2, the lockstep
    engine, on 12 fields separated from 6 frames of make_test_clip_yuv with
    the flash (even rows the top field, FIELDS_PAN): odd deltas are shifted
    by half a line, even ones not.  One warm-up, then one run."""
    scfg, acfg, dcfg, _ = flagship_configs()
    acfg = dataclasses.replace(acfg, fields=True, tff=True)
    frames = make_test_clip_yuv(FIELDS_FRAMES, W, H, seed=0, flash=FLASH,
                                noise=YUV_NOISE, pan=FIELDS_PAN, device=dev)
    clip = split_fields(frames)
    del frames
    fh = H // 2
    fmt = VideoFormat(W, fh, 8, ColorFamily.YUV420)
    degrain_clip(clip, fmt, scfg, acfg, dcfg, 2, engine="lockstep")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    info = {}
    t0 = time.perf_counter()
    out = degrain_clip(clip, fmt, scfg, acfg, dcfg, 2, engine="lockstep",
                       info=info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    changed = [not torch.equal(got, src) for got, src in zip(out, clip)]
    if (any(got.shape != src.shape or got.device.type != "cuda"
            for got, src in zip(out, clip)) or not changed[0]):
        raise AssertionError(f"fields_main_path: output {changed}")
    if min(counts[k] for k in ("sad_map", "fetch_blocks_tiled")) < 1 \
            or plain_calls_on_cuda():
        raise AssertionError(f"fields_main_path: {counts}")
    n = clip[0].shape[0]
    # a pair (t, t +- k) is shifted by half a line where k is odd
    res = {"phase": "fields_main_path", "size": [W, fh], "format": "YUV420",
           "fields": n, "radius": 2, "engine": "lockstep", "tff": True,
           "shifted_pairs": 2 * n, "unshifted_pairs": 2 * n,
           "planes_changed": changed,
           "frames_per_s": n / seconds, "seconds": seconds,
           "stage_ms": stage_ms(info), "launches": counts,
           "peak_memory_bytes": peak}
    emit(res)
    del clip, out
    torch.cuda.empty_cache()
    return res


def psnr(a, b, peak=255.0):
    """bench.py's _psnr: 10 log10(peak^2 / MSE) over the whole arrays, 99
    where they are equal."""
    import math
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 99.0 if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def psnr_vs_exact(dev):
    """bench.py's psnr_vs_exact_512x288 of configs 4 and 5 on the card,
    computed as bench.py:206-215, 247-265 compute it: the lockstep
    engine's output against the exact engine's on a 512x288 clip of panned
    uniform noise (numpy generator seeded 0)."""
    import numpy as np

    from mvtools_tpu_torch.flowfps import FlowFPSConfig, flowfps_frame
    rng = np.random.default_rng(0)

    def gray_clip(t, w, h):
        base = rng.integers(0, 256, (h + 32, w + 32), np.uint8)
        return torch.from_numpy(np.stack(
            [base[(i * 2) % 16:(i * 2) % 16 + h,
                  (i * 3) % 16:(i * 3) % 16 + w] for i in range(t)])).to(dev)

    sw, sh = 512, 288
    # config 4 as bench.py runs it (levels=3, its compile-budget depth)
    scfg = SuperConfig(pel=2, levels=3, chroma=True)
    acfg = AnalyseConfig(blksize=16, levels=3, overlap=8, truemotion=True,
                         chroma=True)
    dcfg = DegrainConfig(thsad=400)
    small = [gray_clip(6, sw, sh), gray_clip(6, sw // 2, sh // 2),
             gray_clip(6, sw // 2, sh // 2)]
    sfmt = VideoFormat(sw, sh, 8, ColorFamily.YUV420)
    lock = degrain_clip(small, sfmt, scfg, acfg, dcfg, radius=3,
                        engine="lockstep")
    exact = degrain_clip(small, sfmt, scfg, acfg, dcfg, radius=3,
                         engine="exact")
    c4 = psnr(lock[0], exact[0])
    # config 5: one interpolated frame at time 128
    sclip = gray_clip(3, sw, sh)
    sspec = SuperConfig(pel=2, levels=0, chroma=False).validate(
        VideoFormat(sw, sh, 8, ColorFamily.GRAY))
    acfg5 = AnalyseConfig(blksize=16, levels=0, truemotion=True,
                          chroma=False)
    ab = dataclasses.replace(acfg5, isb=True).validate(sspec)
    af = dataclasses.replace(acfg5, isb=False).validate(sspec)
    sa = build_super([sclip[0]], sspec)
    sb = build_super([sclip[1]], sspec)
    outs = {}
    for eng in ("lockstep", "exact"):
        mv_b = analyse(sa, sb, ab, engine=eng)
        mv_f = analyse(sb, sa, af, engine=eng)
        outs[eng] = flowfps_frame([sclip[0]], [sclip[1]], sa, sb, mv_b, mv_f,
                                  ab.meta, FlowFPSConfig(maskmode=2),
                                  128)[0]
    c5 = psnr(outs["lockstep"], outs["exact"])
    res = {"phase": "psnr_vs_exact_512x288",
           "config4_psnr_vs_exact_512x288": round(c4, 2),
           "config5_psnr_vs_exact_512x288": round(c5, 2),
           "config4": "bench.py config 4 (levels=3), 6 frames, radius 3, "
                      "luma of every frame",
           "config5": "bench.py config 5, frames 0 and 1, time 128"}
    emit(res)
    return res


# ---- Depan, stabilisation and the command line (the fifteenth slice) ------

# stabilise_main_path: 24 frames of 1080p YUV420, a random-walk pan of 1-6
# px a frame with fractional steps, a scene cut at frame 12; the card's
# stabilisation is held to the CPU's on STAB_CPU_T frames of it.  Besides
# frame 0 and the cut, DepanEstimate's stage 3 drops a frame whose trust is
# under 2*trust and under half a neighbour's: on a noise texture a step
# near half a pixel on both axes spreads the correlation peak (seed 0:
# frames 4 and 14, trust 7.72 and 7.97 beside 15.58 and 16.15, the JAX
# package's depan_estimate on the CPU giving the same four frames), so the
# card's untrusted frames must be the CPU's, the cut among them
STAB_T, STAB_CUT, STAB_CPU_T = 24, 12, 8
# depan_analyse_path: 8 frames, each the first warped by k times this
# motion (dx, dy px, rotation degrees, zoom) about the centre; the fitted
# motion must come within DEPAN_KNOWN_TOL of it (the reference's descent
# stops once the error falls by less than 0.005 a step)
DEPAN_T, DEPAN_KNOWN = 8, (2.6, -1.7, 0.35, 1.006)
DEPAN_KNOWN_TOL = (0.1, 0.1, 0.1, 0.002)
# card against CPU: the CPU tests' tolerances
# (tests/test_torch_depan_estimate.py: EST_TOL, TRUST_TOL relative,
# ANALYSE_TOL)
EST_TOL, TRUST_TOL, ANALYSE_TOL = 1e-4, 1e-4, 1e-4
# cli_main_path: a 10-frame 1080p YUV420 y4m through four pipelines
CLI_T = 10
CLI_PIPES = ("degrain3", "flowfps", "stabilise", "depancompensate")


def has_depan():
    """Whether the package driven has the Depan quartet (a tree given by
    --package-root may predate it)."""
    try:
        import mvtools_tpu_torch.depan  # noqa: F401
    except ImportError:
        return False
    return True


def noise_texture(rng, h, w, dev, smooth):
    """A uint8-valued float32 noise plane from a numpy generator, box
    filtered 3x3 where `smooth` (block matching at half a pixel needs a
    texture the warps can interpolate; phase correlation the raw one)."""
    t = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(
        "float32")).to(dev)
    if smooth:
        t = torch.nn.functional.avg_pool2d(t[None, None], 3, 1, 1,
                                           count_include_pad=False)[0, 0]
    return t


def pan_clip_yuv(n, w, h, seed, dev, cut=None):
    """n YUV420 frames (lists of uint8 planes on `dev`) of a noise texture
    under a random-walk pan of 1-6 px a frame on each axis with
    fractional steps (bilinear resampling), turning back beyond 40 px; a
    new texture from frame `cut` on.  Returns (frames, positions)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    margin = 64
    tex = noise_texture(rng, h + 2 * margin, w + 2 * margin, dev, False)
    pos = np.zeros(2)
    frames, positions = [], []
    for i in range(n):
        if i == cut:
            tex = noise_texture(rng, h + 2 * margin, w + 2 * margin, dev,
                                False)
        if i:
            sign = np.where(pos > 40, -1, np.where(pos < -40, 1,
                                                   rng.choice([-1, 1], 2)))
            pos = pos + sign * rng.uniform(1, 6, 2)
        positions.append(pos.tolist())
        y0, x0 = margin + pos
        iy, ix = int(np.floor(y0)), int(np.floor(x0))
        fy, fx = float(y0 - iy), float(x0 - ix)
        t = tex
        y = (t[iy:iy + h, ix:ix + w] * (1 - fy) * (1 - fx)
             + t[iy + 1:iy + 1 + h, ix:ix + w] * fy * (1 - fx)
             + t[iy:iy + h, ix + 1:ix + 1 + w] * (1 - fy) * fx
             + t[iy + 1:iy + 1 + h, ix + 1:ix + 1 + w] * fy * fx)
        y = y.round().clamp(0, 255).to(torch.uint8)
        frames.append([y, (y[::2, ::2] // 2 + 40).contiguous(),
                       (y[1::2, 1::2] // 2 + 60).contiguous()])
    return frames, positions


def event_ms(events):
    return {k: a.elapsed_time(b) for k, (a, b) in events.items()}


def frames_equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for fa, fb in zip(a, b)
               for x, y in zip(fa, fb))


def estimate_vs_cpu(luma, ecfg):
    """depan_estimate on the card and on the CPU: equal peak positions on
    every frame the CPU trusts (a scene cut's surface has no peak to
    agree on), dx / dy / zoom within EST_TOL, trust within TRUST_TOL
    (relative)."""
    from mvtools_tpu_torch.depan import depan_estimate
    card = depan_estimate(luma, ecfg, return_correl=True)
    cpu = depan_estimate(luma.cpu(), ecfg, return_correl=True)
    trusted = cpu[3] >= ecfg.trust
    peaks_equal = all(
        torch.equal(c.reshape(c.shape[0], -1).argmax(1).cpu()[trusted],
                    p.reshape(p.shape[0], -1).argmax(1)[trusted])
        for c, p in zip(card[4], cpu[4]))
    err = {name: float((c.cpu() - p).abs().max())
           for name, c, p in zip(("dx", "dy", "zoom"), card, cpu)}
    trust_rel = float(((card[3].cpu() - cpu[3]).abs()
                       / cpu[3].abs().clamp(min=1e-30)).max())
    if not peaks_equal or max(err.values()) > EST_TOL \
            or trust_rel > TRUST_TOL:
        raise AssertionError(f"depan_estimate card vs CPU: peaks equal "
                             f"{peaks_equal}, {err}, trust {trust_rel}")
    return dict(peaks_equal=peaks_equal, peaks_compared=int(trusted.sum()),
                max_abs_err=err, trust_max_rel_err=trust_rel,
                cpu_untrusted_frames=[int(k) for k in
                                      torch.nonzero(cpu[0] == 0)[:, 0]])


def run_stabilise_path(dev, seed):
    """stabilise_main_path: models.stabilize.stabilize_clip on STAB_T
    frames of 1080p YUV420 (pan_clip_yuv, a cut at STAB_CUT), method 0
    and method 1 (prev 1, next 1, mirror 15, bicubic); per method one
    warm-up, then one run with every count set to 0 just before it and
    read just after (host clock, CUDA events per stage, peak memory), and
    one traced run for the device launches.  Card against CPU: the motions
    within the CPU tests' tolerances, and depan_stabilise given the same
    motions torch.equal on the first STAB_CPU_T frames."""
    import numpy as np

    from mvtools_tpu_torch import depan
    from mvtools_tpu_torch.models.stabilize import stabilize_clip
    frames, positions = pan_clip_yuv(STAB_T, W, H, seed, dev, STAB_CUT)
    ecfg = depan.DepanEstimateConfig()
    luma = torch.stack([f[0] for f in frames]).to(torch.float32)
    vs_cpu = {"estimate": estimate_vs_cpu(luma, ecfg)}
    res = {"phase": "stabilise_main_path", "size": [W, H],
           "format": "YUV420", "frames": STAB_T, "cut_at": STAB_CUT,
           "seed": seed, "methods": {}}
    for method, kw in ((0, {}), (1, dict(prev=1, next=1, mirror=15,
                                         subpixel=2))):
        scfg = depan.DepanStabiliseConfig(method=method, **kw)

        def run(info=None):
            return stabilize_clip(frames, ecfg, scfg, 1, 1, info=info)

        run()                                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        info = {}
        t0 = time.perf_counter()
        out = run(info)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        (_, _, busy_ms, launches), _ = k6_device_ms(run)
        motions = info["motions"]
        if (len(out) != STAB_T or any(
                p.shape != q.shape or p.dtype != torch.uint8
                or p.device.type != dev.type
                for fo, fi in zip(out, frames) for p, q in zip(fo, fi))):
            raise AssertionError("stabilise_main_path: output shape")
        untrusted = [int(k) for k in np.flatnonzero(motions[:, 0] == 0)]
        if (untrusted != vs_cpu["estimate"]["cpu_untrusted_frames"]
                or STAB_CUT not in untrusted):
            raise AssertionError(f"stabilise_main_path: untrusted frames "
                                 f"{untrusted}, the CPU's {vs_cpu}")
        if plain_calls_on_cuda():
            raise AssertionError("stabilise_main_path: a plain version ran "
                                 "on the card")
        # card against CPU: the same motions, the same frames
        short = motions[:STAB_CPU_T]
        card = depan.depan_stabilise(frames[:STAB_CPU_T], short, scfg, 1, 1)
        cpu = depan.depan_stabilise([[p.cpu() for p in f]
                                     for f in frames[:STAB_CPU_T]], short,
                                    scfg, 1, 1)
        if not frames_equal(card, cpu):
            raise AssertionError(f"stabilise_main_path: method {method}, "
                                 "card and CPU differ")
        steps = np.diff(np.array(positions), axis=0)
        res["methods"][str(method)] = {
            "config": dict(method=method, **kw),
            "frames_per_s": STAB_T / seconds, "seconds": seconds,
            "stage_ms": event_ms(info.get("events", {})),
            "device_launches": launches, "device_busy_ms": busy_ms,
            "repo_kernel_launches": counts, "peak_memory_bytes": peak,
            "trusted_motions": STAB_T - len(untrusted),
            "untrusted_frames": untrusted,
            "dx_first": [round(float(v), 4) for v in motions[1:5, 0]],
            "pan_steps_first": [round(float(-v), 4) for v in steps[:4, 1]],
            "card_vs_cpu_stabilise_equal_frames": STAB_CPU_T}
    res["card_vs_cpu"] = vs_cpu
    emit(res)
    return res


def run_depan_analyse_path(dev, seed):
    """depan_analyse_path: DEPAN_T frames of 1080p YUV420, frame k the
    first warped by k times DEPAN_KNOWN (ops/warp.py's bicubic, mirrored
    edges); Super -> analyse_batch (lockstep: K1, and K2 where a block
    goes bad) on the forward pairs (k, k - 1) -> depan_analyse (zoom and
    rotation on) -> depan_compensate (offset -1: frame k + 1 brought back
    onto frame k), with every count set to 0 just before and read just
    after.  Card against CPU: the motion of every pair within ANALYSE_TOL,
    the compensated planes given the same motions torch.equal, and the
    rotation-branch warp in each subpixel mode torch.equal."""
    import numpy as np

    from mvtools_tpu_torch import depan
    from mvtools_tpu_torch.models.denoise import field_job
    from mvtools_tpu_torch.ops import warp
    rng = np.random.default_rng(seed + 1)
    first = [noise_texture(rng, H >> s, W >> s, dev, True).round().to(
        torch.uint8) for s in (0, 1, 1)]
    step = warp.motion2transform(*DEPAN_KNOWN[:2], DEPAN_KNOWN[2],
                                 DEPAN_KNOWN[3], 1.0, W / 2, H / 2, True,
                                 1.0)
    tr = warp.null_transform()
    frames = []
    for k in range(DEPAN_T):
        frames.append([warp.warp_plane(
            p, warp.transform_for_plane(tr, 1, 1) if i else tr, 2, 15, -1,
            0, 255) for i, p in enumerate(first)])
        tr = warp.sumtransform(tr, step)
    # the rotation branch card against CPU, each subpixel mode
    rot_equal = all(torch.equal(
        warp.warp_plane(first[0], step, sp, 15, -1, 2, 255).cpu(),
        warp.warp_plane(first[0].cpu(), step, sp, 15, -1, 2, 255))
        for sp in (0, 1, 2))
    if not warp.is_rotation(step) or not rot_equal:
        raise AssertionError("depan_analyse_path: the rotation warp differs "
                             "card against CPU")

    scfg, acfg, _, _ = flagship_configs()
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = dataclasses.replace(acfg, isb=False).validate(sspec)
    clip = [torch.stack([f[p] for f in frames]) for p in range(3)]
    src = torch.arange(1, DEPAN_T, device=dev)
    cfg = depan.DepanAnalyseConfig()
    ccfg = depan.DepanCompensateConfig(offset=-1.0)

    def chain(events=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        sups = build_super(clip, sspec)
        ev[1].record()
        mv = analyse_batch(sups.take(src), sups.take(src - 1), aspec)
        ev[2].record()
        motions = np.zeros((DEPAN_T, 4), np.float32)
        motions[0] = (0.0, 0.0, 1.0, 0.0)
        for j in range(DEPAN_T - 1):
            motions[j + 1] = depan.depan_analyse(field_job(mv, j), aspec.meta,
                                                 cfg)
        ev[3].record()
        comp = [depan.depan_compensate(frames[k + 1], motions, k, DEPAN_T,
                                       ccfg, 1, 1) for k in range(DEPAN_T - 1)]
        ev[4].record()
        if events is not None:
            events.update(super=(ev[0], ev[1]), analyse=(ev[1], ev[2]),
                          depan_analyse=(ev[2], ev[3]),
                          depan_compensate=(ev[3], ev[4]))
        return mv, motions, comp

    chain()                                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    syncs0 = depan.host_syncs
    events = {}
    t0 = time.perf_counter()
    mv, motions, comp = chain(events)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    syncs = depan.host_syncs - syncs0
    peak = torch.cuda.max_memory_allocated()
    if counts["sad_map"] < 1 or plain_calls_on_cuda():
        raise AssertionError(f"depan_analyse_path: {counts}")
    err = np.abs(motions[1:] - np.array([DEPAN_KNOWN[0], DEPAN_KNOWN[1],
                                         DEPAN_KNOWN[3], DEPAN_KNOWN[2]],
                                        np.float32)).max(axis=0)
    tol = np.array([DEPAN_KNOWN_TOL[0], DEPAN_KNOWN_TOL[1],
                    DEPAN_KNOWN_TOL[3], DEPAN_KNOWN_TOL[2]])
    if (err > tol).any():
        raise AssertionError(f"depan_analyse_path: fitted motions {motions} "
                             f"against {DEPAN_KNOWN}")
    # compensation brings frame k + 1 back onto frame k: inside a 64 px
    # margin the compensated frame is closer to frame k than frame k + 1 is
    inner = (slice(64, H - 64), slice(64, W - 64))

    def mad(a, b):
        return float((a[inner].float() - b[inner].float()).abs().mean())

    before = [mad(frames[k + 1][0], frames[k][0]) for k in range(DEPAN_T - 1)]
    after = [mad(comp[k][0], frames[k][0]) for k in range(DEPAN_T - 1)]
    if not all(a < b / 2 for a, b in zip(after, before)):
        raise AssertionError(f"depan_analyse_path: compensation {after} "
                             f"against {before}")
    # card against CPU: the motions, and the compensation given them
    def cpu_field(j):
        f = field_job(mv, j)
        return MVField(tuple(MVPlaneField(l.x.cpu(), l.y.cpu(), l.sad.cpu())
                             for l in f.levels), f.validity.cpu(), f.meta)

    cpu_motion_err = max(
        float(np.abs(np.array(depan.depan_analyse(cpu_field(j), aspec.meta,
                                                  cfg))
                     - motions[j + 1]).max())
        for j in range(DEPAN_T - 1))
    if cpu_motion_err > ANALYSE_TOL:
        raise AssertionError(f"depan_analyse_path: the CPU's motions differ "
                             f"by {cpu_motion_err}")
    comp_equal = all(frames_equal(
        [comp[k]], [depan.depan_compensate([p.cpu() for p in frames[k + 1]],
                                           motions, k, DEPAN_T, ccfg, 1, 1)])
        for k in (0, DEPAN_T - 2))
    if not comp_equal:
        raise AssertionError("depan_analyse_path: compensation differs card "
                             "against CPU")
    ms = event_ms(events)
    res = {"phase": "depan_analyse_path", "size": [W, H], "format": "YUV420",
           "frames": DEPAN_T, "pairs": DEPAN_T - 1,
           "known_motion": dict(zip(("dx", "dy", "rot", "zoom"),
                                    DEPAN_KNOWN)),
           "fitted_motions": [[round(float(v), 5) for v in m]
                              for m in motions[1:]],
           "fitted_max_abs_err": dict(zip(("dx", "dy", "zoom", "rot"),
                                          map(float, err))),
           "host_syncs_per_frame": syncs / (DEPAN_T - 1),
           "depan_analyse_ms_per_frame": ms["depan_analyse"] / (DEPAN_T - 1),
           "depan_compensate_ms_per_frame":
               ms["depan_compensate"] / (DEPAN_T - 1),
           "stage_ms": ms, "seconds": seconds,
           "frames_per_s": (DEPAN_T - 1) / seconds,
           "launches": counts, "peak_memory_bytes": peak,
           "compensated_mean_abs_diff": after,
           "uncompensated_mean_abs_diff": before,
           "card_vs_cpu": {"motion_max_abs_err": cpu_motion_err,
                           "compensate_equal": comp_equal,
                           "rotation_warp_equal": rot_equal}}
    emit(res)
    return res


def run_cli_path(dev, seed):
    """cli_main_path: a 1080p YUV420 y4m of CLI_T frames (pan_clip_yuv)
    in a temporary directory through `python3 -m mvtools_tpu_torch.cli`
    on the card for each of CLI_PIPES: every output a y4m of the right
    frame count and size; degrain3 and stabilise byte for byte the
    in-process calls of the same functions on the card."""
    import tempfile

    import numpy as np

    from mvtools_tpu_torch.core.config import (AnalyseConfig as AC,
                                               SuperConfig as SC)
    from mvtools_tpu_torch.depan import DepanStabiliseConfig
    from mvtools_tpu_torch.io import Y4MReader, Y4MWriter
    from mvtools_tpu_torch.models.denoise import degrain_n_frame
    from mvtools_tpu_torch.models.stabilize import stabilize_clip
    frames, _ = pan_clip_yuv(CLI_T, W, H, seed + 2, dev, CLI_T - 3)
    res = {"phase": "cli_main_path", "size": [W, H], "format": "YUV420",
           "frames_in": CLI_T, "runs": {}}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.y4m")
        with Y4MWriter(src, W, H, (30, 1), 2, 2, 8, 3) as wr:
            for f in frames:
                wr.write(f)
        outs = {}
        for pipe in CLI_PIPES:
            out = os.path.join(tmp, f"{pipe}.y4m")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mvtools_tpu_torch.cli", pipe, src,
                 out], cwd=root, capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"cli {pipe}: {proc.stderr[-3000:]}")
            with Y4MReader(out) as rd:
                shape = (rd.width, rd.height, rd.planes, rd.sub_w, rd.sub_h)
                got = list(rd)
            want_n = 2 * CLI_T - 1 if pipe == "flowfps" else CLI_T
            if shape != (W, H, 3, 2, 2) or len(got) != want_n:
                raise AssertionError(f"cli {pipe}: {shape}, {len(got)} "
                                     "frames")
            outs[pipe] = got
            res["runs"][pipe] = {
                "frames_out": len(got), "process_seconds": seconds,
                "frames_per_s": len(got) / seconds,
                "summary": proc.stderr.strip().splitlines()[-1]}
    # the same functions in this process, on the card
    scfg = SC(pel=2, levels=0, chroma=True)
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    acfg = AC(blksize=16, levels=0, truemotion=True, chroma=True)
    aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
    dcfg = DegrainConfig(thsad=400)
    same = {}
    for i in range(CLI_T):
        prevs = [frames[max(i - k, 0)] for k in (1, 2, 3)]
        nexts = [frames[min(i + k, CLI_T - 1)] for k in (1, 2, 3)]
        out = degrain_n_frame(frames[i], prevs, nexts, sspec, aspec_b,
                              aspec_f, dcfg,
                              valid_b=[i + k <= CLI_T - 1 for k in (1, 2, 3)],
                              valid_f=[i - k >= 0 for k in (1, 2, 3)],
                              field_shift_b=[0] * 3, field_shift_f=[0] * 3)
        if not all(np.array_equal(p.cpu().numpy(), q)
                   for p, q in zip(out, outs["degrain3"][i])):
            raise AssertionError(f"cli degrain3: frame {i} differs from the "
                                 "in-process call")
    same["degrain3"] = CLI_T
    stab = stabilize_clip(frames, scfg=DepanStabiliseConfig(fps=30.0),
                          sub_w=1, sub_h=1)
    for i, f in enumerate(stab):
        if not all(np.array_equal(p.cpu().numpy(), q)
                   for p, q in zip(f, outs["stabilise"][i])):
            raise AssertionError(f"cli stabilise: frame {i} differs from the "
                                 "in-process call")
    same["stabilise"] = CLI_T
    res["equal_to_in_process_frames"] = same
    emit(res)
    return res


PATHS = ("gray", "yuv", "yuv16", "satd", "dct", "fps", "pel4", "exact",
         "fields", "depan")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script only runs on a GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t_start = time.perf_counter()
    paths_only = "--paths-only" in sys.argv[1:]
    profile = "--profile" in sys.argv[1:]
    chosen = arg_value("--paths")
    if chosen is not None and not paths_only:
        sys.exit("chip_smoke: --paths needs --paths-only")
    chosen = None if chosen is None else chosen.split(",")
    if chosen is not None and not set(chosen) <= set(PATHS):
        sys.exit(f"chip_smoke: --paths takes names of {PATHS}")

    def wants(name):
        return chosen is None or name in chosen

    # ---- build ------------------------------------------------------------
    build_s = cuda_build.build_all(verbose=True)
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    emit({"phase": "build", "seconds": build_s,
          "sources": [f"mvtools_tpu_torch/csrc/{n}.cu"
                      for n in cuda_build.SOURCES]})
    sass_phase()

    # ---- kernels against their plain versions -----------------------------
    sspec, aspec, dcfg = headline_specs(W, H)
    cfgs = flagship_configs()
    gray_kernels = ("sad_map", "probe_sads_tiled", "fetch_blocks_tiled")
    if not paths_only:
        shown = kernels_vs_plain(dev)
        shown.update(deep_kernels_vs_plain(cfgs, dev))
        dct_vs_cpu(dev)
        # ---- small end-to-end: card against the same code on the CPU ------
        small_end_to_end(dev)
        small_end_to_end_yuv(cfgs, dev)
        small_end_to_end_yuv16(cfgs, dev)
        small_end_to_end_satd(dev)
        small_end_to_end_dct(dev)
        small_end_to_end_fps(dev)
        small_end_to_end_pel4(dev)
        shown.update(exact_vs_plain(dev))
        small_end_to_end_exact(dev)
        small_end_to_end_fields(dev)
    else:
        u8_kernel_times(cfgs, dev)
        redesigned_kernel_times(dev)

    # ---- gray main path at full width ---------------------------------------
    if wants("gray"):
        n_windows = 2
        frames = make_test_clip(BATCH * (n_windows + 1) + 2 * RADIUS, W, H,
                                seed=0, flash=FLASH, device=dev)
        windows = [frames[i * BATCH:i * BATCH + BATCH + 2 * RADIUS]
                   for i in range(n_windows + 1)]
        degrain_window(windows[0], sspec, aspec, dcfg, RADIUS)    # warm-up
        hot = run_windows("main_path", windows[1:], sspec, aspec, dcfg,
                          changes_pixels=True)
        gray_counts = hot["launches"]
        if min(gray_counts[k] for k in gray_kernels) < 1:
            raise AssertionError(f"main path: a kernel never launched "
                                 f"{gray_counts}")

        # the same path on the clip without the flashing region: no block is
        # bad, so the rescue (and the probe kernel) must stay out of it
        plain_clip = make_test_clip(BATCH * n_windows + 2 * RADIUS, W, H,
                                    seed=0, device=dev)
        calm = run_windows(
            "main_path_no_rescue",
            [plain_clip[i * BATCH:i * BATCH + BATCH + 2 * RADIUS]
             for i in range(n_windows)], sspec, aspec, dcfg,
            changes_pixels=False)
        if calm["launches"]["probe_sads_tiled"] != 0:
            raise AssertionError("main path without bad blocks: the rescue "
                                 "ran")
        if profile:
            profile_run("main_path", lambda: degrain_window(
                windows[1], sspec, aspec, dcfg, RADIUS))
            profile_run("main_path_no_rescue", lambda: degrain_window(
                plain_clip[:BATCH + 2 * RADIUS], sspec, aspec, dcfg, RADIUS))
        del frames, windows, plain_clip
        torch.cuda.empty_cache()

    # ---- YUV420 main path at full width ------------------------------------
    if wants("yuv"):
        fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
        flash_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, flash=YUV_FLASH,
                                        noise=YUV_NOISE, pan=YUV_PAN,
                                        device=dev)
        degrain_clip(flash_clip, fmt, *cfgs, engine="lockstep")       # warm-up
        yuv = run_yuv_clip("yuv_main_path", flash_clip, cfgs)
        counts = yuv["launches"]
        if min(counts[k] for k in PLAIN_KERNELS) < 1:
            raise AssertionError(f"yuv main path: a kernel never launched "
                                 f"{counts}")
        calm_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, noise=YUV_NOISE,
                                       pan=YUV_PAN, device=dev)
        yuv_calm = run_yuv_clip("yuv_main_path_calm", calm_clip, cfgs)
        if (yuv_calm["launches"]["probe_sads_tiled"]
                or yuv_calm["launches"]["probe_sads"]):
            raise AssertionError("yuv main path without the flash: the rescue "
                                 f"ran {yuv_calm['launches']}")
        if profile:
            profile_run("yuv_main_path",
                        lambda: degrain_clip(flash_clip, fmt, *cfgs,
                                         engine="lockstep"),
                        split=("probe_sads",))
            profile_run("yuv_main_path_calm",
                        lambda: degrain_clip(calm_clip, fmt, *cfgs,
                                         engine="lockstep"))

        del flash_clip, calm_clip
        torch.cuda.empty_cache()

    # ---- the YUV420 path at 16 bits, full width ---------------------------
    if wants("yuv16"):
        yuv16, yuv16_calm = run_yuv16_paths(cfgs, dev, profile)

    # ---- Recalculate path at full width -------------------------------------
    if wants("satd"):
        recalc_specs = chain_specs(W, H, 0)
        recalc_clip = satd_clip(RECALC_PAIRS + 1, W, H, 0, None, SATD_CLEAN,
                                dev)
        satd_chain(recalc_clip, recalc_specs, {})                 # warm-up
        recalc = run_satd_path("recalc_main_path", recalc_clip, recalc_specs,
                               calm=True)
        rc = recalc["launches"]
        needed = ("sad_map", "sad_map[stats3]", "probe_sads_tiled[stats3]",
                  "fetch_blocks_tiled")
        if min(rc[k] for k in needed) < 1:
            raise AssertionError(f"recalc main path: a kernel never "
                                 f"launched {rc}")
        if min(recalc["blocks_over_thsad"], recalc["blocks_under_thsad"]) < 1:
            raise AssertionError("recalc main path: the clip must leave "
                                 "blocks on both sides of thsad")

        # ---- SATD Analyse path at full width --------------------------------
        sa_specs = chain_specs(W, H, 5)
        sa_flash = satd_clip(SATD_PAIRS + 1, W, H, 0, YUV_FLASH, SATD_CLEAN,
                             dev)
        satd_chain(sa_flash, sa_specs, {})                        # warm-up
        satd = run_satd_path("satd_analyse_path", sa_flash, sa_specs,
                             calm=False)
        sc = satd["launches"]
        needed = ("sad_map[stats3]", "probe_sads_tiled[stats3]",
                  "probe_sads[stats3]", "fetch_blocks_tiled")
        if min(sc[k] for k in needed) < 1:
            raise AssertionError(f"satd analyse path: a kernel never launched "
                                 f"{sc}")
        if sc["sad_map"] or sc["probe_sads_tiled"] or sc["probe_sads"]:
            raise AssertionError(f"satd analyse path: a plain-SAD luma kernel "
                                 f"ran on a gray dct 5 path {sc}")
        sa_calm = satd_clip(SATD_PAIRS + 1, W, H, 0, None, SATD_CLEAN, dev)
        satd_calm = run_satd_path("satd_analyse_path_calm", sa_calm, sa_specs,
                                  calm=True)
        after = satd_calm["launches_after_analyse"]
        if any(after[k] for k in after if k.startswith("probe_sads")):
            raise AssertionError("satd analyse path without the flash: the "
                                 f"rescue ran in Analyse {after}")
        if satd_calm["launches"]["probe_sads_tiled[stats3]"] != 1:
            raise AssertionError("satd analyse path without the flash: "
                                 "Recalculate probes the predictor's cost "
                                 f"once {satd_calm['launches']}")
        if profile:
            profile_run("recalc_main_path",
                        lambda: satd_chain(recalc_clip, recalc_specs, {}))
            profile_run("satd_analyse_path",
                        lambda: satd_chain(sa_flash, sa_specs, {}))
            profile_run("satd_analyse_path_calm",
                        lambda: satd_chain(sa_calm, sa_specs, {}))
        del recalc_clip, sa_flash, sa_calm
        torch.cuda.empty_cache()

    # ---- DCT Analyse path at full width -------------------------------------
    if wants("dct"):
        dct_specs = chain_specs(W, H, 1, 1)
        dct_flash = satd_clip(SATD_PAIRS + 1, W, H, 0, YUV_FLASH, SATD_CLEAN,
                              dev)
        satd_chain(dct_flash, dct_specs, {})                      # warm-up
        dct = run_satd_path("dct_analyse_path", dct_flash, dct_specs,
                            calm=False)
        check_dct_path("dct_analyse_path", dct)
        if dct["rescued_blocks"] < 1:
            raise AssertionError("dct analyse path: the flash made no block "
                                 "bad; the rescue never ran")
        dct_calm_clip = satd_clip(SATD_PAIRS + 1, W, H, 0, None, SATD_CLEAN,
                                  dev)
        dct_calm = run_satd_path("dct_analyse_path_calm", dct_calm_clip,
                                 dct_specs, calm=True)
        check_dct_path("dct_analyse_path_calm", dct_calm)
        if dct_calm["rescued_blocks"]:
            raise AssertionError("dct analyse path without the flash: the "
                                 f"rescue took {dct_calm['rescued_blocks']} "
                                 "blocks")
        if profile:
            profile_run("dct_analyse_path",
                        lambda: satd_chain(dct_flash, dct_specs, {}))
            profile_run("dct_analyse_path_calm",
                        lambda: satd_chain(dct_calm_clip, dct_specs, {}))

    # ---- frame-rate conversion path at full width -------------------------
    fps = None
    if not wants("fps"):
        pass
    elif has_fps():
        fps, fps_calm = run_fps_paths(dev, profile)
    elif not paths_only:
        raise AssertionError("the package has no models/frc.py")
    else:
        emit({"phase": "fps_main_path", "skipped": "the package driven "
              "(--package-root) has no frame-rate conversion path"})

    # ---- bench.py config 2 (pel 4) at full width ---------------------------
    if not wants("pel4"):
        pass
    elif has_pel4():
        pel4, pel4_calm = run_pel4_paths(dev, profile)
    elif not paths_only:
        raise AssertionError("the package builds no pel-4 supers")
    else:
        emit({"phase": "pel4_main_path", "skipped": "the package driven "
              "(--package-root) has no pel-4 path"})

    # ---- the exact engine (config 4) and interlaced input at full width ---
    if not wants("exact"):
        pass
    elif has_exact():
        exact = run_exact_paths(dev)
        psnr_vs_exact(dev)
    elif not paths_only:
        raise AssertionError("the package has no exact engine")
    else:
        emit({"phase": "exact_main_path", "skipped": "the package driven "
              "(--package-root) has no exact engine"})
    if not wants("fields"):
        pass
    elif has_exact():
        fields = run_fields_path(dev)
    elif not paths_only:
        raise AssertionError("the package has no interlaced input")
    else:
        emit({"phase": "fields_main_path", "skipped": "the package driven "
              "(--package-root) has no interlaced input"})

    # ---- Depan, stabilisation and the command line at full width --------
    seed = int(arg_value("--seed") or 0)
    if not wants("depan"):
        pass
    elif has_depan():
        t_phase = [time.perf_counter()]
        stab = run_stabilise_path(dev, seed)
        t_phase.append(time.perf_counter())
        depan_path = run_depan_analyse_path(dev, seed)
        t_phase.append(time.perf_counter())
        if not paths_only:
            run_cli_path(dev, seed)
            t_phase.append(time.perf_counter())
        emit({"phase": "depan_seconds", "seconds": dict(zip(
            ("stabilise_main_path", "depan_analyse_path", "cli_main_path"),
            (b - a for a, b in zip(t_phase, t_phase[1:]))))})
    elif not paths_only:
        raise AssertionError("the package has no Depan quartet")
    else:
        emit({"phase": "stabilise_main_path", "skipped": "the package "
              "driven (--package-root) has no Depan quartet"})

    if paths_only:
        emit({"phase": "done", "paths_only": True,
              "seconds": time.perf_counter() - t_start})
        return

    # ---- the kernels line --------------------------------------------------
    by_path = {"main_path": gray_counts, "yuv_main_path": counts,
               "recalc_main_path": rc, "satd_analyse_path": sc,
               "dct_analyse_path": dct["launches"],
               "yuv16_main_path": yuv16["launches"],
               "yuv16_main_path_calm": yuv16_calm["launches"],
               "fps_main_path": fps["launches"],
               "fps_main_path_calm": fps_calm["launches"],
               "pel4_main_path": pel4["launches"],
               "pel4_main_path_calm": pel4_calm["launches"],
               "exact_main_path": exact["exact_main_path"]["launches"],
               "exact_main_path16": exact["exact_main_path16"]["launches"],
               "exact_recalc_path": exact["exact_recalc_path"]["launches"],
               "fields_main_path": fields["launches"],
               "stabilise_main_path":
                   stab["methods"]["0"]["repo_kernel_launches"],
               "depan_analyse_path": depan_path["launches"]}

    def entry(name, source, replaces, case, path="yuv_main_path"):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=by_path[path][name],
                    launches_on=path,
                    launches_by_path={k: v[name] for k, v in by_path.items()},
                    max_abs_err=case["max_abs_err"], ms=case["ms"],
                    device_ms=case.get("device_ms"),
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                    bound_by=case["bound_by"],
                    library_ms=case.get("library_ms"),
                    measured_at=case["case"])

    emit({"kernels": [
        entry("sad_map", "mvtools_tpu_torch/csrc/sadmap.cu",
              "mvtools_tpu/ops/sadmap.py:145", shown["sad_map"]),
        entry("probe_sads_tiled", "mvtools_tpu_torch/csrc/probe.cu",
              "mvtools_tpu/ops/probe.py:632", shown["probe_sads_tiled"]),
        entry("fetch_blocks_tiled", "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:970", shown["fetch_blocks_tiled"]),
        entry("probe_sads", "mvtools_tpu_torch/csrc/probe_block.cu",
              "mvtools_tpu/ops/probe.py:317", shown["probe_sads"]),
        entry("sad_map[stats3]", "mvtools_tpu_torch/csrc/sadmap.cu",
              "mvtools_tpu/ops/sadmap.py:145", shown["sad_map[stats3]"],
              "recalc_main_path"),
        entry("probe_sads_tiled[stats3]", "mvtools_tpu_torch/csrc/probe.cu",
              "mvtools_tpu/ops/probe.py:632",
              shown["probe_sads_tiled[stats3]"], "recalc_main_path"),
        entry("probe_sads[stats3]", "mvtools_tpu_torch/csrc/probe_block.cu",
              "mvtools_tpu/ops/probe.py:317", shown["probe_sads[stats3]"],
              "satd_analyse_path"),
        entry("fetch_blocks", "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:899", shown["fetch_blocks"],
              "dct_analyse_path"),
        entry("sad_map[u16]", "mvtools_tpu_torch/csrc/sadmap.cu",
              "mvtools_tpu/ops/sadmap.py:145", shown["sad_map[u16]"],
              "yuv16_main_path"),
        entry("probe_sads_tiled[u16]", "mvtools_tpu_torch/csrc/probe.cu",
              "mvtools_tpu/ops/probe.py:632", shown["probe_sads_tiled[u16]"],
              "yuv16_main_path"),
        entry("fetch_blocks_tiled[u16]", "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:970",
              shown["fetch_blocks_tiled[u16]"], "yuv16_main_path"),
        entry("probe_sads[u16]", "mvtools_tpu_torch/csrc/probe_block.cu",
              "mvtools_tpu/ops/probe.py:317", shown["probe_sads[u16]"],
              "yuv16_main_path"),
        # K5's uint16 form is the tiled fetch's hand-over for stacks under
        # its window: at 1080p every level-0 stack Degrain reads is wider,
        # so it is off the full-width 16-bit path (0 launches there, as the
        # JAX package's path at 1080p never reaches its _fetch_kernel); it
        # launches in small_end_to_end_yuv16, whose line shows the count
        entry("fetch_blocks[u16]", "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:899", shown["fetch_blocks[u16]"],
              "yuv16_main_path"),
        # K6 replaces no TPU kernel: the JAX package runs the exact engine
        # as a lax.scan (search_level) and Recalculate's exact search as a
        # vmap over blocks, which XLA compiles
        entry("exact_scan", "mvtools_tpu_torch/csrc/exact_scan.cu",
              "mvtools_tpu/analyse.py:801 (lax.scan, no Pallas kernel)",
              shown["exact_scan"], "exact_main_path"),
        entry("exact_scan[u16]", "mvtools_tpu_torch/csrc/exact_scan.cu",
              "mvtools_tpu/analyse.py:801 (lax.scan, no Pallas kernel)",
              shown["exact_scan[u16]"], "exact_main_path16"),
        entry("exact_search", "mvtools_tpu_torch/csrc/exact_scan.cu",
              "mvtools_tpu/recalculate.py:191 (vmap, no Pallas kernel)",
              shown["exact_search"], "exact_recalc_path"),
        # Recalculate refuses clips of 9 to 16 bits (as it does on the
        # lockstep engine), so the uint16 per-item form is on no path; it
        # runs in exact_vs_plain, at Recalculate's 1080p shape
        entry("exact_search[u16]", "mvtools_tpu_torch/csrc/exact_scan.cu",
              "mvtools_tpu/recalculate.py:191 (vmap, no Pallas kernel)",
              shown["exact_search[u16]"], "exact_recalc_path")]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
