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
origins outside the plane and with 8x8 blocks; the uint16 forms of K1-K5
at the deep-bit YUV420 path's shapes on 16-bit and on 10-bit data, with
blocks of 0 against the pixel maximum; the three-stat tiled probe also on
blocks of 0 against 255 and with 8x8, 32x32 and 64x64 blocks; the maps and
the tiled probes also timed by their device time in a torch.profiler
trace), prints the SASS opcode counts of every kernel form, checks small end-to-end runs on the card against the
same code on CPU tensors (at 8 and at 16 bits, degrain_clip and the gray
degrain_window), and drives six main paths
at full width:

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
  First with the flash (the rescue must run), then without it (it must not).

It also holds the block DCT on the card against the CPU on more than a
million blocks (dct_vs_cpu: not one coefficient may differ) and runs the
DCT chain at 256x192 on the card against the CPU for each of dct 1-4.

Every phase prints one JSON line; any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  The last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

additionally traces one more full-width run of each of the eleven clips
with torch.profiler and prints where the device time went (busy share,
kernels by time, and the summed device time of every kernel form; for the
16-bit flash clip also the uint16 tiled probe's time by launch grid, which
names the plane and the pyramid level).

    python3 chip_smoke.py --paths-only [--profile] [--package-root DIR]
                          [--sass-out FILE] [--sass-reference FILE]

times the 8-bit kernels at the YUV420 and DCT paths' shapes, the uint16
tiled probe and map at theirs (phase redesigned_kernel_times), and drives
the full-width paths (no other kernel comparison, no small runs, no
kernels line and no "ok" line), with the package of the checkout at DIR if
given: the way to compare two trees' kernels, paths and kernel sums in one
call.  DIR must hold a package that has the uint16 kernel forms and
Super.take.  --sass-out writes the sass phase's opcode counts as JSON;
--sass-reference reads such a file (another tree's) and fails unless every
kernel form but the uint16 tiled probe counts the same opcodes.
"""

import dataclasses
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
                               analyse_batch, recalculate)
from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
from mvtools_tpu_torch.core.types import (ColorFamily, MVField, MVPlaneField,
                                          VideoFormat)
from mvtools_tpu_torch.degrain import DegrainConfig, degrain, gather_blocks
from mvtools_tpu_torch.models.denoise import (degrain_clip, degrain_window,
                                              flagship_configs,
                                              headline_specs, make_test_clip,
                                              make_test_clip_yuv)
from mvtools_tpu_torch.ops import cuda_build, probe, sadmap
from mvtools_tpu_torch.super import build_super

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


def time_plain(fn):
    """(result, milliseconds) of a plain version: one warm-up call, then
    one timed call that ends in a synchronise."""
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


def k4_case(ctx, stacks, gen, offsets, kk, plane=0, stats="sad"):
    """probe_sads (the per-block probe) on a plane under the tile window;
    candidates reach a few pixels past the stack's bottom/right edges, where
    the window is shifted in."""
    stack, cy, cx, src_blocks, bsy, bsx, _ = probe_inputs(
        ctx, stacks, gen, plane, kk, spread=10, far_share=0.0)
    logp = ctx.log_pel
    min_dx, min_dy, wy, wx = probe._window_geom(offsets, bsy, bsx, ctx.pel)
    cy.clamp_(min=-min_dy)
    cx.clamp_(min=-min_dx)
    cy[:, -1, 0] = (stack.shape[2] - bsy + 3) << logp
    cx[:, -1, 0] = (stack.shape[3] - bsx + 2) << logp
    args = (stack, cy, cx, src_blocks, offsets, bsy, bsx, ctx.pel, stats)
    label = case_label(ctx, plane, f" pel {ctx.pel} K={kk} D={len(offsets)}"
                       + stats_tag(stats))
    name = kernel_name("probe_sads", stack, stats)
    before = probe.launches[name]
    out = probe.probe_sads(*args)
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name} {label}: the kernel did not launch")
    want, plain_ms = time_plain(lambda: probe.probe_sads_plain(*args))
    err = compare(f"probe_sads {label}", out, want)
    ms = time_cuda(lambda: probe.probe_sads(*args), 20)
    b_ms, b_by = probe_bound(stack, cy, src_blocks, out, cy.numel(),
                             len(offsets), bsy, bsx, stats)
    return dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


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
    name = kernel_name("fetch_blocks_tiled", stack)
    before = probe.launches[name]
    out = gather_blocks(stack, pos_x, pos_y, mvx, mvy, bsy, bsx, 1, pad_x,
                        pad_y, sub, sub, pitch_fp=pitch_x)
    if probe.launches[name] != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch")
    # the same positions through the plain version
    lp = 1
    xa = (((pos_x << 1) + mvx) >> sub) + pad_x
    ya = (((pos_y << 1) + mvy) >> sub) + pad_y
    fx = probe.wrap_clamp(xa >> lp, stack.shape[3], bsx)
    fy = probe.wrap_clamp(ya >> lp, stack.shape[2], bsy)
    cx = ((fx << lp) | (xa & 1)).reshape(nb, -1, 1).contiguous()
    cy = ((fy << lp) | (ya & 1)).reshape(nb, -1, 1).contiguous()
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_tiled_plain(
        stack, cy, cx, bsy, bsx, sspec.pel))
    kind = "chroma" if plane else "luma"
    ov = f" overlap {meta.overlap_x}" if meta.overlap_x else ""
    label = f"level 0 {kind} {bsy}x{bsx}{ov}, {nb} frames{bits_tag(sspec)}"
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


def profile_run(label, fn, split=None):
    """One traced run of fn(): device-busy share and the kernels by time;
    with `split` (a KERNEL_NAMES key) that kernel's time by launch grid."""
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
          **({"split": {split: kernel_split(prof, KERNEL_NAMES[split])}}
             if split else {})})


# the device functions of the kernels that --profile sums, as the trace
# names them; the three-stat map and the fetches under their names in this
# tree and in its parent's, so that --package-root reads both
KERNEL_NAMES = {
    "sad_map": r"sadmap_kernel<(unsigned char, )?\d",
    "probe_sads_tiled": r"probe_kernel<(unsigned char, )?\d",
    "probe_sads": r"probe_block_kernel(<unsigned char>)?\(",
    "sad_map[stats3]": r"sadmap(3|_stats3)_kernel[<(]",
    "probe_sads_tiled[stats3]": r"probe_stats3_kernel[<(]",
    "fetch_blocks_tiled": r"fetch_kernel<(unsigned char, )?-?\d+, 1>",
    "fetch_blocks": r"fetch_kernel<(unsigned char, )?-?\d+, 0>",
    "sad_map[u16]": r"sadmap(16_kernel<|_kernel<unsigned short)",
    "probe_sads_tiled[u16]": r"probe(16_kernel<|_kernel<unsigned short)",
    "probe_sads[u16]": r"probe_block_kernel<unsigned short>",
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
    "probe_sads": ("probe_block", r"18probe_block_kernel(IhE|EPKh)"),
    "fetch_blocks_tiled/fetch_blocks": ("fetch", r"12fetch_kernelI(h|Li)"),
    "sad_map[u16]": ("sadmap", r"(13sadmap_kernelIt|15sadmap16_kernel)"),
    "probe_sads_tiled[u16]": ("probe", r"(12probe_kernelIt|14probe16_kernel)"),
    "probe_sads[u16]": ("probe_block", r"18probe_block_kernelItE"),
    "fetch_blocks_tiled/fetch_blocks[u16]": ("fetch",
                                             r"12fetch_kernelIt"),
    "sad_map[stats3]": ("sadmap", r"sadmap3_kernel"),
    "probe_sads_tiled[stats3]": ("probe", r"19probe_stats3_kernel"),
    "probe_sads[stats3]": ("probe_block", r"probe_block_stats3_kernel"),
}


# the forms whose SASS must stay another tree's (--sass-reference): all but
# the one this tree redesigned
SASS_HELD = tuple(f for f in SASS_FORMS if f != "probe_sads_tiled[u16]")


def arg_value(flag):
    """The value after `flag` on the command line, or None."""
    argv = sys.argv[1:]
    return argv[argv.index(flag) + 1] if flag in argv else None


def sass_phase():
    """The instructions of each kernel form (with --package-root, of the
    other tree's build).  --sass-out FILE writes them as JSON; with
    --sass-reference FILE (another tree's --sass-out) every form of
    SASS_HELD must count the same opcodes as there, or the phase fails."""
    sass = {form: sass_opcodes(source, pattern)
            for form, (source, pattern) in SASS_FORMS.items()}
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
    for counts in (sadmap.launches, probe.launches):
        for key in counts:
            counts[key] = 0
    sadmap.plain_calls_on_cuda = 0
    probe.plain_calls_on_cuda = 0
    fe.host_syncs = 0
    fe.rescued_blocks = 0


def read_counts():
    return dict(**sadmap.launches, **probe.launches)


def fetches(counts):
    """Launches of either fetch kernel."""
    return sum(counts[k] for k in FETCH_KERNELS)


def plain_calls_on_cuda():
    return sadmap.plain_calls_on_cuda + probe.plain_calls_on_cuda


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
    out = degrain_clip(clip, fmt, scfg, acfg, dcfg, radius, info=info)
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
    """K1-K4 at the shapes the YUV420 path gives them: K1/K2/K3 at level 0,
    luma (16x16, pitch 8) and chroma (8x8, pitch 4); K4 on the small planes
    of levels 4 and 5, and once at pel 2."""
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
    ring = tuple(fe._ring_offsets(1, 1))
    walk = tuple(fe._HEXP)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    k1, k2, k3, k4 = [], [], [], []
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
    del ctx, stacks
    for lv, plane, sets in ((4, 1, ((grid16, 1), (ring, 1), (((0, 0),), 6))),
                            (5, 0, ((HEXAGON, 1), (walk, 1),
                                    (((0, 0),), 6), (((0, 0),), 1)))):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        for offsets, kk in sets:
            k4.append(k4_case(ctx, stacks, gen, offsets, kk, plane))
        del ctx, stacks
    del sups, clip
    # pel 2: the finest level of a small clip, both planes
    small_fmt = VideoFormat(SMALL_W, SMALL_H, 8, ColorFamily.YUV420)
    s_sspec = scfg.validate(small_fmt)
    s_aspec = dataclasses.replace(acfg, isb=True).validate(s_sspec)
    small = make_test_clip_yuv(3, SMALL_W, SMALL_H, seed=3, noise=YUV_NOISE,
                               device=dev)
    s_sups = build_super(small, s_sspec)
    ctx, stacks = level_inputs(s_sspec, s_aspec, s_sups,
                               torch.tensor([1, 1], device=dev),
                               torch.tensor([2, 0], device=dev), 0)
    k4.append(k4_case(ctx, stacks, gen, walk, 1, 0))
    k4.append(k4_case(ctx, stacks, gen, HEXAGON, 6, 1))
    torch.cuda.empty_cache()
    return k1, k2, k3, k4


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
    """K1-K5 in their uint16 forms at the shapes the deep-bit YUV420 path
    gives them (K1/K2/K3 at level 0, luma 16x16 pitch 8 and chroma 8x8
    pitch 4; K4 on the small planes of levels 4 and 5; K5 as the tiled
    fetch's hand-over at level 5 and at origins past every edge), on a clip
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
    ring = tuple(fe._ring_offsets(1, 1))
    walk = tuple(fe._HEXP)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    k1, k2, k3, k4, k5 = [], [], [], [], []
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
    for lv, plane, sets in ((4, 1, ((grid16, 1), (ring, 1), (((0, 0),), 6))),
                            (5, 0, ((HEXAGON, 1), (walk, 1),
                                    (((0, 0),), 6), (((0, 0),), 1)))):
        ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        for offsets, kk in sets:
            k4.append(k4_case(ctx, stacks, gen, offsets, kk, plane))
        if lv == 5:
            # K5 as the tiled fetch's hand-over: a map row on level 5's
            # stack, which is under the tiled fetch's window
            stack = stacks[0]
            _, cy, cx, _, _, _, _ = probe_inputs(ctx, stacks, gen, 0, 1,
                                                 spread=4, far_share=0.0)
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
                raise AssertionError("fetch_blocks_tiled: the level-5 "
                                     f"{bits}-bit stack was not handed to "
                                     "fetch_blocks")
            k5.append(k5_case(f"level 5 map row K=15 (the tiled fetch's "
                              f"hand-over) {bits}-bit", stack, rcy, rcx, 16,
                              16, ctx.pel))
        del ctx, stacks
    del sups, clip
    if bits == 10:
        k1.append(k1_largest_blocks_case(gen, dev))
    torch.cuda.empty_cache()
    return k1, k2, k3, k4, k5


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
                           radius, info=info_gpu)
    counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end yuv: a plain version ran on "
                             "CUDA tensors")
    out_cpu = degrain_clip(small, fmt, scfg, acfg, dcfg, radius,
                           info=info_cpu)
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
                           radius, info=info_gpu)
    counts = read_counts()
    if plain_calls_on_cuda():
        raise AssertionError("small end-to-end yuv16: a plain version ran "
                             "on CUDA tensors")
    out_cpu = degrain_clip(small, fmt, scfg, acfg, dcfg, radius,
                           info=info_cpu)
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
    ctx, stacks = level_inputs(sspec, aspec, sups, src_idx, ref_idx, 5)
    for offsets in (HEXAGON, tuple(fe._HEXP), ((0, 0),)):
        k4.append(k4_case(ctx, stacks, gen, offsets, 1, stats=STATS3))
    del ctx, stacks, sups
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
    y1, y2, y3, k4_cases = yuv_kernel_cases(cfgs, gen, dev)
    k1_cases += k1_geometry_cases(gen, dev)
    s1, s2, s4 = satd_kernel_cases(gen, dev)
    k5_cases, k3_dct = dct_kernel_cases(gen, dev)
    k3_cases += k3_dct + [k3_blk8_case(gen, dev)]
    cases = {"sad_map": k1_cases + y1, "probe_sads_tiled": k2_cases + y2,
             "fetch_blocks_tiled": k3_cases + y3, "probe_sads": k4_cases,
             "sad_map[stats3]": s1, "probe_sads_tiled[stats3]": s2,
             "probe_sads[stats3]": s4, "fetch_blocks": k5_cases}
    emit({"phase": "kernels_vs_plain", "tolerance": 0, **cases})
    # the cases the kernels line reports: the main paths' shapes
    return {"sad_map": y1[0], "probe_sads_tiled": y2[0],
            "fetch_blocks_tiled": y3[0], "probe_sads": k4_cases[0],
            "sad_map[stats3]": s1[0], "probe_sads_tiled[stats3]": s2[0],
            "probe_sads[stats3]": s4[0], "fetch_blocks": k5_cases[0]}


def deep_kernels_vs_plain(cfgs, dev):
    """The uint16 forms of K1-K5 against their plain versions on the card
    (tolerance 0) at the deep-bit YUV420 path's shapes, on 16-bit and on
    10-bit data; prints the phase and returns the 16-bit cases that the
    kernels line reports."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    by_bits = {bits: deep_kernel_cases(cfgs, gen, dev, bits)
               for bits in (DEEP_BITS, 10)}
    names = ("sad_map[u16]", "probe_sads_tiled[u16]",
             "fetch_blocks_tiled[u16]", "probe_sads[u16]",
             "fetch_blocks[u16]")
    emit({"phase": "kernels_vs_plain_u16", "tolerance": 0,
          **{name: by_bits[DEEP_BITS][i] + by_bits[10][i]
             for i, name in enumerate(names)}})
    k1, k2, k3, k4, k5 = by_bits[DEEP_BITS]
    return {"sad_map[u16]": k1[0], "probe_sads_tiled[u16]": k2[0],
            "fetch_blocks_tiled[u16]": k3[0], "probe_sads[u16]": k4[0],
            "fetch_blocks[u16]": k5[-1]}


def u8_kernel_times(cfgs, dev):
    """The 8-bit kernels at the YUV420 and DCT paths' shapes (K1-K5),
    against their plain versions, for --paths-only: with --package-root the
    other tree's kernels, so that one call times both trees in turns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k1, k2, k3, k4 = yuv_kernel_cases(cfgs, gen, dev)
    k5, k3_dct = dct_kernel_cases(gen, dev)
    emit({"phase": "u8_kernel_times",
          **{name: [{k: c[k] for k in ("case", "ms", "bound_ms", "plain_ms")}
                    for c in cases]
             for name, cases in (("sad_map", k1), ("probe_sads_tiled", k2),
                                 ("fetch_blocks_tiled", k3 + k3_dct),
                                 ("probe_sads", k4), ("fetch_blocks", k5))}})


def redesigned_kernel_times(cfgs, dev):
    """K2 u16 (redesigned in this tree) and K1 u16 beside it at the shapes
    PERF.md records them at, 16 and 10 bits, against their plain versions,
    for --paths-only: with --package-root the other tree's kernels, so that
    one call times both trees in turns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    by_bits = [deep_kernel_cases(cfgs, gen, dev, bits)
               for bits in (DEEP_BITS, 10)]
    keys = ("case", "ms", "device_ms", "bound_ms", "plain_ms", "before_ms",
            "live_share", "launch")
    emit({"phase": "redesigned_kernel_times",
          **{name: [{k: c[k] for k in keys if k in c}
                    for cases in by_bits for c in cases[i]]
             for i, name in ((1, "probe_sads_tiled[u16]"),
                             (0, "sad_map[u16]"))}})


def run_yuv16_paths(cfgs, dev, profile):
    """The flagship YUV420 path at 16 bits and full width through
    degrain_clip: first with the flash (K1, K2, K4 and K3 in their uint16
    forms must launch), then without it (neither probe kernel may); no
    8-bit kernel may launch on either."""
    fmt = VideoFormat(W, H, DEEP_BITS, ColorFamily.YUV420)
    flash_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, flash=YUV_FLASH,
                                    noise=YUV_NOISE, pan=YUV_PAN,
                                    bits=DEEP_BITS, device=dev)
    degrain_clip(flash_clip, fmt, *cfgs)                      # warm-up
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
                    lambda: degrain_clip(flash_clip, fmt, *cfgs),
                    split="probe_sads_tiled[u16]")
        profile_run("yuv16_main_path_calm",
                    lambda: degrain_clip(calm_clip, fmt, *cfgs))
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
    else:
        u8_kernel_times(cfgs, dev)
        redesigned_kernel_times(cfgs, dev)

    # ---- gray main path at full width ---------------------------------------
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
    plain_clip = make_test_clip(BATCH * n_windows + 2 * RADIUS, W, H, seed=0,
                                device=dev)
    calm = run_windows(
        "main_path_no_rescue",
        [plain_clip[i * BATCH:i * BATCH + BATCH + 2 * RADIUS]
         for i in range(n_windows)], sspec, aspec, dcfg,
        changes_pixels=False)
    if calm["launches"]["probe_sads_tiled"] != 0:
        raise AssertionError("main path without bad blocks: the rescue ran")
    profile = "--profile" in sys.argv[1:]
    if profile:
        profile_run("main_path", lambda: degrain_window(
            windows[1], sspec, aspec, dcfg, RADIUS))
        profile_run("main_path_no_rescue", lambda: degrain_window(
            plain_clip[:BATCH + 2 * RADIUS], sspec, aspec, dcfg, RADIUS))
    del frames, windows, plain_clip
    torch.cuda.empty_cache()

    # ---- YUV420 main path at full width ------------------------------------
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
    flash_clip = make_test_clip_yuv(YUV_T, W, H, seed=0, flash=YUV_FLASH,
                                    noise=YUV_NOISE, pan=YUV_PAN, device=dev)
    degrain_clip(flash_clip, fmt, *cfgs)                      # warm-up
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
                    lambda: degrain_clip(flash_clip, fmt, *cfgs))
        profile_run("yuv_main_path_calm",
                    lambda: degrain_clip(calm_clip, fmt, *cfgs))

    del flash_clip, calm_clip
    torch.cuda.empty_cache()

    # ---- the YUV420 path at 16 bits, full width ---------------------------
    yuv16, yuv16_calm = run_yuv16_paths(cfgs, dev, profile)

    # ---- Recalculate path at full width -------------------------------------
    recalc_specs = chain_specs(W, H, 0)
    recalc_clip = satd_clip(RECALC_PAIRS + 1, W, H, 0, None, SATD_CLEAN, dev)
    satd_chain(recalc_clip, recalc_specs, {})                 # warm-up
    recalc = run_satd_path("recalc_main_path", recalc_clip, recalc_specs,
                           calm=True)
    rc = recalc["launches"]
    needed = ("sad_map", "sad_map[stats3]", "probe_sads_tiled[stats3]",
              "fetch_blocks_tiled")
    if min(rc[k] for k in needed) < 1:
        raise AssertionError(f"recalc main path: a kernel never launched {rc}")
    if min(recalc["blocks_over_thsad"], recalc["blocks_under_thsad"]) < 1:
        raise AssertionError("recalc main path: the clip must leave blocks "
                             "on both sides of thsad")

    # ---- SATD Analyse path at full width ------------------------------------
    sa_specs = chain_specs(W, H, 5)
    sa_flash = satd_clip(SATD_PAIRS + 1, W, H, 0, YUV_FLASH, SATD_CLEAN, dev)
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
                             "Recalculate probes the predictor's cost once "
                             f"{satd_calm['launches']}")
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
    dct_specs = chain_specs(W, H, 1, 1)
    dct_flash = satd_clip(SATD_PAIRS + 1, W, H, 0, YUV_FLASH, SATD_CLEAN, dev)
    satd_chain(dct_flash, dct_specs, {})                      # warm-up
    dct = run_satd_path("dct_analyse_path", dct_flash, dct_specs, calm=False)
    check_dct_path("dct_analyse_path", dct)
    if dct["rescued_blocks"] < 1:
        raise AssertionError("dct analyse path: the flash made no block bad; "
                             "the rescue never ran")
    dct_calm_clip = satd_clip(SATD_PAIRS + 1, W, H, 0, None, SATD_CLEAN, dev)
    dct_calm = run_satd_path("dct_analyse_path_calm", dct_calm_clip,
                             dct_specs, calm=True)
    check_dct_path("dct_analyse_path_calm", dct_calm)
    if dct_calm["rescued_blocks"]:
        raise AssertionError("dct analyse path without the flash: the rescue "
                             f"took {dct_calm['rescued_blocks']} blocks")
    if profile:
        profile_run("dct_analyse_path",
                    lambda: satd_chain(dct_flash, dct_specs, {}))
        profile_run("dct_analyse_path_calm",
                    lambda: satd_chain(dct_calm_clip, dct_specs, {}))

    if paths_only:
        emit({"phase": "done", "paths_only": True,
              "seconds": time.perf_counter() - t_start})
        return

    # ---- the kernels line --------------------------------------------------
    by_path = {"main_path": gray_counts, "yuv_main_path": counts,
               "recalc_main_path": rc, "satd_analyse_path": sc,
               "dct_analyse_path": dct["launches"],
               "yuv16_main_path": yuv16["launches"],
               "yuv16_main_path_calm": yuv16_calm["launches"]}

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
              "yuv16_main_path")]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
