#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA GPU, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from mvtools_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the shapes the main paths
give it (integers: tolerance 0), checks small end-to-end runs on the card
against the same code on CPU tensors, and drives two main paths at full
width:

* the gray headline path (1920x1080 gray, blk 16, pel 2, 3 levels, Degrain1,
  batch 8) through degrain_window: first on a clip with a flashing region,
  whose bad blocks send the search through its rescue and the tiled probe
  kernel, then on the same clip without it;
* the flagship YUV420 path (1920x1080 YUV420, blk 16 overlap 8, pel 2, chroma,
  the full 7-level pyramid, MDegrain3) through degrain_clip on a 14-frame
  clip: first with a flash over most of the frame, which makes blocks bad
  down to the coarse levels whose planes only the per-block probe kernel can
  serve, then without it (neither probe kernel may launch).

Every phase prints one JSON line; any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  The last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

additionally traces one more full-width run of each clip with
torch.profiler and prints where the device time went (busy share, kernels by
time).
"""

import dataclasses
import json
import subprocess
import sys
import time

import torch

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
from mvtools_tpu_torch.core.types import ColorFamily, VideoFormat
from mvtools_tpu_torch.degrain import gather_blocks
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

W, H, BATCH, RADIUS = 1920, 1080, 8, 1
FLASH = (416, 832, 256, 256)
SMALL_W, SMALL_H, SMALL_FLASH = 256, 192, (32, 64, 96, 128)
# the YUV420 path: 14 frames, flash over most of the frame, noise of +-4 per
# frame, pan of one pixel per frame (a neighbour three frames away is then 3
# pixels off, so no border block of the clip without the flash turns bad)
YUV_T, YUV_NOISE, YUV_PAN = 14, 4, (1, 1)
YUV_FLASH = (64, 128, 952, 1664)
SMALL_YUV_T, SMALL_YUV_FLASH = 6, (16, 16, 160, 224)
KERNEL_JOBS = 12      # jobs in the YUV kernel comparisons
HEXAGON = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))


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
    ctx = _level_ctx(sspec, aspec, lv, sups.map(lambda a: a[src_idx]),
                     sups.map(lambda a: a[ref_idx]))
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
    return f"level {ctx.level} {kind}{ov}{extra}"


def k1_case(ctx, stacks, gen, plane=0):
    """sad_map at one level's main-path shape; anchors spread over the
    whole legal range, both clamp ends included."""
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
            pit_x, pit_y, nbx, nby, oy, ox)
    out = sadmap.sad_map(*args)
    want, plain_ms = time_plain(lambda: sadmap.sad_map_plain(*args))
    label = case_label(ctx, plane)
    err = compare(f"sad_map {label}", out, want)
    del want
    ms = time_cuda(lambda: sadmap.sad_map(*args), 5)
    n_ops = out.numel() * bsy * bsx * 2
    n_bytes = (stack.numel() + src_plane.numel()
               + 4 * (afy.numel() + afx.numel()) + 4 * out.numel())
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


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
                            bsx, pit_y, pit_x)
    return stack, cy, cx, src_blocks, bsy, bsx, pit_x


def probe_bound(stack, cy, src_blocks, out, n_valid, d, bsy, bsx):
    n_ops = n_valid * d * bsy * bsx * 2
    n_bytes = (8 * cy.numel() + src_blocks.numel() + 4 * out.numel()
               + min(stack.numel(), n_valid * d * bsy * bsx))
    return bound(n_bytes, n_ops)


def k2_case(ctx, stacks, gen, offsets, kk, label, plane=0):
    """probe_sads_tiled around a smooth vector field; a twentieth of the
    candidates is thrown far off its tile so INVALID_SAD is exercised."""
    stack, cy, cx, src_blocks, bsy, bsx, pit_x = probe_inputs(
        ctx, stacks, gen, plane, kk)
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
                                      pitch_x=pit_x)

    out = run()
    want, plain_ms = time_plain(lambda: probe.probe_sads_tiled_plain(
        stack, cy, cx, src_blocks, offsets, bsy, bsx, ctx.pel, nbx, tile,
        *geom))
    err = compare(f"probe_sads_tiled {label}", out, want)
    n_invalid = int((out[..., 0] == probe.INVALID_SAD).sum())
    n_valid = out[..., 0].numel() - n_invalid
    if n_invalid == 0 or n_valid == 0:
        raise AssertionError(f"probe_sads_tiled {label}: the case must hold "
                             f"valid and invalid candidates ({n_valid}, "
                             f"{n_invalid})")
    ms = time_cuda(run, 10)
    b_ms, b_by = probe_bound(stack, cy, src_blocks, out, n_valid,
                             len(offsets), bsy, bsx)
    return dict(case=label, shape=list(out.shape), invalid=n_invalid,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def k4_case(ctx, stacks, gen, offsets, kk, plane=0):
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
    args = (stack, cy, cx, src_blocks, offsets, bsy, bsx, ctx.pel)
    label = case_label(ctx, plane, f" pel {ctx.pel} K={kk} D={len(offsets)}")
    before = probe.launches["probe_sads"]
    out = probe.probe_sads(*args)
    if probe.launches["probe_sads"] != before + 1:
        raise AssertionError(f"probe_sads {label}: the kernel did not launch")
    want, plain_ms = time_plain(lambda: probe.probe_sads_plain(*args))
    err = compare(f"probe_sads {label}", out, want)
    ms = time_cuda(lambda: probe.probe_sads(*args), 20)
    b_ms, b_by = probe_bound(stack, cy, src_blocks, out, out[..., 0].numel(),
                             len(offsets), bsy, bsx)
    return dict(case=label, shape=list(out.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def k3_case(sspec, meta, sups, gen, plane=0, frames=BATCH):
    """fetch_blocks_tiled as degrain calls it: one block per grid block of
    `frames` frames, vectors running past the clamp on every side."""
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
    out = gather_blocks(stack, pos_x, pos_y, mvx, mvy, bsy, bsx, 1, pad_x,
                        pad_y, sub, sub)
    # the same positions through the plain version
    lp = 1
    xa = (((pos_x << 1) + mvx) >> sub) + pad_x
    ya = (((pos_y << 1) + mvy) >> sub) + pad_y
    fx = (xa >> lp).clamp(0, stack.shape[3] - bsx)
    fy = (ya >> lp).clamp(0, stack.shape[2] - bsy)
    cx = ((fx << lp) | (xa & 1)).reshape(nb, -1, 1).contiguous()
    cy = ((fy << lp) | (ya & 1)).reshape(nb, -1, 1).contiguous()
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_tiled_plain(
        stack, cy, cx, bsy, bsx, sspec.pel))
    kind = "chroma" if plane else "luma"
    ov = f" overlap {meta.overlap_x}" if meta.overlap_x else ""
    label = f"level 0 {kind}{ov}, {nb} frames"
    err = compare(f"fetch_blocks_tiled {label}", out.reshape(want.shape),
                  want)
    ms = time_cuda(lambda: probe.fetch_blocks_tiled(
        stack, cy, cx, bsy, bsx, sspec.pel), 10)
    n_bytes = want.numel() * (1 + 4) + 8 * cy.numel()
    b_ms, b_by = bound(n_bytes, 0)
    return dict(case=label, shape=list(want.shape), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def profile_run(label, fn):
    """One traced run of fn(): device-busy share and the kernels by time."""
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
    emit({"phase": "profile", "run": label, "traced_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_busy_share_of_traced_wall": busy_ms / wall_ms,
          "device_launches": sum(r[1] for r in rows),
          "top_kernels": [{"name": k[:60], "count": c, "ms": ms}
                          for k, c, ms in rows[:12]]})


def reset_counts():
    sadmap.launches["sad_map"] = 0
    for key in probe.launches:
        probe.launches[key] = 0
    sadmap.plain_calls_on_cuda = 0
    probe.plain_calls_on_cuda = 0
    fe.host_syncs = 0


def read_counts():
    return dict(sad_map=sadmap.launches["sad_map"], **probe.launches)


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


def run_yuv_clip(phase, clip, cfgs):
    """Drive degrain_clip over a full-width YUV420 clip once, with every
    count set to 0 just before and read just after; check the outputs;
    print and return the phase's numbers."""
    scfg, acfg, dcfg, radius = cfgs
    fmt = VideoFormat(W, H, 8, ColorFamily.YUV420)
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
        if got.shape != src.shape or got.dtype != torch.uint8:
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
    res = {"phase": phase, "size": [W, H], "format": "YUV420",
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
        k1.append(k1_case(ctx, stacks, gen, plane))
        k2.append(k2_case(ctx, stacks, gen, HEXAGON if plane == 0 else grid16,
                          1, case_label(ctx, plane, " K=1 D=%d"
                                        % (6 if plane == 0 else 16)), plane))
        k3.append(k3_case(sspec, aspec.meta, sups, gen, plane, frames=n))
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
    if min(counts.values()) < 1:
        raise AssertionError(f"small end-to-end yuv: a kernel never "
                             f"launched {counts}")
    emit({"phase": "small_end_to_end_yuv", "size": [SMALL_W, SMALL_H],
          "frames": SMALL_YUV_T, "radius": radius,
          "levels": len(info_gpu["fields_b"].levels),
          "bit_equal_to_cpu": True, "launches": counts})


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

    # ---- build ------------------------------------------------------------
    build_s = cuda_build.build_all(verbose=True)
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    emit({"phase": "build", "seconds": build_s,
          "sources": [f"mvtools_tpu_torch/csrc/{n}.cu"
                      for n in cuda_build.SOURCES]})

    # ---- kernels against their plain versions -----------------------------
    sspec, aspec, dcfg = headline_specs(W, H)
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
        k1_cases.append(k1_case(ctx, stacks, gen))
        k2_cases.append(k2_case(ctx, stacks, gen, HEXAGON, 1,
                                f"level {lv} K=1 hexagon D=6"))
        if lv == 0:
            k2_cases.append(k2_case(ctx, stacks, gen, tuple(fe._HEXP), 1,
                                    "level 0 K=1 walk D=8"))
            k2_cases.append(k2_case(ctx, stacks, gen,
                                    tuple(fe._ring_offsets(1, 1)), 1,
                                    "level 0 K=1 ring D=8"))
            k2_cases.append(k2_case(ctx, stacks, gen, ((0, 0),), 6,
                                    "level 0 K=6 D=1"))
        del ctx, stacks
    k3_cases = [k3_case(sspec, aspec.meta, sups, gen)]
    del sups, clip
    torch.cuda.empty_cache()
    y1, y2, y3, k4_cases = yuv_kernel_cases(cfgs, gen, dev)
    emit({"phase": "kernels_vs_plain", "tolerance": 0,
          "sad_map": k1_cases + y1, "probe_sads_tiled": k2_cases + y2,
          "fetch_blocks_tiled": k3_cases + y3, "probe_sads": k4_cases})

    # ---- small end-to-end: card against the same code on the CPU ----------
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
    gray_kernels = ("sad_map", "probe_sads_tiled", "fetch_blocks_tiled")
    if min(small_counts[k] for k in gray_kernels) < 1:
        raise AssertionError(f"small end-to-end: a kernel never launched "
                             f"{small_counts}")
    emit({"phase": "small_end_to_end", "size": [SMALL_W, SMALL_H],
          "frames": 6, "bit_equal_to_cpu": True, "launches": small_counts})
    small_end_to_end_yuv(cfgs, dev)

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
    if min(counts.values()) < 1:
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

    # ---- the kernels line --------------------------------------------------
    def entry(name, source, replaces, case):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=counts[name],
                    launches_gray_main_path=gray_counts[name],
                    max_abs_err=case["max_abs_err"], ms=case["ms"],
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                    bound_by=case["bound_by"], library_ms=None,
                    measured_at=case["case"])

    emit({"kernels": [
        entry("sad_map", "mvtools_tpu_torch/csrc/sadmap.cu",
              "mvtools_tpu/ops/sadmap.py:145", y1[0]),
        entry("probe_sads_tiled", "mvtools_tpu_torch/csrc/probe.cu",
              "mvtools_tpu/ops/probe.py:632", y2[0]),
        entry("fetch_blocks_tiled", "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:970", y3[0]),
        entry("probe_sads", "mvtools_tpu_torch/csrc/probe_block.cu",
              "mvtools_tpu/ops/probe.py:317", k4_cases[0])]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
