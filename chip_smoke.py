#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA GPU, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the CUDA kernels from mvtools_tpu_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the shapes the headline
path gives it (integers: tolerance 0), checks a small end-to-end run on the
card against the same code on CPU tensors, and drives the headline path
(1920x1080 gray, blk 16, pel 2, 3 levels, Degrain1, batch 8) through
build_super / analyse_batch / degrain: first on a clip with a flashing
region, whose bad blocks send the search through its rescue and the probe
kernel, then on the same clip without it.  Every phase prints one JSON line;
any failure raises and the exit code is non-zero.  Without a CUDA device it
exits non-zero before printing any result.  The last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

additionally traces one more full-width window of each clip with
torch.profiler and prints where the device time went (busy share, kernels by
time).
"""

import json
import subprocess
import sys
import time

import torch

from mvtools_tpu_torch import field_engine as fe
from mvtools_tpu_torch.analyse import _blocks_of, _level_ctx
from mvtools_tpu_torch.degrain import gather_blocks
from mvtools_tpu_torch.models.denoise import (degrain_window, headline_specs,
                                              make_test_clip)
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
    ctx = _level_ctx(sspec, aspec, lv, sups.map(lambda a: a[src_idx]),
                     sups.map(lambda a: a[ref_idx]))
    stack = probe.pad_stack(ctx.ref_stacks[0], fe.FieldProber.PAD)
    return ctx, stack


def k1_case(ctx, stack, gen):
    """sad_map at one level's main-path shape; anchors spread over the
    whole legal range, both clamp ends included."""
    bsx, bsy = ctx.blk_size
    nbx, nby = ctx.nblk
    tile, r = fe._map_tile(ctx), fe.map_radius(ctx)
    ntx = -(-nbx // tile)
    nj = stack.shape[0]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bsy, bsx, ctx.pel, tile, bsx, stack.shape[2], stack.shape[3])
    dev = stack.device
    afy = torch.randint(lo_y, hi_y + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    afx = torch.randint(lo_x, hi_x + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    afy[:, 0], afx[:, 0], afy[:, -1], afx[:, -1] = lo_y, lo_x, hi_y, hi_x
    args = (stack, ctx.src_planes[0], afy, afx, r, r, bsy, bsx, ctx.pel,
            tile, bsx, bsy, nbx, nby, ctx.vpad[0], ctx.hpad[0])
    out = sadmap.sad_map(*args)
    want, plain_ms = time_plain(lambda: sadmap.sad_map_plain(*args))
    err = compare(f"sad_map level {ctx.level}", out, want)
    ms = time_cuda(lambda: sadmap.sad_map(*args), 5)
    n_ops = out.numel() * bsy * bsx * 2
    n_bytes = (stack.numel() + ctx.src_planes[0].numel()
               + 4 * (afy.numel() + afx.numel()) + 4 * out.numel())
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(case=f"level {ctx.level}", shape=list(out.shape),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def k2_case(ctx, stack, gen, offsets, kk, label):
    """probe_sads_tiled around a smooth vector field; a twentieth of the
    candidates is thrown far off its tile so INVALID_SAD is exercised."""
    bsx, bsy = ctx.blk_size
    nbx, nby = ctx.nblk
    nblk = nbx * nby
    nj = stack.shape[0]
    dev = stack.device
    logp = ctx.log_pel
    idx = torch.arange(nblk, device=dev, dtype=torch.int32)
    base_y = ((ctx.vpad[0] + bsy * (idx // nbx) + fe.FieldProber.PAD) << logp)
    base_x = ((ctx.hpad[0] + bsx * (idx % nbx) + fe.FieldProber.PAD) << logp)
    vy = torch.randint(-6, 7, (nj, nblk, kk), generator=gen, device=dev,
                       dtype=torch.int32)
    vx = torch.randint(-6, 7, (nj, nblk, kk), generator=gen, device=dev,
                       dtype=torch.int32)
    far = torch.rand((nj, nblk, kk), generator=gen, device=dev) < 0.05
    vx = torch.where(far, vx + 150 * ctx.pel, vx)
    vy = torch.where(far, vy - 40 * ctx.pel, vy)
    cy = (base_y[None, :, None] + vy).contiguous()
    cx = (base_x[None, :, None] + vx).contiguous()
    src_blocks = _blocks_of(ctx.src_planes[0], ctx.vpad[0], ctx.hpad[0],
                            nby, nbx, bsy, bsx)
    tile = 8 if kk <= 2 else 4
    geom = probe.tile_params(offsets, bsy, bsx, ctx.pel, tile, bsx)

    def run():
        return probe.probe_sads_tiled(stack, cy, cx, src_blocks, offsets,
                                      bsy, bsx, ctx.pel, row_len=nbx,
                                      pitch_x=bsx)

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
    d = len(offsets)
    n_ops = n_valid * d * bsy * bsx * 2
    n_bytes = (8 * cy.numel() + src_blocks.numel() + 4 * out.numel()
               + min(stack.numel(), n_valid * d * bsy * bsx))
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(case=label, shape=list(out.shape), invalid=n_invalid,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def k3_case(sspec, aspec, sups, gen):
    """fetch_blocks_tiled as degrain calls it: one 16x16 block per grid
    block of 8 frames, vectors running past the clamp on every side."""
    m = aspec.meta
    stack = sups.planes[0][0][:BATCH].contiguous()
    nb = stack.shape[0]
    dev = stack.device
    pos_y, pos_x = torch.meshgrid(
        torch.arange(m.blk_y, dtype=torch.int32, device=dev) * m.blk_size_y,
        torch.arange(m.blk_x, dtype=torch.int32, device=dev) * m.blk_size_x,
        indexing="ij")
    lim = (sspec.hpad + 24) * sspec.pel
    mvx = torch.randint(-lim, lim + 1, (nb, m.blk_y, m.blk_x), generator=gen,
                        device=dev, dtype=torch.int32)
    mvy = torch.randint(-lim, lim + 1, (nb, m.blk_y, m.blk_x), generator=gen,
                        device=dev, dtype=torch.int32)
    args = (stack, pos_x, pos_y, mvx, mvy, m.blk_size_y, m.blk_size_x, 1,
            sspec.hpad * sspec.pel, sspec.vpad * sspec.pel)
    out = gather_blocks(*args)
    # the same positions through the plain version
    lp = 1
    xa = (pos_x << 1) + mvx + sspec.hpad * sspec.pel
    ya = (pos_y << 1) + mvy + sspec.vpad * sspec.pel
    fx = (xa >> lp).clamp(0, stack.shape[3] - m.blk_size_x)
    fy = (ya >> lp).clamp(0, stack.shape[2] - m.blk_size_y)
    cx = ((fx << lp) | (xa & 1)).reshape(nb, -1, 1).contiguous()
    cy = ((fy << lp) | (ya & 1)).reshape(nb, -1, 1).contiguous()
    want, plain_ms = time_plain(lambda: probe.fetch_blocks_tiled_plain(
        stack, cy, cx, m.blk_size_y, m.blk_size_x, sspec.pel))
    err = compare("fetch_blocks_tiled", out.reshape(want.shape), want)
    ms = time_cuda(lambda: probe.fetch_blocks_tiled(
        stack, cy, cx, m.blk_size_y, m.blk_size_x, sspec.pel), 10)
    n_bytes = want.numel() * (1 + 4) + 8 * cy.numel()
    b_ms, b_by = bound(n_bytes, 0)
    return dict(case="level 0, 8 frames", shape=list(want.shape),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def profile_window(label, window, sspec, aspec, dcfg):
    """One traced window: device-busy share and the kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        degrain_window(window, sspec, aspec, dcfg, RADIUS)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    emit({"phase": "profile", "window": label, "traced_wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_busy_share_of_traced_wall": busy_ms / wall_ms,
          "device_launches": sum(r[1] for r in rows),
          "top_kernels": [{"name": k[:60], "count": c, "ms": ms}
                          for k, c, ms in rows[:12]]})


def reset_counts():
    sadmap.launches["sad_map"] = 0
    probe.launches["probe_sads_tiled"] = 0
    probe.launches["fetch_blocks_tiled"] = 0
    sadmap.plain_calls_on_cuda = 0
    probe.plain_calls_on_cuda = 0
    fe.host_syncs = 0


def read_counts():
    return dict(sad_map=sadmap.launches["sad_map"],
                probe_sads_tiled=probe.launches["probe_sads_tiled"],
                fetch_blocks_tiled=probe.launches["fetch_blocks_tiled"])


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
    plain_on_cuda = sadmap.plain_calls_on_cuda + probe.plain_calls_on_cuda
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
    stage_ms = {k: sum(i["events"][k][0].elapsed_time(i["events"][k][1])
                       for i in infos) / n
                for k in ("super", "analyse", "degrain")}
    res = {"phase": phase, "size": [W, H], "batch": BATCH, "windows": n,
           "frames_per_s": n * BATCH / seconds,
           "seconds_per_window": seconds / n,
           "stage_ms_per_window": stage_ms, "host_syncs": syncs,
           "launches": counts, "peak_memory_bytes": peak,
           "plain_calls_on_cuda": plain_on_cuda}
    emit(res)
    return res


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

    # ---- build ------------------------------------------------------------
    build_s = cuda_build.build_all(verbose=True)
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    emit({"phase": "build", "seconds": build_s,
          "sources": [f"mvtools_tpu_torch/csrc/{n}.cu"
                      for n in cuda_build.SOURCES]})

    # ---- kernels against their plain versions -----------------------------
    sspec, aspec, dcfg = headline_specs(W, H)
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
    hexagon = ((-2, 0), (-1, 2), (1, 2), (2, 0), (1, -2), (-1, -2))
    for lv in range(aspec.meta.lv_count):
        ctx, stack = level_inputs(sspec, aspec, sups, src_idx, ref_idx, lv)
        k1_cases.append(k1_case(ctx, stack, gen))
        k2_cases.append(k2_case(ctx, stack, gen, hexagon, 1,
                                f"level {lv} K=1 hexagon D=6"))
        if lv == 0:
            k2_cases.append(k2_case(ctx, stack, gen, tuple(fe._HEXP), 1,
                                    "level 0 K=1 walk D=8"))
            k2_cases.append(k2_case(ctx, stack, gen,
                                    tuple(fe._ring_offsets(1, 1)), 1,
                                    "level 0 K=1 ring D=8"))
            k2_cases.append(k2_case(ctx, stack, gen, ((0, 0),), 6,
                                    "level 0 K=6 D=1"))
        del ctx, stack
    k3 = k3_case(sspec, aspec, sups, gen)
    del sups, clip
    torch.cuda.empty_cache()
    emit({"phase": "kernels_vs_plain", "tolerance": 0,
          "sad_map": k1_cases, "probe_sads_tiled": k2_cases,
          "fetch_blocks_tiled": [k3]})

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
    if min(small_counts.values()) < 1:
        raise AssertionError(f"small end-to-end: a kernel never launched "
                             f"{small_counts}")
    emit({"phase": "small_end_to_end", "size": [SMALL_W, SMALL_H],
          "frames": 6, "bit_equal_to_cpu": True, "launches": small_counts})

    # ---- main path at full width ------------------------------------------
    n_windows = 2
    frames = make_test_clip(BATCH * (n_windows + 1) + 2 * RADIUS, W, H,
                            seed=0, flash=FLASH, device=dev)
    windows = [frames[i * BATCH:i * BATCH + BATCH + 2 * RADIUS]
               for i in range(n_windows + 1)]
    degrain_window(windows[0], sspec, aspec, dcfg, RADIUS)    # warm-up
    hot = run_windows("main_path", windows[1:], sspec, aspec, dcfg,
                      changes_pixels=True)
    counts = hot["launches"]
    if min(counts.values()) < 1:
        raise AssertionError(f"main path: a kernel never launched {counts}")

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

    if "--profile" in sys.argv[1:]:
        profile_window("main_path", windows[1], sspec, aspec, dcfg)
        profile_window("main_path_no_rescue", plain_clip[:BATCH + 2 * RADIUS],
                       sspec, aspec, dcfg)

    # ---- the kernels line --------------------------------------------------
    def entry(name, key, source, replaces, case):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=counts[key],
                    max_abs_err=case["max_abs_err"], ms=case["ms"],
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                    bound_by=case["bound_by"], library_ms=None,
                    measured_at=case["case"])

    emit({"kernels": [
        entry("sad_map", "sad_map", "mvtools_tpu_torch/csrc/sadmap.cu",
              "mvtools_tpu/ops/sadmap.py:145", k1_cases[0]),
        entry("probe_sads_tiled", "probe_sads_tiled",
              "mvtools_tpu_torch/csrc/probe.cu",
              "mvtools_tpu/ops/probe.py:632", k2_cases[0]),
        entry("fetch_blocks_tiled", "fetch_blocks_tiled",
              "mvtools_tpu_torch/csrc/fetch.cu",
              "mvtools_tpu/ops/probe.py:970", k3)]})
    print(smi.splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
