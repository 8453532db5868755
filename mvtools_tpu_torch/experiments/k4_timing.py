#!/usr/bin/env python3
"""Where the per-block probe (K4 and K4 u16) spends its time on the two
YUV420 flash clips, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k4_timing.py
    python3 mvtools_tpu_torch/experiments/k4_timing.py --split \\
        [--package-root DIR]
    python3 mvtools_tpu_torch/experiments/k4_timing.py --host \\
        [--package-root DIR]

The first form records every call of one run of the 8-bit and of the
16-bit YUV420 flash clip (chip_smoke.py's yuv_main_path and
yuv16_main_path) that the tiled probe hands to the per-block probe, prints
them by shape (pyramid level and plane by the stack's size, block size, D,
K, jobs; entries, live entries of the `active` mask, items with a live
entry), and replays them all under each body and launch geometry, each
twice, in turns (the list, then the list reversed): the clip's summed
device milliseconds of the per-block kernel (a torch.profiler trace of the
whole replay after one warm-up), its launches, and the CUDA-event and
host-clock milliseconds of the replay.  The bodies:

* the previous one (csrc/probe_block.cu's probe_block_kernel<T> until its
  redesign, a warp per (job, block, candidate)), kept in k4_previous.cu and
  appended to a copy of csrc/probe_block.cu with its launching entry; a
  masked call is masked after it by a torch.where, as its wrapper did (only
  the kernel's time is summed);
* the committed one under the committed geometry and under variants
  (variant_geom: ops/probe.py::probe_block_launch_geom with its CTA size
  fixed, or with parts of at most two or one word: more lanes an entry).

Every body's outputs are held to the committed one's, and those to the
plain version (tolerance 0).  The committed geometry's replay also prints
its kernel time by launch grid.

The second form drives both flash clips once with torch.profiler and prints
the per-block probe's device time split by kernel form and launch grid;
with --package-root, through another checkout's package.

The third form times the wrapper's host path, part by part (the whole
probe_sads call, the hand-over through probe_sads_tiled, the argument
checks, the output's allocation, the current device and stream, ...), in
microseconds a call with no synchronise between calls, on the 8-bit flash
clip's largest per-block call; with --package-root, another checkout's.

Each line printed is one JSON object.  Nothing here is used by the port.
"""

import ctypes
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvtools_tpu_torch.ops import cuda_build, probe  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k1p_timing import build  # noqa: E402

PREVIOUS_CU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "k4_previous.cu")
PREVIOUS_NAME = r"probe_block_previous_kernel"
NAMES = (cs.KERNEL_NAMES["probe_sads"], cs.KERNEL_NAMES["probe_sads[u16]"])


def variant_geom(bs_y, bs_x, n_entries, u16, n_sm, threads=None,
                 max_words=4):
    """ops/probe.py::probe_block_launch_geom with its CTA size fixed
    (threads) or its parts cut to at most max_words words."""
    ppw = 2 if u16 else 4
    half = not u16 and bs_x == 2
    wpr = 1 if half else bs_x // ppw
    cw = next(c for c in (4, 2, 1) if c <= max_words and wpr % c == 0)
    ppr = wpr // cw
    n_parts = bs_y * ppr
    g = min(32, n_parts & -n_parts)
    lanes = n_entries * g
    if threads is None:
        threads = next((t for t in probe.PROBE_BLOCK_THREADS
                        if -(-lanes // t) >= n_sm), 32)
    return dict(cw=cw, half=half, g=g, lg=g.bit_length() - 1,
                parts=n_parts // g, lppr=ppr.bit_length() - 1,
                threads=threads, ctas=-(-lanes // threads))


GEOMS = [("committed", {}), ("threads256", {"threads": 256}),
         ("threads128", {"threads": 128}), ("threads32", {"threads": 32}),
         ("words2", {"max_words": 2}), ("words1", {"max_words": 1})]


def _record_calls(dev, bits, entry="probe_sads_tiled"):
    """Every probe_sads_tiled call of one run of the `bits`-bit YUV420
    flash clip that the tiled probe handed to the per-block probe, as
    (args, kwargs); with entry="probe_sads", the per-block probe's own
    calls."""
    cfgs = cs.flagship_configs()
    fmt = cs.VideoFormat(cs.W, cs.H, bits, cs.ColorFamily.YUV420)
    clip = cs.make_test_clip_yuv(cs.YUV_T, cs.W, cs.H, seed=0,
                                 flash=cs.YUV_FLASH, noise=cs.YUV_NOISE,
                                 pan=cs.YUV_PAN, bits=bits, device=dev)
    calls, original = [], getattr(probe, entry)

    def record(*args, **kw):
        before = probe.launches["probe_sads"] + probe.launches[
            "probe_sads[u16]"]
        out = original(*args, **kw)
        if probe.launches["probe_sads"] + probe.launches[
                "probe_sads[u16]"] != before:
            calls.append((args, kw))
        return out
    setattr(probe, entry, record)
    try:
        cs.degrain_clip(clip, fmt, *cfgs, engine="lockstep")
    finally:
        setattr(probe, entry, original)
    return calls


def _shape_key(args, kw, out):
    stack = args[0]
    return (f"stack {list(stack.shape)} {args[5]}x{args[6]} "
            f"D={out.shape[3]} K={out.shape[2]} jobs={out.shape[0]} "
            f"nblk={out.shape[1]}")


def _by_shape(calls, outs):
    """The calls by shape: count, entries, live entries, items with a live
    entry (the mask's, or every entry where the call has none), and the
    summed bound of the calls (chip_smoke.k4_bound: the bytes and
    operations their live entries need)."""
    shapes = {}
    for (a, kw), out in zip(calls, outs):
        row = shapes.setdefault(_shape_key(a, kw, out), dict(
            calls=0, entries=0, live_entries=0, live_items=0, bytes=0,
            ops=0, bound_ms=0.0))
        act = kw.get("active")
        live = (torch.ones(out.shape, dtype=torch.bool, device=out.device)
                if act is None else torch.broadcast_to(act, out.shape))
        stack, cy, cx, src, offsets, bs_y, bs_x, pel = a[:8]
        offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
        b_ms, _, n_bytes, n_ops = cs.k4_bound(
            stack, cy, cx, src, offsets, bs_y, bs_x, pel, out,
            None if act is None else live.contiguous())
        row["calls"] += 1
        row["entries"] += out.numel()
        row["live_entries"] += int(live.sum())
        row["live_items"] += int(live.any(-1).sum())
        row["bytes"] += n_bytes
        row["ops"] += n_ops
        row["bound_ms"] += b_ms
    return shapes


def _previous_lib():
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    with open(PREVIOUS_CU) as f:
        text = (cuda_build.CSRC / "probe_block.cu").read_text() + f.read()
    src = work / "probe_block_previous.cu"
    src.write_text(text)
    lib = work / "libprobe_block_previous.so"
    p = build(str(lib), str(src), ["-Xptxas", "-v"])
    log, _ = p.communicate()
    if p.returncode:
        sys.exit(f"k4_timing: nvcc failed:\n{log}")
    fn = ctypes.CDLL(str(lib)).mvt_probe_block_previous
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _previous_call(fn, args, kw):
    """One call as the previous wrapper made it: the previous kernel on
    every entry, then the mask by a torch.where."""
    (stack, cy, cx, src, offsets, bs_y, bs_x, pel) = args[:8]
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    nj, nblk, kk = cy.shape
    min_dx, min_dy, wy, wx = probe._window_geom(offsets, bs_y, bs_x, pel)
    offs = probe._offsets_tensor(offsets, stack.device)
    out = torch.empty((nj, nblk, kk, len(offsets)), dtype=torch.int32,
                      device=stack.device)
    err = fn(stack.data_ptr(), cy.data_ptr(), cx.data_ptr(), src.data_ptr(),
             offs.data_ptr(), out.data_ptr(), nj, pel * pel, stack.shape[2],
             stack.shape[3], nblk, kk, len(offsets), bs_y, bs_x,
             pel.bit_length() - 1, min_dy, min_dx, wy, wx,
             int(stack.dtype == torch.uint16),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mvt_probe_block_previous: error {err}")
    act = kw.get("active")
    return out if act is None else probe._invalid_where(
        torch.broadcast_to(act, out.shape), out)


def _set_geom(knobs):
    probe.probe_block_launch_geom = functools.partial(variant_geom, **knobs)
    probe._probe_block_launch.cache_clear()


def _replay(label, run, names):
    """The replay's summed kernel device ms and launches (one warm-up
    first), CUDA-event ms and host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(cs.re.search(n, e.key) for n in names)]
    t0 = time.perf_counter()
    ms = cs.time_cuda(run, 5)
    host_ms = (time.perf_counter() - t0) * 1e3 / 6
    return dict(replay=label,
                kernel_device_ms=sum(e.self_device_time_total
                                     for e in rows) / 1e3,
                launches=sum(e.count for e in rows), event_ms=ms,
                host_ms=host_ms), prof


def replay(dev):
    previous = _previous_lib()
    committed = probe.probe_block_launch_geom
    for bits in (8, cs.DEEP_BITS):
        calls = _record_calls(dev, bits)
        want = [probe.probe_sads_tiled(*a, **k) for a, k in calls]
        torch.cuda.synchronize()
        for (a, k), w in zip(calls, want):
            plain = probe.probe_sads_plain(*a[:8])
            if k.get("active") is not None:
                plain = probe._invalid_where(
                    torch.broadcast_to(k["active"], w.shape), plain)
            cs.compare(f"{bits}-bit replay", w, plain)
        print(json.dumps({"bits": bits, "calls": len(calls),
                          "by_shape": _by_shape(calls, want)}), flush=True)
        runs = [("previous", None)] + list(GEOMS)
        for name, knobs in runs + list(reversed(runs)):
            if name == "previous":
                def run():
                    return [_previous_call(previous, a, k) for a, k in calls]
                names = (PREVIOUS_NAME,)
            else:
                _set_geom(knobs)

                def run():
                    return [probe.probe_sads_tiled(*a, **k)
                            for a, k in calls]
                names = NAMES
            for got, w in zip(run(), want):
                cs.compare(f"{bits}-bit {name}", got, w)
            res, prof = _replay(name, run, names)
            res["bits"] = bits
            print(json.dumps(res), flush=True)
            if name == "committed":
                print(json.dumps({"bits": bits, "split": cs.kernel_split(
                    prof, "|".join(NAMES))}), flush=True)
        probe.probe_block_launch_geom = committed
        probe._probe_block_launch.cache_clear()
        del calls, want
        torch.cuda.empty_cache()


def _host_us(fn, reps=400):
    """Host microseconds a call of fn() takes, with no synchronise between
    calls (the kernels queue behind the host), after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def host(dev):
    """The host path of the per-block probe's wrapper, part by part, on the
    8-bit flash clip's level-4 chroma call with the most entries: the whole
    probe_sads call (through probe_sads_tiled's hand-over too) and what it
    is made of, in microseconds a call."""
    calls = _record_calls(dev, 8, "probe_sads")
    a, kw = max(calls, key=lambda c: c[0][1].numel() * len(c[0][4]))
    stack, cy, cx, src, offsets, bs_y, bs_x, pel = a[:8]
    tiled = _record_calls(dev, 8)
    ta, tkw = max(tiled, key=lambda c: c[0][1].numel() * len(c[0][4]))
    act = kw.get("active", a[9] if len(a) > 9 else None)
    shape = tuple(cy.shape) + (len(offsets),)
    parts = {
        "probe_sads": lambda: probe.probe_sads(*a, **kw),
        "probe_sads_tiled hand-over": lambda: probe.probe_sads_tiled(*ta,
                                                                     **tkw),
        "check_probe_args": lambda: probe._check_probe_args(
            "probe_sads", stack, cy, cx, src, bs_y, bs_x, pel),
        "window_geom": lambda: probe._window_geom(offsets, bs_y, bs_x, pel),
        "empty": lambda: torch.empty(shape, dtype=torch.int32, device=dev),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "data_ptr x7": lambda: [t.data_ptr() for t in (stack, cy, cx, src,
                                                       stack, cy, cx)],
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
    }
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    act_ptr = None if act is None else act.data_ptr()
    if hasattr(probe, "_probe_block_fn"):
        offs_t, ints = probe._probe_block_launch(
            offsets, bs_y, bs_x, pel, False, stack.shape, cy.shape,
            stack.device)
        ptrs = (stack.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                src.data_ptr(), offs_t.data_ptr(), act_ptr, out.data_ptr())
        fn = probe._probe_block_fn(False)
        parts["ctypes launch"] = lambda: fn(*ptrs, ints, stream)
    else:
        offs_t = probe._offsets_tensor(offsets, dev)
        min_dx, min_dy, wy, wx = probe._window_geom(offsets, bs_y, bs_x,
                                                    pel)
        fn = probe._probe_block_lib(False)
        ints = (cy.shape[0], 1, stack.shape[2], stack.shape[3], cy.shape[1],
                cy.shape[2], len(offsets), bs_y, bs_x, pel.bit_length() - 1,
                min_dy, min_dx, wy, wx, 0)
        ptrs = (stack.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                src.data_ptr(), offs_t.data_ptr(), out.data_ptr())
        parts["ctypes launch"] = lambda: fn(*ptrs, *ints, stream)
    if act is not None:
        parts["active_mask"] = lambda: probe._active_mask(act, shape,
                                                          stack.device)
    if hasattr(probe, "_stream"):
        parts["stream (wrapper)"] = lambda: probe._stream(stack.device)
    if hasattr(probe, "_offset_set"):
        parts["offset_set"] = lambda: probe._offset_set(offsets, bs_y, bs_x,
                                                        pel)
        parts["launch_ints"] = lambda: probe._probe_block_launch(
            offsets, bs_y, bs_x, pel, False, stack.shape, cy.shape, dev)
    print(json.dumps({"call": f"{list(cy.shape)} D={len(offsets)} "
                      f"{bs_x}x{bs_y}", "masked": act is not None,
                      "host_us": {k: _host_us(f) for k, f in parts.items()},
                      "event_us": {k: cs.time_cuda(parts[k], 100) * 1e3
                                   for k in ("probe_sads",
                                             "probe_sads_tiled hand-over",
                                             "ctypes launch")}}),
          flush=True)


def split(dev):
    cfgs = cs.flagship_configs()
    for bits, name in ((8, "probe_sads"), (cs.DEEP_BITS, "probe_sads[u16]")):
        fmt = cs.VideoFormat(cs.W, cs.H, bits, cs.ColorFamily.YUV420)
        clip = cs.make_test_clip_yuv(cs.YUV_T, cs.W, cs.H, seed=0,
                                     flash=cs.YUV_FLASH, noise=cs.YUV_NOISE,
                                     pan=cs.YUV_PAN, bits=bits, device=dev)
        cs.degrain_clip(clip, fmt, *cfgs,
                        engine="lockstep")                # warm-up
        cs.profile_run(f"yuv_main_path {bits}-bit",
                       lambda: cs.degrain_clip(clip, fmt, *cfgs,
                                               engine="lockstep"),
                       split=(name,))
        del clip
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("k4_timing: no CUDA device")
    dev = torch.device("cuda")
    if "--split" in sys.argv[1:]:
        split(dev)
    elif "--host" in sys.argv[1:]:
        host(dev)
    else:
        replay(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
