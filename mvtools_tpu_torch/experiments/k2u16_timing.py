#!/usr/bin/env python3
"""Where the uint16 tiled probe (K2 u16) spends its time, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k2u16_timing.py
    python3 mvtools_tpu_torch/experiments/k2u16_timing.py --split \\
        [--package-root DIR]
    python3 mvtools_tpu_torch/experiments/k2u16_timing.py --replay

The first form builds csrc/probe.cu several times with nvcc into
mvtools_tpu_torch/build/experiments/ and times, at the two shapes
chip_smoke.py measures K2 u16 at (the 16-bit YUV420 path's level-0 luma
probe [12, 32026, 1, 6], 16x16 blocks and the hexagon, and its chroma probe
[12, 32026, 1, 16], 8x8 blocks and a 4x4 offset grid, a 1080p clip), each
unmasked and with an `active` mask that leaves about 30 % of the entries
live, every variant twice, in turns (the list, then the list reversed),
with CUDA events and with torch.profiler's device time:

* the previous uint16 body (csrc/probe.cu's probe_kernel on uint16 stacks
  until its redesign, a warp per (job, block, candidate)), kept in
  k2u16_previous.cu and appended to a copy of csrc/probe.cu with its
  launching entry, whole (held to the plain version first, tolerance 0) and
  cut, one
  part at a time (the outputs of a cut body may be wrong; only its time is
  read): without the reference pixels' loads (a register stands in for each
  word), without the validity rule (a bounds check of the candidate's window
  in the stack stands in for it: no member loads), without the runtime
  index divisions (an exact division through a float reciprocal and one
  correction step stands in for each);
* the committed body, probe16_kernel, under other launch geometries
  (variant_geom: ops/probe.py::probe16_launch_geom with its constants
  changed: chunks a lane, words a chunk, warps a CTA, items a warp fixed at
  32) and in other builds, each a copy of csrc/probe.cu with some of its
  text replaced (two offsets a pass; 32-bit or 16-byte reference loads),
  each held to the plain version first, and cut: without the reference
  loads, without the source loads, without the offsets' passes.

The second form drives the 16-bit YUV420 flash clip (chip_smoke.py's
yuv16_main_path) once with torch.profiler and prints K2 u16's device time
split by kernel form and launch grid, which name the plane and the pyramid
level; with --package-root, through another checkout's package.

The third form records every K2 u16 call of one run of that clip and
replays them all under each build and geometry of the first form: the
clip's summed device milliseconds of the tiled kernel, each build's outputs
held to the committed one's; it also prints the calls' entries, live items
and live entries by shape, and the committed build's time by launch grid.

Each line printed is one JSON object.  Nothing here is used by the port.
"""

import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvtools_tpu_torch.ops import cuda_build, probe  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k1p_timing import build  # noqa: E402
from k1u16_timing import _registers  # noqa: E402

# an exact unsigned division through a float reciprocal (the quotients
# here are under 2^24), for the cut without the runtime divisions
FDIV = """
__device__ __forceinline__ unsigned fdiv(unsigned a, unsigned b) {
    unsigned q = (unsigned)__fmul_rz((float)a, __frcp_rz((float)b));
    if (q * b > a) --q;
    else if ((q + 1) * b <= a) ++q;
    return q;
}
#define DIV(a, b) (CUT_DIV ? fdiv((unsigned)(a), (unsigned)(b)) : (a) / (b))
"""
# The previous body is k2u16_previous.cu appended to the text of
# csrc/probe.cu.  (text, text that cuts a part when its flag is 1): in
# csrc/probe.cu (its validity rule's divisions), then in the previous body
PREVIOUS_CUTS = ([
    ("__device__ __forceinline__ int med3(",
     FDIV + "__device__ __forceinline__ int med3("),
    ("    const int row = blk / p.row_len, col = blk - row * p.row_len;\n"
     "    const int c0 = (col / p.tile) * p.tile;",
     "    const int row = (int)DIV(blk, p.row_len), "
     "col = blk - row * p.row_len;\n"
     "    const int c0 = (int)DIV(col, p.tile) * p.tile;")], [
    ("    const unsigned jb = w / (unsigned)p.k;\n"
     "    const unsigned job = jb / (unsigned)p.nblk;",
     "    const unsigned jb = DIV(w, (unsigned)p.k);\n"
     "    const unsigned job = DIV(jb, (unsigned)p.nblk);"),
    ("    if (!candidate_valid(cand_y, cand_x, p, (int)job, blk, cy, cx)) {",
     "    const int wby = (cy + p.min_dy) >> p.logp;\n"
     "    const int wbx = (cx + p.min_dx) >> p.logp;\n"
     "    if (CUT_VALID ? (wby < 0 || wby + p.wy > p.hp || wbx < 0\n"
     "                     || wbx + p.cxs > p.wp)\n"
     "                  : !candidate_valid(cand_y, cand_x, p, (int)job,"
     " blk, cy, cx)) {"),
    ("                    uint32_t v = ref_word(rb + soff[i], 3);",
     "                    uint32_t v = CUT_LOADS ? (uint32_t)(px ^ soff[i])"
     "\n                        : ref_word(rb + soff[i], 3);")])
CUT_FLAGS = ("CUT_LOADS", "CUT_VALID", "CUT_DIV")
CUT_SETS = ["whole"] + list(CUT_FLAGS)
PREVIOUS_CU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "k2u16_previous.cu")


def variant_geom(bs_y, bs_x, kk, n_items, in_flight, lane_chunks=2,
                 chunk_words=4, warps=2, span_fixed=False):
    """ops/probe.py::probe16_launch_geom with its constants as knobs: the
    source chunks a lane holds (about lane_chunks), the words a chunk (at
    most chunk_words), the warps a CTA, and span_fixed (32 items a warp
    whatever the launch's size)."""
    wpr = bs_x // 2
    cw = next(c for c in (4, 2, 1) if c <= chunk_words and wpr % c == 0)
    nc = bs_y * (wpr // cw)
    g = min(32, max(1, nc // lane_chunks))
    ch = nc // g
    if ch not in probe.PROBE16_CH:
        g, ch = 32, 0
    per_warp = 32
    while (not span_fixed and per_warp > 4
           and n_items < per_warp * in_flight):
        per_warp //= 2
    if per_warp < 32:
        warps = 1
    return dict(cw=cw, ch=ch, g=g, warps=warps,
                span=max(1, per_warp * warps // kk))


# launch geometries of the committed body: (name, variant_geom knobs); at
# the shapes timed here each falls on a (cw, ch) form csrc/probe.cu builds
GEOMS = [("committed", {}), ("span_fixed", {"span_fixed": True}),
         ("lane_chunks1", {"lane_chunks": 1}),
         ("lane_chunks4", {"lane_chunks": 4}),
         ("words2", {"chunk_words": 2}),
         ("warps1", {"warps": 1}), ("warps4", {"warps": 4}),
         ("warps8", {"warps": 8})]
# the committed body's one-offset loop, from its first line to its last
OFFSET_LOOP = (
    "            // the offsets one at a time (two a pass timed no faster,"
    " PERF.md)\n",
    "                if (g == (d & (p.g - 1))) o[d] = (int)t;\n            }\n")
# the same loop, two offsets a pass (their loads in flight together)
OFFSETS2_LOOP = """            constexpr int OP = 2;
            // OP offsets a pass (their loads in flight together); a pass
            // past D repeats the last offset and stores nothing of it
            for (int d0 = 0; d0 < p.d; d0 += OP) {
                bool on[OP];
                bool any_on = false;
#pragma unroll
                for (int u = 0; u < OP; ++u) {
                    const int d = d0 + u;
                    on[u] = d < p.d && (few ? ((ilive >> d) & 1u) != 0
                                            : (!act || act[d]));
                    if (d < p.d && !on[u] && g == 0) o[d] = INT_MAX;
                    any_on |= on[u];
                }
                if (!any_on) continue;
                unsigned t[OP];
#pragma unroll
                for (int u = 0; u < OP; ++u) {
                    const int d = min(d0 + u, p.d - 1);
                    const int px = icx + offs[2 * d];
                    const int py = icy + offs[2 * d + 1];
                    const int sub = (px & pelm) | ((py & pelm) << p.logp);
                    const uintptr_t r0 = stack_j
                        + 2 * (uintptr_t)(sub * plane + (py >> p.logp) * p.wp
                                          + (px >> p.logp));
                    unsigned acc_r = 0, acc_m = 0;
                    if (CH > 0) {
#pragma unroll
                        for (int i = 0; i < NC; ++i)
                            chunk_sums<CW>(r0 + roff[i], sw[i], acc_r,
                                           acc_m);
                    } else {
                        for (int ci = g; ci < p.nc; ci += 32) {
                            const int r = ci >> p.lcpr, cc = ci & cmask;
                            uint32_t v[CW];
                            load_words<CW>(s + r * p.bs_x + cc * (2 * CW), v);
                            chunk_sums<CW>(
                                r0 + 2 * (r * p.wp + cc * (2 * CW)), v,
                                acc_r, acc_m);
                        }
                    }
                    t[u] = ssum + acc_r - 2u * acc_m;
                }
                for (int sh = p.g >> 1; sh > 0; sh >>= 1) {
#pragma unroll
                    for (int u = 0; u < OP; ++u)
                        t[u] += __shfl_xor_sync(gmask, t[u], sh);
                }
#pragma unroll
                for (int u = 0; u < OP; ++u)
                    if (on[u] && g == ((d0 + u) & (p.g - 1)))
                        o[d0 + u] = (int)t[u];
            }
"""
# chunk_sums's four-word branch as built, and with two aligned 16-byte loads
LOAD8 = ("    if (CW == 4) {\n"
         "        const uint2* a8 = (const uint2*)(a & ~(uintptr_t)7);")
LOAD16 = """    if (CW == 4) {
        const uint4* a16 = (const uint4*)(a & ~(uintptr_t)15);
        const uint4 x0 = __ldg(a16);
        const uint4 x1 = (a & 15) ? __ldg(a16 + 1) : x0;
        const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const unsigned q = (unsigned)(a >> 2) & 3u;
        uint32_t u[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) u[j] = (q & 2u) ? w[j + 2] : w[j];
#pragma unroll
        for (int j = 0; j < CW + 1; ++j) v[j] = (q & 1u) ? u[j + 1] : u[j];
    } else if (false) {
        const uint2* a8 = (const uint2*)(a & ~(uintptr_t)7);"""
# builds of the committed body, each the text of csrc/probe.cu with some
# substitutions (text, replacement; a (first line, last line) pair stands
# for the text from the one to the other): other loops and loads, each held
# to the plain version first, and cuts, one part left out at a time (the
# outputs of a cut body are wrong; only its time is read): the reference
# loads (a register stands in for each word), the source loads, the
# offsets' passes
NEW_CUTS = {
    "CUT16_REF": [(
        "#pragma unroll\n    for (int j = 0; j < CW; ++j) {\n"
        "        const uint32_t r = __funnelshift_r(",
        "    for (int j = 0; j <= CW; ++j) v[j] = (uint32_t)a + j;\n"
        "#pragma unroll\n    for (int j = 0; j < CW; ++j) {\n"
        "        const uint32_t r = __funnelshift_r(")],
    "CUT16_SRC": [(
        "                    load_words<CW>(s + r * p.bs_x + cc * (2 * CW),"
        " sw[i]);",
        "                    for (int j = 0; j < CW; ++j) sw[i][j] = ci + j;")],
    "CUT16_PASS": [(
        OFFSET_LOOP[0] + "            for (int d = 0; d < p.d; ++d) {",
        "            for (int d = 0; d < 0; ++d) {")]}
NEW_BUILDS = {"whole": [], "offsets2": [(OFFSET_LOOP, OFFSETS2_LOOP)],
              "load32": [(LOAD8, LOAD8.replace("(CW == 4)", "(false)"))],
              "load128": [(LOAD8, LOAD16)], **NEW_CUTS}
NEW_GEOMS = ("committed",)
PREVIOUS_NAME = r"probe16_previous_kernel"


def _substitute(text, subs):
    """text with each (old, new) of subs replaced; old may be a (first
    line, last line) pair, which stands for the text from one to the other.
    Each old must occur once."""
    for old, new in subs:
        if isinstance(old, tuple):
            i = text.find(old[0])
            j = text.find(old[1], i) + len(old[1])
            if i < 0 or j < len(old[1]) or text.count(old[0]) != 1:
                sys.exit(f"k2u16_timing: the source no longer holds {old!r}")
            old = text[i:j]
        if text.count(old) != 1:
            sys.exit(f"k2u16_timing: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def _cases(dev):
    """The level-0 luma and chroma probes of a 16-bit YUV420 1080p clip:
    (label, pel, offsets, probe_inputs, mask or None, blocks a row)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    scfg, acfg, _, _ = cs.flagship_configs()
    fmt = cs.VideoFormat(cs.W, cs.H, cs.DEEP_BITS, cs.ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = cs.dataclasses.replace(acfg, isb=True).validate(sspec)
    n = cs.KERNEL_JOBS // 2 + 1
    clip = cs.make_test_clip_yuv(n, cs.W, cs.H, seed=1, flash=cs.YUV_FLASH,
                                 noise=cs.YUV_NOISE, pan=cs.YUV_PAN,
                                 bits=cs.DEEP_BITS, device=dev)
    sups = cs.build_super(clip, sspec)
    src_idx = torch.arange(cs.KERNEL_JOBS, device=dev) // 2
    ref_idx = (src_idx + 1 - 2 * (torch.arange(cs.KERNEL_JOBS, device=dev)
                                  % 2)).clamp(0, n - 1)
    ctx, stacks = cs.level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
    grid16 = tuple((dx, dy) for dy in range(-2, 2) for dx in range(-2, 2))
    cases = []
    for plane, offsets in ((0, cs.HEXAGON), (1, grid16)):
        inputs = cs.probe_inputs(ctx, stacks, gen, plane, 1)
        shape = tuple(inputs[1].shape) + (len(offsets),)
        for masked in (False, True):
            mask = cs.live_mask(shape, gen, dev) if masked else None
            label = ("luma" if plane == 0 else "chroma") + \
                (" masked" if masked else "")
            cases.append((label, ctx.pel, offsets, inputs, mask,
                          ctx.nblk[0]))
    return cases


def _old_args(case):
    """The previous entry's arguments for a case (as the parent's wrapper
    passed them), and its output tensor."""
    _, pel, offsets, (stack, cy, cx, src, bsy, bsx, pit_x), mask, nbx = case
    nj, nblk, kk = cy.shape
    tile = 8 if kk <= 2 else 4
    wy_total, wx_total, center_y, center_x = probe.tile_params(
        offsets, bsy, bsx, pel, tile, pit_x)
    min_dx, min_dy, wy, _, _, cxs = probe._tile_geom(offsets, bsy, bsx, pel)
    offs = probe._offsets_tensor(offsets, stack.device)
    out = torch.empty((nj, nblk, kk, len(offsets)), dtype=torch.int32,
                      device=stack.device)
    args = (stack.data_ptr(), cy.data_ptr(), cx.data_ptr(), src.data_ptr(),
            offs.data_ptr(), 0 if mask is None else mask.data_ptr(),
            out.data_ptr(), nj, pel * pel, stack.shape[2], stack.shape[3],
            nblk, nbx, kk, len(offsets), tile, bsy, bsx,
            pel.bit_length() - 1, min_dy, min_dx, wy, cxs, wy_total,
            wx_total, center_y, center_x,
            torch.cuda.current_stream().cuda_stream)
    return args, out, (tile, wy_total, wx_total, center_y, center_x)


def _plain(case, geo):
    _, pel, offsets, (stack, cy, cx, src, bsy, bsx, _), mask, nbx = case
    return probe.probe_sads_tiled_plain(stack, cy, cx, src, offsets, bsy,
                                        bsx, pel, nbx, *geo, "sad", mask)


def cut_timings(dev):
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    if "--new-only" in sys.argv[1:]:
        return _cases(dev)
    shared, previous = PREVIOUS_CUTS
    with open(PREVIOUS_CU) as f:
        text = _substitute((cuda_build.CSRC / "probe.cu").read_text(),
                           shared) + _substitute(f.read(), previous)
    cut_src = work / "probe16_previous_cuts.cu"
    cut_src.write_text(text)
    procs = {name: build(str(work / f"libprobe16_previous_{name}.so"),
                         str(cut_src),
                         ["-Xptxas", "-v"]
                         + [f"-D{f}={int(f == name)}" for f in CUT_FLAGS])
             for name in CUT_SETS}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"k2u16_timing: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(work / f"libprobe16_previous_{name}.so")
                         ).mvt_probe16_previous
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
        print(json.dumps({"build": name, "registers": _registers(
            log, PREVIOUS_NAME)}), flush=True)
    cases = _cases(dev)
    for name in CUT_SETS + list(reversed(CUT_SETS)):
        for case in cases:
            args, out, geo = _old_args(case)

            def run():
                err = libs[name](*args)
                if err:
                    raise RuntimeError(f"mvt_probe16_previous: error {err}")
            run()
            if name == "whole":
                cs.compare(f"previous body {case[0]}", out,
                           _plain(case, geo))
            print(json.dumps({"body": "previous", "cut": name,
                              "case": case[0],
                              "ms": cs.time_cuda(run, 10),
                              "device_ms": cs.time_device(
                                  run, 10, PREVIOUS_NAME)}),
                  flush=True)
    return cases


def _new_builds(names):
    """The builds `names` of NEW_BUILDS, loaded (ptxas's registers printed)."""
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "probe.cu").read_text()
    procs = {}
    for name in names:
        src = work / f"probe16_{name}.cu"
        src.write_text(_substitute(text, NEW_BUILDS[name]))
        procs[name] = build(str(work / f"libprobe16_{name}.so"), str(src),
                            ["-Xptxas", "-v"])
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"k2u16_timing: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(work / f"libprobe16_{name}.so"))
        print(json.dumps({"build": name, "registers": _registers(
            log, "probe16_kernel")}), flush=True)
    return libs


def _launch(stack, bs_y, bs_x, n_items):
    """The launch geometry the wrapper gives a call of n_items items."""
    cw, ch, _ = probe.probe16_chunks(bs_y, bs_x)
    return probe.probe16_launch_geom(
        bs_y, bs_x, 1, n_items,
        probe.probe16_in_flight(stack.device.index, cw, ch))


def new_timings(cases):
    libs = _new_builds(NEW_BUILDS)
    committed_lib = cuda_build.load("probe")
    committed = probe.probe16_launch_geom
    runs = [("whole", g) for g, _ in GEOMS] + [
        (b, g) for b in NEW_BUILDS if b != "whole" for g in NEW_GEOMS]
    for build_name, geom in runs + list(reversed(runs)):
        cuda_build._libs["probe"] = libs[build_name]
        probe.probe16_launch_geom = functools.partial(variant_geom,
                                                      **dict(GEOMS)[geom])
        for case in cases:
            label, pel, offsets, (stack, cy, cx, src, bsy, bsx, pit_x), \
                mask, nbx = case

            def run():
                return probe.probe_sads_tiled(
                    stack, cy, cx, src, offsets, bsy, bsx, pel, row_len=nbx,
                    pitch_x=pit_x, active=mask)
            if build_name not in NEW_CUTS:
                _, _, geo = _old_args(case)
                cs.compare(f"probe16 {build_name} {geom} {label}", run(),
                           _plain(case, geo))
            print(json.dumps({
                "body": "probe16", "build": build_name, "geometry": geom,
                "case": label,
                "launch": _launch(stack, bsy, bsx, cy.numel()),
                "ms": cs.time_cuda(run, 10),
                "device_ms": cs.time_device(
                    run, 10, cs.KERNEL_NAMES["probe_sads_tiled[u16]"])}),
                flush=True)
    cuda_build._libs["probe"] = committed_lib
    probe.probe16_launch_geom = committed


def _record_clip_calls(dev):
    """Every probe_sads_tiled call on uint16 stacks of one run of the 16-bit
    YUV420 flash clip, as (args, kwargs), and the clip's inputs kept alive
    by them."""
    cfgs = cs.flagship_configs()
    fmt = cs.VideoFormat(cs.W, cs.H, cs.DEEP_BITS, cs.ColorFamily.YUV420)
    clip = cs.make_test_clip_yuv(cs.YUV_T, cs.W, cs.H, seed=0,
                                 flash=cs.YUV_FLASH, noise=cs.YUV_NOISE,
                                 pan=cs.YUV_PAN, bits=cs.DEEP_BITS,
                                 device=dev)
    calls, original = [], probe.probe_sads_tiled

    def record(*args, **kw):
        if args[0].dtype == torch.uint16:
            calls.append((args, kw))
        return original(*args, **kw)
    probe.probe_sads_tiled = record
    try:
        cs.degrain_clip(clip, fmt, *cfgs, engine="lockstep")
    finally:
        probe.probe_sads_tiled = original
    return calls


def replay(dev):
    """The clip's K2 u16 calls replayed under each build and geometry: the
    summed device milliseconds of the tiled kernel's launches (a
    torch.profiler trace of the whole replay, after one warm-up replay),
    each build's outputs held to the committed one's."""
    calls = _record_clip_calls(dev)
    libs = _new_builds(("whole", "offsets2", "load32", "load128"))
    committed_lib = cuda_build.load("probe")
    committed = probe.probe16_launch_geom
    cuda_build._libs["probe"] = libs["whole"]
    before = probe.launches["probe_sads_tiled[u16]"]
    want = [probe.probe_sads_tiled(*a, **k) for a, k in calls]
    tiled = probe.launches["probe_sads_tiled[u16]"] - before
    live = [int((w != probe.INVALID_SAD).sum()) for w in want]
    print(json.dumps({"calls": len(calls), "tiled_launches": tiled,
                      "entries": sum(w.numel() for w in want),
                      "live_valid_entries": sum(live)}), flush=True)
    # the calls by shape: entries, items with a live valid entry, live
    # valid entries
    shapes = {}
    for (a, _), w in zip(calls, want):
        key = f"{a[5]}x{a[6]} {list(w.shape)}"
        row = shapes.setdefault(key, [0, 0, 0, 0])
        on = w != probe.INVALID_SAD
        row[0] += 1
        row[1] += w.numel()
        row[2] += int(on.any(-1).sum())
        row[3] += int(on.sum())
    print(json.dumps({"by_shape": {k: dict(zip(
        ("calls", "entries", "live_items", "live_entries"), v))
        for k, v in shapes.items()}}), flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a, k in calls:
            probe.probe_sads_tiled(*a, **k)
        torch.cuda.synchronize()
    print(json.dumps({"split": cs.kernel_split(
        prof, cs.KERNEL_NAMES["probe_sads_tiled[u16]"])}), flush=True)
    runs = [(b, "committed") for b in ("whole", "offsets2", "load32",
                                        "load128")] + [
        ("whole", g) for g, _ in GEOMS[1:]]
    for build_name, geom in runs + list(reversed(runs)):
        cuda_build._libs["probe"] = libs[build_name]
        probe.probe16_launch_geom = functools.partial(variant_geom,
                                                      **dict(GEOMS)[geom])
        for (a, k), w in zip(calls, want):
            if not torch.equal(probe.probe_sads_tiled(*a, **k), w):
                sys.exit(f"k2u16_timing: {build_name} {geom} differs")

        def run():
            for a, k in calls:
                probe.probe_sads_tiled(*a, **k)
        print(json.dumps({
            "replay": build_name, "geometry": geom,
            "clip_device_ms": cs.time_device(
                run, 1, cs.KERNEL_NAMES["probe_sads_tiled[u16]"])}),
            flush=True)
    cuda_build._libs["probe"] = committed_lib
    probe.probe16_launch_geom = committed


def split(dev):
    cfgs = cs.flagship_configs()
    fmt = cs.VideoFormat(cs.W, cs.H, cs.DEEP_BITS, cs.ColorFamily.YUV420)
    clip = cs.make_test_clip_yuv(cs.YUV_T, cs.W, cs.H, seed=0,
                                 flash=cs.YUV_FLASH, noise=cs.YUV_NOISE,
                                 pan=cs.YUV_PAN, bits=cs.DEEP_BITS,
                                 device=dev)
    cs.degrain_clip(clip, fmt, *cfgs,
                    engine="lockstep")                    # warm-up
    cs.profile_run("yuv16_main_path",
                   lambda: cs.degrain_clip(clip, fmt, *cfgs,
                                           engine="lockstep"),
                   split=("probe_sads_tiled[u16]",))


def main():
    if not torch.cuda.is_available():
        sys.exit("k2u16_timing: no CUDA device")
    dev = torch.device("cuda")
    if "--split" in sys.argv[1:]:
        split(dev)
    elif "--replay" in sys.argv[1:]:
        replay(dev)
    else:
        new_timings(cut_timings(dev))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
