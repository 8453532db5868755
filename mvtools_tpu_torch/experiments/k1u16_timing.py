#!/usr/bin/env python3
"""Where the uint16 SAD map kernel (K1 u16, csrc/sadmap.cu::sadmap16_kernel)
spends its time, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k1u16_timing.py

It builds csrc/sadmap.cu several times with nvcc into
mvtools_tpu_torch/build/experiments/ and times each build with CUDA events
and with torch.profiler's device time at the two shapes chip_smoke.py
measures K1 u16 at (the 16-bit YUV420 path's level-0 luma map
[12, 32026, 17, 17] and chroma map [12, 32026, 11, 11], a 1080p clip), every
build twice, in turns (the list, then the list reversed):

* launch bounds: (threads a CTA, CTAs an SM) of the committed (288, 3) and
  (288, 2), written into a copy of the source; each is held to the plain
  version first (tolerance 0);
* the tile split over 1 to 4 CTAs (map16_launch_geom's n_part), with the
  committed build, each held to the plain version first;
* other bodies: the results written with cache-streaming stores (__stcs),
  so that the 444 MB of a luma map's output pass through L2 without
  evicting the stack the next CTAs stage; each is held to the plain version
  first (tolerance 0);
* cuts of the committed body, one part left out at a time (the outputs of
  a cut body are wrong; only its time is read): the items' sums of minima,
  the reference window's loads, the column sums, the source rows' loads.

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
from mvtools_tpu_torch.ops import cuda_build, sadmap  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k1p_timing import build  # noqa: E402

BOUNDS = {"t288_b3": 3, "t288_b2": 2}
BOUND_TEXT = "__launch_bounds__(MAP16_THREADS, 3)"
# (text of the committed body, text that cuts a part when the flag is 1)
CUTS = [("            if (col0 & 1)\n                map16_rows<",
         "            if (CUT_ITEMS) {}\n            else if (col0 & 1)\n"
         "                map16_rows<"),
        ("            stage_column(plane_s,",
         "            if (!CUT_STAGE) stage_column(plane_s,"),
        ("            if (x >= g.wx) continue;",
         "            if (CUT_COLS || x >= g.wx) continue;"),
        ("        stage_column(src_j,",
         "        if (!CUT_SRC) stage_column(src_j,")]
CUT_FLAGS = ("CUT_ITEMS", "CUT_STAGE", "CUT_COLS", "CUT_SRC")
CUT_SETS = ["whole"] + list(CUT_FLAGS)
# other bodies: (name, text of the committed body, its replacement); each is
# held to the plain version first (tolerance 0)
VARIANTS = [("stcs",
             "    for (int i = tid; i < nb * dn; i += nthr) out_t[i] = "
             "out_s[i];",
             "    for (int i = tid; i < nb * dn; i += nthr) "
             "__stcs(out_t + i, out_s[i]);")]


def main():
    if not torch.cuda.is_available():
        sys.exit("k1u16_timing: no CUDA device")
    dev = torch.device("cuda")
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "sadmap.cu").read_text()
    if text.count(BOUND_TEXT) != 1:
        sys.exit(f"k1u16_timing: the source no longer holds {BOUND_TEXT!r}")
    procs = {}
    for name, b in BOUNDS.items():
        src = work / f"sadmap16_{name}.cu"
        src.write_text(text.replace(
            BOUND_TEXT, f"__launch_bounds__(MAP16_THREADS, {b})"))
        procs[name] = build(str(work / f"libsadmap16_{name}.so"), str(src),
                            ["-Xptxas", "-v"])
    for name, a, b in VARIANTS:
        if text.count(a) != 1:
            sys.exit(f"k1u16_timing: the body no longer holds {a!r}")
        src = work / f"sadmap16_{name}.cu"
        src.write_text(text.replace(a, b))
        procs[name] = build(str(work / f"libsadmap16_{name}.so"), str(src),
                            ["-Xptxas", "-v"])
    for a, b in CUTS:
        if text.count(a) != 1:
            sys.exit(f"k1u16_timing: the body no longer holds {a!r}")
        text = text.replace(a, b)
    cut_src = work / "sadmap16_cuts.cu"
    cut_src.write_text(text)
    for name in CUT_SETS:
        procs[name] = build(str(work / f"libsadmap16_{name}.so"),
                            str(cut_src),
                            [f"-D{f}={int(f == name)}" for f in CUT_FLAGS])
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"k1u16_timing: nvcc failed for {name}:\n{log}")
        regs = _registers(log, "sadmap16_kernel")
        libs[name] = ctypes.CDLL(str(work / f"libsadmap16_{name}.so"))
        print(json.dumps({"build": name, "registers": regs}), flush=True)

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
    bodies = list(BOUNDS) + [v[0] for v in VARIANTS]
    for name in bodies + list(reversed(bodies)):
        cuda_build._libs["sadmap"] = libs[name]
        for plane in (0, 1):
            r = cs.k1_case(ctx, stacks, gen, plane)
            print(json.dumps({"bounds": name, "shape": r["shape"],
                              "ms": r["ms"], "device_ms": r["device_ms"]}),
                  flush=True)
    committed = sadmap.map16_launch_geom
    parts = (1, 2, 3, 4)
    cuda_build._libs["sadmap"] = libs["t288_b3"]
    for n_part in parts + tuple(reversed(parts)):
        sadmap.map16_launch_geom = functools.partial(committed,
                                                     n_part=n_part)
        for plane in (0, 1):
            r = cs.k1_case(ctx, stacks, gen, plane)
            print(json.dumps({"n_part": n_part, "shape": r["shape"],
                              "ms": r["ms"], "device_ms": r["device_ms"],
                              "launch": r["launch"]}), flush=True)
    sadmap.map16_launch_geom = committed
    for name in CUT_SETS + list(reversed(CUT_SETS)):
        cuda_build._libs["sadmap"] = libs[name]
        for plane in (0, 1):
            args = _map_args(ctx, stacks, gen, plane)
            ms = cs.time_cuda(lambda: sadmap.sad_map(*args), 10)
            dms = cs.time_device(lambda: sadmap.sad_map(*args), 10,
                                 cs.KERNEL_NAMES["sad_map[u16]"])
            print(json.dumps({"cut": name, "plane": plane, "ms": ms,
                              "device_ms": dms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def _registers(log, kernel):
    """The register counts ptxas -v reports for the instantiations of a
    kernel function."""
    regs, inside = set(), False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and "Used " in line:
            regs.add(int(line.split("Used ")[1].split()[0]))
    return sorted(regs)


def _map_args(ctx, stacks, gen, plane):
    """sad_map's arguments at a level's map shape, anchors over the whole
    legal range (chip_smoke.k1_case's inputs, without the comparison)."""
    bsy, bsx, pit_y, pit_x, oy, ox, _ = cs.plane_geom(ctx, plane)
    stack = stacks[plane]
    nbx, nby = ctx.nblk
    tile, r = cs.fe._map_tile(ctx), cs.fe.map_radius(ctx)
    r_y, r_x = cs.fe._chroma_map_geom(ctx, r)[:2] if plane else (r, r)
    ntx = -(-nbx // tile)
    nj = stack.shape[0]
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r_y, r_x, bsy, bsx, ctx.pel, tile, pit_x, stack.shape[2],
        stack.shape[3])
    afy = torch.randint(lo_y, hi_y + 1, (nj, nby * ntx), generator=gen,
                        device=stack.device, dtype=torch.int32)
    afx = torch.randint(lo_x, hi_x + 1, (nj, nby * ntx), generator=gen,
                        device=stack.device, dtype=torch.int32)
    return (stack, ctx.src_planes[plane], afy, afx, r_y, r_x, bsy, bsx,
            ctx.pel, tile, pit_x, pit_y, nbx, nby, oy, ox)


if __name__ == "__main__":
    main()
