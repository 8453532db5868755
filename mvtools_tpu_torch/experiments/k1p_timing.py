#!/usr/bin/env python3
"""Where the three-stat SAD map kernel (K1', csrc/sadmap.cu::sadmap3_kernel)
spends its time, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k1p_timing.py

It builds csrc/sadmap.cu several times with nvcc into
mvtools_tpu_torch/build/experiments/ and times each build at the two shapes
chip_smoke.py measures K1' at (Recalculate's level 0 [8, 32026, 15, 15, 3]
and Analyse's [8, 8040, 15, 15, 3], a 1080p gray clip), every build twice,
in turns (the list, then the list reversed):

* launch bounds: (threads a CTA, CTAs an SM) of (512, 1), (512, 2),
  (256, 3) and the committed (288, 3), written into a copy of the source
  (the launch geometry follows ops/sadmap.py::MAP3_MAX_THREADS); each is
  held to the plain version first (tolerance 0);
* cuts of the committed body, one part left out at a time (the outputs of
  a cut body are wrong; only its time is read): the SATD terms, the SAD,
  the transform bands, the box sums, all item work.

Each line printed is one JSON object.  Nothing here is used by the port.
"""

import ctypes
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

BOUNDS = {"t512_b1": (512, 1), "t512_b2": (512, 2), "t256_b3": (256, 3),
          "t288_b3": (288, 3)}
# (text of the committed body, text that cuts a part when the flag is 1)
CUTS = [("        uint4 h[4];",
         "        if (CUT_SATD) continue;\n        uint4 h[4];"),
        ("for (int yy = 0; yy < 4; ++yy) {",
         "for (int yy = 0; yy < (CUT_SAD ? 0 : 4); ++yy) {"),
        ("for (int x = tid; x < g.npos; x += nthr) {",
         "for (int x = tid; x < (CUT_BANDS ? 0 : g.npos); x += nthr) {"),
        ("for (int x = tid; x < wx; x += nthr) {",
         "for (int x = tid; x < (CUT_BOX ? 0 : wx); x += nthr) {"),
        ("        for (int i = tid; i < g.ny * g.nbox; i += nthr) {",
         "        for (int i = tid; i < (CUT_BOX ? 0 : g.ny * g.nbox); "
         "i += nthr) {"),
        ("                if (!active || i < 0",
         "                if (CUT_ITEMS || !active || i < 0")]
CUT_FLAGS = ("CUT_SATD", "CUT_SAD", "CUT_BANDS", "CUT_BOX", "CUT_ITEMS")
CUT_SETS = ["whole", "CUT_SATD", "CUT_SAD", "CUT_BANDS", "CUT_BOX",
            "CUT_ITEMS"]


BOUND_TEXT = ("constexpr int MAP3_THREADS = 288;",
              "__launch_bounds__(MAP3_THREADS, 3)")


def build(out, src, flags):
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
         str(cuda_build.CSRC), *flags, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("k1p_timing: no CUDA device")
    dev = torch.device("cuda")
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "sadmap.cu").read_text()
    if any(text.count(a) != 1 for a in BOUND_TEXT):
        sys.exit("k1p_timing: the source no longer states its launch bounds "
                 f"as {BOUND_TEXT}")
    procs = {}
    for name, (t, b) in BOUNDS.items():
        src = work / f"sadmap_{name}.cu"
        src.write_text(text.replace(BOUND_TEXT[0], f"constexpr int "
                                    f"MAP3_THREADS = {t};").replace(
            BOUND_TEXT[1], f"__launch_bounds__(MAP3_THREADS, {b})"))
        procs[name] = build(str(work / f"libsadmap_{name}.so"), str(src),
                            ["-Xptxas", "-v"])
    for a, b in CUTS:
        if text.count(a) != 1:
            sys.exit(f"k1p_timing: the body no longer holds {a!r}")
        text = text.replace(a, b)
    cut_src = work / "sadmap_cuts.cu"
    cut_src.write_text(text)
    for name in CUT_SETS:
        procs[name] = build(str(work / f"libsadmap_{name}.so"), str(cut_src),
                            [f"-D{f}={int(f == name)}" for f in CUT_FLAGS])
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"k1p_timing: nvcc failed for {name}:\n{log}")
        regs = sorted({int(w.split()[0]) for w in log.split("Used ")[1:]})
        libs[name] = ctypes.CDLL(str(work / f"libsadmap_{name}.so"))
        print(json.dumps({"build": name, "registers": regs}), flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sspec, aspec, _, rspec = cs.chain_specs(cs.W, cs.H, 5)
    clip = cs.satd_clip(cs.RECALC_PAIRS + 1, cs.W, cs.H, 1, cs.YUV_FLASH,
                        cs.SATD_CLEAN, dev)
    sups = cs.build_super([clip], sspec)
    centres = torch.arange(1, cs.RECALC_PAIRS, 2, device=dev)
    src_idx = centres.repeat_interleave(2)
    ref_idx = src_idx + 1 - 2 * (torch.arange(cs.RECALC_PAIRS, device=dev)
                                 % 2)
    levels = [cs.level_inputs(sspec, spec, sups, src_idx, ref_idx, 0)
              for spec in (rspec, aspec)]
    committed = sadmap.MAP3_MAX_THREADS
    for name in list(BOUNDS) + list(reversed(BOUNDS)):
        sadmap.MAP3_MAX_THREADS = BOUNDS[name][0]
        cuda_build._libs["sadmap"] = libs[name]
        for ctx, stacks in levels:
            r = cs.k1_case(ctx, stacks, gen, stats=cs.STATS3)
            print(json.dumps({"bounds": name, "shape": r["shape"],
                              "ms": r["ms"], "launch": r["launch"]}),
                  flush=True)
    sadmap.MAP3_MAX_THREADS = committed
    ctx, stacks = levels[0]
    bsy, bsx, pit_y, pit_x, oy, ox, _ = cs.plane_geom(ctx, 0)
    nbx, nby = ctx.nblk
    tile, r = cs.fe._map_tile(ctx), cs.fe.map_radius(ctx)
    ntx = -(-nbx // tile)
    (lo_y, hi_y), (lo_x, hi_x) = sadmap.anchor_bounds(
        r, r, bsy, bsx, ctx.pel, tile, pit_x, stacks[0].shape[2],
        stacks[0].shape[3])
    nj = stacks[0].shape[0]
    afy = torch.randint(lo_y, hi_y + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    afx = torch.randint(lo_x, hi_x + 1, (nj, nby * ntx), generator=gen,
                        device=dev, dtype=torch.int32)
    args = (stacks[0], ctx.src_planes[0], afy, afx, r, r, bsy, bsx, ctx.pel,
            tile, pit_x, pit_y, nbx, nby, oy, ox, cs.STATS3)
    for name in CUT_SETS + list(reversed(CUT_SETS)):
        cuda_build._libs["sadmap"] = libs[name]
        ms = cs.time_cuda(lambda: sadmap.sad_map(*args), 10)
        print(json.dumps({"cut": name, "shape": [nj, nby * nbx, 15, 15, 3],
                          "ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
