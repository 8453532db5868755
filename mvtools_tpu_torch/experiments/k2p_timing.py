#!/usr/bin/env python3
"""How the three-stat tiled probe kernel (K2', csrc/probe.cu::
probe_stats3_kernel) times under other launch bounds, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k2p_timing.py

It builds csrc/probe.cu with nvcc into mvtools_tpu_torch/build/experiments/
once per launch bound of the kernel, (256 threads, at least N CTAs an SM)
for N = 1 (the committed bound, no minimum), 6 and 8, prints each build's
registers (ptxas -v), and times each build at the shapes chip_smoke.py
measures K2' at (Recalculate's level 0 [8, 32026, 1, 1, 3], Analyse's
hexagon and ring [8, 8040, 1, D, 3], a 1080p gray clip), every build twice,
in turns (the list, then the list reversed), each case held to the plain
version first (tolerance 0), with CUDA events and with torch.profiler's
device time.

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
from mvtools_tpu_torch.ops import cuda_build  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k1p_timing import build  # noqa: E402
from k1u16_timing import _registers  # noqa: E402

BOUND_TEXT = "template <int TPL>\n__global__ void __launch_bounds__(256)"
BOUNDS = {"b1": None, "b6": 6, "b8": 8}


def main():
    if not torch.cuda.is_available():
        sys.exit("k2p_timing: no CUDA device")
    dev = torch.device("cuda")
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "probe.cu").read_text()
    if text.count(BOUND_TEXT) != 1:
        sys.exit(f"k2p_timing: the source no longer holds {BOUND_TEXT!r}")
    procs = {}
    for name, b in BOUNDS.items():
        src = work / f"probe_{name}.cu"
        src.write_text(text if b is None else text.replace(
            BOUND_TEXT, BOUND_TEXT[:-1] + f", {b})"))
        procs[name] = build(str(work / f"libprobe_{name}.so"), str(src),
                            ["-Xptxas", "-v"])
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"k2p_timing: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(work / f"libprobe_{name}.so"))
        print(json.dumps({"build": name, "registers":
                          _registers(log, "probe_stats3_kernel")}),
              flush=True)

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
    ring = tuple(cs.fe._ring_offsets(1, 1))
    cases = []
    ctx, stacks = cs.level_inputs(sspec, rspec, sups, src_idx, ref_idx, 0)
    cases.append((ctx, stacks, ((0, 0),), "recalc K=1 D=1"))
    ctx, stacks = cs.level_inputs(sspec, aspec, sups, src_idx, ref_idx, 0)
    cases.append((ctx, stacks, cs.HEXAGON, "hexagon D=6"))
    cases.append((ctx, stacks, ring, "ring D=8"))
    for name in list(BOUNDS) + list(reversed(BOUNDS)):
        cuda_build._libs["probe"] = libs[name]
        for ctx, stacks, offsets, label in cases:
            r = cs.k2_case(ctx, stacks, gen, offsets, 1, label,
                           stats=cs.STATS3)
            print(json.dumps({"bounds": name, "case": label,
                              "shape": r["shape"], "ms": r["ms"],
                              "device_ms": r["device_ms"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
