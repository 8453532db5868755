#!/usr/bin/env python3
"""Where the three-stat per-block probe (K4') spends its time on the SATD
Analyse path's flash chain, on one GPU.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k4p_timing.py

It records every K4' call of one run of chip_smoke.py's
satd_analyse_path chain (1920x1080 gray, Analyse dct 5 with its rescue on
the flash pairs, Recalculate dct 5, Degrain1), prints them by shape, and
replays them all under each body and launch geometry, each twice, in turns
(the list, then the list reversed): the summed device milliseconds of the
K4' kernel (a torch.profiler trace of the whole replay after one warm-up),
its launches, and the CUDA-event and host-clock milliseconds of the replay.
The bodies:

* the previous one (csrc/probe_block.cu's probe_block_stats3_kernel until
  its redesign), kept in k4p_previous.cu and appended to a copy of
  csrc/probe_block.cu with its launching entry; a masked call is masked
  after it by a torch.where, as its wrapper did (only the kernel's time is
  summed);
* the committed one, under the committed geometry and with its CTA size
  fixed at 256, 128 and 32 lanes;
* "shared" (k4p_shared.cu): lanes an item instead of an entry, the source
  block's transform made once for the item's D offsets.

Every body's outputs are held to the committed one's, and those to the
plain version (tolerance 0).  Each line printed is one JSON object.
Nothing here is used by the port.
"""

import ctypes
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvtools_tpu_torch.ops import cuda_build, probe  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k1p_timing import build  # noqa: E402
from k4_timing import _replay  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "probe_sads[stats3]"
GEOMS = [("committed", {}), ("threads256", {"threads": 256}),
         ("threads128", {"threads": 128}), ("threads32", {"threads": 32})]


def variant_geom(bs_y, bs_x, n_entries, n_sm, threads=None):
    """ops/probe.py::probe_block3_launch_geom with its CTA size fixed."""
    g = COMMITTED_GEOM(bs_y, bs_x, n_entries, n_sm)
    if threads is not None:
        lanes = n_entries * g["g"]
        g.update(threads=threads, ctas=-(-lanes // threads))
    return g


COMMITTED_GEOM = probe.probe_block3_launch_geom


def _lib(cu, entry, argtypes):
    """A copy of csrc/probe_block.cu with `cu` appended, built; its
    function `entry`."""
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    src = work / f"probe_block_{entry}.cu"
    with open(os.path.join(HERE, cu)) as f:
        src.write_text((cuda_build.CSRC / "probe_block.cu").read_text()
                       + f.read())
    lib = work / f"lib{entry}.so"
    p = build(str(lib), str(src), ["-Xptxas", "-v"])
    log, _ = p.communicate()
    if p.returncode:
        sys.exit(f"k4p_timing: nvcc failed:\n{log}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _record_calls(dev):
    """Every K4' call of one run of the SATD Analyse path's flash chain, as
    (args, kwargs)."""
    specs = cs.chain_specs(cs.W, cs.H, 5)
    clip = cs.satd_clip(cs.SATD_PAIRS + 1, cs.W, cs.H, 0, cs.YUV_FLASH,
                        cs.SATD_CLEAN, dev)
    calls, original = [], probe.probe_sads

    def record(*args, **kw):
        before = probe.launches[NAME]
        out = original(*args, **kw)
        if probe.launches[NAME] != before:
            calls.append((args, kw))
        return out
    probe.probe_sads = record
    try:
        cs.satd_chain(clip, specs, {})
    finally:
        probe.probe_sads = original
    return calls


def _norm(args, kw):
    stack, cy, cx, src, offsets, bs_y, bs_x, pel = args[:8]
    offsets = tuple((int(dx), int(dy)) for dx, dy in offsets)
    act = kw.get("active", args[9] if len(args) > 9 else None)
    return stack, cy, cx, src, offsets, bs_y, bs_x, pel, act


def _by_shape(calls, outs):
    shapes = {}
    for (a, kw), out in zip(calls, outs):
        stack, cy, cx, src, offsets, bs_y, bs_x, pel, act = _norm(a, kw)
        key = (f"stack {list(stack.shape)} {bs_y}x{bs_x} D={len(offsets)} "
               f"K={cy.shape[2]} jobs={cy.shape[0]} nblk={cy.shape[1]}")
        live = (torch.ones(out.shape[:4], dtype=torch.bool, device=out.device)
                if act is None else torch.broadcast_to(act, out.shape[:4]))
        b_ms, _, n_bytes, n_ops = cs.k4_bound(
            stack, cy, cx, src, offsets, bs_y, bs_x, pel, out,
            None if act is None else live.contiguous(), cs.STATS3)
        row = shapes.setdefault(key, dict(calls=0, entries=0,
                                          live_entries=0, bytes=0, ops=0,
                                          bound_ms=0.0))
        row["calls"] += 1
        row["entries"] += live.numel()
        row["live_entries"] += int(live.sum())
        row["bytes"] += n_bytes
        row["ops"] += n_ops
        row["bound_ms"] += b_ms
    return shapes


def main():
    if not torch.cuda.is_available():
        sys.exit("k4p_timing: no CUDA device")
    dev = torch.device("cuda")
    previous = _lib("k4p_previous.cu", "mvt_probe_block3_previous",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                    + [ctypes.c_void_p])
    shared = _lib("k4p_shared.cu", "mvt_probe_block3_shared",
                  [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p])
    calls = _record_calls(dev)
    want = [probe.probe_sads(*a, **k) for a, k in calls]
    for (a, k), w in zip(calls, want):
        stack, cy, cx, src, offsets, bs_y, bs_x, pel, act = _norm(a, k)
        cs.compare("replay", w, probe.probe_sads_plain(
            stack, cy, cx, src, offsets, bs_y, bs_x, pel, cs.STATS3,
            active=act))
    print(json.dumps({"calls": len(calls), "by_shape": _by_shape(calls,
                                                                  want)}),
          flush=True)

    def run_previous():
        outs = []
        for a, k in calls:
            stack, cy, cx, src, offsets, bs_y, bs_x, pel, act = _norm(a, k)
            nj, nblk, kk = cy.shape
            min_dx, min_dy, wy, wx = probe._window_geom(offsets, bs_y, bs_x,
                                                        pel)
            offs = probe._offsets_tensor(offsets, dev)
            out = torch.empty((nj, nblk, kk, len(offsets), 3),
                              dtype=torch.int32, device=dev)
            err = previous(stack.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                           src.data_ptr(), offs.data_ptr(), out.data_ptr(),
                           nj, pel * pel, stack.shape[2], stack.shape[3],
                           nblk, kk, len(offsets), bs_y, bs_x,
                           pel.bit_length() - 1, min_dy, min_dx, wy, wx, 0,
                           torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"previous K4': error {err}")
            outs.append(out if act is None else probe._invalid_where(
                torch.broadcast_to(act, out.shape[:4]).contiguous(), out))
        return outs

    def run_shared():
        outs = []
        for a, k in calls:
            stack, cy, cx, src, offsets, bs_y, bs_x, pel, act = _norm(a, k)
            offs, args = probe._probe_block_launch(
                offsets, bs_y, bs_x, pel, False, stack.shape, cy.shape, dev,
                True)
            act = (None if act is None else
                   torch.broadcast_to(act, cy.shape + (len(offsets),))
                   .contiguous())
            out = torch.empty(cy.shape + (len(offsets), 3),
                              dtype=torch.int32, device=dev)
            err = shared(stack.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                         src.data_ptr(), offs.data_ptr(),
                         None if act is None else act.data_ptr(),
                         out.data_ptr(), args,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"shared K4': error {err}")
            outs.append(out)
        return outs

    def run_committed():
        return [probe.probe_sads(*a, **k) for a, k in calls]

    names = {"previous": (r"probe_block3_previous_kernel",),
             "shared": (r"probe_block3_shared_kernel",)}
    runs = ([("previous", None, run_previous)]
            + [(n, kn, run_committed) for n, kn in GEOMS]
            + [("shared", None, run_shared)])
    for name, knobs, run in runs + list(reversed(runs)):
        if knobs is not None:
            probe.probe_block3_launch_geom = functools.partial(variant_geom,
                                                               **knobs)
            probe._probe_block_launch.cache_clear()
        for got, w in zip(run(), want):
            cs.compare(f"k4p {name}", got, w)
        res, _ = _replay(name, run, names.get(
            name, (cs.KERNEL_NAMES[NAME],)))
        print(json.dumps(res), flush=True)
        probe.probe_block3_launch_geom = COMMITTED_GEOM
        probe._probe_block_launch.cache_clear()


if __name__ == "__main__":
    main()
