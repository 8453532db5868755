#!/usr/bin/env python3
"""K6, the exact engine's level scan, on one GPU: the committed body
(csrc/exact_scan.cu, a CTA of eight warps a job that evaluates each search
step's candidates at once) against the previous one (k6_previous.cu, one
warp a job, one candidate at a time), in one call, in turns: previous,
committed, committed, previous.

Run from the repository root on the machine with the card:

    python3 mvtools_tpu_torch/experiments/k6_timing.py [--check]
    compute-sanitizer --tool racecheck \\
        python3 mvtools_tpu_torch/experiments/k6_timing.py --small

Inputs: bench.py config 4 as chip_smoke.py drives it (1920x1080 YUV420,
blk 16 overlap 8, pel 2, chroma, the full pyramid; chip_smoke.py's clip
with the 256x256 flash).  Cases:

* level 0, 2 jobs: chip_smoke.py exact_vs_plain's pair of a flash job and
  a calm one, the whole level;
* level 0, 48 jobs: one 8-frame clip at radius 3, both directions (the
  jobs of one K6 launch of exact_main_path);
* the level-0 strip of 8 block rows across the flash where the whole
  level's scan left the most blocks over badsad (exact_vs_plain's strip).

Every turn's vectors, SADs, rescue counts and candidate counts must equal
the other body's.  K6' (Recalculate's per-item search, the same source's
second entry point) is timed the same way on chip_smoke.py's 1080p
Recalculate case, by torch.profiler device time.  Printed per case: each turn's CUDA-event ms, the
candidates, the committed body's dependent steps (summed over jobs, and
the most a job walked), and its latency bound: the most steps a job
walked times one step's least dependent latency, measured here by the
probes of k6_latency.cu (a chain of L2 loads; a 256-thread CTA's shuffle
sums, slot writes, barrier and fold).

Then the 2-job level under builds of the committed source with other
flags (VARIANTS: a CTA of 4 or 16 warps; the phase profile, -DMVT_PHASES,
which prints thread 0's clock cycles a block by phase), each held to the
committed build; --variants stops there.

--check: build, run the 2-job level once under each body, compare, stop
(a first call after a change to the kernel).  --small: one 128x96 level of
2 jobs under the committed body alone, held to the plain version (for a
run under compute-sanitizer).  Each line printed is one JSON object.
Nothing here is used by the port.
"""

import ctypes
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
from mvtools_tpu_torch.analyse import analyse_exact_jobs  # noqa: E402
from mvtools_tpu_torch.models.denoise import neighbour_index  # noqa: E402
from mvtools_tpu_torch.ops import cuda_build  # noqa: E402
from mvtools_tpu_torch.ops import exact_scan as es  # noqa: E402
from mvtools_tpu_torch.ops.probe import _stream  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
I32, I64 = torch.int32, torch.int64


def emit(obj):
    print(json.dumps(obj), flush=True)


# builds of the committed source with other flags: the CTA's size, and the
# phase profile (the committed CTA)
VARIANTS = {"threads_128": ["-DMVT_THREADS=128"],
            "threads_512": ["-DMVT_THREADS=512"],
            "phases": ["-DMVT_PHASES"]}
PHASES = ("predictors and staging", "staging barrier", "trials' evaluation",
          "trials' barrier", "control code", "steps' evaluation",
          "steps' barrier", "steps' fold")


def nvcc(out, src, flags=()):
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
         "-o", out, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def build_variants():
    """{name: the variant's level-scan entry} (and "phases_read": the
    phase profile's reader), built in parallel."""
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    procs = {name: (str(work / f"libexact_scan_{name}.so"),
                    nvcc(str(work / f"libexact_scan_{name}.so"),
                         str(cuda_build.CSRC / "exact_scan.cu"), flags))
             for name, flags in VARIANTS.items()}
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k6_timing: nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        fn = dll.mvt_exact_scan
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.POINTER(ctypes.c_int),
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = fn
        if name == "phases":
            out["phases_read"] = dll.mvt_exact_phases
    return out


def variant_cases(case, variants):
    """The 2-job level under each variant (held to the committed body),
    and the phase profile: thread 0's cycles a block by phase."""
    (ref_vec, ref_bc, ref_ev, _), t_c = timed(
        lambda: run_body(es._fn("mvt_exact_scan"), case, True))
    res = {"committed_ms": t_c}
    for name in VARIANTS:
        (vec, bc, ev, _), t = timed(lambda: run_body(variants[name], case,
                                                     True))
        same(name, (ref_vec, ref_bc), (vec, bc))
        if not torch.equal(ev, ref_ev):
            raise AssertionError(f"k6_timing {name}: candidates differ")
        res[f"{name}_ms"] = t
    sums = (ctypes.c_ulonglong * len(PHASES))()
    variants["phases_read"](sums)      # the run above; cleared
    ctx = case[0]
    per_block = ctx.nblk[0] * ctx.nblk[1] * case[2][0].shape[0]
    res["phase_cycles_a_block"] = {k: sums[i] / per_block
                                   for i, k in enumerate(PHASES)}
    return res


def build():
    """({"P": the previous body's level-scan entry, "C": the committed
    one's}, the latency probes' library): the previous body and the probes
    built with nvcc beside the committed sources (built by cuda_build)."""
    work = cuda_build.BUILD / "experiments"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {name: (str(work / f"lib{name}.so"),
                    nvcc(str(work / f"lib{name}.so"),
                         os.path.join(HERE, f"{name}.cu")))
             for name in ("k6_previous", "k6_latency")}
    cuda_build.build_all(verbose=True)
    cuda_build.load("exact_scan")
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k6_timing: nvcc failed for {name}:\n{log}")
        print(log, flush=True)
        libs[name] = ctypes.CDLL(lib)
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    prev = libs["k6_previous"].mvt_exact_scan_previous
    prev.argtypes = [ctypes.c_void_p] * 14 + [ctypes.POINTER(ctypes.c_int),
                                              ctypes.c_void_p]
    prev.restype = ctypes.c_int
    search = libs["k6_previous"].mvt_exact_search_previous
    search.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    search.restype = ctypes.c_int
    return ({"P": prev, "C": es._fn("mvt_exact_scan"), "P_search": search},
            libs["k6_latency"])


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_body(fn, case, committed):
    """One body on one level, as its wrapper (ops/exact_scan.py::
    _launch_scan) calls it: ((x, y, sad), badcount, candidates per job,
    steps per job or None)."""
    ctx, plan, vin, gx, gy, zs = case
    srcs, refs = es._planes(ctx)
    g = es.scan_geom(ctx)
    dev = srcs[0].device
    vx, vy = (v.to(I32).contiguous().clone() for v in vin[:2])
    vs = vin[2].to(I64).contiguous().clone()
    gx, gy, zs = (t.to(I32).contiguous() for t in (gx, gy, zs))
    nj = vx.shape[0]
    bc = torch.empty((nj,), dtype=I32, device=dev)
    n_eval = torch.empty((nj,), dtype=I64, device=dev)
    n_steps = torch.empty((nj,), dtype=I64, device=dev) if committed \
        else None
    args = es._args(ctx, g, refs, **es._plan_args(plan))
    c = g.chroma
    ptrs = [srcs[0].data_ptr(), _ptr(srcs[1] if c else None),
            _ptr(srcs[2] if c else None), refs[0].data_ptr(),
            _ptr(refs[1] if c else None), _ptr(refs[2] if c else None),
            vx.data_ptr(), vy.data_ptr(), vs.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), zs.data_ptr(), bc.data_ptr(), n_eval.data_ptr()]
    if committed:
        ptrs.append(n_steps.data_ptr())
    err = fn(*ptrs, args, _stream(dev))
    cuda_build.check_launch(err, "exact_scan" if committed
                            else "exact_scan_previous")
    return (vx, vy, vs), bc, n_eval, n_steps


def timed(fn):
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def same(label, a, b):
    for k, x, y in zip(("x", "y", "sad", "badcount"), a[0] + (a[1],),
                       b[0] + (b[1],)):
        if not torch.equal(x, y):
            raise AssertionError(f"k6_timing {label}: the bodies' {k} "
                                 "differ")


def compare_case(label, case, bodies, turns):
    """One case in turns (P = previous, C = committed): the bodies'
    outputs and candidates per job held equal; the numbers."""
    ms = {"P": [], "C": []}
    ref = cand = steps = None
    for turn in turns:
        (vec, bc, n_eval, n_steps), t = timed(
            lambda: run_body(bodies[turn], case, turn == "C"))
        ms[turn].append(t)
        if ref is None:
            ref, cand = (vec, bc), n_eval
        same(label, ref, (vec, bc))
        if not torch.equal(cand, n_eval):
            raise AssertionError(f"k6_timing {label}: the bodies' "
                                 "candidate counts differ")
        if n_steps is not None:
            steps = n_steps
    ctx = case[0]
    res = {"case": label, "jobs": case[2][0].shape[0],
           "blocks": ctx.nblk[0] * ctx.nblk[1], "level": ctx.level,
           "candidates": int(cand.sum()), "rescued": int(ref[1].sum()),
           "ms_previous": ms["P"], "ms_committed": ms["C"],
           "turns": turns}
    if steps is not None:
        res.update(steps=int(steps.sum()), steps_most_a_job=int(steps.max()))
    return res


def item_args(dev):
    """chip_smoke.py exact_vs_plain's Recalculate case: the arguments of
    ops/exact_scan.py::search_blocks for one 1080p gray job (blk 16
    overlap 8, HEX2, on a blk 16 lockstep analysis)."""
    from mvtools_tpu_torch import (AnalyseConfig, RecalculateConfig,
                                   SuperConfig, analyse_batch)
    from mvtools_tpu_torch.analyse import _level_ctx
    from mvtools_tpu_torch.recalculate import _interpolate_old_vectors
    gfmt = cs.VideoFormat(cs.W, cs.H, 8, cs.ColorFamily.GRAY)
    gclip = cs.make_test_clip_yuv(3, cs.W, cs.H, seed=1, flash=cs.FLASH,
                                  noise=cs.YUV_NOISE, pan=cs.YUV_PAN,
                                  device=dev)[0]
    gs = SuperConfig(pel=2, levels=0, chroma=False).validate(gfmt)
    ga = AnalyseConfig(blksize=16, levels=0, truemotion=True,
                       chroma=False).validate(gs)
    rcfg = RecalculateConfig(blksize=16, overlap=8, thsad=200, chroma=False)
    rspec = rcfg.to_analyse_config().validate(gs)
    gsups = cs.build_super([gclip], gs)
    s1 = gsups.take(torch.tensor([1], device=dev))
    r1 = gsups.take(torch.tensor([0], device=dev))
    old = analyse_batch(s1, r1, ga)
    ctx = _level_ctx(gs, rspec, 0, s1, r1)
    px, py, _ = _interpolate_old_vectors(old.levels[0], ga.meta, rspec.meta,
                                         rcfg.smooth, ctx.log_pel)
    thsad = int(rcfg.thsad * 255 / 255.0 + 0.5) * 16 * 16 // 64
    return (ctx, rspec.search, rspec.n_search_param, px.reshape(1, -1),
            py.reshape(1, -1), rspec.lambda_ // (ctx.pel * ctx.pel),
            rspec.pnew, thsad)


def item_case(prev_search, dev):
    """K6' (Recalculate's per-item search) under both bodies in turns
    (P/C/C/P): device ms (torch.profiler) and outputs held equal."""
    args = item_args(dev)
    ctx, search, param, px, py, lam, pnew, thsad = args
    srcs, refs = es._planes(ctx)
    g = es.scan_geom(ctx, recalculate=True)
    a = es._args(ctx, g, refs, search=int(search), param=param, pzero=0,
                 pglobal=0, badsad=0, badrange=0, trymany=0, meander=0,
                 lsad=0, lambda_level=lam, pnew=pnew, verybig=0, smallest=0,
                 thsad=thsad)
    pxi, pyi = px.to(I32).contiguous(), py.to(I32).contiguous()

    def previous():
        out = [torch.empty_like(pxi), torch.empty_like(pyi),
               torch.empty(pxi.shape, dtype=I64, device=dev)]
        err = prev_search(srcs[0].data_ptr(), None, None, refs[0].data_ptr(),
                          None, None, pxi.data_ptr(), pyi.data_ptr(),
                          *(t.data_ptr() for t in out), None, a,
                          _stream(pxi.device))
        cuda_build.check_launch(err, "exact_search_previous")
        return out

    bodies = {"P": previous, "C": lambda: es.search_blocks(*args)}
    names = {"P": r"exact_search_previous_kernel<unsigned char>",
             "C": cs.EXACT_KERNEL_NAMES["exact_search"]}
    want = es.search_blocks(*args)
    ms = {"P": [], "C": []}
    for turn in "PCCP":
        got = bodies[turn]()
        for x, y in zip(want, got):
            if not torch.equal(x, y):
                raise AssertionError("k6_timing: K6' bodies differ")
        ms[turn].append(cs.time_device(bodies[turn], 5, names[turn]))
    return {"case": "recalculate 1080p gray, 1 job, "
                    f"{px.numel()} items", "device_ms_previous": ms["P"],
            "device_ms_committed": ms["C"], "turns": "PCCP"}


def level0(sups, src, ref, aspec):
    levels = cs.capture_levels(lambda: analyse_exact_jobs(
        sups.take(src), sups.take(ref), aspec))
    return next(c for c in levels if c[0].level == 0)


def strip_case(case, out):
    """exact_vs_plain's strip: the STRIP_ROWS block rows of level 0 that
    the whole level's scan left with the most blocks over badsad."""
    ctx, plan, vin, gx, gy, zs = case
    nbx, nby = ctx.nblk
    bad = (out[0][2].reshape(-1, nby, nbx) > plan["badsad"]).sum(
        dim=(0, 2)).cpu()
    upto = torch.cat([torch.zeros(1, dtype=bad.dtype), bad.cumsum(0)])
    rows = cs.STRIP_ROWS
    first = int(torch.argmax(upto[rows:] - upto[:-rows]))
    sctx, svin, first = cs.strip_of(ctx, vin, rows, first)
    return (sctx, plan, svin, gx, gy, zs), first


def latency_probes(lib, dev):
    """ns of one dependent L2 load and of one CTA round (k6_latency.cu),
    each by CUDA events over a long chain after a warm-up."""
    n = 4 << 20                           # 16 MB of indices: in L2, not L1
    gen = torch.Generator().manual_seed(0)
    order = torch.randperm(n, generator=gen)
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[order] = torch.roll(order, -1).to(torch.int32)
    nxt = nxt.to(dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    st = _stream(sink.device)
    lib.mvt_l2_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.mvt_cta_reduce.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
    nxt.sum()                              # bring the chain into L2
    steps, rounds = 200000, 200000
    res = {}
    for name, call, count in (
            ("l2_load_ns", lambda: lib.mvt_l2_chase(nxt.data_ptr(), steps,
                                                    sink.data_ptr(), st),
             steps),
            ("cta_round_ns", lambda: lib.mvt_cta_reduce(rounds,
                                                        sink.data_ptr(), st),
             rounds)):
        call()
        _, t = timed(call)
        res[name] = t * 1e6 / count
    res["step_ns"] = res["l2_load_ns"] + res["cta_round_ns"]
    return res


def small_case(dev):
    """One 128x96 level of 2 jobs (the gray three-level search) under the
    committed body, held to the plain version on the CPU."""
    name, planes, sspec, aspec, src, ref, fs = cs.exact_option_runs(
        8, cs.SMALL_W // 2, cs.SMALL_H // 2)[0]
    sups = cs.build_super([p.to(dev) for p in planes], sspec)
    levels = cs.capture_levels(lambda: analyse_exact_jobs(
        sups.take(src.to(dev)), sups.take(ref.to(dev)), aspec, fs))
    ctx, plan, vin, gx, gy, zs = levels[-1]
    got = es._launch_scan(ctx, plan, vin, gx, gy, zs)
    torch.cuda.synchronize()
    cpu = cs.exact_case(f"{name} level {ctx.level}", ctx, plan, vin, gx,
                        gy, zs, plain_dev="cpu")
    emit({"phase": "small", **cpu, "rescued": int(got[1].sum())})


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_timing: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi})
    if "--small" in sys.argv[1:]:
        cuda_build.build_all()
        small_case(dev)
        return
    bodies, lat = build()
    scfg, acfg, _, _ = cs.flagship_configs()
    fmt = cs.VideoFormat(cs.W, cs.H, 8, cs.ColorFamily.YUV420)
    sspec = scfg.validate(fmt)
    aspec = cs.dataclasses.replace(acfg, isb=True).validate(sspec)
    clip = cs.make_test_clip_yuv(cs.EXACT_T, cs.W, cs.H, seed=0,
                                 flash=cs.FLASH, noise=cs.YUV_NOISE,
                                 pan=cs.YUV_PAN, device=dev)
    two = level0(cs.build_super([p[:4] for p in clip], sspec),
                 torch.tensor([1, 2], device=dev),
                 torch.tensor([0, 3], device=dev), aspec)
    if "--check" in sys.argv[1:]:
        emit({"phase": "check", **compare_case("level 0, 2 jobs", two,
                                               bodies, "PC")})
        small_case(dev)
        return
    variants = build_variants()
    emit({"phase": "variants", "case": "level 0, 2 jobs",
          **variant_cases(two, variants)})
    if "--variants" in sys.argv[1:]:
        return
    t, r = cs.EXACT_T, 3
    cur = torch.arange(t, device=dev).repeat(r)
    sups = cs.build_super(clip, sspec)
    many = level0(sups, torch.cat([cur, cur]),
                  torch.cat([neighbour_index(t, r, 1, dev),
                             neighbour_index(t, r, -1, dev)]), aspec)
    out = es._launch_scan(*two)
    strip, first = strip_case(two, out)
    probes = latency_probes(lat, dev)
    emit({"phase": "latency_probes", **probes})
    emit({"phase": "k6_item_timing", **item_case(bodies["P_search"], dev)})
    for label, case in (("level 0, 2 jobs", two), ("level 0, 48 jobs", many),
                        (f"level-0 strip from row {first}", strip)):
        res = compare_case(label, case, bodies, "PCCP")
        res["latency_bound_ms"] = (res["steps_most_a_job"]
                                   * probes["step_ns"] / 1e6)
        emit({"phase": "k6_timing", **res})


if __name__ == "__main__":
    main()
