"""Run a motion-compensated pipeline of the PyTorch port over a y4m stream.

The counterpart of tools/mvtools_run.py, with the same pipelines, flags,
per-frame calls and frame handling: frames stream through the native
prefetching reader (native/y4m.cc, io/y4m.py), the pipeline runs on the
card (or on the CPU with --device cpu), and results stream out as y4m.

Examples:
  python -m mvtools_tpu_torch.cli degrain1 in.y4m out.y4m --blksize 16
  python -m mvtools_tpu_torch.cli degrain3 in.y4m out.y4m --thsad 600
  python -m mvtools_tpu_torch.cli compensate in.y4m out.y4m --thsad 400
  python -m mvtools_tpu_torch.cli flowfps in.y4m out.y4m --num 60 --den 1
  python -m mvtools_tpu_torch.cli blockfps in.y4m out.y4m --num 60 --den 1
  python -m mvtools_tpu_torch.cli flow in.y4m out.y4m --time 50
  python -m mvtools_tpu_torch.cli mask in.y4m out.y4m --kind 0
  python -m mvtools_tpu_torch.cli scdetect in.y4m out.y4m
  python -m mvtools_tpu_torch.cli stabilise in.y4m out.y4m --method 0
  python -m mvtools_tpu_torch.cli flowinter in.y4m out.y4m --time 50
  python -m mvtools_tpu_torch.cli flowblur in.y4m out.y4m --blur 50
  python -m mvtools_tpu_torch.cli finest in.y4m out.y4m --pel 2
  python -m mvtools_tpu_torch.cli recalculate in.y4m out.y4m \\
      --recalc-blksize 8
  python -m mvtools_tpu_torch.cli depancompensate in.y4m out.y4m \\
      --offset -1
  python -m mvtools_tpu_torch.cli degrain3 in.y4m out.y4m --device cpu
"""

import argparse
import dataclasses
import sys
import time
from fractions import Fraction

PIPELINES = ["degrain1", "degrain2", "degrain3", "degrain4", "degrain5",
             "degrain6", "compensate", "flowfps", "blockfps", "flow",
             "mask", "scdetect", "stabilise", "flowinter", "flowblur",
             "finest", "recalculate", "depancompensate"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pipeline", choices=PIPELINES)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--blksize", type=int, default=16)
    ap.add_argument("--pel", type=int, default=2)
    ap.add_argument("--levels", type=int, default=0)
    ap.add_argument("--overlap", type=int, default=0)
    ap.add_argument("--thsad", type=int, default=400)
    ap.add_argument("--search", type=int, default=4)
    ap.add_argument("--method", type=int, default=0)
    ap.add_argument("--num", type=int, default=0,
                    help="flowfps/blockfps output fps numerator "
                         "(default: double the input rate)")
    ap.add_argument("--den", type=int, default=0)
    ap.add_argument("--maskmode", type=int, default=2)
    ap.add_argument("--mode", type=int, default=0,
                    help="blockfps mode / mask kind alias")
    ap.add_argument("--kind", type=int, default=0, help="mask kind 0-5")
    ap.add_argument("--time", type=float, default=100.0)
    ap.add_argument("--ml", type=float, default=100.0)
    ap.add_argument("--blur", type=float, default=50.0,
                    help="flowblur blur length (0-200)")
    ap.add_argument("--prec", type=int, default=1,
                    help="flowblur precision (subsample of blur steps)")
    ap.add_argument("--recalc-blksize", type=int, default=8,
                    help="recalculate pipeline: refined block size")
    ap.add_argument("--offset", type=float, default=-1.0,
                    help="depancompensate time offset in frames")
    ap.add_argument("--fields", action="store_true",
                    help="input is field-separated (interlaced)")
    ap.add_argument("--tff", type=int, default=None, choices=[0, 1],
                    help="top field first (required with --fields)")
    ap.add_argument("--engine", default="lockstep",
                    choices=["lockstep", "exact"])
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the pipeline runs (cuda raises without a "
                         "card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from . import AnalyseConfig, SuperConfig, analyse, build_super
    from .compensate import CompensateConfig, compensate
    from .convert import require_device
    from .core.fields import field_shift
    from .core.types import ColorFamily, VideoFormat
    from .degrain import DegrainConfig
    from .io import Y4MReader, Y4MWriter

    dev = require_device(args.device)

    def load(f):
        return [torch.from_numpy(p).to(dev) for p in f]

    r = Y4MReader(args.input)
    fam = {(1, 1): ColorFamily.YUV444 if r.planes == 3 else ColorFamily.GRAY,
           (2, 2): ColorFamily.YUV420,
           (2, 1): ColorFamily.YUV422}[(r.sub_w, r.sub_h)]
    fmt = VideoFormat(r.width, r.height, r.bits, fam)
    chroma = r.planes == 3
    tff = None if args.tff is None else bool(args.tff)

    scfg = SuperConfig(pel=args.pel, levels=args.levels, chroma=chroma)
    sspec = scfg.validate(fmt)
    acfg = AnalyseConfig(blksize=args.blksize, levels=args.levels,
                         truemotion=True, chroma=chroma,
                         overlap=args.overlap, fields=args.fields, tff=tff)

    out_fps = (r.fps_num, r.fps_den)
    if args.pipeline in ("flowfps", "blockfps"):
        if args.num and args.den:
            out_fps = (args.num, args.den)
        else:
            out_fps = (r.fps_num * 2, r.fps_den)

    w = Y4MWriter(args.output, r.width, r.height, out_fps, r.sub_w,
                  r.sub_h, r.bits, r.planes)

    t0 = time.perf_counter()
    n = 0

    def fs(src_n, ref_n):
        return field_shift(src_n, ref_n, args.pel, args.fields, tff)

    if args.pipeline.startswith("degrain"):
        radius = int(args.pipeline[len("degrain"):])
        from .models.denoise import degrain_n_frame
        aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
        aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
        dcfg = DegrainConfig(thsad=args.thsad)

        frames_in = []
        for f in r:
            frames_in.append(load(f))
            if args.max_frames and len(frames_in) >= args.max_frames + radius:
                break
        total = len(frames_in)
        for i in range(total):
            if args.max_frames and n >= args.max_frames:
                break
            prevs = [frames_in[max(i - k, 0)] for k in range(1, radius + 1)]
            nexts = [frames_in[min(i + k, total - 1)]
                     for k in range(1, radius + 1)]
            vb = [i + k <= total - 1 for k in range(1, radius + 1)]
            vf = [i - k >= 0 for k in range(1, radius + 1)]
            fb = [fs(i, i + k) for k in range(1, radius + 1)]
            ff = [fs(i, i - k) for k in range(1, radius + 1)]
            out = degrain_n_frame(frames_in[i], prevs, nexts, sspec, aspec_b,
                                  aspec_f, dcfg, engine=args.engine,
                                  valid_b=vb, valid_f=vf, field_shift_b=fb,
                                  field_shift_f=ff)
            w.write(out)
            n += 1
    elif args.pipeline == "compensate":
        aspec = dataclasses.replace(acfg, isb=False).validate(sspec)
        ccfg = CompensateConfig(thsad=args.thsad * 25, fields=args.fields,
                                tff=tff)

        def comp(cur, prv, fshift):
            s_cur = build_super(cur, scfg, fmt)
            s_prev = build_super(prv, scfg, fmt)
            mv = analyse(s_cur, s_prev, aspec, engine=args.engine,
                         field_shift=fshift)
            return compensate(s_cur, s_prev, mv, aspec.meta, ccfg,
                              field_shift=fshift)

        prev = None
        i = 0
        for f in r:
            f = load(f)
            fshift = fs(i, i - 1) if prev is not None else 0
            out = comp(f, prev if prev is not None else f, fshift)
            w.write(out)
            prev = f
            n += 1
            i += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.pipeline in ("flowfps", "blockfps"):
        from .blockfps import BlockFPSConfig, blockfps_frame
        from .flowfps import (FlowFPSConfig, flowfps_frame,
                              output_frame_mapping)
        aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
        aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)

        frames_in = [load(f) for f in r]
        total = len(frames_in)
        # retiming (MVFlowFPS.c:736-757): fa/fb = reduced in/out rate
        # ratio; output count = 1 + (N-1) * fb / fa
        fa = Fraction(out_fps[1] * r.fps_num, out_fps[0] * r.fps_den)
        n_out = int(1 + (total - 1) / fa)
        if args.pipeline == "flowfps":
            fcfg = FlowFPSConfig(maskmode=args.maskmode, ml=args.ml)
            synth_frame = flowfps_frame
        else:
            fcfg = BlockFPSConfig(mode=args.mode, ml=args.ml)
            synth_frame = blockfps_frame

        def synth(cur, nxt, t256):
            s_cur = build_super(cur, scfg, fmt)
            s_next = build_super(nxt, scfg, fmt)
            mv_b = analyse(s_cur, s_next, aspec_b, engine=args.engine)
            mv_f = analyse(s_next, s_cur, aspec_f, engine=args.engine)
            return synth_frame(cur, nxt, s_cur, s_next, mv_b, mv_f,
                               aspec_b.meta, fcfg, t256)

        for i in range(n_out):
            if args.max_frames and n >= args.max_frames:
                break
            nleft, nright, t256 = output_frame_mapping(i, fa, 1)
            nleft = min(nleft, total - 1)
            nright = min(nright, total - 1)
            if t256 == 0 or nleft == nright:
                out = frames_in[nleft]
            elif t256 == 256:
                out = frames_in[nright]
            else:
                out = synth(frames_in[nleft], frames_in[nright], t256)
            w.write(out)
            n += 1
    elif args.pipeline == "flow":
        from .flow import FlowConfig, flow
        aspec = dataclasses.replace(acfg, isb=False).validate(sspec)
        flcfg = FlowConfig(time=args.time, mode=args.mode)

        def fl(cur, prv):
            s_cur = build_super(cur, scfg, fmt)
            s_prev = build_super(prv, scfg, fmt)
            mv = analyse(s_cur, s_prev, aspec, engine=args.engine)
            return flow(cur, s_prev, mv, aspec.meta, flcfg)

        prev = None
        for f in r:
            f = load(f)
            out = fl(f, prev if prev is not None else f)
            w.write(out)
            prev = f
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.pipeline == "mask":
        from .mask import MaskConfig, mask as mask_fn
        aspec = dataclasses.replace(acfg, isb=False).validate(sspec)
        mcfg = MaskConfig(kind=args.kind, ml=args.ml)

        def mk(cur, prv):
            s_cur = build_super(cur, scfg, fmt)
            s_prev = build_super(prv, scfg, fmt)
            mv = analyse(s_cur, s_prev, aspec, engine=args.engine)
            return mask_fn(cur, mv, aspec.meta, mcfg)

        prev = None
        for f in r:
            f = load(f)
            out = mk(f, prev if prev is not None else f)
            w.write(out)
            prev = f
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.pipeline == "flowinter":
        from .flowinter import FlowInterConfig, flowinter
        aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
        aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
        ficfg = FlowInterConfig(time=args.time, ml=args.ml)

        def fi(cur, nxt):
            s_cur = build_super(cur, scfg, fmt)
            s_next = build_super(nxt, scfg, fmt)
            mv_b = analyse(s_cur, s_next, aspec_b, engine=args.engine)
            mv_f = analyse(s_next, s_cur, aspec_f, engine=args.engine)
            return flowinter(cur, nxt, s_cur, s_next, mv_b, mv_f,
                             aspec_b.meta, ficfg)

        frames_in = []
        for f in r:
            frames_in.append(load(f))
            if args.max_frames and len(frames_in) > args.max_frames:
                break
        for i in range(len(frames_in)):
            if args.max_frames and n >= args.max_frames:
                break
            nxt = frames_in[min(i + 1, len(frames_in) - 1)]
            out = (frames_in[i] if i == len(frames_in) - 1
                   else fi(frames_in[i], nxt))
            w.write(out)
            n += 1
    elif args.pipeline == "flowblur":
        from .flowblur import FlowBlurConfig, flowblur
        aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
        aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
        fbcfg = FlowBlurConfig(blur=args.blur, prec=args.prec)

        def fb(prv, cur, nxt):
            # mvbw@(n-1) = search(n-1, n), mvfw@(n+1) = search(n+1, n)
            # (MVFlowBlur.c:152-181 with off=1)
            s_prev = build_super(prv, scfg, fmt)
            s_cur = build_super(cur, scfg, fmt)
            s_next = build_super(nxt, scfg, fmt)
            mv_b = analyse(s_prev, s_cur, aspec_b, engine=args.engine)
            mv_f = analyse(s_next, s_cur, aspec_f, engine=args.engine)
            return flowblur(cur, s_cur, mv_b, mv_f, aspec_b.meta, fbcfg)

        frames_in = []
        for f in r:
            frames_in.append(load(f))
            if args.max_frames and len(frames_in) > args.max_frames + 1:
                break
        total = len(frames_in)
        for i in range(total):
            if args.max_frames and n >= args.max_frames:
                break
            out = fb(frames_in[max(i - 1, 0)], frames_in[i],
                     frames_in[min(i + 1, total - 1)])
            w.write(out)
            n += 1
    elif args.pipeline == "finest":
        from .finest import finest as finest_fn
        # output is the pel-interleaved full-resolution frame
        # (w*pel x h*pel, Merge4PlanesToBig MVFinest.c)
        w.close()
        w = Y4MWriter(args.output, r.width * args.pel,
                      r.height * args.pel, out_fps, r.sub_w, r.sub_h,
                      r.bits, r.planes)
        for f in r:
            w.write(finest_fn(build_super(load(f), scfg, fmt)))
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    elif args.pipeline == "recalculate":
        # MAnalyse -> MRecalculate (refined grid) -> MDegrain1: the
        # standard two-stage vector pipeline of the reference
        from .degrain import degrain as degrain_fn
        from .recalculate import RecalculateConfig, recalculate
        aspec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
        aspec_f = dataclasses.replace(acfg, isb=False).validate(sspec)
        rcfg = RecalculateConfig(blksize=args.recalc_blksize,
                                 thsad=args.thsad // 2, chroma=chroma,
                                 truemotion=True)
        rspec_b = rspec_f = rcfg.to_analyse_config().validate(sspec)
        dcfg = DegrainConfig(thsad=args.thsad)

        def rec(cur, prv, nxt):
            s_cur = build_super(cur, scfg, fmt)
            s_prev = build_super(prv, scfg, fmt)
            s_next = build_super(nxt, scfg, fmt)
            mv_b = analyse(s_cur, s_next, aspec_b, engine=args.engine)
            mv_f = analyse(s_cur, s_prev, aspec_f, engine=args.engine)
            mv_b = recalculate(s_cur, s_next, mv_b, rspec_b, rcfg,
                               engine=args.engine)
            mv_f = recalculate(s_cur, s_prev, mv_f, rspec_f, rcfg,
                               engine=args.engine)
            return degrain_fn(cur, [s_next, s_prev], [mv_b, mv_f],
                              rspec_b.meta, dcfg)

        frames_in = []
        for f in r:
            frames_in.append(load(f))
            if args.max_frames and len(frames_in) > args.max_frames + 1:
                break
        total = len(frames_in)
        for i in range(total):
            if args.max_frames and n >= args.max_frames:
                break
            out = rec(frames_in[i], frames_in[max(i - 1, 0)],
                      frames_in[min(i + 1, total - 1)])
            w.write(out)
            n += 1
    elif args.pipeline == "depancompensate":
        from .depan import (DepanCompensateConfig, DepanEstimateConfig,
                            depan_compensate, depan_estimate)
        frames = []
        for f in r:
            frames.append(load(f))
            if args.max_frames and len(frames) >= args.max_frames:
                break
        luma = torch.stack([f[0] for f in frames]).to(torch.float32)
        dx, dy, zoom, _ = depan_estimate(luma, DepanEstimateConfig())
        motions = torch.stack([dx, dy, zoom, torch.zeros_like(dx)],
                              dim=1).cpu().numpy()
        dccfg = DepanCompensateConfig(offset=args.offset)
        intoff = dccfg.intoffset
        for ndest in range(len(frames)):
            nsrc = ndest - intoff
            src = frames[min(max(nsrc, 0), len(frames) - 1)]
            w.write(depan_compensate(src, motions, ndest, len(frames),
                                     dccfg, sub_w=r.sub_w - 1,
                                     sub_h=r.sub_h - 1, bits=r.bits))
            n += 1
    elif args.pipeline == "scdetect":
        from .scdetect import SCDetectionConfig, scdetect
        aspec = dataclasses.replace(acfg, isb=False).validate(sspec)
        sccfg = SCDetectionConfig()

        def sc(cur, prv):
            s_cur = build_super(cur, scfg, fmt)
            s_prev = build_super(prv, scfg, fmt)
            mv = analyse(s_cur, s_prev, aspec, engine=args.engine)
            return scdetect(mv, aspec.meta, sccfg)

        prev = None
        for f in r:
            planes = f
            f = load(f)
            flag = bool(sc(f, prev if prev is not None else f))
            # scene-change flag rendered as a constant frame (255 = change)
            val = 255 if flag else 0
            w.write([np.full_like(p, val) for p in planes])
            prev = f
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    else:  # stabilise
        from .depan import DepanStabiliseConfig
        from .models.stabilize import stabilize_clip
        frames = []
        for f in r:
            frames.append(load(f))
            if args.max_frames and len(frames) >= args.max_frames:
                break
        cfg = DepanStabiliseConfig(
            method=args.method, fps=r.fps_num / max(r.fps_den, 1))
        for out in stabilize_clip(frames, scfg=cfg, sub_w=r.sub_w - 1,
                                  sub_h=r.sub_h - 1, bits=r.bits):
            w.write(out)
            n += 1

    w.close()
    r.close()
    dt = time.perf_counter() - t0
    print(f"{args.pipeline}: {n} frames in {dt:.2f}s "
          f"({n / dt:.2f} fps)", file=sys.stderr)


if __name__ == "__main__":
    main()
