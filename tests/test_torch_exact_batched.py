"""PyTorch port: K6's batched body (csrc/exact_scan.cu: a team of groups
that evaluates each search step's candidates at once and folds them in the
reference's order) against the plain version, on the CPU, tolerance 0.

The kernel source is built for the host with g++ twice: at one thread, and
at the card's CTA of 256 threads (8 groups of 32 lanes run as loops: the
same partition of candidates over groups and of pixels over lanes, and the
same fold, as on the card).  Both are held to exact_engine.search_level
level by level (vectors, SADs and rescue counts per job), and their
candidate counts to the previous body's (experiments/k6_previous.cu, one
candidate at a time, built for the host too): the redesign evaluates no
candidate more and none fewer.  Recalculate's per-item search (the same
step code with one group) is held to exact_engine.search_items.  Last, the
exact engine's one call for both directions in degrain_clip against one
call per direction.  Inputs: seeded numpy planes, 128x96 at blk 8 (64x48
for the ties, flat planes and checkerboards, and for the edges)."""
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from mvtools_tpu_torch.analyse import (_level_ctx, _level_plan,  # noqa: E402
                                       analyse_exact_jobs)
from mvtools_tpu_torch.core.config import AnalyseConfig, SuperConfig  # noqa: E402,E501
from mvtools_tpu_torch.core.types import (ColorFamily, SearchType,  # noqa: E402
                                          VideoFormat)
from mvtools_tpu_torch.degrain import DegrainConfig  # noqa: E402
from mvtools_tpu_torch.models import denoise  # noqa: E402
from mvtools_tpu_torch.ops import cuda_build  # noqa: E402
from mvtools_tpu_torch.ops import exact_scan as es  # noqa: E402
from mvtools_tpu_torch.super import build_super  # noqa: E402

W, H = 128, 96
CTA_THREADS = 256
PREVIOUS = cuda_build.CSRC.parent / "experiments" / "k6_previous.cu"

_HOST_SOURCE = r"""
#include "%(source)s"
using namespace %(ns)s;
template <typename T>
static void pick(const void* const* s, const void* const* r, const T** ps,
                 const T** pr) {
    for (int i = 0; i < 3; ++i) { ps[i] = (const T*)s[i]; pr[i] = (const T*)r[i]; }
}
extern "C" void host_scan(const void* const* s, const void* const* r,
                          int* vx, int* vy, long long* vs, const int* gx,
                          const int* gy, const int* zs, int* badcount,
                          long long* n_eval, long long* n_steps,
                          const int* a) {
    Params p;
    for (int i = 0; i < P_COUNT; ++i) p.v[i] = a[i];
    (void)n_steps;
    for (int job = 0; job < a[P_JOBS]; ++job) {
        if (a[P_U16]) {
            const uint16_t *ps[3], *pr[3];
            pick(s, r, ps, pr);
            scan_job<uint16_t>(p, ps, pr, vx, vy, vs, gx, gy, zs, badcount,
                               n_eval, job %(steps)s);
        } else {
            const uint8_t *ps[3], *pr[3];
            pick(s, r, ps, pr);
            scan_job<uint8_t>(p, ps, pr, vx, vy, vs, gx, gy, zs, badcount,
                              n_eval, job %(steps)s);
        }
    }
}
extern "C" void host_search(const void* const* s, const void* const* r,
                            const int* px, const int* py, int* ox, int* oy,
                            long long* os, int* n_eval, const int* a) {
    Params p;
    for (int i = 0; i < P_COUNT; ++i) p.v[i] = a[i];
    const long long n = (long long)a[P_JOBS] * a[P_NBX] * a[P_NBY];
    for (long long it = 0; it < n; ++it) {
        const uint8_t *ps[3], *pr[3];
        pick(s, r, ps, pr);
        search_item<uint8_t>(p, ps, pr, px, py, ox, oy, os, n_eval, it);
    }
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"one": the body at 1 thread, "cta": at 256, "previous": the
    previous body}, built in parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of csrc/exact_scan.cu "
                    "needs a C++ compiler")
    tmp = tmp_path_factory.mktemp("k6_host")
    builds = {"one": (cuda_build.CSRC / "exact_scan.cu", "mvt_exact", 1),
              "cta": (cuda_build.CSRC / "exact_scan.cu", "mvt_exact",
                      CTA_THREADS),
              "previous": (PREVIOUS, "mvt_exact_previous", 1)}
    procs = {}
    for name, (source, ns, threads) in builds.items():
        drv = tmp / f"{name}.cpp"
        drv.write_text(_HOST_SOURCE % dict(
            source=source, ns=ns,
            steps="" if name == "previous" else ", n_steps"))
        lib = tmp / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", f"-DMVT_THREADS={threads}", "-o", str(lib), str(drv)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    vp = ctypes.c_void_p
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        dll = ctypes.CDLL(str(lib))
        dll.host_scan.argtypes = [ctypes.POINTER(vp)] * 2 + [vp] * 9 + [
            ctypes.POINTER(ctypes.c_int)]
        dll.host_search.argtypes = [ctypes.POINTER(vp)] * 2 + [vp] * 6 + [
            ctypes.POINTER(ctypes.c_int)]
        out[name] = dll
    return out


def _ptrs(ts):
    ts = list(ts) + [None] * (3 - len(ts))
    return (ctypes.c_void_p * 3)(*(None if t is None else t.data_ptr()
                                   for t in ts))


def host_scan(lib, ctx, plan, vin, gx, gy, zs):
    """One level of every job through a host build: ((x, y, sad),
    badcount, candidates, steps), each per job."""
    srcs, refs = es._planes(ctx)
    vx, vy = (v.to(torch.int32).contiguous().clone() for v in vin[:2])
    vs = vin[2].to(torch.int64).contiguous().clone()
    gx, gy, zs = (t.to(torch.int32).contiguous() for t in (gx, gy, zs))
    nj = vx.shape[0]
    bc = torch.zeros(nj, dtype=torch.int32)
    n_eval = torch.zeros(nj, dtype=torch.int64)
    n_steps = torch.zeros(nj, dtype=torch.int64)
    args = es._args(ctx, es.scan_geom(ctx), refs, **es._plan_args(plan))
    lib.host_scan(_ptrs(srcs), _ptrs(refs), vx.data_ptr(), vy.data_ptr(),
                  vs.data_ptr(), gx.data_ptr(), gy.data_ptr(), zs.data_ptr(),
                  bc.data_ptr(), n_eval.data_ptr(), n_steps.data_ptr(), args)
    return (vx, vy, vs), bc, n_eval, n_steps


class Checked:
    """es.scan_level replaced by the plain version, each level also run by
    the three host builds and held to it; the per-level records."""

    def __init__(self, libs, monkeypatch):
        self.libs, self.seen = libs, []
        monkeypatch.setattr(es, "scan_level", self)

    def __call__(self, ctx, plan, vin, gx, gy, zs):
        want = es.scan_level_plain(ctx, plan, vin, gx, gy, zs)
        runs = {k: host_scan(lib, ctx, plan, vin, gx, gy, zs)
                for k, lib in self.libs.items()}
        for name, (vec, bc, _, _) in runs.items():
            for k, a, b in zip("xys", want[0], vec):
                assert torch.equal(a, b), f"{name} level {ctx.level} {k}"
            assert torch.equal(want[1], bc), f"{name} level {ctx.level}"
        # candidates: the same whatever the partition, and the previous
        # body's; steps: the same at either thread count
        assert torch.equal(runs["one"][2], runs["previous"][2])
        assert torch.equal(runs["cta"][2], runs["previous"][2])
        assert torch.equal(runs["one"][3], runs["cta"][3])
        self.seen.append(dict(level=ctx.level, rescued=int(want[1].sum()),
                              candidates=int(runs["cta"][2].sum()),
                              steps=int(runs["cta"][3].sum())))
        return want


def clip_planes(family="GRAY", bits=8, frames=4, seed=0, flat=None,
                w=W, h=H):
    """Seeded numpy planes [T, h, w]: noise panned (2, 1) px a frame, a
    flashing region (frame 1 saturated, frame 2 dark), at 16 bits each
    sample v as (v << 8) | r with r a fresh byte; `flat`: every frame one
    level, flat[t]."""
    rng = np.random.default_rng(seed)
    subs = (0, 1, 1) if family == "YUV420" else (0,)
    out = []
    for sub in subs:
        pw, ph = w >> sub, h >> sub
        if flat is not None:
            o = np.stack([np.full((ph, pw), v, np.uint8) for v in flat])
        else:
            base = rng.integers(0, 256, (ph + 32, pw + 32), np.uint8)
            o = np.empty((frames, ph, pw), np.uint8)
            for t in range(frames):
                dy, dx = (t * 1) >> sub, (t * 2) >> sub
                o[t] = base[dy:dy + ph, dx:dx + pw]
            y0, x0, fh, fw = ph // 4, pw // 4, ph // 3, pw // 3
            o[1, y0:y0 + fh, x0:x0 + fw] = 255
            o[2, y0:y0 + fh, x0:x0 + fw] >>= 3
        if bits > 8:
            low = rng.integers(0, 256, o.shape, np.uint16)
            o = (o.astype(np.uint16) << 8) | low
        out.append(o)
    return out


def analyse_checked(checked, planes, family, bits, skw, akw, jobs, fs=0,
                    isb=True):
    """analyse_exact_jobs of `jobs` (src, ref) with every level checked."""
    w, h = planes[0].shape[2], planes[0].shape[1]
    fmt = VideoFormat(w, h, bits, getattr(ColorFamily, family))
    sspec = SuperConfig(**skw).validate(fmt)
    aspec = dataclasses.replace(AnalyseConfig(**akw), isb=isb).validate(
        sspec)
    sups = build_super([torch.from_numpy(p) for p in planes], sspec)
    first = len(checked.seen)
    analyse_exact_jobs(sups.take(torch.tensor([a for a, _ in jobs])),
                       sups.take(torch.tensor([b for _, b in jobs])), aspec,
                       fs)
    return checked.seen[first:]


GRAY = dict(chroma=False)
JOBS = ((1, 2), (2, 0))       # the flash against calm, and the reverse


def test_every_search_type_matches_plain(libs, monkeypatch):
    """The eight search types at searchparam 3, two levels, the flash
    sending blocks through the UMH rescue."""
    checked = Checked(libs, monkeypatch)
    planes = clip_planes()
    rescued = 0
    for st in SearchType:
        seen = analyse_checked(
            checked, planes, "GRAY", 8, dict(pel=2, levels=2, **GRAY),
            dict(blksize=8, levels=2, search=st, searchparam=3, pelsearch=3,
                 truemotion=True, **GRAY), JOBS)
        rescued += sum(s["rescued"] for s in seen)
    assert rescued > 0
    assert len(checked.seen) == 2 * len(SearchType)


def test_options_match_plain(libs, monkeypatch):
    """trymany with the ring rescue and divide at pel 4; YUV420 with
    chroma, overlap, global_ and meander, and without meander; 16 bits at
    pel 1; a field shift per job; a forward spec."""
    checked = Checked(libs, monkeypatch)
    gray, yuv = clip_planes(seed=1), clip_planes("YUV420", seed=2)
    deep = clip_planes(bits=16, seed=3)
    runs = [
        (gray, "GRAY", 8, dict(pel=4, levels=2, **GRAY),
         dict(blksize=8, levels=2, trymany=True, badrange=-6, divide=2,
              truemotion=True, **GRAY), 0),
        (yuv, "YUV420", 8, dict(pel=2, levels=2, chroma=True),
         dict(blksize=8, overlap=4, levels=2, truemotion=True, chroma=True,
              global_=True, meander=True), 0),
        (yuv, "YUV420", 8, dict(pel=2, levels=2, chroma=True),
         dict(blksize=8, overlap=4, levels=2, truemotion=True, chroma=True,
              meander=False, trymany=True), 0),
        (deep, "GRAY", 16, dict(pel=1, levels=2, **GRAY),
         dict(blksize=8, levels=2, search=SearchType.EXHAUSTIVE,
              searchparam=2, pelsearch=2, **GRAY), 0),
        (deep, "GRAY", 16, dict(pel=2, levels=2, **GRAY),
         dict(blksize=8, levels=2, truemotion=True, badrange=12, **GRAY),
         [1, -1]),
    ]
    for planes, family, bits, skw, akw, fs in runs:
        analyse_checked(checked, planes, family, bits, skw, akw, JOBS, fs)
    analyse_checked(checked, gray, "GRAY", 8, dict(pel=2, levels=2, **GRAY),
                    dict(blksize=8, levels=2, truemotion=True, **GRAY),
                    ((1, 0), (2, 1)), isb=False)
    assert sum(s["rescued"] for s in checked.seen) > 0


def checkerboards(frames=4, w=W, h=H):
    """[T, h, w] checkerboards of 100 and 150, frame t in phase t % 2: on
    a pair of opposite phase every full-pel candidate an odd number of
    pixels away costs 0 and every even one the most, so the steps' lowest
    costs tie (without truemotion a cost is the SAD alone)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([(100 + 50 * ((xx + yy + t) & 1)).astype(np.uint8)
                      for t in range(frames)])]


def test_ties_keep_the_first_candidate(libs, monkeypatch):
    """64x48 flat planes (every SAD the same) and checkerboards of opposite
    phase (the hexagon's, the rings', the UMH's odd candidates all cost
    0), at pel 1 and 2, every search type, trymany, and the rescue on
    every block (badsad 0): the fold keeps the reference's first
    candidate among equal costs."""
    checked = Checked(libs, monkeypatch)
    flat = [np.stack([np.full((H // 2, W // 2), v, np.uint8)
                      for v in (100, 100, 130, 100)])]
    for planes in (flat, checkerboards(w=W // 2, h=H // 2)):
        for pel in (1, 2):
            for st in SearchType:
                analyse_checked(checked, planes, "GRAY", 8,
                                dict(pel=pel, levels=2, **GRAY),
                                dict(blksize=8, levels=2, search=st,
                                     searchparam=2, truemotion=False,
                                     **GRAY), ((1, 2), (1, 0)))
        analyse_checked(checked, planes, "GRAY", 8,
                        dict(pel=2, levels=2, **GRAY),
                        dict(blksize=8, levels=2, trymany=True, badsad=0,
                             truemotion=False, **GRAY), ((1, 2), (1, 0)))
    assert sum(s["rescued"] for s in checked.seen) > 0


def test_candidates_past_every_edge(libs, monkeypatch):
    """A 64x48 level whose predictions point far past each edge of the
    plane (the inter-level prediction, the global predictor, the field
    shift), so that trials clip to the bounds and the steps' candidates
    fall out on every side: UMH with its rescue, HEX2, EXHAUSTIVE, ONETIME
    and LOGARITHMIC at pel 2 and pel 1, YUV420."""
    checked = Checked(libs, monkeypatch)
    rng = np.random.default_rng(7)
    planes = clip_planes("YUV420", seed=4, w=64, h=48)
    for pel, st in ((2, SearchType.UMH), (2, SearchType.HEX2),
                    (1, SearchType.EXHAUSTIVE), (2, SearchType.ONETIME),
                    (1, SearchType.LOGARITHMIC)):
        fmt = VideoFormat(64, 48, 8, ColorFamily.YUV420)
        sspec = SuperConfig(pel=pel, levels=1, chroma=True).validate(fmt)
        aspec = dataclasses.replace(AnalyseConfig(
            blksize=8, levels=1, search=st, searchparam=4, pelsearch=4,
            truemotion=True, chroma=True, badsad=0, meander=True),
            isb=True).validate(sspec)
        sups = build_super([torch.from_numpy(p) for p in planes], sspec)
        src, ref = sups.take(torch.tensor([1, 2, 3])), sups.take(
            torch.tensor([0, 1, 2]))
        ctx = _level_ctx(sspec, aspec, 0, src, ref)
        nbx, nby = ctx.nblk
        # vectors far past every edge, in every direction
        far = 4 * 64 * pel
        vin = (torch.from_numpy(rng.integers(-far, far, (3, nbx * nby))
                                .astype(np.int32)),
               torch.from_numpy(rng.integers(-far, far, (3, nbx * nby))
                                .astype(np.int32)),
               torch.from_numpy(rng.integers(0, 5000, (3, nbx * nby))))
        gx = torch.tensor([far, -far, 3], dtype=torch.int32)
        gy = torch.tensor([-far, far, -3], dtype=torch.int32)
        zs = torch.tensor([1, -1, 0], dtype=torch.int32)
        plan = _level_plan(aspec, 0)
        plan = dict(plan, smallest_plane=False)
        checked(ctx, plan, vin, gx, gy + zs, zs)
        checked(ctx, dict(plan, smallest_plane=True), vin, gx, gy + zs, zs)
    assert len(checked.seen) == 10


def test_recalculate_items_match_plain(libs):
    """Recalculate's per-item search (one group, the same steps) against
    exact_engine.search_items for every search type, thsad low enough that
    most blocks refine, predictors past the edges."""
    lib = libs["cta"]
    rng = np.random.default_rng(8)
    planes = clip_planes(seed=5)
    fmt = VideoFormat(W, H, 8, ColorFamily.GRAY)
    sspec = SuperConfig(pel=2, levels=1, chroma=False).validate(fmt)
    sups = build_super([torch.from_numpy(p) for p in planes], sspec)
    src, ref = sups.take(torch.tensor([1, 2])), sups.take(
        torch.tensor([2, 0]))
    refined = 0
    for st in SearchType:
        rspec = AnalyseConfig(blksize=8, overlap=4, levels=1, search=st,
                              searchparam=2, chroma=False).validate(sspec)
        ctx = _level_ctx(sspec, rspec, 0, src, ref)
        nbx, nby = ctx.nblk
        px = torch.from_numpy(rng.integers(-80, 80, (2, nbx * nby))
                              .astype(np.int32))
        py = torch.from_numpy(rng.integers(-60, 60, (2, nbx * nby))
                              .astype(np.int32))
        args = (ctx, st, 2, px, py, 300, 50, 100)
        want = es.search_blocks_plain(*args)
        srcs, refs = es._planes(ctx)
        ox, oy = torch.empty_like(px), torch.empty_like(py)
        osad = torch.empty(px.shape, dtype=torch.int64)
        n_eval = torch.zeros(px.shape, dtype=torch.int32)
        a = es._args(ctx, es.scan_geom(ctx, True), refs, search=int(st),
                     param=2, pzero=0, pglobal=0, badsad=0, badrange=0,
                     trymany=0, meander=0, lsad=0, lambda_level=300,
                     pnew=50, verybig=0, smallest=0, thsad=100)
        lib.host_search(_ptrs(srcs), _ptrs(refs), px.data_ptr(),
                        py.data_ptr(), ox.data_ptr(), oy.data_ptr(),
                        osad.data_ptr(), n_eval.data_ptr(), a)
        for k, x, y in zip("xys", want, (ox, oy, osad)):
            assert torch.equal(x, y), f"{st.name} {k}"
        refined += int((n_eval > 1).sum())
    assert refined > 0


def test_degrain_clip_exact_one_call_for_both_directions(monkeypatch):
    """degrain_clip on the exact engine hands both directions' jobs to one
    analyse_exact_jobs call (one scan a level); its fields equal one call
    per direction's, field for field, each with its own direction's meta;
    a backward and a forward spec that differ in more than the direction
    stay two calls."""
    planes = [torch.from_numpy(p) for p in clip_planes(
        "YUV420", frames=4, seed=6, w=64, h=48)]
    fmt = VideoFormat(64, 48, 8, ColorFamily.YUV420)
    scfg = SuperConfig(pel=2, levels=0, chroma=True)
    acfg = AnalyseConfig(blksize=8, overlap=4, levels=0, truemotion=True,
                         chroma=True)
    calls = []
    real = es.scan_level

    def count(ctx, *a):
        calls.append(ctx.src_planes[0].shape[0])
        return real(ctx, *a)
    monkeypatch.setattr(es, "scan_level", count)
    info = {}
    out = denoise.degrain_clip(planes, fmt, scfg, acfg, DegrainConfig(), 2,
                               info=info)
    sspec = scfg.validate(fmt)
    lv_count = len(info["fields_b"].levels)
    assert calls == [2 * 2 * 4] * lv_count      # 16 jobs a direction
    total, radius = 4, 2
    sups = build_super(planes, sspec)
    cur = torch.arange(total).repeat(radius)
    for isb, nbr in ((True, denoise.neighbour_index(total, radius, 1, "cpu")),
                     (False, denoise.neighbour_index(total, radius, -1,
                                                     "cpu"))):
        spec = dataclasses.replace(acfg, isb=isb).validate(sspec)
        want = denoise._analyse_jobs(sups, cur, nbr, spec, "exact",
                                     [0] * len(cur))
        got = info["fields_b" if isb else "fields_f"]
        assert got.meta == spec.meta and got.meta.is_backward == isb
        assert torch.equal(got.validity, want.validity)
        for a, b in zip(got.levels, want.levels):
            for k in ("x", "y", "sad"):
                assert torch.equal(getattr(a, k), getattr(b, k))
    assert all(p.shape == q.shape for p, q in zip(out, planes))
    # specs that differ beyond the direction: one call each
    calls.clear()
    spec_b = dataclasses.replace(acfg, isb=True).validate(sspec)
    spec_f = dataclasses.replace(acfg, isb=False, pzero=0).validate(sspec)
    mv_b, mv_f = denoise._analyse_both(
        sups, (cur[:2], cur[:2] + 1, spec_b, 0),
        (cur[:2] + 1, cur[:2], spec_f, 0), "exact")
    assert calls == [2] * (2 * lv_count)
    assert mv_b.meta == spec_b.meta and mv_f.meta == spec_f.meta
