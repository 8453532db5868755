"""PyTorch port: the exact engine's options and Recalculate's exact engine
against the JAX package on CPU, bit for bit (inputs and JAX side:
test_torch_exact_analyse.py, load_exact): Recalculate with engine="exact", the
LOGARITHMIC search (the diamond) and HEX2, on gray_b's field; analyse with its default
engine (now "exact" in both packages); the exact engine's refusal of the
DCT and SATD costs; and the kernel's search code, built for the host with
g++, against the plain version."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_reference as tpr  # noqa: E402
from mvtools_tpu_torch import RecalculateConfig, analyse, recalculate  # noqa: E402,E501
from mvtools_tpu_torch.analyse import analyse_exact_jobs  # noqa: E402
from mvtools_tpu_torch.core import config, types  # noqa: E402
from mvtools_tpu_torch.core.types import MVField, MVPlaneField  # noqa: E402
from mvtools_tpu_torch.super import build_super  # noqa: E402
from test_torch_exact_analyse import assert_field, port_analysis  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return tpr.load_exact(tmp_path_factory)


def gray_b_inputs():
    """(SuperSpec, AnalyseSpec, source supers, reference supers) of
    gray_b's jobs."""
    _, _, _, _, jobs = tpr.EX_ANALYSES["gray_b"]
    sspec, aspec = tpr.exact_specs(config, types, "gray_b")
    sups = build_super([torch.from_numpy(tpr.make_exact_gray())], sspec)
    return (sspec, aspec, sups.take(torch.tensor([a for a, _ in jobs])),
            sups.take(torch.tensor([b for _, b in jobs])))


@pytest.mark.parametrize("name", ["log", "hex2"])
def test_exact_recalculate_matches_jax(ref, name):
    sspec, aspec, src, rs = gray_b_inputs()
    old = MVField(tuple(
        MVPlaneField(*(torch.from_numpy(ref[f"gray_b_{k}{lv}"])
                       for k in ("x", "y", "sad")))
        for lv in range(3)), torch.ones((4,), dtype=torch.int32), aspec.meta)
    rcfg = RecalculateConfig(**tpr.recalc_kw(types, tpr.EX_RECALC[name]))
    rspec = rcfg.to_analyse_config().validate(sspec)
    got = recalculate(src, rs, old, rspec, rcfg, engine="exact")
    assert_field(ref, f"rc_{name}_", got)
    # the JAX package's Recalculate takes a field shift and never applies
    # it; neither does the port
    again = recalculate(src, rs, old, rspec, rcfg, field_shift=1,
                        engine="exact")
    for a, b in zip(got.levels, again.levels):
        assert torch.equal(a.x, b.x) and torch.equal(a.sad, b.sad)


def test_analyse_default_engine_matches_jax(ref):
    """analyse with its defaults: the exact engine in both packages."""
    _, aspec, src, rs = gray_b_inputs()
    for j in range(4):
        mv = analyse(src.map(lambda a, j=j: a[j]),
                     rs.map(lambda a, j=j: a[j]), aspec)
        for lv, level in enumerate(mv.levels):
            for k in ("x", "y", "sad"):
                np.testing.assert_array_equal(
                    getattr(level, k).numpy(), ref[f"gray_b_{k}{lv}"][j])


def test_exact_engine_refuses_dct():
    """dct 1-10 on the exact engine raise NotImplementedError on either
    device, before any work is done (the check does not look at the
    tensors' device)."""
    sspec, aspec, src, rs = gray_b_inputs()
    for dct in (1, 5):
        spec = dataclasses.replace(aspec, dct=dct)
        with pytest.raises(NotImplementedError, match=f"dct={dct}"):
            analyse_exact_jobs(src, rs, spec)
        with pytest.raises(NotImplementedError, match='engine="exact"'):
            analyse(src.map(lambda a: a[0]), rs.map(lambda a: a[0]), spec)


_HOST_DRIVER = r"""
#include "exact_scan.cu"
#include <cstring>
using namespace mvt_exact;
template <typename T>
static void pick(const void* const* s, const void* const* r, const T** ps,
                 const T** pr) {
    for (int i = 0; i < 3; ++i) { ps[i] = (const T*)s[i]; pr[i] = (const T*)r[i]; }
}
extern "C" void host_scan(const void* const* s, const void* const* r,
                          int* vx, int* vy, long long* vs, const int* gx,
                          const int* gy, const int* zs, int* badcount,
                          const int* a) {
    Params p;
    std::memcpy(p.v, a, sizeof(p.v));
    for (int job = 0; job < a[P_JOBS]; ++job) {
        if (a[P_U16]) {
            const uint16_t *ps[3], *pr[3];
            pick(s, r, ps, pr);
            scan_job<uint16_t>(p, ps, pr, vx, vy, vs, gx, gy, zs, badcount,
                               nullptr, job);
        } else {
            const uint8_t *ps[3], *pr[3];
            pick(s, r, ps, pr);
            scan_job<uint8_t>(p, ps, pr, vx, vy, vs, gx, gy, zs, badcount,
                              nullptr, job);
        }
    }
}
extern "C" void host_search(const void* const* s, const void* const* r,
                            const int* px, const int* py, int* ox, int* oy,
                            long long* os, const int* a) {
    Params p;
    std::memcpy(p.v, a, sizeof(p.v));
    const long long n = (long long)a[P_JOBS] * a[P_NBX] * a[P_NBY];
    for (long long it = 0; it < n; ++it) {
        const uint8_t *ps[3], *pr[3];
        pick(s, r, ps, pr);
        search_item<uint8_t>(p, ps, pr, px, py, ox, oy, os, nullptr, it);
    }
}
"""


def _host_library(tmp_path):
    """csrc/exact_scan.cu's search code built for the host (one lane, no
    shuffles) with a driver that runs every job or item in turn."""
    import ctypes
    import shutil
    import subprocess

    from mvtools_tpu_torch.ops import cuda_build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of csrc/exact_scan.cu "
                    "needs a C++ compiler")
    src = tmp_path / "driver.cpp"
    src.write_text(_HOST_DRIVER)
    lib = tmp_path / "libexact_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(cuda_build.CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def test_kernel_search_code_on_the_host_matches_plain(tmp_path):
    """K6's scan and per-item search, compiled for the host, give the plain
    version's vectors, SADs and rescue counts level by level:
    gray (the UMH rescue), YUV420 with chroma, overlap, global_ and
    meander, 16 bits at pel 1, pel 4 with trymany and the ring rescue, a
    field shift, and VERTICAL; and Recalculate's exact search with the
    diamond and HEX2."""
    import ctypes

    from mvtools_tpu_torch.ops import exact_scan as es

    lib = _host_library(tmp_path)
    vp = ctypes.c_void_p
    lib.host_scan.argtypes = [ctypes.POINTER(vp)] * 2 + [vp] * 7 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.host_search.argtypes = [ctypes.POINTER(vp)] * 2 + [vp] * 5 + [
        ctypes.POINTER(ctypes.c_int)]

    def ptrs(ts):
        ts = list(ts) + [None] * (3 - len(ts))
        return (vp * 3)(*(None if t is None else t.data_ptr() for t in ts))

    compared = []

    def scan_both(ctx, plan, vin, gx, gy, zs):
        want = es.scan_level_plain(ctx, plan, vin, gx, gy, zs)
        srcs, refs = es._planes(ctx)
        vx, vy = (v.to(torch.int32).contiguous().clone() for v in vin[:2])
        vs = vin[2].to(torch.int64).contiguous().clone()
        gx, gy, zs = (t.to(torch.int32).contiguous() for t in (gx, gy, zs))
        bc = torch.zeros(vx.shape[0], dtype=torch.int32)
        args = es._args(ctx, es.scan_geom(ctx), refs, **es._plan_args(plan))
        lib.host_scan(ptrs(srcs), ptrs(refs), vx.data_ptr(), vy.data_ptr(),
                      vs.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                      zs.data_ptr(), bc.data_ptr(), args)
        for a, b in zip(want[0], (vx, vy, vs)):
            assert torch.equal(a, b), f"level {ctx.level}"
        assert torch.equal(want[1], bc)
        compared.append(int(bc.sum()))
        return want

    def search_both(ctx, search, param, px, py, lam, pnew, thsad):
        want = es.search_blocks_plain(ctx, search, param, px, py, lam, pnew,
                                      thsad)
        srcs, refs = es._planes(ctx)
        px, py = (t.to(torch.int32).contiguous() for t in (px, py))
        ox, oy = torch.empty_like(px), torch.empty_like(py)
        osad = torch.empty(px.shape, dtype=torch.int64)
        args = es._args(ctx, es.scan_geom(ctx, True), refs,
                        search=int(search), param=param, pzero=0, pglobal=0,
                        badsad=0, badrange=0, trymany=0, meander=0, lsad=0,
                        lambda_level=lam, pnew=pnew, verybig=0, smallest=0,
                        thsad=thsad)
        lib.host_search(ptrs(srcs), ptrs(refs), px.data_ptr(), py.data_ptr(),
                        ox.data_ptr(), oy.data_ptr(), osad.data_ptr(), args)
        for a, b in zip(want, (ox, oy, osad)):
            assert torch.equal(a, b)
        compared.append(-1)
        return want

    scan, search = es.scan_level, es.search_blocks
    es.scan_level, es.search_blocks = scan_both, search_both
    try:
        for name, fs in (("gray_b", list(tpr.EX_FS_JOBS)), ("yuv", 0),
                         ("deep", 0), ("opts", 0)):
            port_analysis(name, fs)
        sspec, aspec, src, rs = gray_b_inputs()
        # VERTICAL, one level
        vspec = dataclasses.replace(config.AnalyseConfig(
            blksize=8, levels=1, search=types.SearchType.VERTICAL,
            searchparam=3, pelsearch=3, truemotion=True, chroma=False),
            isb=True).validate(sspec)
        analyse_exact_jobs(src, rs, vspec)
        old = analyse_exact_jobs(src, rs, aspec)
        for search in (2, 4):           # the diamond, HEX2
            rcfg = RecalculateConfig(**tpr.recalc_kw(types, dict(
                tpr.EX_RECALC["log"], search=search)))
            recalculate(src, rs, old,
                        rcfg.to_analyse_config().validate(sspec), rcfg,
                        engine="exact")
    finally:
        es.scan_level, es.search_blocks = scan, search
    assert len(compared) == 3 + 2 + 1 + 2 + 1 + 3 + 2
    assert sum(c for c in compared if c > 0) > 0     # the rescue ran
