// Reference-block fetches: the tiled fetch (K3) and the per-block fetch (K5),
// one kernel.
//
// K3 replaces the TPU kernel mvtools_tpu/ops/probe.py::_tiled_fetch_kernel
// (fetch_blocks_tiled_pallas), K5 the TPU kernel
// mvtools_tpu/ops/probe.py::_fetch_kernel (fetch_blocks_pallas).  Both
// compute, per (job, block, candidate k),
//
//   sub = (cx & (pel-1)) | ((cy & (pel-1)) << logp)
//   fy, fx = the full-pel origin (cy >> logp, cx >> logp) taken AS A WHOLE
//            the way the JAX package's window slice takes an out-of-range
//            start: a negative start wraps once round the plane, then it is
//            clamped to [0, hp - bs_y] x [0, wp - bs_x]
//   out[job, block, k, y, x] = stack[job, sub, fy + y, fx + x]   (as int32)
//
// so every block is a window of the plane.  The two differ only in their
// callers and hand-over (ops/probe.py): K3 serves block grids on stacks at
// least the TPU kernel's tile window, K5 everything else.  (At an origin
// outside the plane the Pallas tiled kernel returns a window placed by its
// 8-row / 128-column fallback alignment instead; no caller of either package
// reaches such an origin: ROADMAP, Q3-9.)
//
// Bound on this card: bytes (a bs_y x bs_x block read, four times that
// written per candidate; no arithmetic).  The first K3 body spent one thread
// per int32 output with a 64-bit division and remainder by runtime sizes for
// each; here T lanes own one candidate (T = 32, or fewer for blocks of under
// 128 pixels, so that a warp still writes 512 contiguous bytes a step), the
// job is the grid's y index, and the block width is a template constant for
// the widths the port reaches (4, 8, 16, 32): a lane's (row, column group) is
// a shift and a mask, all index arithmetic is 32-bit within a plane.  Each
// lane moves four pixels at a time: one 32-bit word read where the address
// is word-aligned, two aligned words and a funnel shift elsewhere, stored as
// one 16-byte int4.  The clamp is applied to the origin only, once per
// candidate, so a block inside the plane pays nothing for it.  The launch
// geometry (template width, lanes per candidate) is computed by
// ops/probe.py::fetch_launch_geom.
//
// A uint16 stack (9- to 16-bit clips) takes a second instantiation of the
// same body: four pixels are two 32-bit words, each read aligned or as two
// aligned words and a 16-bit funnel shift; the output stays int32.  0.141
// ms at the YUV luma shape [7, 32026, 1, 16, 16] (the 8-bit form: 0.12;
// H100 80GB HBM3, 700 W), 1.37x its byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Four 8-bit pixels starting at p, as one little-endian word.
__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
    const unsigned a = (unsigned)((uintptr_t)p & 3);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p - a);
    const uint32_t w0 = __ldg(w);
    // the next word is read only when the four pixels reach into it
    return a ? __funnelshift_r(w0, __ldg(w + 1), 8 * a) : w0;
}

// Two 16-bit pixels starting at p (2-byte aligned), as one word.
__device__ __forceinline__ uint32_t load2(const uint16_t* p) {
    const unsigned a = (unsigned)((uintptr_t)p & 2);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const uint8_t*>(p) - a);
    const uint32_t w0 = __ldg(w);
    return a ? __funnelshift_r(w0, __ldg(w + 1), 16) : w0;
}

// Four pixels starting at p, widened to int32.
__device__ __forceinline__ int4 load4px(const uint8_t* p) {
    const uint32_t w = load4(p);
    return make_int4((int)(w & 255u), (int)((w >> 8) & 255u),
                     (int)((w >> 16) & 255u), (int)(w >> 24));
}

__device__ __forceinline__ int4 load4px(const uint16_t* p) {
    const uint32_t lo = load2(p), hi = load2(p + 2);
    return make_int4((int)(lo & 0xffffu), (int)(lo >> 16),
                     (int)(hi & 0xffffu), (int)(hi >> 16));
}

// One candidate's block: 1 << log_t lanes (t of them), lane `lane` of them.
template <typename T, int BSX>
__device__ __forceinline__ void fetch_one(const T* __restrict__ stack,
                                          int cy, int cx, int* out, int job,
                                          int n_sub, int hp, int wp, int bs_y,
                                          int bs_x, int logp, int lane,
                                          int t) {
    const int pelm = (1 << logp) - 1;
    const int sub = (cx & pelm) | ((cy & pelm) << logp);
    int fy = cy >> logp, fx = cx >> logp;
    fy += fy < 0 ? hp : 0;                 // a window slice's start
    fx += fx < 0 ? wp : 0;
    fy = fy < 0 ? 0 : (fy > hp - bs_y ? hp - bs_y : fy);
    fx = fx < 0 ? 0 : (fx > wp - bs_x ? wp - bs_x : fx);
    const T* src = stack + ((size_t)job * n_sub + sub) * hp * wp
                   + fy * wp + fx;
    if (BSX > 0) {
        constexpr int GPR = BSX / 4;            // int4 groups per row
        constexpr int LOG_GPR = GPR == 1 ? 0 : GPR == 2 ? 1 : GPR == 4 ? 2 : 3;
        int4* dst = reinterpret_cast<int4*>(out);
        const int n_groups = bs_y * GPR;
        for (int g = lane; g < n_groups; g += t) {
            const int r = g >> LOG_GPR, q = g & (GPR - 1);
            dst[g] = load4px(src + r * wp + 4 * q);
        }
    } else if ((bs_x & 3) == 0) {
        const int gpr = bs_x >> 2;
        int4* dst = reinterpret_cast<int4*>(out);
        const int n_groups = bs_y * gpr;
        for (int g = lane; g < n_groups; g += t) {
            const int r = g / gpr;
            dst[g] = load4px(src + r * wp + 4 * (g - r * gpr));
        }
    } else {
        const int npix = bs_y * bs_x;
        for (int i = lane; i < npix; i += t) {
            const int r = i / bs_x;
            out[i] = __ldg(src + r * wp + (i - r * bs_x));
        }
    }
}

// T: the pixel type (uint8_t, or uint16_t for 9- to 16-bit clips).  BSX:
// the block width as a template constant (4, 8, 16, 32), or 0 for any other
// width.  1 << log_t lanes per candidate.  TILED (1 for K3, 0 for K5)
// changes nothing in the body: it names the two fetches apart in a
// profiler's trace.
template <typename T, int BSX, int TILED>
__global__ void __launch_bounds__(256)
fetch_kernel(const T* __restrict__ stack, const int* __restrict__ cand_y,
             const int* __restrict__ cand_x, int* __restrict__ out,
             int per_job, int n_sub, int hp, int wp, int bs_y, int bs_x,
             int logp, int log_t) {
    const int cl = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> log_t);
    if (cl >= per_job) return;
    const size_t c = (size_t)blockIdx.y * per_job + cl;
    fetch_one<T, BSX>(stack, cand_y[c], cand_x[c],
                      out + c * (size_t)(bs_y * bs_x), blockIdx.y, n_sub, hp,
                      wp, bs_y, bs_x, logp, threadIdx.x & ((1 << log_t) - 1),
                      1 << log_t);
}

}  // namespace

template <typename T, int TILED>
static void launch_fetch(dim3 grid, int threads, cudaStream_t st, int bsx_t,
                         const T* s, const int* y, const int* x, int* o,
                         int pj, int n_sub, int hp, int wp, int bs_y,
                         int bs_x, int logp, int log_t) {
#define MVT_FETCH(W)                                                         \
    fetch_kernel<T, W, TILED><<<grid, threads, 0, st>>>(                     \
        s, y, x, o, pj, n_sub, hp, wp, bs_y, bs_x, logp, log_t)
    switch (bsx_t) {
        case 4: MVT_FETCH(4); break;
        case 8: MVT_FETCH(8); break;
        case 16: MVT_FETCH(16); break;
        case 32: MVT_FETCH(32); break;
        default: MVT_FETCH(0); break;
    }
#undef MVT_FETCH
}

template <typename T>
static void launch_fetch_tiled(int tiled, dim3 grid, int threads,
                               cudaStream_t st, int bsx_t, const void* stack,
                               const int* y, const int* x, int* o, int pj,
                               int n_sub, int hp, int wp, int bs_y, int bs_x,
                               int logp, int log_t) {
    const T* s = (const T*)stack;
    if (tiled)
        launch_fetch<T, 1>(grid, threads, st, bsx_t, s, y, x, o, pj, n_sub,
                           hp, wp, bs_y, bs_x, logp, log_t);
    else
        launch_fetch<T, 0>(grid, threads, st, bsx_t, s, y, x, o, pj, n_sub,
                           hp, wp, bs_y, bs_x, logp, log_t);
}

// bsx_t, log_t: the launch geometry of ops/probe.py::fetch_launch_geom;
// tiled: 1 for the tiled fetch (K3), 0 for the per-block fetch (K5);
// u16: 1 for a uint16 stack, 0 for uint8.
extern "C" int mvt_fetch_blocks(const void* stack, const void* cand_y,
                                const void* cand_x, void* out, int n_jobs,
                                int n_sub, int hp, int wp, int nblk, int k,
                                int bs_y, int bs_x, int logp, int bsx_t,
                                int log_t, int tiled, int u16, void* stream) {
    const long long per_job = (long long)nblk * k;
    if (n_jobs == 0 || per_job == 0 || bs_y * bs_x == 0) return 0;
    if (per_job > (1LL << 26) || n_jobs > 65535 || log_t < 0 || log_t > 5
        || (bsx_t && (bsx_t != bs_x || bsx_t > 32 || (bsx_t & (bsx_t - 1)))))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long lanes = per_job << log_t;
    dim3 grid((unsigned)((lanes + threads - 1) / threads), (unsigned)n_jobs);
    cudaStream_t st = (cudaStream_t)stream;
    const int* y = (const int*)cand_y;
    const int* x = (const int*)cand_x;
    int* o = (int*)out;
    const int pj = (int)per_job;
    if (u16)
        launch_fetch_tiled<uint16_t>(tiled, grid, threads, st, bsx_t, stack,
                                     y, x, o, pj, n_sub, hp, wp, bs_y, bs_x,
                                     logp, log_t);
    else
        launch_fetch_tiled<uint8_t>(tiled, grid, threads, st, bsx_t, stack, y,
                                    x, o, pj, n_sub, hp, wp, bs_y, bs_x, logp,
                                    log_t);
    return (int)cudaGetLastError();
}
