// Per-block candidate probe (K4) and its three-stat form (K4').
//
// Replaces the TPU kernel mvtools_tpu/ops/probe.py::_probe_kernel
// (probe_sads_pallas): probe_block_kernel its stats="sad" form,
// probe_block_stats3_kernel its stats="sad_satd_luma" form.
//
// out[job, block, k, d] = SAD of the source block against the reference
// block at pel position (cand_x + dx_d, cand_y + dy_d), for K candidate
// centres per block and D static pel offsets.  Every (block, candidate) has
// a window of its own, so there is no validity rule and no sentinel: every
// entry is a real SAD.
//
//   ax = cand_x + dx,  ay = cand_y + dy
//   sub = (ax & (pel-1)) | ((ay & (pel-1)) << logp)
//   ref(y, x) = stack[job, sub, oy + y, ox + x]
//
// Out-of-range rule (the same one as probe_sads_plain): the WINDOW of the
// whole offset set, wy x wx full-pel pixels starting at
// ((cand_y + min_dy) >> logp, (cand_x + min_dx) >> logp), is shifted as a
// whole so that it lies inside the plane, and each offset's block keeps its
// place inside the window:
//
//   wb_y = (cand_y + min_dy) >> logp
//   oy   = clamp(wb_y, 0, hp - wy) + ((ay >> logp) - wb_y)        (x alike)
//
// Pixels are not clamped one by one.  The search bounds keep every candidate
// of the motion search inside the padded stack, where the shift is zero.  (A
// window start left of or above the stack clamps to 0 here; the JAX slice
// this was derived from wraps such a start round to the far edge.)
//
// Bound on this card: bytes for a handful of offsets, operations for a large
// offset set (bs_y*bs_x abs-diff accumulates per output).  This kernel serves
// the planes that are too small for the tiled probe's shared window: tens to
// hundreds of blocks per job.  Design: one warp per (job, block, candidate);
// its lanes stride the block's pixels for each offset and reduce with
// shuffles.  Nothing is staged: a window is a few hundred bytes and stays in
// L1/L2 between offsets.
//
// The three-stat form writes the triple (SAD, SATD, sum of the reference
// block) per entry, out[job, block, k, d, 0..2] (satd.cuh says what the SATD
// is), with the same rule for a window that leaves the stack.  A group of
// lanes owns one (job, block, candidate, offset) and splits the block's 8x4
// partitions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

namespace {

struct BlockProbeParams {
    int n_sub, hp, wp;     // stack [J, n_sub, hp, wp]
    int nblk, k, d;        // blocks per job, K, D
    int bs_y, bs_x, logp;
    int min_dy, min_dx;    // most negative offsets of the set
    int wy, wx;            // window of the offset set, full-pel pixels
    long long total;       // J * nblk * K warps of work
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void probe_block_kernel(const uint8_t* __restrict__ stack,
                                   const int* __restrict__ cand_y,
                                   const int* __restrict__ cand_x,
                                   const uint8_t* __restrict__ src,
                                   const int* __restrict__ offs,  // [D, 2]
                                   int* __restrict__ out,
                                   BlockProbeParams p) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (w >= p.total) return;
    const long long jb = w / p.k;            // (job, block) flat
    const int job = (int)(jb / p.nblk);

    const int cy = cand_y[w], cx = cand_x[w];
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int shift_y = clampi(wb_y, 0, p.hp - p.wy) - wb_y;
    const int shift_x = clampi(wb_x, 0, p.wp - p.wx) - wb_x;

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const uint8_t* stack_j = stack + (size_t)job * p.n_sub * plane;
    const int npix = p.bs_y * p.bs_x;
    const uint8_t* s = src + (size_t)jb * npix;
    int* o = out + (size_t)w * p.d;
    for (int d = 0; d < p.d; ++d) {
        const int ax = cx + offs[2 * d], ay = cy + offs[2 * d + 1];
        const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
        const int oy = (ay >> p.logp) + shift_y;
        const int ox = (ax >> p.logp) + shift_x;
        const uint8_t* r = stack_j + sub * plane + (size_t)oy * p.wp + ox;
        int acc = 0;
        for (int i = lane; i < npix; i += 32) {
            const int y = i / p.bs_x, x = i % p.bs_x;
            acc += abs((int)r[(size_t)y * p.wp + x] - (int)s[i]);
        }
        for (int sh = 16; sh > 0; sh >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, sh);
        if (lane == 0) o[d] = acc;
    }
}

// The three-stat form: `group` lanes per (job, block, candidate, offset).
__global__ void probe_block_stats3_kernel(
        const uint8_t* __restrict__ stack, const int* __restrict__ cand_y,
        const int* __restrict__ cand_x, const uint8_t* __restrict__ src,
        const int* __restrict__ offs, int* __restrict__ out,
        BlockProbeParams p, int group) {
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = gt / group;          // ((job, block), k, d) flat
    const int g_lane = (int)(gt % group);
    const bool active = item < p.total * p.d;
    const long long w = active ? item / p.d : 0;       // (job, block, k)
    const int d = active ? (int)(item % p.d) : 0;
    const long long jb = w / p.k;
    const int job = (int)(jb / p.nblk);

    const int cy = cand_y[w], cx = cand_x[w];
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int shift_y = clampi(wb_y, 0, p.hp - p.wy) - wb_y;
    const int shift_x = clampi(wb_x, 0, p.wp - p.wx) - wb_x;

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const int ax = cx + offs[2 * d], ay = cy + offs[2 * d + 1];
    const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
    const int oy = (ay >> p.logp) + shift_y;
    const int ox = (ax >> p.logp) + shift_x;
    const uint8_t* r = stack + ((size_t)job * p.n_sub + sub) * plane
                       + (size_t)oy * p.wp + ox;
    const uint8_t* s = src + (size_t)jb * p.bs_y * p.bs_x;
    const mvt::Stats3 st = mvt::block_stats3(s, p.bs_x, r, p.wp, p.bs_y,
                                             p.bs_x, g_lane, group, active);
    if (active && g_lane == 0) {
        int* o = out + (size_t)item * 3;
        o[0] = st.sad; o[1] = st.satd; o[2] = st.luma;
    }
}

}  // namespace

extern "C" int mvt_probe_sads(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int k, int d, int bs_y, int bs_x, int logp,
        int min_dy, int min_dx, int wy, int wx, void* stream) {
    BlockProbeParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk; p.k = k; p.d = d;
    p.bs_y = bs_y; p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy;
    p.min_dx = min_dx; p.wy = wy; p.wx = wx;
    p.total = (long long)n_jobs * nblk * k;
    if (p.total == 0 || d == 0) return 0;
    const int warps = 4;
    const long long blocks = (p.total + warps - 1) / warps;
    probe_block_kernel<<<(unsigned)blocks, warps * 32, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (int*)out, p);
    return (int)cudaGetLastError();
}

extern "C" int mvt_probe_sads_stats3(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int k, int d, int bs_y, int bs_x, int logp,
        int min_dy, int min_dx, int wy, int wx, void* stream) {
    BlockProbeParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk; p.k = k; p.d = d;
    p.bs_y = bs_y; p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy;
    p.min_dx = min_dx; p.wy = wy; p.wx = wx;
    p.total = (long long)n_jobs * nblk * k;
    if (p.total == 0 || d == 0) return 0;
    const int group = mvt::stats3_group(bs_y, bs_x);
    const int threads = 128;
    const long long lanes = p.total * d * group;
    const long long blocks = (lanes + threads - 1) / threads;
    probe_block_stats3_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (int*)out, p, group);
    return (int)cudaGetLastError();
}
