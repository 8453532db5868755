// Tiled candidate probe (K2) and its three-stat form (K2').
//
// Replaces the TPU kernel mvtools_tpu/ops/probe.py::_tiled_probe_kernel
// (probe_sads_tiled_pallas): probe_kernel its stats="sad" form,
// probe_stats3_kernel its stats="sad_satd_luma" form.
//
// out[job, block, k, d] = SAD of the source block against the reference
// block at pel position (cand_x + dx_d, cand_y + dy_d), for K candidate
// centres per block and D static pel offsets — or INVALID_SAD (int32 max)
// when the candidate's window falls outside the extent of its tile's shared
// window.  That validity rule decides which candidates can win a search, so
// it is reproduced exactly: blocks of one block row are grouped in tiles of
// `tile` (rows edge-padded to a multiple of `tile`), the tile window base is
// the median of the first/middle/last block's candidate 0, shifted by
// `center`, clamped to the stack and aligned down to 8 rows / 128 columns.
//
// Bound on this card: bytes.  Each valid candidate costs bs_y*bs_x abs-diff
// accumulates per offset, but with a handful of offsets per candidate that
// is less time than reading the touched part of the stack once; after the
// first touch L2 serves the overlap of neighbouring windows.  Design: one
// warp per (job, block, candidate); it recomputes its tile's base from three
// candidate reads, applies the validity rule, and either writes D sentinels
// or strides its lanes over the block's pixels per offset and reduces with
// shuffles.  No window is staged: every valid read lies inside the stack.
//
// The three-stat form writes the triple (SAD, SATD, sum of the reference
// block) per entry, out[job, block, k, d, 0..2] (satd.cuh says what the SATD
// is), under the same validity rule: an invalid candidate reports INVALID_SAD
// in all three.  A group of lanes owns one (job, block, candidate, offset)
// and splits the block's 8x4 partitions.  Bound: integer operations once a
// call has more than a few offsets per candidate, bytes below that.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "satd.cuh"

namespace {

struct ProbeParams {
    int n_sub, hp, wp;        // stack [J, n_sub, hp, wp]
    int nblk, row_len, k, d;  // blocks per job, blocks per row, K, D
    int tile, bs_y, bs_x, logp;
    int min_dy, min_dx;       // most negative offsets of the set
    int wy, cxs;              // logical window rows, 128-rounded columns
    int wy_total, wx_total, center_y, center_x;
    long long total;          // J * nblk * K warps of work
};

__device__ __forceinline__ int med3(int a, int b, int c) {
    return max(min(a, b), min(max(a, b), c));
}

__device__ __forceinline__ int tile_base(int w0, int wm, int w1, int center,
                                         int lo_max, int mask) {
    int base = med3(w0, wm, w1) - center;
    base = base < 0 ? 0 : (base > lo_max ? lo_max : base);
    return base & mask;
}

__global__ void probe_kernel(const uint8_t* __restrict__ stack,
                             const int* __restrict__ cand_y,
                             const int* __restrict__ cand_x,
                             const uint8_t* __restrict__ src,
                             const int* __restrict__ offs,  // [D, 2] (dx, dy)
                             int* __restrict__ out, ProbeParams p) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (w >= p.total) return;
    const int kk = (int)(w % p.k);
    const long long jb = w / p.k;
    const int blk = (int)(jb % p.nblk);
    const int job = (int)(jb / p.nblk);

    // tile members (block rows are edge-padded to a multiple of `tile`)
    const int row = blk / p.row_len, col = blk % p.row_len;
    const int c0 = (col / p.tile) * p.tile;
    const int last = p.row_len - 1;
    const size_t rb = ((size_t)job * p.nblk + (size_t)row * p.row_len) * p.k;
    const size_t i0 = rb + (size_t)min(c0, last) * p.k;
    const size_t im = rb + (size_t)min(c0 + p.tile / 2, last) * p.k;
    const size_t i1 = rb + (size_t)min(c0 + p.tile - 1, last) * p.k;
    const int ay = tile_base((cand_y[i0] + p.min_dy) >> p.logp,
                             (cand_y[im] + p.min_dy) >> p.logp,
                             (cand_y[i1] + p.min_dy) >> p.logp,
                             p.center_y, p.hp - p.wy_total, ~7);
    const int ax = tile_base((cand_x[i0] + p.min_dx) >> p.logp,
                             (cand_x[im] + p.min_dx) >> p.logp,
                             (cand_x[i1] + p.min_dx) >> p.logp,
                             p.center_x, p.wp - p.wx_total, ~127);

    const size_t ci = ((size_t)job * p.nblk + blk) * p.k + kk;
    const int cy = cand_y[ci], cx = cand_x[ci];
    const int rel_y = ((cy + p.min_dy) >> p.logp) - ay;
    const int rel_x = ((cx + p.min_dx) >> p.logp) - ax;
    const bool valid = rel_y >= 0 && rel_y + p.wy <= p.wy_total
                       && rel_x >= 0
                       && (rel_x & ~127) + p.cxs <= p.wx_total;
    int* o = out + ci * p.d;
    if (!valid) {
        for (int d = lane; d < p.d; d += 32) o[d] = INT_MAX;
        return;
    }

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const uint8_t* stack_j = stack + (size_t)job * p.n_sub * plane;
    const uint8_t* s = src + ((size_t)job * p.nblk + blk) * p.bs_y * p.bs_x;
    const int npix = p.bs_y * p.bs_x;
    for (int d = 0; d < p.d; ++d) {
        const int px = cx + offs[2 * d], py = cy + offs[2 * d + 1];
        const int sub = (px & pelm) | ((py & pelm) << p.logp);
        const uint8_t* r = stack_j + sub * plane
                           + (size_t)(py >> p.logp) * p.wp + (px >> p.logp);
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
__global__ void probe_stats3_kernel(const uint8_t* __restrict__ stack,
                                    const int* __restrict__ cand_y,
                                    const int* __restrict__ cand_x,
                                    const uint8_t* __restrict__ src,
                                    const int* __restrict__ offs,
                                    int* __restrict__ out, ProbeParams p,
                                    int group) {
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = gt / group;          // ((job, block), k, d) flat
    const int g_lane = (int)(gt % group);
    const bool in_range = item < p.total * p.d;
    const long long w = in_range ? item / p.d : 0;     // (job, block, k)
    const int d = in_range ? (int)(item % p.d) : 0;
    const int kk = (int)(w % p.k);
    const long long jb = w / p.k;
    const int blk = (int)(jb % p.nblk);
    const int job = (int)(jb / p.nblk);

    // the tile window base and the validity rule, exactly as probe_kernel
    const int row = blk / p.row_len, col = blk % p.row_len;
    const int c0 = (col / p.tile) * p.tile;
    const int last = p.row_len - 1;
    const size_t rb = ((size_t)job * p.nblk + (size_t)row * p.row_len) * p.k;
    const size_t i0 = rb + (size_t)min(c0, last) * p.k;
    const size_t im = rb + (size_t)min(c0 + p.tile / 2, last) * p.k;
    const size_t i1 = rb + (size_t)min(c0 + p.tile - 1, last) * p.k;
    const int ay = tile_base((cand_y[i0] + p.min_dy) >> p.logp,
                             (cand_y[im] + p.min_dy) >> p.logp,
                             (cand_y[i1] + p.min_dy) >> p.logp,
                             p.center_y, p.hp - p.wy_total, ~7);
    const int ax = tile_base((cand_x[i0] + p.min_dx) >> p.logp,
                             (cand_x[im] + p.min_dx) >> p.logp,
                             (cand_x[i1] + p.min_dx) >> p.logp,
                             p.center_x, p.wp - p.wx_total, ~127);
    const size_t ci = ((size_t)job * p.nblk + blk) * p.k + kk;
    const int cy = cand_y[ci], cx = cand_x[ci];
    const int rel_y = ((cy + p.min_dy) >> p.logp) - ay;
    const int rel_x = ((cx + p.min_dx) >> p.logp) - ax;
    const bool valid = rel_y >= 0 && rel_y + p.wy <= p.wy_total
                       && rel_x >= 0
                       && (rel_x & ~127) + p.cxs <= p.wx_total;

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const int px = cx + offs[2 * d], py = cy + offs[2 * d + 1];
    const int sub = (px & pelm) | ((py & pelm) << p.logp);
    // an invalid candidate may point outside the stack: it reads nothing
    const bool active = in_range && valid;
    const uint8_t* r = stack + ((size_t)job * p.n_sub + sub) * plane
                       + (active ? (size_t)(py >> p.logp) * p.wp
                                   + (px >> p.logp) : 0);
    const uint8_t* s = src + ((size_t)job * p.nblk + blk) * p.bs_y * p.bs_x;
    const mvt::Stats3 st = mvt::block_stats3(s, p.bs_x, r, p.wp, p.bs_y,
                                             p.bs_x, g_lane, group, active);
    if (in_range && g_lane == 0) {
        int* o = out + (ci * p.d + d) * 3;
        o[0] = valid ? st.sad : INT_MAX;
        o[1] = valid ? st.satd : INT_MAX;
        o[2] = valid ? st.luma : INT_MAX;
    }
}

}  // namespace

static ProbeParams probe_params(int n_jobs, int n_sub, int hp, int wp,
                                int nblk, int row_len, int k, int d, int tile,
                                int bs_y, int bs_x, int logp, int min_dy,
                                int min_dx, int wy, int cxs, int wy_total,
                                int wx_total, int center_y, int center_x) {
    ProbeParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk;
    p.row_len = row_len; p.k = k; p.d = d; p.tile = tile; p.bs_y = bs_y;
    p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy; p.min_dx = min_dx;
    p.wy = wy; p.cxs = cxs; p.wy_total = wy_total; p.wx_total = wx_total;
    p.center_y = center_y; p.center_x = center_x;
    p.total = (long long)n_jobs * nblk * k;
    return p;
}

extern "C" int mvt_probe_sads_tiled(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int row_len, int k, int d, int tile,
        int bs_y, int bs_x, int logp, int min_dy, int min_dx, int wy,
        int cxs, int wy_total, int wx_total, int center_y, int center_x,
        void* stream) {
    const ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x);
    if (p.total == 0 || d == 0) return 0;
    const int warps = 4;
    const long long blocks = (p.total + warps - 1) / warps;
    probe_kernel<<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (int*)out, p);
    return (int)cudaGetLastError();
}

extern "C" int mvt_probe_sads_tiled_stats3(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int row_len, int k, int d, int tile,
        int bs_y, int bs_x, int logp, int min_dy, int min_dx, int wy,
        int cxs, int wy_total, int wx_total, int center_y, int center_x,
        void* stream) {
    const ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x);
    if (p.total == 0 || d == 0) return 0;
    const int group = mvt::stats3_group(bs_y, bs_x);
    const int threads = 128;
    const long long lanes = p.total * d * group;
    const long long blocks = (lanes + threads - 1) / threads;
    probe_stats3_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (int*)out, p, group);
    return (int)cudaGetLastError();
}
