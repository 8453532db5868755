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
// `active` (optional, bool [J, nblk, K, D]) names the entries the caller
// will look at: an inactive entry reads nothing and reports INVALID_SAD, and
// a (job, block, candidate) with no active entry ends its warp at once.  The
// search's walks probe every block for a whole offset set and then keep a
// few entries of a few blocks; the mask lets the card skip the rest.
//
// Bound on this card: bytes.  A valid entry costs bs_y*bs_x abs-diff
// accumulates, but with a handful of offsets per candidate that is less
// time than reading the touched part of the stack once; after the first
// touch L2 serves the overlap of neighbouring windows.  At the YUV path's
// level-0 luma shape [12, 32026, 1, 6] the byte bound is 0.074 ms; the first
// body of this kernel took 1.079 ms there (H100 80GB HBM3, 700 W): one warp
// per candidate loaded single bytes of source and reference per pixel,
// split the pixel index by a division and a modulo by the runtime block
// width, and reloaded the source for every offset (~40 instructions per
// pixel step).
//
// Design: one warp per (job, block, candidate), all of its index arithmetic
// 32-bit (64-bit divisions had cost more than the pixels).  The warp reads
// its up to 32 offsets and `active` flags once, a lane each, and takes
// them by shuffle and ballot; it computes the validity rule once from the
// three member reads.  The source block lives in registers as 32-bit words,
// loaded once: a block of nw words is split over G = min(32, nw) lanes,
// WPL = nw / G words a lane (16x16: G 32, two words; 8x8: G 16, one word,
// and the warp runs two offsets at a time).  Each lane fixes the byte
// offset of its words in the stack plane once, before the offset loop: no
// division in the pixel loop.  A reference word at an arbitrary column is
// built from the two aligned words that hold it with one funnel shift (both
// aligned loads hold a byte of the block, so neither can leave the stack's
// pages).  Four pixels are summed per instruction pair, as in the SAD map:
//
//   acc = __dp4a(__vabsdiffu4(ref, src), 0x01010101, acc)
//
// (__vsadu4 compiles to fewer instructions but timed no faster here and
// slower in the map; PERF.md), and each offset's lanes are summed
// with one __reduce_add_sync.  Block sizes whose word count is
// not a power of two that a warp holds in at most 16 words a lane (64x32
// and larger) take the generic instantiation: the same body with the source
// re-read from global per offset and each lane's (row, word) stepped
// without division.  What remains is a fixed cost a warp: a handful of
// runtime integer divisions (~15 SASS instructions each) and the dependent
// loads of the validity rule, before any pixel.  Staging the offset set's
// window in shared memory once per warp timed slower (PERF.md).
// nvcc -Xptxas -v (sm_90a): 32-74 registers a thread over the
// instantiations (probe_kernel<uint8_t, 2, false> and <uint16_t, 4, false>:
// 40), no spills.
//
// The same body serves uint16 stacks (9- to 16-bit clips): the pixel type is
// a template parameter, a word holds two pixels (pixels.cuh: the SAD of a
// word is max.u16x2 - min.u16x2 and one IDP.2A), so a 16x16 block is 128
// words, four a lane, and an 8x8 chroma block 32 words, one a lane; the
// funnel shift of ref_word steps by 16 bits (a 16-bit pixel's address is
// even).  0.585 ms at [12, 32026, 1, 6] (the 8-bit form: 0.44; H100 80GB
// HBM3, 700 W).
//
// The three-stat form writes the triple (SAD, SATD, sum of the reference
// block) per entry, out[job, block, k, d, 0..2] (satd.cuh says what the SATD
// is), under the same validity rule: an invalid candidate, or an inactive
// entry, reports INVALID_SAD in all three.  A group of lanes owns one
// (job, block, candidate, offset) and splits the block's 8x4 partitions.
// Bound: integer operations once a call has more than a few offsets per
// candidate, bytes below that.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pixels.cuh"
#include "satd.cuh"

namespace {

using mvt::PixWord;

constexpr unsigned FULL = 0xffffffffu;

struct ProbeParams {
    int n_sub, hp, wp;        // stack [J, n_sub, hp, wp]
    int nblk, row_len, k, d;  // blocks per job, blocks per row, K, D
    int tile, bs_y, bs_x, logp;
    int min_dy, min_dx;       // most negative offsets of the set
    int wy, cxs;              // logical window rows, 128-rounded columns
    int wy_total, wx_total, center_y, center_x;
    int nw, wpr, g;           // source words per block / per row, lanes per offset
    long long total;          // J * nblk * K warps of work
    unsigned n_warps;         // the same, once it is known to fit
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

// The tile-extent validity rule for a candidate (cy, cx) of block `blk`
// of job `job`.
__device__ __forceinline__ bool candidate_valid(const int* __restrict__ cand_y,
                                                const int* __restrict__ cand_x,
                                                const ProbeParams& p, int job,
                                                int blk, int cy, int cx) {
    const int row = blk / p.row_len, col = blk - row * p.row_len;
    const int c0 = (col / p.tile) * p.tile;
    const int last = p.row_len - 1;
    const unsigned rb = ((unsigned)job * p.nblk + (unsigned)row * p.row_len)
                        * p.k;
    const unsigned i0 = rb + (unsigned)min(c0, last) * p.k;
    const unsigned im = rb + (unsigned)min(c0 + p.tile / 2, last) * p.k;
    const unsigned i1 = rb + (unsigned)min(c0 + p.tile - 1, last) * p.k;
    const int ay = tile_base((cand_y[i0] + p.min_dy) >> p.logp,
                             (cand_y[im] + p.min_dy) >> p.logp,
                             (cand_y[i1] + p.min_dy) >> p.logp,
                             p.center_y, p.hp - p.wy_total, ~7);
    const int ax = tile_base((cand_x[i0] + p.min_dx) >> p.logp,
                             (cand_x[im] + p.min_dx) >> p.logp,
                             (cand_x[i1] + p.min_dx) >> p.logp,
                             p.center_x, p.wp - p.wx_total, ~127);
    const int rel_y = ((cy + p.min_dy) >> p.logp) - ay;
    const int rel_x = ((cx + p.min_dx) >> p.logp) - ax;
    return rel_y >= 0 && rel_y + p.wy <= p.wy_total && rel_x >= 0
           && (rel_x & ~127) + p.cxs <= p.wx_total;
}

// The reference word at byte address a (any alignment) whose last needed
// byte is a + last: two aligned loads that both hold a needed byte, joined
// by one funnel shift.
__device__ __forceinline__ uint32_t ref_word(const uint8_t* a, int last) {
    const uintptr_t ai = (uintptr_t)a;
    const uint32_t lo = __ldg((const uint32_t*)(ai & ~(uintptr_t)3));
    const uint32_t hi = __ldg((const uint32_t*)((ai + last)
                                                & ~(uintptr_t)3));
    return __funnelshift_r(lo, hi, (unsigned)(ai & 3) * 8u);
}

// T: the pixel type (uint8_t, or uint16_t for 9- to 16-bit clips).  WPL:
// source words a lane holds in registers (1, 2, 4, 8, 16), or 0 for the
// generic body.  MASKED: the block width is not a multiple of the pixels a
// word holds (only a 2-wide 8-bit chroma block), so a row's last word is cut
// by a mask.
template <typename T, int WPL, bool MASKED>
__global__ void __launch_bounds__(256)
probe_kernel(const T* __restrict__ stack,
             const int* __restrict__ cand_y, const int* __restrict__ cand_x,
             const T* __restrict__ src,
             const int* __restrict__ offs,  // [D, 2] (dx, dy)
             const uint8_t* __restrict__ active, int* __restrict__ out,
             ProbeParams p) {
    constexpr int PPW = PixWord<T>::PPW, SH = PixWord<T>::SH;
    constexpr int PB = (int)sizeof(T);        // bytes a pixel
    const int lane = threadIdx.x & 31;
    const unsigned w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= p.n_warps) return;                // uniform over the warp
    int* o = out + (size_t)w * p.d;            // w = (job, block, candidate)
    const uint8_t* act = active ? active + (size_t)w * p.d : nullptr;
    // up to 32 offsets: lane d holds offset d, bit d of `live` its flag
    const bool few = p.d <= 32;
    int odx = 0, ody = 0;
    unsigned live = FULL;
    if (few) {
        if (lane < p.d) {
            odx = offs[2 * lane];
            ody = offs[2 * lane + 1];
        }
        live = __ballot_sync(FULL, lane < p.d && (!act || act[lane]));
    } else if (act) {
        bool any = false;
        for (int d = lane; d < p.d; d += 32) any |= act[d] != 0;
        live = __ballot_sync(FULL, any);
    }
    if (!live) {
        for (int d = lane; d < p.d; d += 32) o[d] = INT_MAX;
        return;
    }
    const unsigned jb = w / (unsigned)p.k;
    const unsigned job = jb / (unsigned)p.nblk;
    const int blk = (int)(jb - job * (unsigned)p.nblk);
    const int cy = cand_y[w], cx = cand_x[w];
    if (!candidate_valid(cand_y, cand_x, p, (int)job, blk, cy, cx)) {
        for (int d = lane; d < p.d; d += 32) o[d] = INT_MAX;
        return;
    }

    const int g = lane & (p.g - 1);            // lane inside its offset slot
    const int slot = lane / p.g;
    const int n_slots = 32 / p.g;
    const T* s = src + (size_t)jb * p.bs_y * p.bs_x;

    // the source block in registers, each word's plane offset (in bytes)
    // fixed once
    constexpr int NR = WPL > 0 ? WPL : 1;
    uint32_t sw[NR];
    int soff[NR];
    int slast[NR];
    uint32_t smask[NR];
    int row0 = 0, col0 = 0, step_r = 0, step_c = 0;
    if (WPL > 0) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const int wi = g + i * p.g;
            const int row = wi / p.wpr, c4 = PPW * (wi - row * p.wpr);
            soff[i] = (row * p.wp + c4) * PB;
            if (MASKED) {
                const int nb = min(PPW, p.bs_x - c4);
                uint32_t v = 0;
                for (int e = 0; e < nb; ++e)
                    v |= (uint32_t)s[row * p.bs_x + c4 + e] << (SH * e);
                sw[i] = v;
                smask[i] = nb == PPW ? FULL : (1u << (SH * nb)) - 1u;
                slast[i] = nb * PB - 1;
            } else {
                sw[i] = *(const uint32_t*)(s + row * p.bs_x + c4);
                smask[i] = FULL;
                slast[i] = 3;
            }
        }
    } else {                                   // generic: G == 32
        row0 = lane / p.wpr;
        col0 = lane - row0 * p.wpr;
        step_r = 32 / p.wpr;
        step_c = 32 - step_r * p.wpr;
    }

    const int pelm = (1 << p.logp) - 1;
    const int plane = p.hp * p.wp;
    const T* stack_j = stack + (size_t)job * p.n_sub * plane;
    for (int d0 = 0; d0 < p.d; d0 += n_slots) {
        const int d = d0 + slot;
        bool on;
        int dx, dy;
        if (few) {
            on = d < p.d && ((live >> d) & 1u);
            dx = __shfl_sync(FULL, odx, d & 31);
            dy = __shfl_sync(FULL, ody, d & 31);
        } else {
            on = d < p.d && (!act || act[d]);
            dx = on ? offs[2 * d] : 0;
            dy = on ? offs[2 * d + 1] : 0;
        }
        if (d < p.d && !on && g == 0) o[d] = INT_MAX;
        if (!__any_sync(FULL, on)) continue;
        unsigned acc = 0;
        if (on) {
            const int px = cx + dx, py = cy + dy;
            const int sub = (px & pelm) | ((py & pelm) << p.logp);
            const T* r = stack_j + (sub * plane + (py >> p.logp) * p.wp
                                    + (px >> p.logp));
            const uint8_t* rb = (const uint8_t*)r;
            if (WPL > 0) {
#pragma unroll
                for (int i = 0; i < NR; ++i) {
                    uint32_t v = ref_word(rb + soff[i], slast[i]);
                    if (MASKED) v &= smask[i];
                    acc = PixWord<T>::sad(v, sw[i], acc);
                }
            } else {
                int row = row0, col = col0;
                for (int wi = lane; wi < p.nw; wi += 32) {
                    const uint32_t sv = *(const uint32_t*)(
                        s + row * p.bs_x + PPW * col);
                    acc = PixWord<T>::sad(
                        ref_word((const uint8_t*)(r + row * p.wp + PPW * col),
                                 3),
                        sv, acc);
                    col += step_c;
                    row += step_r;
                    if (col >= p.wpr) {
                        col -= p.wpr;
                        ++row;
                    }
                }
            }
        }
        // one warp-wide sum per offset slot
        for (int s2 = 0; s2 < n_slots; ++s2) {
            const unsigned t = __reduce_add_sync(FULL, slot == s2 ? acc : 0u);
            if (lane == s2 * p.g && on) o[d] = (int)t;
        }
    }
}

// The three-stat form: `group` lanes per (job, block, candidate, offset).
__global__ void probe_stats3_kernel(const uint8_t* __restrict__ stack,
                                    const int* __restrict__ cand_y,
                                    const int* __restrict__ cand_x,
                                    const uint8_t* __restrict__ src,
                                    const int* __restrict__ offs,
                                    const uint8_t* __restrict__ active,
                                    int* __restrict__ out, ProbeParams p,
                                    int group) {
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = gt / group;          // ((job, block), k, d) flat
    const int g_lane = (int)(gt % group);
    const bool in_range = item < p.total * p.d;
    const long long w = in_range ? item / p.d : 0;     // (job, block, k)
    const int d = in_range ? (int)(item % p.d) : 0;
    const long long jb = w / p.k;
    const int blk = (int)(jb % p.nblk);
    const int job = (int)(jb / p.nblk);
    const size_t ci = (size_t)w;
    const int cy = cand_y[ci], cx = cand_x[ci];
    // an inactive entry reads nothing and reports INVALID_SAD
    const bool wanted = in_range && (!active || active[ci * p.d + d]);
    const bool valid = wanted
                       && candidate_valid(cand_y, cand_x, p, job, blk, cy,
                                          cx);

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const int px = cx + offs[2 * d], py = cy + offs[2 * d + 1];
    const int sub = (px & pelm) | ((py & pelm) << p.logp);
    // an invalid candidate may point outside the stack: it reads nothing
    const uint8_t* r = stack + ((size_t)job * p.n_sub + sub) * plane
                       + (valid ? (size_t)(py >> p.logp) * p.wp
                                  + (px >> p.logp) : 0);
    const uint8_t* s = src + (size_t)jb * p.bs_y * p.bs_x;
    const mvt::Stats3 st = mvt::block_stats3(s, p.bs_x, r, p.wp, p.bs_y,
                                             p.bs_x, g_lane, group, valid);
    if (in_range && g_lane == 0) {
        int* o = out + (ci * p.d + d) * 3;
        o[0] = valid ? st.sad : INT_MAX;
        o[1] = valid ? st.satd : INT_MAX;
        o[2] = valid ? st.luma : INT_MAX;
    }
}

}  // namespace

// ppw: pixels a 32-bit word holds (4 for uint8, 2 for uint16).
static ProbeParams probe_params(int n_jobs, int n_sub, int hp, int wp,
                                int nblk, int row_len, int k, int d, int tile,
                                int bs_y, int bs_x, int logp, int min_dy,
                                int min_dx, int wy, int cxs, int wy_total,
                                int wx_total, int center_y, int center_x,
                                int ppw) {
    ProbeParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk;
    p.row_len = row_len; p.k = k; p.d = d; p.tile = tile; p.bs_y = bs_y;
    p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy; p.min_dx = min_dx;
    p.wy = wy; p.cxs = cxs; p.wy_total = wy_total; p.wx_total = wx_total;
    p.center_y = center_y; p.center_x = center_x;
    p.wpr = (bs_x + ppw - 1) / ppw;
    p.nw = bs_y * p.wpr;
    p.g = 32;
    p.total = (long long)n_jobs * nblk * k;
    p.n_warps = (unsigned)p.total;
    return p;
}

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <typename T>
static void launch_probe(int wpl, bool masked, unsigned blocks, int threads,
                         cudaStream_t st, const void* stack,
                         const void* cand_y, const void* cand_x,
                         const void* src, const void* offs,
                         const uint8_t* active, void* out,
                         const ProbeParams& p) {
#define MVT_PROBE(W, M)                                                     \
    probe_kernel<T, W, M><<<blocks, threads, 0, st>>>(                      \
        (const T*)stack, (const int*)cand_y, (const int*)cand_x,            \
        (const T*)src, (const int*)offs, active, (int*)out, p)
    switch (wpl) {
        case 1:
            if (masked) MVT_PROBE(1, true);
            else MVT_PROBE(1, false);
            break;
        case 2: MVT_PROBE(2, false); break;
        case 4: MVT_PROBE(4, false); break;
        case 8: MVT_PROBE(8, false); break;
        case 16: MVT_PROBE(16, false); break;
        default: MVT_PROBE(0, false); break;
    }
#undef MVT_PROBE
}

// u16: 1 for uint16 stack and source blocks, 0 for uint8.
extern "C" int mvt_probe_sads_tiled(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        int n_jobs, int n_sub, int hp, int wp, int nblk, int row_len, int k,
        int d, int tile, int bs_y, int bs_x, int logp, int min_dy, int min_dx,
        int wy, int cxs, int wy_total, int wx_total, int center_y,
        int center_x, int u16, void* stream) {
    const int ppw = u16 ? 2 : 4;
    ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x,
        ppw);
    if (p.total == 0 || d == 0) return 0;
    // the body's index arithmetic is 32-bit (byte offsets within a job)
    if (p.total > INT_MAX
        || (long long)n_sub * hp * wp * (u16 ? 2 : 1) > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const bool masked = bs_x % ppw != 0;
    int wpl = 0;                     // 0: the generic body
    if (p.nw <= 32 && pow2(p.nw)) {
        p.g = p.nw;
        wpl = 1;
    } else if (p.nw % 32 == 0 && pow2(p.nw / 32) && p.nw / 32 <= 16) {
        wpl = p.nw / 32;
    }
    if (masked && wpl != 1) return (int)cudaErrorInvalidValue;
    const int warps = 8;
    const unsigned blocks = (unsigned)((p.total + warps - 1) / warps);
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* a = (const uint8_t*)active;
    if (u16)
        launch_probe<uint16_t>(wpl, masked, blocks, warps * 32, st, stack,
                               cand_y, cand_x, src, offs, a, out, p);
    else
        launch_probe<uint8_t>(wpl, masked, blocks, warps * 32, st, stack,
                              cand_y, cand_x, src, offs, a, out, p);
    return (int)cudaGetLastError();
}

extern "C" int mvt_probe_sads_tiled_stats3(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        int n_jobs, int n_sub, int hp, int wp, int nblk, int row_len, int k,
        int d, int tile, int bs_y, int bs_x, int logp, int min_dy, int min_dx,
        int wy, int cxs, int wy_total, int wx_total, int center_y,
        int center_x, int u16, void* stream) {
    // the three stats are defined for 8-bit stacks only
    if (u16) return (int)cudaErrorInvalidValue;
    const ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x, 4);
    if (p.total == 0 || d == 0) return 0;
    const int group = mvt::stats3_group(bs_y, bs_x);
    const int threads = 128;
    const long long lanes = p.total * d * group;
    const long long blocks = (lanes + threads - 1) / threads;
    probe_stats3_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (const uint8_t*)active,
        (int*)out, p, group);
    return (int)cudaGetLastError();
}
