// Per-block candidate probe (K4) and its three-stat form (K4').
//
// Replaces the TPU kernel mvtools_tpu/ops/probe.py::_probe_kernel
// (probe_sads_pallas): probe_block_kernel its stats="sad" form,
// probe_block_stats3_kernel its stats="sad_satd_luma" form.
//
// out[job, block, k, d] = SAD of the source block against the reference
// block at pel position (cand_x + dx_d, cand_y + dy_d), for K candidate
// centres per block and D static pel offsets.  Every (block, candidate) has
// a window of its own, so there is no validity rule: every active entry is
// a real SAD.
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
//   oy   = clamp(wrap(wb_y), 0, hp - wy) + ((ay >> logp) - wb_y)  (x alike)
//
// where wrap adds hp to a negative start: the JAX package's window slice,
// and its Pallas kernel run in interpret mode, take a start left of or
// above the stack round to the far edge.  Pixels are not clamped one by
// one.  The search bounds keep every candidate of the motion search inside
// the padded stack, where the shift is zero.
//
// `active` (optional, bool [J, nblk, K, D]) names the entries the caller
// will look at: an inactive entry reads no pixel and reports INVALID_SAD
// (int32 max; in all three stats of the three-stat form).
//
// Bound on this card: neither bytes nor operations.  The kernel serves the
// planes too small for the tiled probe's shared window (the coarse levels
// 4-6 of a 1080p pyramid: 18 or 98 blocks a job), where a call needs well
// under a microsecond of either (a byte bound of 0.02-0.5 us at the paths'
// shapes, PERF.md) and its time is the launch and one chain of dependent
// loads.  The first body gave each (job, block, candidate) one warp, which
// walked the D offsets one after another, each a strided pixel loop with a
// runtime division by the block width, byte loads and a five-step shuffle
// sum: D rounds of load latency in a row, on a handful of warps an SM
// (0.0094 device ms at level-4 chroma D=16; 0.32 ms over a 1080p YUV flash
// clip's 28 launches, H100 80GB HBM3, 700 W).
//
// Design (probe_block_kernel<T, CW, HALF>): every (job, block, candidate,
// offset) entry gets G lanes of its own (a power of two up to 32; the
// launch geometry is ops/probe.py::probe_block_launch_geom), so every
// offset of every item is in flight at once and a lane waits for one round
// of loads: the entry's flag, candidate and offset (independent), then its
// source and reference words.  A lane takes `parts` parts of the block,
// each CW (4, 2 or 1) 32-bit words of one block row: the source part by one
// vector load, the reference part by CW + 1 aligned 32-bit loads joined by
// funnel shifts; the part's row and column come from shifts and masks (no
// division after the entry's own indices).  Packed sums: VABSDIFF4 + IDP.4A
// a word for uint8, sum S + sum R - 2 sum min(S, R) (min.u16x2, IDP.2A) for
// uint16; the G lanes add by xor shuffles.  HALF: a uint8 block 2 pixels
// wide, whose row is half a word (the funnel-shifted word masked to two
// bytes).  A dead entry costs its flag, candidate and offset loads and one
// store.  CTAs of 256 lanes, fewer where a small launch would leave SMs
// without one.  Device time 0.0017-0.0073 ms a launch at the paths'
// shapes, 0.090 ms over the 8-bit clip's 28 launches (PERF.md): the
// launch itself is most of it.
//
// The three-stat form (K4', probe_block_stats3_kernel<TILE4>) writes the
// triple (SAD, SATD, sum of the reference block) per entry,
// out[job, block, k, d, 0..2] (satd.cuh says what the SATD is), with the
// same rule for a window that leaves the stack and the same `active` rule
// (an inactive entry reads no pixel and reports INVALID_SAD in all three).
// It is defined for 8-bit stacks only.  Its first body gave a (job, block,
// candidate, offset) entry a group of lanes over fixed CTAs of 128 that
// took each 4x4 tile of S - R pixel by pixel, computed every entry, and was
// masked after the launch by its wrapper (0.0028-0.0032 device ms a launch
// at the SATD path's level-5 shapes, H100 80GB HBM3, 700 W; PERF.md).
// Design, after K4's: G lanes an entry (a power of two up to 32; geometry
// ops/probe.py::probe_block3_launch_geom), a lane `parts` 8x4 partitions
// of the block (part q: rows 4 (q >> lpx), columns 8 (q & (2^lpx - 1))),
// or the one 4x4 tile of a 4x4 block (TILE4).  A partition is two 4x4
// tiles: the source rows by one 8-byte load a row, the reference rows by
// three aligned 32-bit loads and two funnel shifts a row; the SAD and the
// reference sum by VABSDIFF4 / IDP.4A, the SATD as
// sum |H(S) - H(R)| = sum u_S + sum u_R - 2 sum min(u_S, u_R) on biased
// 16-bit halves (satd.cuh::tile_stats3, as K2' takes it).  The entry's
// flag, candidate and offset are independent loads; a dead entry writes
// INT_MAX three times.  CTAs of 256 lanes, fewer where that leaves an SM
// without one.  The lanes of an entry add by xor shuffles.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "satd.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// A window slice's start: a negative start wraps once round the axis, then
// the n-long window is clamped inside it.
__device__ __forceinline__ int window_start(int start, int size, int n) {
    return clampi(start < 0 ? start + size : start, 0, size - n);
}

// The SAD form's launch, set by the wrapper (ops/probe.py::probe_sads) from
// ops/probe.py::probe_block_launch_geom.
struct K4Params {
    int n_sub, hp, wp;     // stack [J, n_sub, hp, wp]
    int nblk, k, d;        // blocks per job, K, D
    int bs_y, bs_x, logp;
    int min_dy, min_dx;    // most negative offsets of the set
    int wy, wx;            // window of the offset set, full-pel pixels
    int lg;                // log2 of G, the lanes of an entry
    int parts;             // parts (CW words of one block row) a lane takes
    int lppr;              // log2 of the parts of a block row
    unsigned n_lanes;      // entries * G
};

// CW words of source pixels from an address aligned to 4 * CW bytes (HALF:
// the two bytes of a 2-pixel uint8 row, aligned to 2), one load.
template <typename T, int CW, bool HALF>
__device__ __forceinline__ void source_words(const T* a, uint32_t* v) {
    if (HALF) {
        v[0] = *(const uint16_t*)a;
    } else if (CW == 4) {
        const uint4 q = *(const uint4*)a;
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if (CW == 2) {
        const uint2 q = *(const uint2*)a;
        v[0] = q.x; v[1] = q.y;
    } else {
        v[0] = *(const uint32_t*)a;
    }
}

// The CW reference words at byte address a (any alignment for uint8, even
// for uint16): CW + 1 aligned 32-bit loads, each holding a byte of the
// part (so none leaves the stack's allocation), joined by one funnel shift
// a word (HALF: the two bytes of a 2-pixel row, the upper half cleared).
template <int CW, bool HALF>
__device__ __forceinline__ void reference_words(uintptr_t a, uint32_t* r) {
    const unsigned sh = (unsigned)(a & 3) * 8u;
    const uint32_t* a4 = (const uint32_t*)(a & ~(uintptr_t)3);
    uint32_t v[CW + 1];
#pragma unroll
    for (int j = 0; j < CW; ++j) v[j] = __ldg(a4 + j);
    v[CW] = __ldg((const uint32_t*)((a + (HALF ? 1 : 4 * CW - 1))
                                    & ~(uintptr_t)3));
#pragma unroll
    for (int j = 0; j < CW; ++j) r[j] = __funnelshift_r(v[j], v[j + 1], sh);
    if (HALF) r[0] &= 0xffffu;
}

// The SAD of CW words added into acc: VABSDIFF4.U8 + IDP.4A a word for
// uint8; for uint16 sum S + sum R - 2 sum min(S, R), one min.u16x2 and three
// IDP.2A a word (acc wraps modulo 2^32; the whole sum is exact).
template <typename T, int CW>
__device__ __forceinline__ unsigned words_sad(const uint32_t* s,
                                              const uint32_t* r,
                                              unsigned acc) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
        if (sizeof(T) == 1) {
            acc = __dp4a(__vabsdiffu4(r[j], s[j]), 0x01010101u, acc);
        } else {
            acc = __dp2a_lo(s[j], 0x0101u, acc);
            acc = __dp2a_lo(r[j], 0x0101u, acc);
            acc -= 2u * __dp2a_lo(mvt::min_u16x2(s[j], r[j]), 0x0101u, 0u);
        }
    }
    return acc;
}

// T: the pixel type (uint8_t, or uint16_t for 9- to 16-bit clips); CW:
// words a part (1, 2, 4); HALF: a uint8 block 2 pixels wide (a part is half
// a word).  G lanes take one entry (job, block, candidate, offset), each
// `parts` parts of the block (part q: block row q >> lppr, word column
// (q & (2^lppr - 1)) * CW), and sum over G lanes by xor shuffles.
template <typename T, int CW, bool HALF>
__global__ void __launch_bounds__(256)
probe_block_kernel(const T* __restrict__ stack,
                   const int* __restrict__ cand_y,
                   const int* __restrict__ cand_x,
                   const T* __restrict__ src,
                   const int2* __restrict__ offs,     // [D] (dx, dy)
                   const uint8_t* __restrict__ active,
                   int* __restrict__ out, K4Params p) {
    constexpr int PB = (int)sizeof(T);               // bytes a pixel
    constexpr int PPP = HALF ? 2 : 4 * CW / PB;      // pixels a part
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.n_lanes) return;                      // whole entries only
    const int lane = threadIdx.x & 31;
    const int G = 1 << p.lg;
    const int g = lane & (G - 1);                    // lane inside its entry
    const unsigned e = t >> p.lg;                    // (job, block, k, d)
    const unsigned w = e / (unsigned)p.d;            // (job, block, k)
    const int d = (int)(e - w * (unsigned)p.d);
    // the entry's flag, candidate and offset: independent loads
    const bool live = active == nullptr || active[e] != 0;
    const int cy = __ldg(cand_y + w), cx = __ldg(cand_x + w);
    const int2 o = __ldg(offs + d);
    if (!live) {                                     // reads no pixel
        if (g == 0) out[e] = INT_MAX;
        return;
    }
    const unsigned jb = w / (unsigned)p.k;           // (job, block)
    const unsigned job = jb / (unsigned)p.nblk;
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int ax = cx + o.x, ay = cy + o.y;
    const int pelm = (1 << p.logp) - 1;
    const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
    const int oy = (ay >> p.logp) + window_start(wb_y, p.hp, p.wy) - wb_y;
    const int ox = (ax >> p.logp) + window_start(wb_x, p.wp, p.wx) - wb_x;
    const size_t plane = (size_t)p.hp * p.wp;
    const uintptr_t r0 = (uintptr_t)(stack + ((size_t)job * p.n_sub + sub)
                                     * plane + (size_t)oy * p.wp + ox);
    const T* s0 = src + (size_t)jb * p.bs_y * p.bs_x;
    const int pmask = (1 << p.lppr) - 1;
    unsigned acc = 0;
#pragma unroll 4
    for (int i = 0; i < p.parts; ++i) {
        const int q = g + (i << p.lg);
        const int row = q >> p.lppr, col = (q & pmask) * PPP;
        uint32_t s[CW], r[CW];
        source_words<T, CW, HALF>(s0 + row * p.bs_x + col, s);
        reference_words<CW, HALF>(
            r0 + (uintptr_t)(row * p.wp + col) * PB, r);
        acc = words_sad<T, CW>(s, r, acc);
    }
    const unsigned gmask = G == 32 ? 0xffffffffu
                                   : ((1u << G) - 1u) << (lane & ~(G - 1));
    for (int sh = G >> 1; sh > 0; sh >>= 1)
        acc += __shfl_xor_sync(gmask, acc, sh);
    if (g == 0) out[e] = (int)acc;
}

// The three-stat form's launch, set by the wrapper (ops/probe.py::
// probe_sads) from ops/probe.py::probe_block3_launch_geom.
struct K4pParams {
    int n_sub, hp, wp;     // stack [J, n_sub, hp, wp]
    int nblk, k, d;        // blocks per job, K, D
    int bs_y, bs_x, logp;
    int min_dy, min_dx;    // most negative offsets of the set
    int wy, wx;            // window of the offset set, full-pel pixels
    int lg;                // log2 of G, the lanes of an entry
    int parts;             // 8x4 partitions a lane takes
    int lpx;               // log2 of the partitions of a block row
    unsigned n_lanes;      // entries * G
};

// One 4x4 tile of an entry: source rows s, reference rows r (pixels in byte
// order); adds its SAD, SATD (the tile's sum of |H(S) - H(R)|, halved) and
// reference sum.
__device__ __forceinline__ void tile3(const uint32_t (&s)[4],
                                      const uint32_t (&r)[4], unsigned& sad,
                                      int& sat, unsigned& luma) {
    uint32_t hs[8];
    mvt::tile_hadamard(s, hs);
    mvt::tile_stats3(r, s, hs, sad, sat, luma);
    sat += 8 * (int)(s[0] & 0xffu) + 16 * (int)mvt::ZB;   // 8 S00 + 16 Z
}

// TILE4: the 4x4 block (one tile, G = 1).  Otherwise G lanes take one entry
// (job, block, candidate, offset), each `parts` 8x4 partitions.
template <bool TILE4>
__global__ void __launch_bounds__(256)
probe_block_stats3_kernel(const uint8_t* __restrict__ stack,
                          const int* __restrict__ cand_y,
                          const int* __restrict__ cand_x,
                          const uint8_t* __restrict__ src,
                          const int2* __restrict__ offs,    // [D] (dx, dy)
                          const uint8_t* __restrict__ active,
                          int* __restrict__ out, K4pParams p) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.n_lanes) return;                      // whole entries only
    const int lane = threadIdx.x & 31;
    const int G = 1 << p.lg;
    const int g = lane & (G - 1);                    // lane inside its entry
    const unsigned e = t >> p.lg;                    // (job, block, k, d)
    const unsigned w = e / (unsigned)p.d;            // (job, block, k)
    const int d = (int)(e - w * (unsigned)p.d);
    // the entry's flag, candidate and offset: independent loads
    const bool live = active == nullptr || active[e] != 0;
    const int cy = __ldg(cand_y + w), cx = __ldg(cand_x + w);
    const int2 o = __ldg(offs + d);
    int* oe = out + (size_t)e * 3;
    if (!live) {                                     // reads no pixel
        if (g == 0) oe[0] = oe[1] = oe[2] = INT_MAX;
        return;
    }
    const unsigned jb = w / (unsigned)p.k;           // (job, block)
    const unsigned job = jb / (unsigned)p.nblk;
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int ax = cx + o.x, ay = cy + o.y;
    const int pelm = (1 << p.logp) - 1;
    const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
    const int oy = (ay >> p.logp) + window_start(wb_y, p.hp, p.wy) - wb_y;
    const int ox = (ax >> p.logp) + window_start(wb_x, p.wp, p.wx) - wb_x;
    const size_t plane = (size_t)p.hp * p.wp;
    const uintptr_t r0 = (uintptr_t)(stack + ((size_t)job * p.n_sub + sub)
                                     * plane + (size_t)oy * p.wp + ox);
    const uint8_t* s0 = src + (size_t)jb * p.bs_y * p.bs_x;
    unsigned sad = 0, luma = 0;
    int sat = 0;
    if (TILE4) {
        uint32_t s[4], r[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            s[y] = *(const uint32_t*)(s0 + 4 * y);
            reference_words<1, false>(r0 + (uintptr_t)y * p.wp, &r[y]);
        }
        tile3(s, r, sad, sat, luma);
    } else {
        const int pxm = (1 << p.lpx) - 1;
#pragma unroll 2
        for (int i = 0; i < p.parts; ++i) {
            const int q = g + (i << p.lg);
            const int row = (q >> p.lpx) << 2, col = (q & pxm) << 3;
            uint32_t sa[4], sb[4], ra[4], rb[4];
#pragma unroll
            for (int y = 0; y < 4; ++y) {
                const uint2 v = *(const uint2*)(s0 + (row + y) * p.bs_x
                                                + col);
                sa[y] = v.x; sb[y] = v.y;
                uint32_t rr[2];
                reference_words<2, false>(
                    r0 + (uintptr_t)((row + y) * p.wp + col), rr);
                ra[y] = rr[0]; rb[y] = rr[1];
            }
            tile3(sa, ra, sad, sat, luma);
            tile3(sb, rb, sad, sat, luma);
        }
    }
    const unsigned gmask = G == 32 ? 0xffffffffu
                                   : ((1u << G) - 1u) << (lane & ~(G - 1));
    for (int sh = G >> 1; sh > 0; sh >>= 1) {
        sad += __shfl_xor_sync(gmask, sad, sh);
        sat += __shfl_xor_sync(gmask, sat, sh);
        luma += __shfl_xor_sync(gmask, luma, sh);
    }
    if (g == 0) {
        oe[0] = (int)sad; oe[1] = sat; oe[2] = (int)luma;
    }
}

}  // namespace

// The ints of a launch, in the order of ops/probe.py::_PROBE_BLOCK_ARGS.
enum K4Arg {
    A_JOBS, A_SUB, A_HP, A_WP, A_NBLK, A_K, A_D, A_BSY, A_BSX, A_LOGP,
    A_MINDY, A_MINDX, A_WY, A_WX, A_U16, A_CW, A_HALF, A_LG, A_PARTS,
    A_LPPR, A_THREADS, A_COUNT
};

// a: the launch's A_COUNT ints (u16: 1 for uint16 stack and source blocks,
// 0 for uint8; cw, half, lg, parts, lppr, threads: the geometry of
// ops/probe.py::probe_block_launch_geom).  active: bool [J, nblk, K, D] or
// null for all.
extern "C" int mvt_probe_sads(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        const int* a, void* stream) {
    K4Params p;
    p.n_sub = a[A_SUB]; p.hp = a[A_HP]; p.wp = a[A_WP]; p.nblk = a[A_NBLK];
    p.k = a[A_K]; p.d = a[A_D]; p.bs_y = a[A_BSY]; p.bs_x = a[A_BSX];
    p.logp = a[A_LOGP]; p.min_dy = a[A_MINDY]; p.min_dx = a[A_MINDX];
    p.wy = a[A_WY]; p.wx = a[A_WX]; p.lg = a[A_LG]; p.parts = a[A_PARTS];
    p.lppr = a[A_LPPR];
    const int u16 = a[A_U16], cw = a[A_CW], half = a[A_HALF];
    const int threads = a[A_THREADS];
    const long long entries = (long long)a[A_JOBS] * p.nblk * p.k * p.d;
    if (entries == 0) return 0;
    // whole words a row (half a word: a 2-pixel uint8 row), rows of whole
    // parts, the parts of a row a power of two, G lanes an entry that take
    // all of the block's parts, 32-bit lane indices
    const int ppw = u16 ? 2 : 4;
    const int wpr = half ? 1 : p.bs_x / ppw;
    if ((u16 != 0 && u16 != 1) || (cw != 1 && cw != 2 && cw != 4)
        || (half && (u16 || cw != 1 || p.bs_x != 2 || p.lppr != 0))
        || (!half && (p.bs_x % ppw || wpr % cw || wpr / cw != 1 << p.lppr))
        || p.lg < 0 || p.lg > 5 || p.parts < 1
        || (long long)p.bs_y * (wpr / cw) != (long long)p.parts << p.lg
        || threads < 32 || threads > 256 || threads % 32
        || (entries << p.lg) > INT_MAX)
        return (int)cudaErrorInvalidValue;
    p.n_lanes = (unsigned)(entries << p.lg);
    const unsigned blocks = (p.n_lanes + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
#define MVT_K4(T, C, H)                                                     \
    probe_block_kernel<T, C, H><<<blocks, threads, 0, st>>>(                \
        (const T*)stack, (const int*)cand_y, (const int*)cand_x,            \
        (const T*)src, (const int2*)offs, (const uint8_t*)active,           \
        (int*)out, p)
    if (u16) {
        switch (cw) {
            case 4: MVT_K4(uint16_t, 4, false); break;
            case 2: MVT_K4(uint16_t, 2, false); break;
            default: MVT_K4(uint16_t, 1, false); break;
        }
    } else if (half) {
        MVT_K4(uint8_t, 1, true);
    } else {
        switch (cw) {
            case 4: MVT_K4(uint8_t, 4, false); break;
            case 2: MVT_K4(uint8_t, 2, false); break;
            default: MVT_K4(uint8_t, 1, false); break;
        }
    }
#undef MVT_K4
    return (int)cudaGetLastError();
}

// The ints of a three-stat launch, in the order of
// ops/probe.py::_PROBE_BLOCK3_ARGS.
enum K4pArg {
    B_JOBS, B_SUB, B_HP, B_WP, B_NBLK, B_K, B_D, B_BSY, B_BSX, B_LOGP,
    B_MINDY, B_MINDX, B_WY, B_WX, B_TILE4, B_LG, B_PARTS, B_LPX, B_THREADS,
    B_COUNT
};

// a: the launch's B_COUNT ints (tile4, lg, parts, lpx, threads: the
// geometry of ops/probe.py::probe_block3_launch_geom).  active: bool
// [J, nblk, K, D] or null for all.  uint8 stacks and source blocks only.
extern "C" int mvt_probe_sads_stats3(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        const int* a, void* stream) {
    K4pParams p;
    p.n_sub = a[B_SUB]; p.hp = a[B_HP]; p.wp = a[B_WP]; p.nblk = a[B_NBLK];
    p.k = a[B_K]; p.d = a[B_D]; p.bs_y = a[B_BSY]; p.bs_x = a[B_BSX];
    p.logp = a[B_LOGP]; p.min_dy = a[B_MINDY]; p.min_dx = a[B_MINDX];
    p.wy = a[B_WY]; p.wx = a[B_WX]; p.lg = a[B_LG]; p.parts = a[B_PARTS];
    p.lpx = a[B_LPX];
    const int tile4 = a[B_TILE4], threads = a[B_THREADS];
    const long long entries = (long long)a[B_JOBS] * p.nblk * p.k * p.d;
    if (entries == 0) return 0;
    // the 4x4 block as one tile on one lane; otherwise rows of whole 8x4
    // partitions, a power of two of them a row, G lanes that take them all
    if ((tile4 != 0 && tile4 != 1)
        || (tile4 && (p.bs_y != 4 || p.bs_x != 4 || p.lg || p.parts != 1))
        || (!tile4 && (p.bs_y % 4 || p.bs_x % 8 || p.lpx < 0
                       || p.bs_x / 8 != 1 << p.lpx
                       || (long long)(p.bs_y / 4) * (p.bs_x / 8)
                          != (long long)p.parts << p.lg))
        || p.lg < 0 || p.lg > 5 || p.parts < 1
        || threads < 32 || threads > 256 || threads % 32
        || (entries << p.lg) > INT_MAX)
        return (int)cudaErrorInvalidValue;
    p.n_lanes = (unsigned)(entries << p.lg);
    const unsigned blocks = (p.n_lanes + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
#define MVT_K4P(T4)                                                         \
    probe_block_stats3_kernel<T4><<<blocks, threads, 0, st>>>(              \
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,      \
        (const uint8_t*)src, (const int2*)offs, (const uint8_t*)active,     \
        (int*)out, p)
    if (tile4) MVT_K4P(true); else MVT_K4P(false);
#undef MVT_K4P
    return (int)cudaGetLastError();
}
