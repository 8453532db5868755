// Tiled candidate probe (K2) and its three-stat form (K2').
//
// Replaces the TPU kernel mvtools_tpu/ops/probe.py::_tiled_probe_kernel
// (probe_sads_tiled_pallas): probe_kernel its stats="sad" form on uint8
// stacks, probe16_kernel the same on uint16 stacks, probe_stats3_kernel its
// stats="sad_satd_luma" form.
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
// loads of the validity rule, before any pixel (for this body's former
// uint16 form the cuts below found the pixel loads the larger cost).
// Staging the offset set's window in shared memory once per warp timed
// slower (PERF.md).  nvcc -Xptxas -v (sm_90a): 32-74 registers a thread
// over the instantiations (probe_kernel<2, false>: 40), no spills.
//
// probe_kernel takes uint8 stacks only.  uint16 stacks (9- to 16-bit clips)
// have a kernel of their own, probe16_kernel: it replaces the same Pallas
// kernel (_tiled_probe_kernel) on uint16 stacks.  Bound: bytes (each valid,
// live entry reads its block of the stack; every entry writes four bytes;
// each flag is read once).  probe_kernel's former uint16 instantiation took
// 0.585 ms at [12, 32026, 1, 6] and 0.832 at the chroma [12, 32026, 1, 16]
// (H100 80GB HBM3, 700 W); cutting its body on the card
// (experiments/k2u16_timing.py, which keeps a copy of it) showed that
// neither its runtime divisions (0.00 ms) nor the validity rule's loads
// (0.03 ms) held it back: its pixel loads did (0.21 of 0.58 ms), two
// 32-bit loads a word, and a warp per
// candidate walked the chroma block's 16 offsets one at a time.  The clip's
// launches are masked: 3.8 % of the 3.1 G entries a 16-bit flash clip
// probes are live and valid, and 97-98 % of the items of its level-0 walks
// are dead, so a dead item must cost no more than its flags and its stores.
// probe16_kernel's design:
// - a CTA takes a span of a block row's blocks (3-D grid: block group,
//   block row, job), its items up to 32 a warp (fewer in a launch of few
//   items, so that its warps fill the card);
// - a lane checks one item: its flags (whole words where D is a multiple
//   of 4), then for a live item its candidate against its tile's window
//   base; a dead or off-tile item is filled with INVALID_SAD by that lane,
//   four entries a store;
// - the warp's live, valid items go to its groups of G lanes in turn, each
//   lane with CH chunks of four (two, one) source words of one block row,
//   loaded once by one vector load; the launch geometry is
//   ops/probe.py::probe16_launch_geom;
// - per offset a chunk's five reference words come from up to three
//   aligned 8-byte loads and a select (two thirds of the 32-bit loads), one
//   funnel shift a word, and the SAD is sum S + sum R - 2 sum min(S, R): one
//   min.u16x2 and two IDP.2A a word, sum S made once; the item's G lanes add
//   by xor shuffles.
// The loads of the live entries' reference words remain its largest cost
// (PERF.md).

// The three-stat form writes the triple (SAD, SATD, sum of the reference
// block) per entry, out[job, block, k, d, 0..2] (satd.cuh says what the SATD
// is), under the same validity rule: an invalid candidate, or an inactive
// entry, reports INVALID_SAD in all three.  Bound: bytes at the search's
// offset counts.  Its first body gave each (job, block, candidate, offset) a
// group of lanes that loaded both blocks byte by byte and transformed S - R
// afresh (about ten instructions a pixel-offset, 64-bit index arithmetic,
// the validity rule's loads in every lane): 0.158 ms at Recalculate's
// [8, 32026, 1, 1, 3], 0.139 at Analyse's hexagon [8, 8040, 1, 6, 3]
// (H100 80GB HBM3, 700 W, CUDA events).  probe_stats3_kernel is K2's frame
// with the arithmetic of K1' (the three-stat map): a warp per candidate (or
// per two or more where a candidate has too few offsets to fill the warp),
// the source block's 4x4
// Hadamard transforms H(S) made once, and per offset H(R) in biased 16-bit
// halves, set against H(S) by one min.u16x2 and one IDP.2A a coefficient
// pair (satd.cuh); the launch geometry is
// ops/probe.py::probe3_launch_geom.

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

// The uint8 form.  WPL: source words a lane holds in registers (1, 2, 4, 8,
// 16), or 0 for the generic body.  MASKED: the block width is not a multiple
// of the pixels a word holds (only a 2-wide chroma block), so a row's last
// word is cut by a mask.
template <int WPL, bool MASKED>
__global__ void __launch_bounds__(256)
probe_kernel(const uint8_t* __restrict__ stack,
             const int* __restrict__ cand_y, const int* __restrict__ cand_x,
             const uint8_t* __restrict__ src,
             const int* __restrict__ offs,  // [D, 2] (dx, dy)
             const uint8_t* __restrict__ active, int* __restrict__ out,
             ProbeParams p) {
    using T = uint8_t;
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

struct Probe16Params {
    int n_sub, hp, wp;        // stack [J, n_sub, hp, wp] of uint16 pixels
    int nblk, row_len, k, d;  // blocks per job, blocks per row, K, D
    int tile, bs_y, bs_x, logp;
    int min_dy, min_dx;       // most negative offsets of the set
    int wy, cxs;              // logical window rows, 128-rounded columns
    int wy_total, wx_total, center_y, center_x;
    int g, lg;                // lanes an item takes in the pixel pass, log2
    int lcpr;                 // log2 of the chunks a block row
    int nc;                   // chunks a block
    int span;                 // blocks of a block row a CTA takes
};

// CW source words (2 * CW pixels) from a uint16 address aligned to 4 * CW
// bytes, with one vector load.
template <int CW>
__device__ __forceinline__ void load_words(const uint16_t* p, uint32_t* v) {
    if (CW == 4) {
        const uint4 q = *(const uint4*)p;
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else if (CW == 2) {
        const uint2 q = *(const uint2*)p;
        v[0] = q.x; v[1] = q.y;
    } else {
        v[0] = *(const uint32_t*)p;
    }
}

// Adds sum R and sum min(S, R) of one chunk: the CW reference words at byte
// address a (even) against the source words s.  Four-word chunks: up to
// three aligned 8-byte loads and a select of the five words that hold the
// chunk (32-bit and 16-byte loads timed slower, PERF.md); narrower ones:
// CW + 1 aligned 32-bit loads.  One funnel shift a word.  Every aligned
// load holds a pixel of the chunk, so none can leave the stack's allocation.
template <int CW>
__device__ __forceinline__ void chunk_sums(uintptr_t a, const uint32_t* s,
                                           unsigned& acc_r, unsigned& acc_m) {
    const unsigned sh = (unsigned)(a & 3) * 8u;
    uint32_t v[CW + 1];
    if (CW == 4) {
        const uint2* a8 = (const uint2*)(a & ~(uintptr_t)7);
        const uint2 x0 = __ldg(a8), x1 = __ldg(a8 + 1);
        const uint2 x2 = (a & 7) ? __ldg(a8 + 2) : x1;
        const uint32_t w[6] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y};
        const bool q = ((a >> 2) & 1u) != 0;
#pragma unroll
        for (int j = 0; j < CW + 1; ++j) v[j] = q ? w[j + 1] : w[j];
    } else {
        const uint32_t* a4 = (const uint32_t*)(a & ~(uintptr_t)3);
#pragma unroll
        for (int j = 0; j < CW; ++j) v[j] = __ldg(a4 + j);
        v[CW] = __ldg((const uint32_t*)((a + 4 * CW - 1) & ~(uintptr_t)3));
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
        const uint32_t r = __funnelshift_r(v[j], v[j + 1], sh);
        acc_r = __dp2a_lo(r, 0x0101u, acc_r);
        acc_m = __dp2a_lo(mvt::min_u16x2(r, s[j]), 0x0101u, acc_m);
    }
}

// Bit i of the result: byte i of w, a flag of 0 or 1.
__device__ __forceinline__ unsigned flag_bits(uint32_t w) {
    return ((w & 0x01010101u) * 0x01020408u) >> 24;
}

// INT_MAX into the d entries at o by the g lanes of an item (lane l of
// them: l, l + g, ...), four at a time where d is a multiple of 4 (o is
// then 16-byte aligned: it starts a row of d entries).
__device__ __forceinline__ void fill_invalid(int* o, int d, int l, int g) {
    if (d % 4 == 0) {
        const int4 v = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
        for (int e = 4 * l; e < d; e += 4 * g) *(int4*)(o + e) = v;
    } else {
        for (int e = l; e < d; e += g) o[e] = INT_MAX;
    }
}

// The three-stat form (K2'): K2's frame with the arithmetic of K1'.  One warp
// per C (job, block, candidate)s, as probe_kernel with C = 1: the same 32-bit
// indices, the validity rule computed once a candidate, the offsets and flags
// read once and taken by shuffle and ballot.  A lane owns whole 4x4 tiles of
// the block: G lanes an offset (G = the block's tiles where they are a power
// of two up to 32, 32 beyond), 32 / G offset slots a warp, split evenly over
// its C candidates (C > 1 where a candidate has too few offsets to fill the
// slots: Recalculate's one offset of a 16x16 block, two candidates a warp).
// TPL: tiles a lane keeps in registers (1, 2 or 4 when the tiles are G *
// TPL), their source words and their transforms H(S), made once before the
// offset loop; 0 for the generic body, which strides the tiles over the warp
// and makes both afresh per offset.  Per offset a lane builds each tile's
// four reference words (ref_word: one funnel shift each) and adds, by
// satd.cuh::tile_stats3, the tile's SAD (VABSDIFF4 + IDP.4A a word),
// reference sum (IDP.4A) and SATD part from H(R) in biased 16-bit halves (one
// VIMNMX.U16x2 + IDP.2A a coefficient pair); the offset's lanes then add
// their three sums.
template <int TPL>
__global__ void __launch_bounds__(256)
probe_stats3_kernel(const uint8_t* __restrict__ stack,
                    const int* __restrict__ cand_y,
                    const int* __restrict__ cand_x,
                    const uint8_t* __restrict__ src,
                    const int* __restrict__ offs,  // [D, 2] (dx, dy)
                    const uint8_t* __restrict__ active,
                    int* __restrict__ out, ProbeParams p, int cpw) {
    const int lane = threadIdx.x & 31;
    const unsigned w0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))
                        * (unsigned)cpw;       // the warp's first candidate
    if (w0 >= p.n_warps) return;               // uniform over the warp
    const int ncw = min(cpw, (int)(p.n_warps - w0));  // its candidates
    const int g = lane & (p.g - 1);            // lane inside its offset slot
    const int slot = lane / p.g;
    const int spc = 32 / p.g / cpw;            // offset slots a candidate
    const int cl = slot / spc, so = slot - cl * spc;
    const unsigned w = w0 + cl;                // the lane's candidate
    const bool have = cl < ncw;
    // up to 32 offsets: lane d holds offset d; with C candidates (C * D <= 32)
    // lane l holds the flag of entry l % D of candidate l / D, bit l of `live`
    const bool few = p.d <= 32;
    int odx = 0, ody = 0;
    unsigned live = FULL;
    const uint8_t* act = active ? active + (size_t)w0 * p.d : nullptr;
    if (few) {
        if (lane < p.d) {
            odx = offs[2 * lane];
            ody = offs[2 * lane + 1];
        }
        live = __ballot_sync(FULL, lane < ncw * p.d && (!act || act[lane]));
    } else if (act) {                          // C == 1
        bool any = false;
        for (int d = lane; d < p.d; d += 32) any |= act[d] != 0;
        live = __ballot_sync(FULL, any);
    }
    const unsigned mine = few ? (live >> (cl * p.d)) & ((2u << (p.d - 1)) - 1u)
                              : live;
    const int ntx = p.bs_x >> 2;               // tiles a tile row
    const int n_tiles = (p.bs_y >> 2) * ntx;
    constexpr int NT = TPL > 0 ? TPL : 1;
    uint32_t sw[NT][4];                        // the lane's source tiles
    bool ok = false;
    unsigned jb = 0, job = 0;
    int cy = 0, cx = 0;
    if (have && mine) {
        jb = w / (unsigned)p.k;
        job = jb / (unsigned)p.nblk;
        cy = cand_y[w];
        cx = cand_x[w];
        if (TPL > 0) {       // loaded while the validity rule's are in flight
            const uint8_t* s = src + (size_t)jb * p.bs_y * p.bs_x;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
                const int t = g + i * p.g;
                const int ty = t / ntx, tx = t - ty * ntx;
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    sw[i][y] = *(const uint32_t*)(s + 4 * (ty * p.bs_x + tx)
                                                  + y * p.bs_x);
            }
        }
        ok = candidate_valid(cand_y, cand_x, p, (int)job,
                             (int)(jb - job * (unsigned)p.nblk), cy, cx);
    }
    int* o = out + (size_t)w * p.d * 3;
    if (!__any_sync(FULL, ok)) {
        int* ow = out + (size_t)w0 * p.d * 3;
        for (int i = lane; i < 3 * p.d * ncw; i += 32) ow[i] = INT_MAX;
        return;
    }
    if (have && !ok)                           // the candidate's lanes
        for (int i = so * p.g + g; i < 3 * p.d; i += spc * p.g) o[i] = INT_MAX;

    const uint8_t* s = src + (size_t)jb * p.bs_y * p.bs_x;

    // the lane's tiles: H(S), plane offset, and the source constants sum of
    // 8 S00 + 16 Z
    uint32_t hs[NT][8];
    int toff[NT];
    int sconst = 0;
    if (TPL > 0 && ok) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
            const int t = g + i * p.g;
            const int ty = t / ntx, tx = t - ty * ntx;
            mvt::tile_hadamard(sw[i], hs[i]);
            sconst += 8 * (int)(sw[i][0] & 255u) + 16 * (int)mvt::ZB;
            toff[i] = 4 * (ty * p.wp + tx);
        }
    }

    const int pelm = (1 << p.logp) - 1;
    const int plane = p.hp * p.wp;
    const uint8_t* stack_j = stack + (size_t)job * p.n_sub * plane;
    for (int d0 = 0; d0 < p.d; d0 += spc) {
        const int d = d0 + so;
        bool on;
        int dx, dy;
        if (few) {
            on = ok && d < p.d && ((mine >> d) & 1u);
            dx = __shfl_sync(FULL, odx, d & 31);
            dy = __shfl_sync(FULL, ody, d & 31);
        } else {
            on = ok && d < p.d && (!act || act[d]);
            dx = on ? offs[2 * d] : 0;
            dy = on ? offs[2 * d + 1] : 0;
        }
        if (ok && d < p.d && !on && g == 0)
            o[3 * d] = o[3 * d + 1] = o[3 * d + 2] = INT_MAX;
        if (!__any_sync(FULL, on)) continue;
        unsigned sad = 0, luma = 0;
        int sat = 0;
        if (on) {
            const int px = cx + dx, py = cy + dy;
            const int sub = (px & pelm) | ((py & pelm) << p.logp);
            const uint8_t* r = stack_j + (sub * plane + (py >> p.logp) * p.wp
                                          + (px >> p.logp));
            uint32_t rw[4];
            if (TPL > 0) {
                sat = sconst;
#pragma unroll
                for (int i = 0; i < NT; ++i) {
#pragma unroll
                    for (int y = 0; y < 4; ++y)
                        rw[y] = ref_word(r + toff[i] + y * p.wp, 3);
                    mvt::tile_stats3(rw, sw[i], hs[i], sad, sat, luma);
                }
            } else {                           // generic: G == 32
                for (int t = lane; t < n_tiles; t += 32) {
                    const int ty = t / ntx, tx = t - ty * ntx;
                    const uint8_t* st = s + 4 * (ty * p.bs_x + tx);
                    uint32_t sv[4], hv[8];
#pragma unroll
                    for (int y = 0; y < 4; ++y) {
                        sv[y] = *(const uint32_t*)(st + y * p.bs_x);
                        rw[y] = ref_word(r + 4 * (ty * p.wp + tx) + y * p.wp,
                                         3);
                    }
                    mvt::tile_hadamard(sv, hv);
                    sat += 8 * (int)(sv[0] & 255u) + 16 * (int)mvt::ZB;
                    mvt::tile_stats3(rw, sv, hv, sad, sat, luma);
                }
            }
        }
        // the offset's lanes add their sums: one warp-wide sum per stat
        // when the warp runs one offset, else xor shuffles inside the slot
        if (p.g == 32) {
            sad = __reduce_add_sync(FULL, sad);
            sat = (int)__reduce_add_sync(FULL, (unsigned)sat);
            luma = __reduce_add_sync(FULL, luma);
        } else {
            for (int sh = p.g >> 1; sh > 0; sh >>= 1) {
                sad += __shfl_xor_sync(FULL, sad, sh);
                sat += __shfl_xor_sync(FULL, sat, sh);
                luma += __shfl_xor_sync(FULL, luma, sh);
            }
        }
        if (g == 0 && on) {
            o[3 * d] = (int)sad;
            o[3 * d + 1] = sat;
            o[3 * d + 2] = (int)luma;
        }
    }
}

// The uint16 form (K2 u16).  A CTA takes `span` blocks of one block row of
// one job (blockIdx = block group, block row, job), their items (block,
// candidate) in order, up to 32 a warp at a time.  First each lane checks one
// item: its flags (whole words where D is a multiple of 4), then, for a
// live one, its candidate against its tile's window base (made from the
// three members' candidate 0); a dead or off-tile item is filled with
// INVALID_SAD by that lane alone.  Then the warp's live, valid items go
// to its groups of G lanes, 32 / G at a time: G lanes own an item, CH
// chunks of CW source words each (a chunk is CW words of one block row),
// loaded once with one vector load a chunk.  Per offset a lane builds its
// chunks' reference words (chunk_sums) and adds sum R and sum min(S, R);
// the item's SAD is sum S + sum R - 2 sum min(S, R), summed over its G
// lanes by xor shuffles.  CH 0: the generic body (G 32, the lanes stride
// over the chunks, the source re-read per offset).
template <int CW, int CH>
__global__ void __launch_bounds__(256)
probe16_kernel(const uint16_t* __restrict__ stack,
               const int* __restrict__ cand_y, const int* __restrict__ cand_x,
               const uint16_t* __restrict__ src,
               const int* __restrict__ offs,  // [D, 2] (dx, dy)
               const uint8_t* __restrict__ active, int* __restrict__ out,
               Probe16Params p) {
    const int lane = threadIdx.x & 31;
    const int g = lane & (p.g - 1);            // lane inside its item
    const int gbase = lane - g;                // the item's first lane
    const unsigned gmask = p.g == 32 ? FULL
                                     : ((1u << p.g) - 1u) << gbase;
    const int grp = lane >> p.lg, n_grp = 32 >> p.lg;
    const int row = blockIdx.y, job = blockIdx.z;
    const int col0 = blockIdx.x * p.span;      // the CTA's first column
    const int n_items = min(p.span, p.row_len - col0) * p.k;
    const int rb = job * p.nblk + row * p.row_len;  // the row's first block
    const int w0 = (rb + col0) * p.k;          // the CTA's first item
    const int last = p.row_len - 1;
    const int pelm = (1 << p.logp) - 1;
    const int plane = p.hp * p.wp;
    const uintptr_t stack_j = (uintptr_t)(stack + (size_t)job * p.n_sub
                                                  * plane);
    const int cmask = (1 << p.lcpr) - 1;
    const bool few = p.d <= 32;
    const unsigned all = few ? (p.d == 32 ? FULL : (1u << p.d) - 1u) : FULL;
    for (int i0 = (threadIdx.x >> 5) * 32; i0 < n_items;
         i0 += (int)blockDim.x) {
        // the lane's item: live entries (bit d for entry d, D <= 32), and
        // for a live one its candidate and the validity rule
        const int it = i0 + lane;
        const int w = w0 + it;                 // (job, block, candidate)
        unsigned live = 0;
        int cy = 0, cx = 0;
        bool ok = false;
        if (it < n_items) {
            const uint8_t* act = active ? active + (size_t)w * p.d : nullptr;
            live = all;
            bool any = true;
            if (act && few) {
                live = 0;
                if (p.d % 4 == 0) {
                    for (int q = 0; q < p.d; q += 4)
                        live |= flag_bits(*(const uint32_t*)(act + q)) << q;
                } else {
                    for (int d = 0; d < p.d; ++d)
                        live |= (act[d] != 0 ? 1u : 0u) << d;
                }
                any = live != 0;
            } else if (act) {
                any = false;
                for (int d = 0; d < p.d; ++d) any |= act[d] != 0;
            }
            if (any) {
                cy = cand_y[w];
                cx = cand_x[w];
                const int col = col0 + (p.k == 1 ? it : it / p.k);
                const int c0 = col - col % p.tile;
                const int i0m = (rb + min(c0, last)) * p.k;
                const int imm = (rb + min(c0 + p.tile / 2, last)) * p.k;
                const int i1m = (rb + min(c0 + p.tile - 1, last)) * p.k;
                const int ay = tile_base((cand_y[i0m] + p.min_dy) >> p.logp,
                                         (cand_y[imm] + p.min_dy) >> p.logp,
                                         (cand_y[i1m] + p.min_dy) >> p.logp,
                                         p.center_y, p.hp - p.wy_total, ~7);
                const int ax = tile_base((cand_x[i0m] + p.min_dx) >> p.logp,
                                         (cand_x[imm] + p.min_dx) >> p.logp,
                                         (cand_x[i1m] + p.min_dx) >> p.logp,
                                         p.center_x, p.wp - p.wx_total, ~127);
                const int rel_y = ((cy + p.min_dy) >> p.logp) - ay;
                const int rel_x = ((cx + p.min_dx) >> p.logp) - ax;
                ok = rel_y >= 0 && rel_y + p.wy <= p.wy_total && rel_x >= 0
                     && (rel_x & ~127) + p.cxs <= p.wx_total;
            }
            if (!ok) fill_invalid(out + (size_t)w * p.d, p.d, 0, 1);
        }
        // the live, valid items, one to each group of G lanes in turn
        unsigned todo = __ballot_sync(FULL, ok);
        while (todo) {
            unsigned m = todo;                 // the group's item: set bit grp
            for (int r = 0; r < grp; ++r) m &= m - 1u;
            const int sl = m ? __ffs(m) - 1 : 0;
            const bool have = m != 0;
            const int iw = __shfl_sync(FULL, w, sl);
            const unsigned ilive = __shfl_sync(FULL, live, sl);
            const int icy = __shfl_sync(FULL, cy, sl);
            const int icx = __shfl_sync(FULL, cx, sl);
            for (int r = 0; r < n_grp; ++r) todo &= todo - 1u;
            if (!have) continue;
            const int jb = p.k == 1 ? iw : iw / p.k;
            int* o = out + (size_t)iw * p.d;
            const uint8_t* act = active ? active + (size_t)iw * p.d : nullptr;
            const uint16_t* s = src + (size_t)jb * p.bs_y * p.bs_x;
            // the lane's chunks: source words, plane byte offset, and the
            // lane's part of sum S
            constexpr int NC = CH > 0 ? CH : 1;
            uint32_t sw[NC][CW];
            int roff[NC];
            unsigned ssum = 0;
            if (CH > 0) {
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const int ci = g + i * p.g;
                    const int r = ci >> p.lcpr, cc = ci & cmask;
                    load_words<CW>(s + r * p.bs_x + cc * (2 * CW), sw[i]);
#pragma unroll
                    for (int j = 0; j < CW; ++j)
                        ssum = __dp2a_lo(sw[i][j], 0x0101u, ssum);
                    roff[i] = 2 * (r * p.wp + cc * (2 * CW));
                }
            } else {
                for (int ci = g; ci < p.nc; ci += 32) {
                    const int r = ci >> p.lcpr, cc = ci & cmask;
                    uint32_t v[CW];
                    load_words<CW>(s + r * p.bs_x + cc * (2 * CW), v);
#pragma unroll
                    for (int j = 0; j < CW; ++j)
                        ssum = __dp2a_lo(v[j], 0x0101u, ssum);
                }
            }
            // the offsets one at a time (two a pass timed no faster, PERF.md)
            for (int d = 0; d < p.d; ++d) {
                if (!(few ? ((ilive >> d) & 1u) != 0 : (!act || act[d]))) {
                    if (g == 0) o[d] = INT_MAX;
                    continue;
                }
                const int px = icx + offs[2 * d];
                const int py = icy + offs[2 * d + 1];
                const int sub = (px & pelm) | ((py & pelm) << p.logp);
                const uintptr_t r0 = stack_j
                    + 2 * (uintptr_t)(sub * plane + (py >> p.logp) * p.wp
                                      + (px >> p.logp));
                unsigned acc_r = 0, acc_m = 0;
                if (CH > 0) {
#pragma unroll
                    for (int i = 0; i < NC; ++i)
                        chunk_sums<CW>(r0 + roff[i], sw[i], acc_r, acc_m);
                } else {
                    for (int ci = g; ci < p.nc; ci += 32) {
                        const int r = ci >> p.lcpr, cc = ci & cmask;
                        uint32_t v[CW];
                        load_words<CW>(s + r * p.bs_x + cc * (2 * CW), v);
                        chunk_sums<CW>(r0 + 2 * (r * p.wp + cc * (2 * CW)),
                                       v, acc_r, acc_m);
                    }
                }
                unsigned t = ssum + acc_r - 2u * acc_m;
                for (int sh = p.g >> 1; sh > 0; sh >>= 1)
                    t += __shfl_xor_sync(gmask, t, sh);
                if (g == (d & (p.g - 1))) o[d] = (int)t;
            }
        }
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

static void launch_probe(int wpl, bool masked, unsigned blocks, int threads,
                         cudaStream_t st, const void* stack,
                         const void* cand_y, const void* cand_x,
                         const void* src, const void* offs,
                         const uint8_t* active, void* out,
                         const ProbeParams& p) {
#define MVT_PROBE(W, M)                                                     \
    probe_kernel<W, M><<<blocks, threads, 0, st>>>(                         \
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,      \
        (const uint8_t*)src, (const int*)offs, active, (int*)out, p)
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

// The (CW, CH) forms of probe16_kernel: those ops/probe.py::
// probe16_launch_geom gives for the block sizes the search admits.
#define MVT_PROBE16_FORMS(X) X(4, 2) X(4, 4) X(4, 1) X(4, 0) X(2, 2) X(1, 2)

static int launch_probe16(int n_jobs, const ProbeParams& q, int cw, int ch,
                          int g, int warps, int span, cudaStream_t st,
                          const void* stack, const void* cand_y,
                          const void* cand_x, const void* src,
                          const void* offs, const uint8_t* active,
                          void* out) {
    Probe16Params p;
    p.n_sub = q.n_sub; p.hp = q.hp; p.wp = q.wp; p.nblk = q.nblk;
    p.row_len = q.row_len; p.k = q.k; p.d = q.d; p.tile = q.tile;
    p.bs_y = q.bs_y; p.bs_x = q.bs_x; p.logp = q.logp; p.min_dy = q.min_dy;
    p.min_dx = q.min_dx; p.wy = q.wy; p.cxs = q.cxs;
    p.wy_total = q.wy_total; p.wx_total = q.wx_total;
    p.center_y = q.center_y; p.center_x = q.center_x;
    p.g = g; p.span = span;
    // whole words a row, rows of whole chunks, a power of two of them; the
    // item's lanes hold its chunks (CH 1, 2, 4) or stride over them (CH 0,
    // G 32)
    const int wpr = q.bs_x / 2;
    if (q.bs_x % 2 || (cw != 1 && cw != 2 && cw != 4) || wpr % cw
        || !pow2(wpr / cw) || !pow2(g) || g > 32
        || (ch != 0 && ch != 1 && ch != 2 && ch != 4)
        || (ch == 0 && g != 32) || warps < 1 || warps > 8 || span < 1
        || (long long)n_jobs * q.nblk * q.k * q.d > INT_MAX
        || q.nblk % q.row_len || q.tile < 1 || n_jobs > 65535)
        return (int)cudaErrorInvalidValue;
    p.lg = 0;
    while ((1 << p.lg) < g) ++p.lg;
    p.lcpr = 0;
    while ((1 << p.lcpr) < wpr / cw) ++p.lcpr;
    p.nc = q.bs_y << p.lcpr;
    if (ch != 0 && g * ch != p.nc) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((q.row_len + span - 1) / span),
                    (unsigned)(q.nblk / q.row_len), (unsigned)n_jobs);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const unsigned threads = 32u * (unsigned)warps;
#define MVT_PROBE16(W, C)                                                   \
    case W * 8 + C:                                                         \
        probe16_kernel<W, C><<<grid, threads, 0, st>>>(                     \
            (const uint16_t*)stack, (const int*)cand_y, (const int*)cand_x, \
            (const uint16_t*)src, (const int*)offs, active, (int*)out, p);  \
        break;
    switch (cw * 8 + ch) {
        MVT_PROBE16_FORMS(MVT_PROBE16)
        default: return (int)cudaErrorInvalidValue;
    }
#undef MVT_PROBE16
    return (int)cudaGetLastError();
}

// Warps of probe16_kernel<cw, ch> that one SM keeps resident in CTAs of
// `warps` warps (its registers decide), or a negative CUDA error: with the
// SM count, the warps a launch should fill (ops/probe.py::probe16_launch_geom).
extern "C" int mvt_probe16_resident_warps(int cw, int ch, int warps) {
    int n = 0;
    cudaError_t e = cudaErrorInvalidValue;
#define MVT_PROBE16(W, C)                                                   \
    case W * 8 + C:                                                         \
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                  \
            &n, probe16_kernel<W, C>, 32 * warps, 0);                       \
        break;
    switch (cw * 8 + ch) {
        MVT_PROBE16_FORMS(MVT_PROBE16)
        default: break;
    }
#undef MVT_PROBE16
    return e == cudaSuccess ? n * warps : -(int)e;
}

// u16: 1 for uint16 stack and source blocks (probe16_kernel, launched with
// the geometry cw, ch, g, n_warps, span of ops/probe.py::
// probe16_launch_geom),
// 0 for uint8 (probe_kernel; the geometry is not read).
extern "C" int mvt_probe_sads_tiled(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        int n_jobs, int n_sub, int hp, int wp, int nblk, int row_len, int k,
        int d, int tile, int bs_y, int bs_x, int logp, int min_dy, int min_dx,
        int wy, int cxs, int wy_total, int wx_total, int center_y,
        int center_x, int u16, int cw, int ch, int g, int n_warps,
        int span, void* stream) {
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
    cudaStream_t st = (cudaStream_t)stream;
    const uint8_t* a = (const uint8_t*)active;
    if (u16)
        return launch_probe16(n_jobs, p, cw, ch, g, n_warps, span, st,
                              stack, cand_y, cand_x, src, offs, a, out);
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
    launch_probe(wpl, masked, blocks, warps * 32, st, stack, cand_y, cand_x,
                 src, offs, a, out, p);
    return (int)cudaGetLastError();
}

// g, tpl, cpw: the launch geometry of ops/probe.py::probe3_launch_geom
// (lanes an offset, tiles a lane holds, 0 for the generic body, candidates a
// warp).
extern "C" int mvt_probe_sads_tiled_stats3(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        int n_jobs, int n_sub, int hp, int wp, int nblk, int row_len, int k,
        int d, int tile, int bs_y, int bs_x, int logp, int min_dy, int min_dx,
        int wy, int cxs, int wy_total, int wx_total, int center_y,
        int center_x, int g, int tpl, int cpw, void* stream) {
    ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x, 4);
    if (p.total == 0 || d == 0) return 0;
    const int n_tiles = (bs_y / 4) * (bs_x / 4);
    // whole 4x4 tiles (8x4 partitions, or one 4x4 block), 32-bit indices,
    // the candidates of a warp sharing its offset slots
    if (bs_y % 4 || bs_x % 4 || (bs_x % 8 && n_tiles != 1)
        || !pow2(g) || g > 32 || (tpl > 0 && g * tpl != n_tiles)
        || (tpl == 0 && g != 32) || !pow2(cpw)
        || (cpw > 1 && cpw * d > 32 / g) || p.total > INT_MAX
        || (long long)n_sub * hp * wp > INT_MAX)
        return (int)cudaErrorInvalidValue;
    p.g = g;
    const int warps = 8;
    const long long n_w = (p.total + cpw - 1) / cpw;
    const unsigned blocks = (unsigned)((n_w + warps - 1) / warps);
    cudaStream_t st = (cudaStream_t)stream;
#define MVT_PROBE3(T)                                                       \
    probe_stats3_kernel<T><<<blocks, warps * 32, 0, st>>>(                  \
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,      \
        (const uint8_t*)src, (const int*)offs, (const uint8_t*)active,      \
        (int*)out, p, cpw)
    switch (tpl) {
        case 0: MVT_PROBE3(0); break;
        case 1: MVT_PROBE3(1); break;
        case 2: MVT_PROBE3(2); break;
        case 4: MVT_PROBE3(4); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef MVT_PROBE3
    return (int)cudaGetLastError();
}
