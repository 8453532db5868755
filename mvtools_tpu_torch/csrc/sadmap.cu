// Dense SAD map (K1) and its three-stat form (K1').
//
// Replaces the TPU kernel mvtools_tpu/ops/sadmap.py::_sadmap_kernel
// (sad_map_pallas): sadmap_kernel its stats="sad" form, sadmap3_kernel
// its stats="sad_satd_luma" form.
//
// For every block of a tile of consecutive blocks in one block row, the SAD
// of the source block against the reference at every pel offset (dx, dy) of
// a (2*r_y+1) x (2*r_x+1) grid around the tile's full-pel anchor:
//
//   sub = (dx & (pel-1)) | ((dy & (pel-1)) << logp)
//   ref(y, x) = stack[job, sub, afy + (dy >> logp) + y,
//                              afx + b*pitch + (dx >> logp) + x]
//   out[job, block, dy + r_y, dx + r_x] = sum_{y,x} |src(y, x) - ref(y, x)|
//
// Bound on this card: integer operations.  Each output is bs_y*bs_x
// abs-diff accumulates over a window that is read once from memory; the
// bound counts two operations a pixel at the 67 T/s float32 rate (the
// integer pipe issues half that, the byte-SIMD instructions four pixels
// each).  At the YUV path's level-0 luma shape [12, 32026, 17, 17] it is
// 0.849 ms; the first body of this kernel took 13.082 ms there (H100 80GB
// HBM3, 700 W): a thread owned one (block, offset) pair and spent two byte
// loads from shared memory, a subtract, an abs and an add per pixel.
//
// Design: one CTA per (job, tile) stages the tile's
// [pel^2, wy, ref_pitch] reference window and each block's source rows
// ([nb, bs_y, 4*wpr], word-aligned whatever the block pitch, zero past the
// block width) in shared memory, so device memory sees each byte once.  A
// thread then owns one (block, subplane, full-pel row oy) and NOX full-pel
// columns ox of that grid row (all of them at the usual radii: 9 at r 8,
// pel 2).  For each block row it reads the source row once (wpr words) and
// the reference row segment once (NRW aligned words), builds each shifted
// reference word with one funnel shift (the shift is a template constant:
// the thread's column alignment M picks one of four bodies) and sums four
// pixels per instruction pair:
//
//   acc[ox] = __dp4a(__vabsdiffu4(ref_shifted, src), 0x01010101, acc[ox])
//
// (VABSDIFF4.U8 + IDP.4A.U8.U8).  For a 16-wide block, 9 columns and one
// block row that is 36 VABSDIFF4, 36 IDP.4A, 27 SHF.R.W and 11 LDS for 144
// pixel-offset pairs, about 0.8 instructions each, where the first body
// spent more than 5, and a tenth of its shared-memory reads
// (cuobjdump -sass of sadmap_kernel<4, 9>).  __vsadu4 (VABSDIFF4.U8.ACC,
// the accumulator folded in) saves a quarter of those instructions but
// timed slower on the H100 at the YUV luma, YUV chroma and gray level-0
// map shapes (PERF.md; why is not measured).  The tile's
// [nb, 2r_y+1, 2r_x+1] results are staged in shared memory (a thread's
// entries lie pel apart in dx) and leave as one contiguous, coalesced run.
// The launch geometry (threads, shared-memory layout and size, template
// choice) is computed by ops/sadmap.py::map_launch_geom, where a CPU test
// holds it to the card's limits for every geometry the search admits.
// nvcc -Xptxas -v (sm_90a): 32-59 registers a thread over the 12
// instantiations (sadmap_kernel<uint8_t, 4, 9>: 40), no spills.
//
// uint16 stacks (9- to 16-bit clips) take a kernel of their own,
// sadmap16_kernel (below): with |a - b| = a + b - 2 min(a, b) an entry is
// sum S + sum R - 2 sum min(S, R), so its items spend one min.u16x2 and one
// IDP.2A on a word of two pixels, sum S is made once per block and sum R
// from the window's column sums, and a CTA stages one subplane's window at
// a time (72 KB at the YUV level-0 luma shape: three CTAs an SM).  Its first
// body was this kernel's body on uint16 words (four instructions for two
// pixels, 104 KB of staging a CTA, two CTAs an SM): 3.28 ms at that shape
// (H100 80GB HBM3, 700 W), 3.9x its operations bound.
//
// The three-stat form (K1', sadmap3_kernel) writes, for the same grid, the
// triple (SAD, SATD, sum of the reference block) per entry:
// out[job, block, dy + r_y, dx + r_x, 0..2] (satd.cuh says what the SATD
// is).  Bound: integer operations, 9 a pixel-offset as PERF.md counts them.
// Its first body (the one K4' still uses, satd.cuh::block_stats3)
// gave each (block, offset) pair a group of lanes that loaded both blocks
// byte by byte and transformed S - R afresh: about ten instructions per
// pixel-offset, 10.855 ms at [8, 32026, 15, 15, 3] (H100 80GB HBM3, 700 W).
// This body does each piece of work once: per CTA (job, tile) the
// Hadamard transforms H(S) of the source span's 4x4 tiles, and per
// subplane the box sums of every block-sized reference position (the
// reference sum) and, band by band of four rows, the transforms H(R) of
// every 4x4 reference position; an entry's SATD is then a sum over
// coefficient pairs of the two tables (below), its SAD K1's byte-SIMD sum.
// A thread owns one (block, full-pel grid row, chunk of NOX full-pel
// columns) of the subplane, the four-row bands bring each of its tile rows
// in turn, and it writes its entries at the end.  The launch geometry
// (threads, chunks, shared-memory layout, bands) is computed by
// ops/sadmap.py::map3_launch_geom, where a CPU test walks every geometry
// the search admits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixels.cuh"
#include "satd.cuh"

namespace {

using mvt::PixWord;
using mvt::ZB;
using mvt::col_pass;
using mvt::min_u16x2;
using mvt::row_pass;
using mvt::tile_words;

struct MapParams {
    int n_sub, hp, wp;          // stack [J, n_sub, hp, wp]
    int hs, ws;                 // source planes [J, hs, ws]
    int nbx, nby, ntx;          // block grid, tiles per block row
    int tile, pitch_x, pitch_y; // blocks per tile, block pitches (full pel)
    int bs_y, bs_x;
    int src_y0, src_x0;         // origin of block (0, 0) in the source plane
    int r_y, r_x, logp;
    int min_oy, min_ox;         // most negative full-pel grid offsets
    int wy, wx_max;             // window rows, widest window (full tile)
    int span_max;               // widest source span (full tile)
};

// The plain map's shared-memory layout and work split
// (ops/sadmap.py::map_launch_geom).
struct MapGeom {
    int ref_pitch;              // bytes per staged reference row (4 | it)
    int src_stride;             // bytes per staged source block (4 | it)
    int src_off, out_off;       // byte offsets of the two in shared memory
    int wpr;                    // source words per block row
    int n_rows;                 // (subplane, full-pel row) pairs per block
    int n_chunk;                // column chunks of NOX per grid row
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// First offset d >= -r whose pel parity is q, and the count of offsets of
// that parity in [-r, r].
__device__ __forceinline__ int parity_first(int r, int q, int pelm) {
    return -r + ((q + r) & pelm);
}

__device__ __forceinline__ int parity_count(int r, int d0, int logp) {
    return max(0, ((r - d0) >> logp) + 1);
}

// One item of the plain map: NOX accumulators over the block's rows.  ref
// points at the word holding the item's first reference pixel (pixel M of
// it), src at the block's first staged source word.
template <typename T, int NWS, int NOX, int M>
__device__ __forceinline__ void map_rows(const uint32_t* __restrict__ ref,
                                         int ref_pitch_w,
                                         const uint32_t* __restrict__ src,
                                         int wpr, int bs_y, uint32_t lastmask,
                                         unsigned (&acc)[NOX]) {
    constexpr int PPW = PixWord<T>::PPW;
    constexpr int NRW = (M + NOX - 1 + PPW * NWS - 1) / PPW + 1;
    for (int y = 0; y < bs_y; ++y) {
        const uint32_t* rr = ref + y * ref_pitch_w;
        const uint32_t* ss = src + y * wpr;
        for (int wc = 0; wc < wpr; wc += NWS) {
            uint32_t s[NWS], r[NRW];
#pragma unroll
            for (int k = 0; k < NWS; ++k) s[k] = ss[wc + k];
#pragma unroll
            for (int q = 0; q < NRW; ++q) r[q] = rr[wc + q];
            // a width that is not a multiple of PPW (NWS 1 only): the
            // row's last word keeps its leading pixels
            const uint32_t msk = (NWS == 1 && wc == wpr - 1) ? lastmask
                                                              : 0xffffffffu;
#pragma unroll
            for (int i = 0; i < NOX; ++i) {
#pragma unroll
                for (int k = 0; k < NWS; ++k) {
                    const int o = M + i + PPW * k;
                    const int q = o / PPW, sh = o % PPW;
                    uint32_t v = sh ? __funnelshift_r(
                                          r[q], r[q + 1 < NRW ? q + 1 : q],
                                          PixWord<T>::SH * sh)
                                    : r[q];
                    if (NWS == 1) v &= msk;
                    acc[i] = PixWord<T>::sad(v, s[k], acc[i]);
                }
            }
        }
    }
}

// T: the pixel type (uint8_t; uint16_t stacks take sadmap16_kernel).
template <typename T, int NWS, int NOX>
__global__ void __launch_bounds__(512)
sadmap_kernel(const T* __restrict__ stack, const T* __restrict__ src,
              const int* __restrict__ afy, const int* __restrict__ afx,
              int* __restrict__ out, MapParams p, MapGeom g) {
    constexpr int PPW = PixWord<T>::PPW, SH = PixWord<T>::SH;
    extern __shared__ __align__(16) uint8_t smem16[];
    const int tc = blockIdx.x, row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile;
    const int nb = min(p.tile, p.nbx - b0);
    uint8_t* ref_s = smem16;                       // [n_sub * wy][ref_pitch]
    uint8_t* src_s = smem16 + g.src_off;           // [nb][src_stride]
    int* out_s = (int*)(smem16 + g.out_off);       // [nb][Dy][Dx]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    // ---- stage the tile's reference window, one 32-bit word per lane
    const int t = row * p.ntx + tc;
    const int base_y = afy[job * p.nby * p.ntx + t] + p.min_oy;
    const int base_x = afx[job * p.nby * p.ntx + t] + p.min_ox;
    const size_t plane = (size_t)p.hp * p.wp;
    const T* stack_j = stack + (size_t)job * p.n_sub * plane;
    const int wpitch = g.ref_pitch >> 2;
    for (int rr = warp; rr < p.n_sub * p.wy; rr += nwarps) {
        const int s = rr / p.wy, y = rr - s * p.wy;
        const T* grow = stack_j + s * plane
                        + (size_t)clampi(base_y + y, 0, p.hp - 1) * p.wp;
        uint32_t* srow = (uint32_t*)(ref_s + rr * g.ref_pitch);
        for (int cw = lane; cw < wpitch; cw += 32) {
            const int x = base_x + PPW * cw;
            uint32_t v = 0;
#pragma unroll
            for (int e = 0; e < PPW; ++e)
                v |= (uint32_t)grow[clampi(x + e, 0, p.wp - 1)] << (SH * e);
            srow[cw] = v;
        }
    }
    // ---- stage each block's source rows, word-aligned
    const T* src_j = src + (size_t)job * p.hs * p.ws;
    const int sy0 = p.src_y0 + row * p.pitch_y;
    const int sx0 = p.src_x0 + b0 * p.pitch_x;
    const int n_sw = nb * p.bs_y * g.wpr;
    for (int i = threadIdx.x; i < n_sw; i += blockDim.x) {
        const int by = i / g.wpr, cw = i - by * g.wpr;
        const int b = by / p.bs_y, y = by - b * p.bs_y;
        const T* grow = src_j + (size_t)clampi(sy0 + y, 0, p.hs - 1) * p.ws;
        const int x0 = sx0 + b * p.pitch_x + PPW * cw;
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < PPW; ++e)
            if (PPW * cw + e < p.bs_x)
                v |= (uint32_t)grow[clampi(x0 + e, 0, p.ws - 1)] << (SH * e);
        *(uint32_t*)(src_s + b * g.src_stride + 4 * (y * g.wpr + cw)) = v;
    }
    __syncthreads();

    // ---- items: (block, subplane, full-pel row, column chunk)
    const int pelm = (1 << p.logp) - 1;
    const int dxn = 2 * p.r_x + 1;
    const int dn = (2 * p.r_y + 1) * dxn;
    const int per0 = parity_count(p.r_y, parity_first(p.r_y, 0, pelm), p.logp)
                     << p.logp;                    // rows of dy parity 0
    const uint32_t lastmask = (p.bs_x & (PPW - 1))
                              ? (1u << (SH * (p.bs_x & (PPW - 1)))) - 1u
                              : 0xffffffffu;
    const int n_items = nb * g.n_rows * g.n_chunk;
    for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
        const int b = item % nb;
        const int rest = item / nb;
        const int chunk = rest % g.n_chunk;
        const int rid = rest / g.n_chunk;
        const int py = rid < per0 ? 0 : 1;
        const int k = rid - py * per0;
        const int px = k & pelm;
        const int dy = parity_first(p.r_y, py, pelm) + ((k >> p.logp) << p.logp);
        const int dx0 = parity_first(p.r_x, px, pelm);
        const int ncol = min(NOX, parity_count(p.r_x, dx0, p.logp)
                                  - chunk * NOX);
        if (ncol <= 0) continue;
        const int sub = px | (py << p.logp);
        const int col0 = b * p.pitch_x + (dx0 >> p.logp) + chunk * NOX
                         - p.min_ox;
        const uint32_t* ref = (const uint32_t*)(
            ref_s + (sub * p.wy + (dy >> p.logp) - p.min_oy) * g.ref_pitch)
            + (col0 >> PixWord<T>::LOG_PPW);
        const uint32_t* sw = (const uint32_t*)(src_s + b * g.src_stride);
        unsigned acc[NOX];
#pragma unroll
        for (int i = 0; i < NOX; ++i) acc[i] = 0;
        switch (col0 & 3) {
            case 0: map_rows<T, NWS, NOX, 0>(ref, wpitch, sw, g.wpr, p.bs_y,
                                             lastmask, acc); break;
            case 1: map_rows<T, NWS, NOX, 1>(ref, wpitch, sw, g.wpr, p.bs_y,
                                             lastmask, acc); break;
            case 2: map_rows<T, NWS, NOX, 2>(ref, wpitch, sw, g.wpr, p.bs_y,
                                             lastmask, acc); break;
            default: map_rows<T, NWS, NOX, 3>(ref, wpitch, sw, g.wpr, p.bs_y,
                                              lastmask, acc);
                     break;
        }
        int* o = out_s + b * dn + (dy + p.r_y) * dxn
                 + dx0 + ((chunk * NOX) << p.logp) + p.r_x;
#pragma unroll
        for (int i = 0; i < NOX; ++i)
            if (i < ncol) o[i << p.logp] = (int)acc[i];
    }
    __syncthreads();

    // ---- the tile's results are one contiguous run of the output
    int* out_t = out + ((size_t)job * p.nbx * p.nby + (size_t)row * p.nbx
                        + b0) * dn;
    for (int i = threadIdx.x; i < nb * dn; i += blockDim.x) out_t[i] = out_s[i];
}

// ---------------------------------------------------------------------------
// K1 on uint16 stacks (9- to 16-bit clips): sadmap16_kernel.  With
// |a - b| = a + b - 2 min(a, b), an entry is
//
//   SAD = sum S + sum R - 2 sum min(S, R)
//
// The items sum only the minima: one min.u16x2 and one IDP.2A a word of two
// pixels (map16_rows), where |a - b| per half took max.u16x2, min.u16x2, a
// subtract and an IDP.2A.  sum S is taken once per block after its rows are
// staged.  sum R, the sum of the block-sized reference window at each
// (subplane, full-pel position), comes from the window's block-high column
// sums at every full-pel grid row, made once per subplane as the window is
// staged (below); an item adds bs_x of them for its first column and slides
// along the grid row for the next.  All sums are unsigned 32-bit: a 16x16 block of 16-bit pixels gives
// at most 2 * 16 776 960 for sum S + sum R, a 10-bit 128x128 block
// 2 * 16 760 832.
//
// The CTA walks the subplanes in turn, staging one subplane's window at a
// time, two barriers a subplane: a word column a thread, eight rows' loads
// in flight, the thread then summing its two pixel columns.  At the YUV
// level-0 luma shape a whole tile's CTA holds 72 KB (the window 12.8 KB, the
// source rows 16 KB, the results 35.8 KB, the column sums 9.5 KB), so three
// CTAs share an SM, where the staging of all four subplanes took 104 KB and
// two.  The launch geometry may split a tile over CTAs (n_part, each
// staging the window of its own blocks round the tile's anchor), for more
// CTAs an SM to cover each other's staging and barriers.  A thread owns one
// (full-pel grid row, block, chunk of NOX columns) of the subplane's
// offsets, the grid row fastest, so that a warp's window reads spread over
// the banks (its source reads are broadcasts).

constexpr int MAP16_THREADS = 288;

// The uint16 map's shared-memory layout and work split
// (ops/sadmap.py::map16_launch_geom).
struct Map16Geom {
    int ref_pitch;              // bytes per staged reference row (4 | it)
    int src_stride;             // bytes per staged source block (4 | it)
    int src_off, out_off, col_off, ss_off;  // byte offsets in shared memory
    int wpr;                    // source words per block row
    int n_chunk;                // column chunks of NOX per grid row
    int ny, wx;                 // full-pel grid rows, window columns summed
    int nbc, n_part;            // blocks a CTA, CTAs a tile
};

// Rows row0 .. row0 + n - 1 of one word column of a uint16 plane into shared
// memory (a stride of `dst_pitch` words): the two pixels from column x of
// each row, up to 8 rows' loads in flight together.  Inside the row a word
// is one aligned load, or two joined by a funnel shift (each holds a needed
// pixel, so neither leaves the stack); columns past either edge are clamped
// one by one, rows into the plane.
__device__ __forceinline__ void stage_column(const uint16_t* __restrict__ plane,
                                             int w, int h, int row0, int n,
                                             int x, uint32_t* dst,
                                             int dst_pitch) {
    const bool inside = x >= 0 && x + 1 < w;
    for (int y0 = 0; y0 < n; y0 += 8) {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (y0 + k >= n) break;
            const uint16_t* row = plane
                                  + (size_t)clampi(row0 + y0 + k, 0, h - 1) * w;
            if (inside) {
                const uintptr_t a = (uintptr_t)(row + x);
                v[k] = (a & 2) ? __funnelshift_r(
                                     __ldg((const uint32_t*)(a - 2)),
                                     __ldg((const uint32_t*)(a + 2)), 16)
                               : __ldg((const uint32_t*)a);
            } else {
                v[k] = (uint32_t)row[clampi(x, 0, w - 1)]
                       | ((uint32_t)row[clampi(x + 1, 0, w - 1)] << 16);
            }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (y0 + k < n) dst[(y0 + k) * dst_pitch] = v[k];
    }
}

// One item of the uint16 map: NOX sums of minima over the block's rows.  ref
// points at the word holding the item's first reference pixel (pixel M of
// it), src at the block's first staged source word.  A word at an odd pixel
// offset is the funnel shift of two staged words; each is made once a row
// step and serves every (column, source word) pair that reads it.
template <int NWS, int NOX, int M>
__device__ __forceinline__ void map16_rows(const uint32_t* __restrict__ ref,
                                           int ref_pitch_w,
                                           const uint32_t* __restrict__ src,
                                           int wpr, int bs_y,
                                           unsigned (&acc)[NOX]) {
    constexpr int NRW = ((M + NOX - 1 + 2 * (NWS - 1)) >> 1) + 2;
    for (int y = 0; y < bs_y; ++y) {
        const uint32_t* rr = ref + y * ref_pitch_w;
        const uint32_t* ss = src + y * wpr;
        for (int wc = 0; wc < wpr; wc += NWS) {
            uint32_t s[NWS], r[NRW];
#pragma unroll
            for (int k = 0; k < NWS; ++k) s[k] = ss[wc + k];
#pragma unroll
            for (int q = 0; q < NRW; ++q) r[q] = rr[wc + q];
#pragma unroll
            for (int i = 0; i < NOX; ++i) {
#pragma unroll
                for (int k = 0; k < NWS; ++k) {
                    const int o = M + i + 2 * k;
                    const uint32_t v = (o & 1) ? __funnelshift_r(
                                                     r[o >> 1], r[(o >> 1) + 1],
                                                     16)
                                               : r[o >> 1];
                    acc[i] = __dp2a_lo(mvt::min_u16x2(v, s[k]), 0x0101u,
                                       acc[i]);
                }
            }
        }
    }
}

template <int NWS, int NOX>
__global__ void __launch_bounds__(MAP16_THREADS, 3)
sadmap16_kernel(const uint16_t* __restrict__ stack,
                const uint16_t* __restrict__ src, const int* __restrict__ afy,
                const int* __restrict__ afx, int* __restrict__ out,
                MapParams p, Map16Geom g) {
    extern __shared__ __align__(16) uint8_t smem_u16[];
    // this CTA's blocks: part `part` of tile tc (nbc blocks each)
    const int tc = blockIdx.x / g.n_part, part = blockIdx.x - tc * g.n_part;
    const int row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile + part * g.nbc;
    const int nb = min(min(g.nbc, p.tile - part * g.nbc), p.nbx - b0);
    if (nb <= 0) return;                           // uniform over the CTA
    uint32_t* ref_s = (uint32_t*)smem_u16;                 // [wy][rpw]
    uint32_t* src_s = (uint32_t*)(smem_u16 + g.src_off);   // [nb][sw]
    int* out_s = (int*)(smem_u16 + g.out_off);             // [nb][Dy][Dx]
    unsigned* col_s = (unsigned*)(smem_u16 + g.col_off);   // [ny][wx]
    unsigned* ss_s = (unsigned*)(smem_u16 + g.ss_off);     // [nb]
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
    const int rpw = g.ref_pitch >> 2, sw = g.src_stride >> 2;

    // ---- each block's source rows, word-aligned, a word column a thread;
    // then each block's sum
    const uint16_t* src_j = src + (size_t)job * p.hs * p.ws;
    const int sy0 = p.src_y0 + row * p.pitch_y;
    const int sx0 = p.src_x0 + b0 * p.pitch_x;
    for (int i = tid; i < nb * g.wpr; i += nthr) {
        const int b = i / g.wpr, cw = i - b * g.wpr;
        stage_column(src_j, p.ws, p.hs, sy0, p.bs_y,
                     sx0 + b * p.pitch_x + 2 * cw, src_s + b * sw + cw, g.wpr);
    }
    const int n_bw = p.bs_y * g.wpr;
    __syncthreads();
    for (int b = warp; b < nb; b += nwarps) {
        unsigned acc = 0;
        for (int k = lane; k < n_bw; k += 32)
            acc = __dp2a_lo(src_s[b * sw + k], 0x0101u, acc);
        acc = __reduce_add_sync(0xffffffffu, acc);
        if (lane == 0) ss_s[b] = acc;
    }

    const int pelm = (1 << p.logp) - 1;
    const int dxn = 2 * p.r_x + 1;
    const int dn = (2 * p.r_y + 1) * dxn;
    const int t = row * p.ntx + tc;
    const int base_y = afy[job * p.nby * p.ntx + t] + p.min_oy;
    const int base_x = afx[job * p.nby * p.ntx + t] + p.min_ox
                       + part * g.nbc * p.pitch_x;
    const size_t plane = (size_t)p.hp * p.wp;
    for (int s = 0; s < p.n_sub; ++s) {
        __syncthreads();        // the previous subplane's items are done
        // ---- the subplane's reference window, a word column a thread, and
        // the block-high sums of its two pixel columns at every grid row
        const uint16_t* plane_s = stack + ((size_t)job * p.n_sub + s) * plane;
        for (int cw = tid; cw < rpw; cw += nthr) {
            stage_column(plane_s, p.wp, p.hp, base_y, p.wy, base_x + 2 * cw,
                         ref_s + cw, rpw);
            const int x = 2 * cw;
            if (x >= g.wx) continue;
            unsigned lo = 0, hi = 0;
            for (int y = 0; y < p.bs_y; ++y) {
                const uint32_t w = ref_s[y * rpw + cw];
                lo += w & 0xffffu;
                hi += w >> 16;
            }
            for (int oy = 0; oy < g.ny; ++oy) {
                if (oy > 0) {
                    const uint32_t wi = ref_s[(oy + p.bs_y - 1) * rpw + cw];
                    const uint32_t wo = ref_s[(oy - 1) * rpw + cw];
                    lo += (wi & 0xffffu) - (wo & 0xffffu);
                    hi += (wi >> 16) - (wo >> 16);
                }
                col_s[oy * g.wx + x] = lo;
                if (x + 1 < g.wx) col_s[oy * g.wx + x + 1] = hi;
            }
        }
        __syncthreads();

        // ---- items: (grid row, block, column chunk) of this subplane
        const int px = s & pelm, py = s >> p.logp;
        const int dy0 = parity_first(p.r_y, py, pelm);
        const int dx0 = parity_first(p.r_x, px, pelm);
        const int rows_s = parity_count(p.r_y, dy0, p.logp);
        const int cols_s = parity_count(p.r_x, dx0, p.logp);
        const int n_items = rows_s * nb * g.n_chunk;
        for (int item = tid; item < n_items; item += nthr) {
            const int kr = item % rows_s;
            const int rest = item / rows_s;
            const int b = rest % nb, chunk = rest / nb;
            const int ncol = min(NOX, cols_s - chunk * NOX);
            if (ncol <= 0) continue;
            const int dy = dy0 + (kr << p.logp);
            const int oy = (dy >> p.logp) - p.min_oy;
            const int col0 = b * p.pitch_x + (dx0 >> p.logp) - p.min_ox
                             + chunk * NOX;
            const uint32_t* ref = ref_s + oy * rpw + (col0 >> 1);
            const uint32_t* sp = src_s + b * sw;
            unsigned acc[NOX];
#pragma unroll
            for (int i = 0; i < NOX; ++i) acc[i] = 0;
            if (col0 & 1)
                map16_rows<NWS, NOX, 1>(ref, rpw, sp, g.wpr, p.bs_y, acc);
            else
                map16_rows<NWS, NOX, 0>(ref, rpw, sp, g.wpr, p.bs_y, acc);
            // sum S + sum R - 2 sum min, sum R sliding along the grid row
            const unsigned* cs = col_s + oy * g.wx + col0;
            unsigned box = ss_s[b];
            for (int j = 0; j < p.bs_x; ++j) box += cs[j];
            int* o = out_s + b * dn + (dy + p.r_y) * dxn + dx0
                     + ((chunk * NOX) << p.logp) + p.r_x;
#pragma unroll
            for (int i = 0; i < NOX; ++i) {
                if (i >= ncol) break;
                if (i > 0) box += cs[i - 1 + p.bs_x] - cs[i - 1];
                o[i << p.logp] = (int)(box - 2u * acc[i]);
            }
        }
    }
    __syncthreads();

    // ---- the tile's results are one contiguous run of the output
    int* out_t = out + ((size_t)job * p.nbx * p.nby + (size_t)row * p.nbx
                        + b0) * dn;
    for (int i = tid; i < nb * dn; i += nthr) out_t[i] = out_s[i];
}

// ---------------------------------------------------------------------------
// K1': the three-stat map.  The SATD by linearity of the Hadamard transform,
// H(S - R) = H(S) - H(R): every 4x4 tile of the source span and every 4x4
// position of the reference window is transformed once per CTA, and an
// entry's SATD is a sum over coefficient pairs of those two tables.
//
// Coefficients are stored as unsigned 16-bit halves of 32-bit words, each
// biased by Z (an 8-bit tile's coefficients lie in [-2040, 2040], its DC in
// [0, 4080], so a biased value lies in [Z - 4080, Z + 4080] and no half can
// carry into the other).  With u = H + Z,
//
//   sum |H(S) - H(R)| over a tile = sum u_S + sum u_R - 2 sum min(u_S, u_R)
//
// and sum u over a tile = 16 * (its top-left pixel) + 16 Z (the columns of
// the 4-point Hadamard sum to (4, 0, 0, 0)).  So an 8x4 partition's halved
// sum (satd.cuh: two tiles' sums added, then >> 1; the sum is even) is
//
//   8 (S00 + S04 + R00 + R04) + 32 Z - sum over its 16 words of
//                                      (min.lo + min.hi)
//
// one VIMNMX.U16x2 and one IDP.2A per two coefficients, the source terms a
// per-block constant, the reference terms two IDP.4A per partition row 0.

// Four bytes at byte offset x of a word-aligned shared row.
__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int x) {
    const uint32_t* w = (const uint32_t*)row + (x >> 2);
    const int sh = x & 3;
    return sh ? __funnelshift_r(w[0], w[1], 8 * sh) : w[0];
}

// The three-stat map's shared-memory layout and work split
// (ops/sadmap.py::map3_launch_geom).
struct Map3Geom {
    int nox, n_chunk;           // columns a thread owns, chunks per grid row
    int ref_pitch, span_pitch;  // bytes per staged reference / source row
    int src_off, hs_off, sc_off, hr_off, hr_pitch, box_off;
    int nxs;                    // 4x4 source tiles per span row
    int npos;                   // 4x4 reference positions per window row
    int nbox;                   // block-sized positions per window row
    int ny, nyp, n_band;        // full-pel grid rows, 4x4 row starts, bands
};

// One item's work on tile row i of its block: the SAD of the four pixel
// rows and, per 8x4 partition, the SATD terms of the reference side.  ref
// points at the item's first reference row (row oy + 4i of the subplane's
// window) at the word holding byte col0 (which is byte M of it); src at the
// block's row 4i of the span; hs at the block's first tile of tile row i;
// hr at the band row t of the item.
template <int NOX, int M>
__device__ __forceinline__ void item_tile_row(
        const uint8_t* __restrict__ ref, int ref_pitch,
        const uint8_t* __restrict__ src, int span_pitch,
        const uint4* __restrict__ hs, const uint8_t* __restrict__ hr,
        int col0, int xmax, int parts, unsigned (&sad)[NOX],
        int (&sat)[NOX]) {
    constexpr int NRW = (M + NOX - 1 + 7) / 4 + 1;
    for (int pj = 0; pj < parts; ++pj) {
#pragma unroll
        for (int yy = 0; yy < 4; ++yy) {
            const uint32_t* rr = (const uint32_t*)(ref + yy * ref_pitch) + 2 * pj;
            const uint32_t* ss = (const uint32_t*)(src + yy * span_pitch) + 2 * pj;
            const uint32_t s0 = ss[0], s1 = ss[1];
            uint32_t r[NRW + 1];
#pragma unroll
            for (int q = 0; q < NRW; ++q) r[q] = rr[q];
            r[NRW] = r[NRW - 1];
#pragma unroll
            for (int c = 0; c < NOX; ++c) {
                const int q = (M + c) >> 2, sh = (M + c) & 3;
                const uint32_t v0 = sh ? __funnelshift_r(r[q], r[q + 1], 8 * sh)
                                       : r[q];
                const uint32_t v1 = sh ? __funnelshift_r(r[q + 1], r[q + 2],
                                                         8 * sh)
                                       : r[q + 1];
                sad[c] = __dp4a(__vabsdiffu4(v0, s0), 0x01010101u, sad[c]);
                sad[c] = __dp4a(__vabsdiffu4(v1, s1), 0x01010101u, sad[c]);
                if (yy == 0) {              // + 8 (R00 + R04)
                    sat[c] = (int)__dp4a(v0, 8u, (unsigned)sat[c]);
                    sat[c] = (int)__dp4a(v1, 8u, (unsigned)sat[c]);
                }
            }
        }
        uint4 h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) h[k] = hs[4 * pj + k];
#pragma unroll
        for (int c = 0; c < NOX; ++c) {
            const int x = min(col0 + c + 8 * pj, xmax);
            const uint4* g = (const uint4*)(hr + 32 * x);
            const uint4 g0 = g[0], g1 = g[1], g2 = g[8], g3 = g[9];
            int acc = sat[c];
            // - sum (min.lo + min.hi): halves are below 2^15, so the signed
            // two-way product with bytes (-1, -1) subtracts both
            acc = __dp2a_lo((int)min_u16x2(h[0].x, g0.x), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[0].y, g0.y), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[0].z, g0.z), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[0].w, g0.w), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[1].x, g1.x), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[1].y, g1.y), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[1].z, g1.z), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[1].w, g1.w), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[2].x, g2.x), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[2].y, g2.y), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[2].z, g2.z), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[2].w, g2.w), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[3].x, g3.x), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[3].y, g3.y), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[3].z, g3.z), 0xffff, acc);
            acc = __dp2a_lo((int)min_u16x2(h[3].w, g3.w), 0xffff, acc);
            sat[c] = acc;
        }
    }
}

// At most 288 threads a CTA (a pass of items, or one column strip of the
// window each in the box sums' and the bands' phases) and three CTAs an SM:
// ptxas then keeps the body in 72 registers, and one CTA's barriers overlap
// the others' work (other bounds: experiments/k1p_timing.py).
constexpr int MAP3_THREADS = 288;

template <int NOX>
__global__ void __launch_bounds__(MAP3_THREADS, 3)
sadmap3_kernel(const uint8_t* __restrict__ stack,
               const uint8_t* __restrict__ src, const int* __restrict__ afy,
               const int* __restrict__ afx, int* __restrict__ out,
               MapParams p, Map3Geom g) {
    extern __shared__ __align__(16) uint8_t smem3[];
    const int tc = blockIdx.x, row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile;
    const int nb = min(p.tile, p.nbx - b0);
    uint8_t* ref_s = smem3;                          // [wy][ref_pitch]
    uint8_t* src_s = smem3 + g.src_off;              // [bs_y][span_pitch]
    uint4* hs_s = (uint4*)(smem3 + g.hs_off);        // [bs_y/4][nxs][2]
    int* sc_s = (int*)(smem3 + g.sc_off);            // [tile]
    uint8_t* hr_s = smem3 + g.hr_off;                // [BAND][hr_pitch]
    int* cs_s = (int*)(smem3 + g.hr_off);            // [ny][wx] (first)
    int* box_s = (int*)(smem3 + g.box_off);          // [ny][nbox]
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int wy = p.wy, wx = p.wx_max;

    // ---- the tile's source span, word rows
    const uint8_t* src_j = src + (size_t)job * p.hs * p.ws;
    const int sy0 = p.src_y0 + row * p.pitch_y;
    const int sx0 = p.src_x0 + b0 * p.pitch_x;
    const int spw = g.span_pitch >> 2;
    for (int i = tid; i < p.bs_y * spw; i += nthr) {
        const int y = i / spw, cw = i - y * spw;
        const uint8_t* grow = src_j
                              + (size_t)clampi(sy0 + y, 0, p.hs - 1) * p.ws;
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v |= (uint32_t)grow[clampi(sx0 + 4 * cw + e, 0, p.ws - 1)]
                 << (8 * e);
        ((uint32_t*)src_s)[i] = v;
    }
    __syncthreads();
    // ---- H(S) of every 4x4 tile of the span; each block's source constant
    const int tys = p.bs_y >> 2;
    for (int i = tid; i < tys * g.nxs; i += nthr) {
        const int ty = i / g.nxs, tx = i - ty * g.nxs;
        uint32_t w[4];
#pragma unroll
        for (int y = 0; y < 4; ++y)
            w[y] = ((const uint32_t*)(src_s + (4 * ty + y) * g.span_pitch))[tx];
        tile_words(w, hs_s + 2 * i);
    }
    const int parts = p.bs_x >> 3;
    for (int b = tid; b < nb; b += nthr) {
        int acc = 0;
        for (int ty = 0; ty < tys; ++ty)
            for (int pj = 0; pj < parts; ++pj) {
                const uint8_t* s = src_s + 4 * ty * g.span_pitch
                                   + b * p.pitch_x + 8 * pj;
                acc += 8 * ((int)s[0] + (int)s[4]) + 32 * (int)ZB;
            }
        sc_s[b] = acc;
    }

    const int pelm = (1 << p.logp) - 1;
    const int dxn = 2 * p.r_x + 1;
    const int dn = (2 * p.r_y + 1) * dxn;
    const size_t plane = (size_t)p.hp * p.wp;
    const int t_idx = row * p.ntx + tc;
    const int base_y = afy[job * p.nby * p.ntx + t_idx] + p.min_oy;
    const int base_x = afx[job * p.nby * p.ntx + t_idx] + p.min_ox;
    int* out_t = out + ((size_t)job * p.nbx * p.nby + (size_t)row * p.nbx
                        + b0) * dn * 3;
    const int rpw = g.ref_pitch >> 2;
    // items of the largest subplane, so every thread runs every pass
    const int n_pass_items = nb * ((2 * p.r_y + 1 + pelm) >> p.logp)
                             * g.n_chunk;
    for (int s = 0; s < p.n_sub; ++s) {
        __syncthreads();        // the previous subplane's items are done
        // ---- the subplane's reference window, one word per thread a step
        const uint8_t* plane_s = stack + ((size_t)job * p.n_sub + s) * plane;
        for (int i = tid; i < wy * rpw; i += nthr) {
            const int y = i / rpw, cw = i - y * rpw;
            const uint8_t* grow = plane_s
                + (size_t)clampi(base_y + y, 0, p.hp - 1) * p.wp;
            uint32_t v = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v |= (uint32_t)grow[clampi(base_x + 4 * cw + e, 0, p.wp - 1)]
                     << (8 * e);
            ((uint32_t*)ref_s)[i] = v;
        }
        __syncthreads();
        // ---- box sums of every block-sized position: column sums, then rows
        for (int x = tid; x < wx; x += nthr) {
            int acc = 0;
            for (int y = 0; y < p.bs_y; ++y) acc += ref_s[y * g.ref_pitch + x];
            cs_s[x] = acc;
            for (int oy = 1; oy < g.ny; ++oy) {
                acc += ref_s[(oy + p.bs_y - 1) * g.ref_pitch + x]
                       - ref_s[(oy - 1) * g.ref_pitch + x];
                cs_s[oy * wx + x] = acc;
            }
        }
        __syncthreads();
        for (int i = tid; i < g.ny * g.nbox; i += nthr) {
            const int oy = i / g.nbox, x = i - oy * g.nbox;
            const int* c = cs_s + oy * wx + x;
            int acc = 0;
            for (int j = 0; j < p.bs_x; ++j) acc += c[j];
            box_s[i] = acc;
        }

        const int px = s & pelm, py = s >> p.logp;
        const int dy0 = parity_first(p.r_y, py, pelm);
        const int dx0 = parity_first(p.r_x, px, pelm);
        const int rows_s = parity_count(p.r_y, dy0, p.logp);
        const int cols_s = parity_count(p.r_x, dx0, p.logp);
        const int n_items = nb * rows_s * g.n_chunk;
        for (int first = 0; first < n_pass_items; first += nthr) {
            const int item = first + tid;
            const bool active = item < n_items;
            const int kr = active ? item % rows_s : 0;
            const int rest = active ? item / rows_s : 0;
            const int chunk = rest % g.n_chunk, b = rest / g.n_chunk;
            const int dy = dy0 + (kr << p.logp);
            const int oy = (dy >> p.logp) - p.min_oy;
            const int ncol = min(NOX, cols_s - chunk * NOX);
            const int col0 = b * p.pitch_x + (dx0 >> p.logp) - p.min_ox
                             + chunk * NOX;
            unsigned sad[NOX];
            int sat[NOX];
#pragma unroll
            for (int c = 0; c < NOX; ++c) { sad[c] = 0; sat[c] = 0; }
            for (int band = 0; band < g.n_band; ++band) {
                __syncthreads();    // the box sums or the last band are read
                // ---- H(R) of the band's 4x4 positions, a column strip each
                const int y0 = band * 4;
                const int nt = min(4, g.nyp - y0);
                for (int x = tid; x < g.npos; x += nthr) {
                    uint32_t a[7], bb[7];
#pragma unroll
                    for (int y = 0; y < 7; ++y)
                        if (y < nt + 3)
                            row_pass(word_at(ref_s + (y0 + y) * g.ref_pitch, x),
                                     a[y], bb[y]);
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        if (t < nt) {
                            uint32_t a0 = a[t], a1 = a[t + 1], a2 = a[t + 2],
                                     a3 = a[t + 3];
                            uint32_t c0 = bb[t], c1 = bb[t + 1],
                                     c2 = bb[t + 2], c3 = bb[t + 3];
                            col_pass(a0, a1, a2, a3);
                            col_pass(c0, c1, c2, c3);
                            uint4* d = (uint4*)(hr_s + t * g.hr_pitch + 32 * x);
                            d[0] = make_uint4(a0, a1, a2, a3);
                            d[1] = make_uint4(c0, c1, c2, c3);
                        }
                    }
                }
                __syncthreads();
                // ---- the item's tile row in this band, if it has one
                const int i = (y0 - oy + 3) >> 2;
                if (!active || i < 0 || i >= tys || oy + 4 * i >= y0 + 4)
                    continue;
                const int t = oy + 4 * i - y0;
                const uint8_t* rp = ref_s + (oy + 4 * i) * g.ref_pitch
                                    + 4 * (col0 >> 2);
                const uint8_t* sp = src_s + 4 * i * g.span_pitch
                                    + b * p.pitch_x;
                const uint4* hp = hs_s + 2 * (i * g.nxs + ((b * p.pitch_x) >> 2));
                const uint8_t* hrp = hr_s + t * g.hr_pitch;
                const int xmax = g.npos - 5;
                switch (col0 & 3) {
                    case 0: item_tile_row<NOX, 0>(rp, g.ref_pitch, sp,
                                g.span_pitch, hp, hrp, col0, xmax, parts,
                                sad, sat); break;
                    case 1: item_tile_row<NOX, 1>(rp, g.ref_pitch, sp,
                                g.span_pitch, hp, hrp, col0, xmax, parts,
                                sad, sat); break;
                    case 2: item_tile_row<NOX, 2>(rp, g.ref_pitch, sp,
                                g.span_pitch, hp, hrp, col0, xmax, parts,
                                sad, sat); break;
                    default: item_tile_row<NOX, 3>(rp, g.ref_pitch, sp,
                                 g.span_pitch, hp, hrp, col0, xmax, parts,
                                 sad, sat); break;
                }
            }
            if (active) {
                const int* bx = box_s + oy * g.nbox + col0;
                int* o = out_t + ((size_t)b * dn + (dy + p.r_y) * dxn + dx0
                                  + ((chunk * NOX) << p.logp) + p.r_x) * 3;
#pragma unroll
                for (int c = 0; c < NOX; ++c)
                    if (c < ncol) {
                        o[3 * (c << p.logp)] = (int)sad[c];
                        o[3 * (c << p.logp) + 1] = sat[c] + sc_s[b];
                        o[3 * (c << p.logp) + 2] = bx[c];
                    }
            }
        }
    }
}

}  // namespace

static MapParams map_params(int n_sub, int hp, int wp, int hs, int ws,
                            int nbx, int nby, int tile, int pitch_x,
                            int pitch_y, int bs_y, int bs_x, int src_y0,
                            int src_x0, int r_y, int r_x, int logp) {
    MapParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.hs = hs; p.ws = ws;
    p.nbx = nbx; p.nby = nby; p.ntx = (nbx + tile - 1) / tile;
    p.tile = tile; p.pitch_x = pitch_x; p.pitch_y = pitch_y;
    p.bs_y = bs_y; p.bs_x = bs_x; p.src_y0 = src_y0; p.src_x0 = src_x0;
    p.r_y = r_y; p.r_x = r_x; p.logp = logp;
    p.min_oy = (-r_y) >> logp;
    p.min_ox = (-r_x) >> logp;
    const int max_oy = r_y >> logp, max_ox = r_x >> logp;
    p.span_max = (tile - 1) * pitch_x + bs_x;
    p.wy = bs_y + max_oy - p.min_oy;
    p.wx_max = p.span_max + max_ox - p.min_ox;
    return p;
}

template <typename T, int NWS, int NOX>
static int launch_map(dim3 grid, int threads, int smem, cudaStream_t st,
                      const void* stack, const void* src, const void* afy,
                      const void* afx, void* out, const MapParams& p,
                      const MapGeom& g) {
    cudaError_t err = cudaFuncSetAttribute(
        sadmap_kernel<T, NWS, NOX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sadmap_kernel<T, NWS, NOX><<<grid, threads, smem, st>>>(
        (const T*)stack, (const T*)src, (const int*)afy, (const int*)afx,
        (int*)out, p, g);
    return (int)cudaGetLastError();
}

template <typename T, int NWS>
static int launch_map_nox(int nox, dim3 grid, int threads, int smem,
                          cudaStream_t st, const void* stack, const void* src,
                          const void* afy, const void* afx, void* out,
                          const MapParams& p, const MapGeom& g) {
    switch (nox) {
        case 6: return launch_map<T, NWS, 6>(grid, threads, smem, st, stack,
                                             src, afy, afx, out, p, g);
        case 9: return launch_map<T, NWS, 9>(grid, threads, smem, st, stack,
                                             src, afy, afx, out, p, g);
        case 16: return launch_map<T, NWS, 16>(grid, threads, smem, st,
                                               stack, src, afy, afx, out, p,
                                               g);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_map_nws(int nws, int nox, dim3 grid, int threads, int smem,
                          cudaStream_t st, const void* stack, const void* src,
                          const void* afy, const void* afx, void* out,
                          const MapParams& p, const MapGeom& g) {
    switch (nws) {
        case 1: return launch_map_nox<T, 1>(nox, grid, threads, smem, st,
                                            stack, src, afy, afx, out, p, g);
        case 2: return launch_map_nox<T, 2>(nox, grid, threads, smem, st,
                                            stack, src, afy, afx, out, p, g);
        case 4: return launch_map_nox<T, 4>(nox, grid, threads, smem, st,
                                            stack, src, afy, afx, out, p, g);
        case 8: return launch_map_nox<T, 8>(nox, grid, threads, smem, st,
                                            stack, src, afy, afx, out, p, g);
        default: return (int)cudaErrorInvalidValue;
    }
}

// threads .. n_rows: the launch geometry of ops/sadmap.py::map_launch_geom
// (uint8 stack and source planes).
extern "C" int mvt_sad_map(const void* stack, const void* src,
                           const void* afy, const void* afx, void* out,
                           int n_jobs, int n_sub, int hp, int wp, int hs,
                           int ws, int nbx, int nby, int tile, int pitch_x,
                           int pitch_y, int bs_y, int bs_x, int src_y0,
                           int src_x0, int r_y, int r_x, int logp,
                           int threads, int smem, int ref_pitch,
                           int src_stride, int src_off, int out_off, int nws,
                           int nox, int n_chunk, int n_rows, void* stream) {
    const MapParams p = map_params(n_sub, hp, wp, hs, ws, nbx, nby, tile,
                                   pitch_x, pitch_y, bs_y, bs_x, src_y0,
                                   src_x0, r_y, r_x, logp);
    MapGeom g;
    g.ref_pitch = ref_pitch; g.src_stride = src_stride; g.src_off = src_off;
    g.out_off = out_off; g.wpr = (bs_x + 3) / 4; g.n_rows = n_rows;
    g.n_chunk = n_chunk;
    if (ref_pitch % 4 || src_stride % 4 || src_off % 4 || out_off % 4
        || g.wpr % nws)
        return (int)cudaErrorInvalidValue;
    dim3 grid(p.ntx, nby, n_jobs);
    return launch_map_nws<uint8_t>(nws, nox, grid, threads, smem,
                                   (cudaStream_t)stream, stack, src, afy, afx,
                                   out, p, g);
}

template <int NWS, int NOX>
static int launch_map16(dim3 grid, int threads, int smem, cudaStream_t st,
                        const void* stack, const void* src, const void* afy,
                        const void* afx, void* out, const MapParams& p,
                        const Map16Geom& g) {
    cudaError_t err = cudaFuncSetAttribute(
        sadmap16_kernel<NWS, NOX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            sadmap16_kernel<NWS, NOX>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sadmap16_kernel<NWS, NOX><<<grid, threads, smem, st>>>(
        (const uint16_t*)stack, (const uint16_t*)src, (const int*)afy,
        (const int*)afx, (int*)out, p, g);
    return (int)cudaGetLastError();
}

// threads .. wx: the launch geometry of ops/sadmap.py::map16_launch_geom
// (uint16 stack and source planes).
extern "C" int mvt_sad_map_u16(const void* stack, const void* src,
                               const void* afy, const void* afx, void* out,
                               int n_jobs, int n_sub, int hp, int wp, int hs,
                               int ws, int nbx, int nby, int tile,
                               int pitch_x, int pitch_y, int bs_y, int bs_x,
                               int src_y0, int src_x0, int r_y, int r_x,
                               int logp, int threads, int smem,
                               int ref_pitch, int src_stride, int src_off,
                               int out_off, int col_off, int ss_off, int nws,
                               int nox, int n_chunk, int ny, int wx,
                               int nbc, int n_part, void* stream) {
    const MapParams p = map_params(n_sub, hp, wp, hs, ws, nbx, nby, tile,
                                   pitch_x, pitch_y, bs_y, bs_x, src_y0,
                                   src_x0, r_y, r_x, logp);
    Map16Geom g;
    g.ref_pitch = ref_pitch; g.src_stride = src_stride; g.src_off = src_off;
    g.out_off = out_off; g.col_off = col_off; g.ss_off = ss_off;
    g.wpr = bs_x / 2; g.n_chunk = n_chunk; g.ny = ny; g.wx = wx;
    g.nbc = nbc; g.n_part = n_part;
    if (ref_pitch % 4 || src_stride % 4 || src_off % 4 || out_off % 4
        || col_off % 4 || ss_off % 4 || bs_x % 2 || g.wpr % nws
        || threads % 32 || threads > MAP16_THREADS || nbc < 1
        || nbc * n_part < tile)
        return (int)cudaErrorInvalidValue;
    dim3 grid(p.ntx * n_part, nby, n_jobs);
    cudaStream_t st = (cudaStream_t)stream;
    switch (nws * 100 + nox) {
#define MVT_MAP16(W, N)                                                      \
        case W * 100 + N:                                                    \
            return launch_map16<W, N>(grid, threads, smem, st, stack, src,   \
                                      afy, afx, out, p, g);
        MVT_MAP16(1, 6) MVT_MAP16(1, 9) MVT_MAP16(1, 16)
        MVT_MAP16(2, 6) MVT_MAP16(2, 9) MVT_MAP16(2, 16)
        MVT_MAP16(4, 6) MVT_MAP16(4, 9) MVT_MAP16(4, 16)
        MVT_MAP16(8, 6) MVT_MAP16(8, 9) MVT_MAP16(8, 16)
#undef MVT_MAP16
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int mvt_sad_map_stats3(const void* stack, const void* src,
                                  const void* afy, const void* afx, void* out,
                                  int n_jobs, int n_sub, int hp, int wp,
                                  int hs, int ws, int nbx, int nby, int tile,
                                  int pitch_x, int pitch_y, int bs_y,
                                  int bs_x, int src_y0, int src_x0, int r_y,
                                  int r_x, int logp, int threads, int smem,
                                  int nox, int n_chunk, int ref_pitch,
                                  int span_pitch, int src_off, int hs_off,
                                  int sc_off, int hr_off, int hr_pitch,
                                  int box_off, int nxs, int npos, int nbox,
                                  int ny, int nyp, int n_band, void* stream) {
    const MapParams p = map_params(n_sub, hp, wp, hs, ws, nbx, nby, tile,
                                   pitch_x, pitch_y, bs_y, bs_x, src_y0,
                                   src_x0, r_y, r_x, logp);
    Map3Geom g;
    g.nox = nox; g.n_chunk = n_chunk; g.ref_pitch = ref_pitch;
    g.span_pitch = span_pitch; g.src_off = src_off; g.hs_off = hs_off;
    g.sc_off = sc_off; g.hr_off = hr_off; g.hr_pitch = hr_pitch;
    g.box_off = box_off; g.nxs = nxs; g.npos = npos; g.nbox = nbox;
    g.ny = ny; g.nyp = nyp; g.n_band = n_band;
    if (ref_pitch % 4 || span_pitch % 4 || src_off % 16 || hs_off % 16
        || hr_off % 16 || hr_pitch % 16 || box_off % 4 || pitch_x % 8
        || bs_x % 8 || bs_y % 4 || threads % 32 || threads > MAP3_THREADS)
        return (int)cudaErrorInvalidValue;
    dim3 grid(p.ntx, nby, n_jobs);
    cudaStream_t st = (cudaStream_t)stream;
    switch (nox) {
#define MVT_MAP3(N)                                                          \
        case N: {                                                            \
            cudaError_t err = cudaFuncSetAttribute(                          \
                sadmap3_kernel<N>,                                           \
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
            if (err != cudaSuccess) return (int)err;                         \
            sadmap3_kernel<N><<<grid, threads, smem, st>>>(                  \
                (const uint8_t*)stack, (const uint8_t*)src, (const int*)afy, \
                (const int*)afx, (int*)out, p, g);                           \
            return (int)cudaGetLastError();                                  \
        }
        MVT_MAP3(4) MVT_MAP3(5) MVT_MAP3(6) MVT_MAP3(7) MVT_MAP3(8)
#undef MVT_MAP3
        default: return (int)cudaErrorInvalidValue;
    }
}
