// Dense SAD map (K1) and its three-stat form (K1').
//
// Replaces the TPU kernel mvtools_tpu/ops/sadmap.py::_sadmap_kernel
// (sad_map_pallas): sadmap_kernel its stats="sad" form, sadmap_stats3_kernel
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
// nvcc -Xptxas -v (sm_90a): 32-59 registers a thread over the twelve
// instantiations (sadmap_kernel<4, 9>: 40), no spills.
//
// The three-stat form writes, for the same grid, the triple (SAD, SATD, sum
// of the reference block) per entry: out[job, block, dy + r_y, dx + r_x, 0..2]
// (satd.cuh says what the SATD is).  Its CTA stages the window with a row
// width of wx_max and the tile's source span as one [bs_y, span_max] array;
// a group of lanes owns a (block, offset) pair and splits the block's 8x4
// partitions.  Bound: integer operations, about 2.5 times the plain map's
// per pixel (the two butterflies and the three accumulations).

#include <cuda_runtime.h>
#include <stdint.h>

#include "satd.cuh"

namespace {

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
// points at the word holding the item's first reference byte (at byte M of
// it), src at the block's first staged source word.
template <int NWS, int NOX, int M>
__device__ __forceinline__ void map_rows(const uint32_t* __restrict__ ref,
                                         int ref_pitch_w,
                                         const uint32_t* __restrict__ src,
                                         int wpr, int bs_y, uint32_t lastmask,
                                         unsigned (&acc)[NOX]) {
    constexpr int NRW = (M + NOX - 1 + 4 * NWS - 1) / 4 + 1;
    for (int y = 0; y < bs_y; ++y) {
        const uint32_t* rr = ref + y * ref_pitch_w;
        const uint32_t* ss = src + y * wpr;
        for (int wc = 0; wc < wpr; wc += NWS) {
            uint32_t s[NWS], r[NRW];
#pragma unroll
            for (int k = 0; k < NWS; ++k) s[k] = ss[wc + k];
#pragma unroll
            for (int q = 0; q < NRW; ++q) r[q] = rr[wc + q];
            // a width that is not a multiple of 4 (NWS 1 only): the row's
            // last word keeps its leading bytes
            const uint32_t msk = (NWS == 1 && wc == wpr - 1) ? lastmask
                                                              : 0xffffffffu;
#pragma unroll
            for (int i = 0; i < NOX; ++i) {
#pragma unroll
                for (int k = 0; k < NWS; ++k) {
                    const int o = M + i + 4 * k;
                    const int q = o >> 2, sh = o & 3;
                    uint32_t v = sh ? __funnelshift_r(
                                          r[q], r[q + 1 < NRW ? q + 1 : q],
                                          8 * sh)
                                    : r[q];
                    if (NWS == 1) v &= msk;
                    acc[i] = __dp4a(__vabsdiffu4(v, s[k]), 0x01010101u,
                                    acc[i]);
                }
            }
        }
    }
}

template <int NWS, int NOX>
__global__ void __launch_bounds__(512)
sadmap_kernel(const uint8_t* __restrict__ stack,
              const uint8_t* __restrict__ src, const int* __restrict__ afy,
              const int* __restrict__ afx, int* __restrict__ out, MapParams p,
              MapGeom g) {
    extern __shared__ __align__(16) uint8_t smem16[];
    const int tc = blockIdx.x, row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile;
    const int nb = min(p.tile, p.nbx - b0);
    uint8_t* ref_s = smem16;                       // [n_sub * wy][ref_pitch]
    uint8_t* src_s = smem16 + g.src_off;           // [nb][src_stride]
    int* out_s = (int*)(smem16 + g.out_off);       // [nb][Dy][Dx]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;

    // ---- stage the reference window, one 32-bit word per lane
    const int t = row * p.ntx + tc;
    const int base_y = afy[job * p.nby * p.ntx + t] + p.min_oy;
    const int base_x = afx[job * p.nby * p.ntx + t] + p.min_ox;
    const size_t plane = (size_t)p.hp * p.wp;
    const uint8_t* stack_j = stack + (size_t)job * p.n_sub * plane;
    const int wpitch = g.ref_pitch >> 2;
    for (int rr = warp; rr < p.n_sub * p.wy; rr += nwarps) {
        const int s = rr / p.wy, y = rr - s * p.wy;
        const uint8_t* grow = stack_j + s * plane
                              + (size_t)clampi(base_y + y, 0, p.hp - 1) * p.wp;
        uint32_t* srow = (uint32_t*)(ref_s + rr * g.ref_pitch);
        for (int cw = lane; cw < wpitch; cw += 32) {
            const int x = base_x + 4 * cw;
            uint32_t v = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                v |= (uint32_t)grow[clampi(x + e, 0, p.wp - 1)] << (8 * e);
            srow[cw] = v;
        }
    }
    // ---- stage each block's source rows, word-aligned
    const uint8_t* src_j = src + (size_t)job * p.hs * p.ws;
    const int sy0 = p.src_y0 + row * p.pitch_y;
    const int sx0 = p.src_x0 + b0 * p.pitch_x;
    const int n_sw = nb * p.bs_y * g.wpr;
    for (int i = threadIdx.x; i < n_sw; i += blockDim.x) {
        const int by = i / g.wpr, cw = i - by * g.wpr;
        const int b = by / p.bs_y, y = by - b * p.bs_y;
        const uint8_t* grow = src_j
                              + (size_t)clampi(sy0 + y, 0, p.hs - 1) * p.ws;
        const int x0 = sx0 + b * p.pitch_x + 4 * cw;
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (4 * cw + e < p.bs_x)
                v |= (uint32_t)grow[clampi(x0 + e, 0, p.ws - 1)] << (8 * e);
        *(uint32_t*)(src_s + b * g.src_stride + 4 * (y * g.wpr + cw)) = v;
    }
    __syncthreads();

    // ---- items: (block, subplane, full-pel row, column chunk)
    const int pelm = (1 << p.logp) - 1;
    const int dxn = 2 * p.r_x + 1;
    const int dn = (2 * p.r_y + 1) * dxn;
    const int per0 = parity_count(p.r_y, parity_first(p.r_y, 0, pelm), p.logp)
                     << p.logp;                    // rows of dy parity 0
    const uint32_t lastmask = (p.bs_x & 3)
                              ? (1u << (8 * (p.bs_x & 3))) - 1u : 0xffffffffu;
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
            + (col0 >> 2);
        const uint32_t* sw = (const uint32_t*)(src_s + b * g.src_stride);
        unsigned acc[NOX];
#pragma unroll
        for (int i = 0; i < NOX; ++i) acc[i] = 0;
        switch (col0 & 3) {
            case 0: map_rows<NWS, NOX, 0>(ref, wpitch, sw, g.wpr, p.bs_y,
                                          lastmask, acc); break;
            case 1: map_rows<NWS, NOX, 1>(ref, wpitch, sw, g.wpr, p.bs_y,
                                          lastmask, acc); break;
            case 2: map_rows<NWS, NOX, 2>(ref, wpitch, sw, g.wpr, p.bs_y,
                                          lastmask, acc); break;
            default: map_rows<NWS, NOX, 3>(ref, wpitch, sw, g.wpr, p.bs_y,
                                           lastmask, acc); break;
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

// Stage the tile's reference window (rows of wx_max bytes) and source span
// ([bs_y, span_max]) in shared memory for the three-stat form; returns the
// number of blocks in this tile.
__device__ __forceinline__ int stage_tile(const uint8_t* __restrict__ stack,
                                          const uint8_t* __restrict__ src,
                                          const int* __restrict__ afy,
                                          const int* __restrict__ afx,
                                          const MapParams& p,
                                          uint8_t* ref_s, uint8_t* src_s) {
    const int tc = blockIdx.x, row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile;
    const int nb = min(p.tile, p.nbx - b0);
    const int span = (nb - 1) * p.pitch_x + p.bs_x;
    const int wx = span + (p.wx_max - p.span_max);

    const int t = row * p.ntx + tc;
    const int base_y = afy[job * p.nby * p.ntx + t] + p.min_oy;
    const int base_x = afx[job * p.nby * p.ntx + t] + p.min_ox;

    const size_t plane = (size_t)p.hp * p.wp;
    const uint8_t* stack_j = stack + (size_t)job * p.n_sub * plane;
    const int n_ref = p.n_sub * p.wy * wx;
    for (int i = threadIdx.x; i < n_ref; i += blockDim.x) {
        const int x = i % wx;
        const int y = (i / wx) % p.wy;
        const int s = i / (wx * p.wy);
        const int gy = clampi(base_y + y, 0, p.hp - 1);
        const int gx = clampi(base_x + x, 0, p.wp - 1);
        ref_s[(s * p.wy + y) * p.wx_max + x] =
            stack_j[s * plane + (size_t)gy * p.wp + gx];
    }
    const uint8_t* src_j = src + (size_t)job * p.hs * p.ws;
    const int sy0 = p.src_y0 + row * p.pitch_y;
    const int sx0 = p.src_x0 + b0 * p.pitch_x;
    for (int i = threadIdx.x; i < p.bs_y * span; i += blockDim.x) {
        const int x = i % span, y = i / span;
        const int gy = clampi(sy0 + y, 0, p.hs - 1);
        const int gx = clampi(sx0 + x, 0, p.ws - 1);
        src_s[y * p.span_max + x] = src_j[(size_t)gy * p.ws + gx];
    }
    __syncthreads();
    return nb;
}

// The three-stat form: `group` lanes per (block, offset) pair.
__global__ void sadmap_stats3_kernel(const uint8_t* __restrict__ stack,
                                     const uint8_t* __restrict__ src,
                                     const int* __restrict__ afy,
                                     const int* __restrict__ afx,
                                     int* __restrict__ out, MapParams p,
                                     int group) {
    extern __shared__ uint8_t smem[];
    const int tc = blockIdx.x, row = blockIdx.y, job = blockIdx.z;
    const int b0 = tc * p.tile;
    uint8_t* ref_s = smem;                               // [n_sub][wy][wx_max]
    uint8_t* src_s = smem + p.n_sub * p.wy * p.wx_max;   // [bs_y][span_max]
    const int nb = stage_tile(stack, src, afy, afx, p, ref_s, src_s);

    const int dxn = 2 * p.r_x + 1;
    const int d = (2 * p.r_y + 1) * dxn;
    const int pelm = (1 << p.logp) - 1;
    int* out_t = out + ((size_t)job * p.nbx * p.nby
                        + (size_t)row * p.nbx + b0) * d * 3;
    const int g_lane = threadIdx.x % group;
    const int per_pass = blockDim.x / group;
    const int n_items = nb * d;
    // every thread runs every pass: the group sums are warp-wide shuffles
    for (int first = 0; first < n_items; first += per_pass) {
        const int item = first + threadIdx.x / group;
        const bool active = item < n_items;
        const int b = active ? item / d : 0;
        const int di = active ? item % d : 0;
        const int dy = di / dxn - p.r_y;
        const int dx = di % dxn - p.r_x;
        const int sub = (dx & pelm) | ((dy & pelm) << p.logp);
        const int oy = (dy >> p.logp) - p.min_oy;
        const int ox = (dx >> p.logp) - p.min_ox + b * p.pitch_x;
        const mvt::Stats3 st = mvt::block_stats3(
            src_s + b * p.pitch_x, p.span_max,
            ref_s + (sub * p.wy + oy) * p.wx_max + ox, p.wx_max, p.bs_y,
            p.bs_x, g_lane, group, active);
        if (active && g_lane == 0) {
            int* o = out_t + (size_t)item * 3;
            o[0] = st.sad; o[1] = st.satd; o[2] = st.luma;
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

template <int NWS, int NOX>
static int launch_map(dim3 grid, int threads, int smem, cudaStream_t st,
                      const void* stack, const void* src, const void* afy,
                      const void* afx, void* out, const MapParams& p,
                      const MapGeom& g) {
    cudaError_t err = cudaFuncSetAttribute(
        sadmap_kernel<NWS, NOX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    sadmap_kernel<NWS, NOX><<<grid, threads, smem, st>>>(
        (const uint8_t*)stack, (const uint8_t*)src, (const int*)afy,
        (const int*)afx, (int*)out, p, g);
    return (int)cudaGetLastError();
}

template <int NWS>
static int launch_map_nox(int nox, dim3 grid, int threads, int smem,
                          cudaStream_t st, const void* stack, const void* src,
                          const void* afy, const void* afx, void* out,
                          const MapParams& p, const MapGeom& g) {
    switch (nox) {
        case 6: return launch_map<NWS, 6>(grid, threads, smem, st, stack, src,
                                          afy, afx, out, p, g);
        case 9: return launch_map<NWS, 9>(grid, threads, smem, st, stack, src,
                                          afy, afx, out, p, g);
        case 16: return launch_map<NWS, 16>(grid, threads, smem, st, stack,
                                            src, afy, afx, out, p, g);
        default: return (int)cudaErrorInvalidValue;
    }
}

// threads .. n_chunk: the launch geometry of ops/sadmap.py::map_launch_geom.
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
    cudaStream_t st = (cudaStream_t)stream;
    switch (nws) {
        case 1: return launch_map_nox<1>(nox, grid, threads, smem, st, stack,
                                         src, afy, afx, out, p, g);
        case 2: return launch_map_nox<2>(nox, grid, threads, smem, st, stack,
                                         src, afy, afx, out, p, g);
        case 4: return launch_map_nox<4>(nox, grid, threads, smem, st, stack,
                                         src, afy, afx, out, p, g);
        case 8: return launch_map_nox<8>(nox, grid, threads, smem, st, stack,
                                         src, afy, afx, out, p, g);
        default: return (int)cudaErrorInvalidValue;
    }
}

static size_t map_smem(const MapParams& p) {
    return (size_t)p.n_sub * p.wy * p.wx_max + (size_t)p.bs_y * p.span_max;
}

extern "C" int mvt_sad_map_stats3(const void* stack, const void* src,
                                  const void* afy, const void* afx, void* out,
                                  int n_jobs, int n_sub, int hp, int wp,
                                  int hs, int ws, int nbx, int nby, int tile,
                                  int pitch_x, int pitch_y, int bs_y,
                                  int bs_x, int src_y0, int src_x0, int r_y,
                                  int r_x, int logp, void* stream) {
    const MapParams p = map_params(n_sub, hp, wp, hs, ws, nbx, nby, tile,
                                   pitch_x, pitch_y, bs_y, bs_x, src_y0,
                                   src_x0, r_y, r_x, logp);
    const size_t smem = map_smem(p);
    cudaError_t err = cudaFuncSetAttribute(
        sadmap_stats3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(p.ntx, nby, n_jobs);
    sadmap_stats3_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const uint8_t*)src, (const int*)afy,
        (const int*)afx, (int*)out, p, mvt::stats3_group(bs_y, bs_x));
    return (int)cudaGetLastError();
}
