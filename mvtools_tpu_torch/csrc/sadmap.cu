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
// Bound on this card: integer operations (each output is bs_y*bs_x abs-diff
// accumulates over a window that is read once from memory).  Design: one
// CTA per (job, tile) stages the tile's source span and the
// [pel^2, bs_y + span_oy, span + span_ox] reference window in shared memory
// once, so device memory sees each byte once and every (block, offset) pair
// then runs out of shared memory; threads own (block, offset) pairs with dx
// fastest, so the int32 results leave as coalesced dy-major rows.  Sums are
// int32: exact for every block size and bit depth that fits the map.
//
// The three-stat form writes, for the same grid, the triple (SAD, SATD, sum
// of the reference block) per entry: out[job, block, dy + r_y, dx + r_x, 0..2]
// (satd.cuh says what the SATD is).  Same CTA, same staged window; a group of
// lanes owns a (block, offset) pair and splits the block's 8x4 partitions.
// Bound: integer operations, about 2.5 times the plain map's per pixel (the
// two butterflies and the three accumulations).

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Stage the tile's reference window and source span in shared memory;
// returns the number of blocks in this tile.
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

__global__ void sadmap_kernel(const uint8_t* __restrict__ stack,
                              const uint8_t* __restrict__ src,
                              const int* __restrict__ afy,
                              const int* __restrict__ afx,
                              int* __restrict__ out, MapParams p) {
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
                        + (size_t)row * p.nbx + b0) * d;
    for (int item = threadIdx.x; item < nb * d; item += blockDim.x) {
        const int b = item / d;
        const int di = item % d;
        const int dy = di / dxn - p.r_y;
        const int dx = di % dxn - p.r_x;
        const int sub = (dx & pelm) | ((dy & pelm) << p.logp);
        const int oy = (dy >> p.logp) - p.min_oy;
        const int ox = (dx >> p.logp) - p.min_ox + b * p.pitch_x;
        const uint8_t* r0 = ref_s + (sub * p.wy + oy) * p.wx_max + ox;
        const uint8_t* s0 = src_s + b * p.pitch_x;
        int acc = 0;
        for (int y = 0; y < p.bs_y; ++y) {
            const uint8_t* rr = r0 + y * p.wx_max;
            const uint8_t* ss = s0 + y * p.span_max;
            for (int x = 0; x < p.bs_x; ++x)
                acc += abs((int)rr[x] - (int)ss[x]);
        }
        out_t[item] = acc;
    }
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

static size_t map_smem(const MapParams& p) {
    return (size_t)p.n_sub * p.wy * p.wx_max + (size_t)p.bs_y * p.span_max;
}

extern "C" int mvt_sad_map(const void* stack, const void* src,
                           const void* afy, const void* afx, void* out,
                           int n_jobs, int n_sub, int hp, int wp, int hs,
                           int ws, int nbx, int nby, int tile, int pitch_x,
                           int pitch_y, int bs_y, int bs_x, int src_y0,
                           int src_x0, int r_y, int r_x, int logp,
                           void* stream) {
    const MapParams p = map_params(n_sub, hp, wp, hs, ws, nbx, nby, tile,
                                   pitch_x, pitch_y, bs_y, bs_x, src_y0,
                                   src_x0, r_y, r_x, logp);
    const size_t smem = map_smem(p);
    cudaError_t err = cudaFuncSetAttribute(
        sadmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(p.ntx, nby, n_jobs);
    sadmap_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const uint8_t*)src, (const int*)afy,
        (const int*)afx, (int*)out, p);
    return (int)cudaGetLastError();
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
