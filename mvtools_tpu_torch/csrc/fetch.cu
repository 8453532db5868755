// Reference-block fetches: the tiled fetch (K3) and the per-block fetch (K5).
//
// K3 replaces the TPU kernel mvtools_tpu/ops/probe.py::_tiled_fetch_kernel
// (fetch_blocks_tiled_pallas), K5 the TPU kernel
// mvtools_tpu/ops/probe.py::_fetch_kernel (fetch_blocks_pallas).  Both
// compute, per (job, block, candidate k),
//
//   sub = (cx & (pel-1)) | ((cy & (pel-1)) << logp)
//   out[job, block, k, y, x] = stack[job, sub, fy + y, fx + x]   (as int32)
//
// and differ only in how an origin outside the plane is treated:
//
// * K3 (mvt_fetch_blocks_tiled): fy = (cy >> logp), fx = (cx >> logp), rows
//   and columns clamped into the plane one by one.  The TPU kernel shares
//   one window per tile of blocks and keeps a private fallback copy only to
//   stay exact for every block; here every block reads its own patch and L2
//   serves the overlap, so the result is exact by construction.  Its callers
//   (Degrain, the DCT map rows) keep every block inside the plane.
// * K5 (mvt_fetch_blocks): the full-pel origin is clamped AS A WHOLE to
//   [0, hp - bs_y] x [0, wp - bs_x], what the JAX package's window slice
//   does with an out-of-range start, so every block is a window of the
//   plane.  It serves the DCT costs' candidate blocks (dct 1-4) and the
//   stacks under the tiled fetch's window.
//
// Bound on this card: bytes (a bs_y x bs_x block read, four times that
// written per candidate; no arithmetic).  K3: one thread per output element
// with x fastest, so the int32 stores are fully coalesced and each warp
// reads one or two contiguous source rows.  K5: one warp per candidate; each
// lane moves four pixels of a row at a time, read as one 32-bit word where
// the source address is word-aligned (four byte loads elsewhere) and stored
// as one 16-byte int4, so a warp writes 512 contiguous bytes per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fetch_tiled_kernel(const uint8_t* __restrict__ stack,
                                   const int* __restrict__ cand_y,
                                   const int* __restrict__ cand_x,
                                   int* __restrict__ out, long long total,
                                   int n_sub, int hp, int wp,
                                   long long per_job, int bs_y, int bs_x,
                                   int logp) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int npix = bs_y * bs_x;
    const long long c = i / npix;            // (job, block, k) flat
    const int pix = (int)(i % npix);
    const int y = pix / bs_x, x = pix % bs_x;
    const int job = (int)(c / per_job);
    const int cy = cand_y[c], cx = cand_x[c];
    const int pelm = (1 << logp) - 1;
    const int sub = (cx & pelm) | ((cy & pelm) << logp);
    int gy = (cy >> logp) + y, gx = (cx >> logp) + x;
    gy = gy < 0 ? 0 : (gy > hp - 1 ? hp - 1 : gy);
    gx = gx < 0 ? 0 : (gx > wp - 1 ? wp - 1 : gx);
    out[i] = stack[(((size_t)job * n_sub + sub) * hp + gy) * wp + gx];
}

__global__ void fetch_block_kernel(const uint8_t* __restrict__ stack,
                                   const int* __restrict__ cand_y,
                                   const int* __restrict__ cand_x,
                                   int* __restrict__ out, long long n_cand,
                                   int n_sub, int hp, int wp,
                                   long long per_job, int bs_y, int bs_x,
                                   int logp) {
    const long long c =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (c >= n_cand) return;
    const int job = (int)(c / per_job);
    const int cy = cand_y[c], cx = cand_x[c];
    const int pelm = (1 << logp) - 1;
    const int sub = (cx & pelm) | ((cy & pelm) << logp);
    int fy = cy >> logp, fx = cx >> logp;
    fy = fy < 0 ? 0 : (fy > hp - bs_y ? hp - bs_y : fy);
    fx = fx < 0 ? 0 : (fx > wp - bs_x ? wp - bs_x : fx);
    const uint8_t* src =
        stack + (((size_t)job * n_sub + sub) * hp + fy) * wp + fx;
    int* dst = out + (size_t)c * bs_y * bs_x;
    if ((bs_x & 3) == 0) {
        // dst is 16-byte aligned: the output starts aligned and every
        // block holds a multiple of four int32 per row
        const int per_row = bs_x >> 2;
        const int n_groups = bs_y * per_row;
        for (int g = lane; g < n_groups; g += 32) {
            const int r = g / per_row;
            const uint8_t* p = src + (size_t)r * wp + ((g - r * per_row) << 2);
            uint32_t w;
            if (((uintptr_t)p & 3) == 0) {
                w = __ldg(reinterpret_cast<const uint32_t*>(p));
            } else {
                w = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8)
                    | ((uint32_t)__ldg(p + 2) << 16)
                    | ((uint32_t)__ldg(p + 3) << 24);
            }
            reinterpret_cast<int4*>(dst)[g] =
                make_int4((int)(w & 255u), (int)((w >> 8) & 255u),
                          (int)((w >> 16) & 255u), (int)(w >> 24));
        }
    } else {
        const int npix = bs_y * bs_x;
        for (int i = lane; i < npix; i += 32) {
            const int r = i / bs_x;
            dst[i] = __ldg(src + (size_t)r * wp + (i - r * bs_x));
        }
    }
}

}  // namespace

extern "C" int mvt_fetch_blocks_tiled(const void* stack, const void* cand_y,
                                      const void* cand_x, void* out,
                                      int n_jobs, int n_sub, int hp, int wp,
                                      int nblk, int k, int bs_y, int bs_x,
                                      int logp, void* stream) {
    const long long per_job = (long long)nblk * k;
    const long long total = (long long)n_jobs * per_job * bs_y * bs_x;
    if (total == 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    fetch_tiled_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (int*)out, total, n_sub, hp, wp, per_job, bs_y, bs_x, logp);
    return (int)cudaGetLastError();
}

extern "C" int mvt_fetch_blocks(const void* stack, const void* cand_y,
                                const void* cand_x, void* out, int n_jobs,
                                int n_sub, int hp, int wp, int nblk, int k,
                                int bs_y, int bs_x, int logp, void* stream) {
    const long long per_job = (long long)nblk * k;
    const long long n_cand = (long long)n_jobs * per_job;
    if (n_cand == 0 || bs_y * bs_x == 0) return 0;
    const int threads = 256;                 // eight candidates per block
    const long long blocks = (n_cand * 32 + threads - 1) / threads;
    fetch_block_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (int*)out, n_cand, n_sub, hp, wp, per_job, bs_y, bs_x, logp);
    return (int)cudaGetLastError();
}
