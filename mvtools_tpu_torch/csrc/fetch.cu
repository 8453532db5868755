// Reference-block fetch (K3).
//
// Replaces the TPU kernel mvtools_tpu/ops/probe.py::_tiled_fetch_kernel
// (fetch_blocks_tiled_pallas).
//
//   sub = (cx & (pel-1)) | ((cy & (pel-1)) << logp)
//   out[job, block, k, y, x] = stack[job, sub, (cy >> logp) + y,
//                                              (cx >> logp) + x]   (as int32)
//
// The TPU kernel shares one window per tile of blocks and keeps a private
// fallback copy only to stay exact for every block; here every block reads
// its own bs_y x bs_x patch and L2 serves the overlap, so the result is
// exact by construction.  Rows and columns are clamped into the plane, so a
// position outside it reads edge pixels instead of faulting.
//
// Bound on this card: bytes (bs_y*bs_x bytes read, four times that written
// per block; no arithmetic).  Design: one thread per output element with x
// fastest, so the int32 stores are fully coalesced and each warp reads one
// or two contiguous source rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fetch_kernel(const uint8_t* __restrict__ stack,
                             const int* __restrict__ cand_y,
                             const int* __restrict__ cand_x,
                             int* __restrict__ out, long long total,
                             int n_sub, int hp, int wp, long long per_job,
                             int bs_y, int bs_x, int logp) {
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

}  // namespace

extern "C" int mvt_fetch_blocks(const void* stack, const void* cand_y,
                                const void* cand_x, void* out, int n_jobs,
                                int n_sub, int hp, int wp, int nblk, int k,
                                int bs_y, int bs_x, int logp, void* stream) {
    const long long per_job = (long long)nblk * k;
    const long long total = (long long)n_jobs * per_job * bs_y * bs_x;
    if (total == 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    fetch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (int*)out, total, n_sub, hp, wp, per_job, bs_y, bs_x, logp);
    return (int)cudaGetLastError();
}
