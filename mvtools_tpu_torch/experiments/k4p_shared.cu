// A variant of the three-stat per-block probe (K4') for timing only: G
// lanes an ITEM (job, block, candidate) instead of an entry, one 8x4
// partition (or the 4x4 tile) a lane, so that the source block's transform
// H(S) is made once and serves the item's D offsets, which the lanes then
// take one after another.  k4p_timing.py appends this file to the text of
// csrc/probe_block.cu (whose K4pParams, reference_words, window_start and
// tile words it uses) and builds the result with nvcc; it takes the
// committed launch's ints (ops/probe.py::_probe_block_launch) and needs
// parts == 1 (blocks up to 32x32).  The port does not build it.

namespace {

template <bool TILE4>
__global__ void __launch_bounds__(256)
probe_block3_shared_kernel(const uint8_t* __restrict__ stack,
                           const int* __restrict__ cand_y,
                           const int* __restrict__ cand_x,
                           const uint8_t* __restrict__ src,
                           const int2* __restrict__ offs,
                           const uint8_t* __restrict__ active,
                           int* __restrict__ out, K4pParams p) {
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= p.n_lanes) return;
    const int lane = threadIdx.x & 31;
    const int G = 1 << p.lg;
    const int g = lane & (G - 1);
    const unsigned w = t >> p.lg;                    // (job, block, k)
    const int cy = __ldg(cand_y + w), cx = __ldg(cand_x + w);
    const unsigned jb = w / (unsigned)p.k;
    const unsigned job = jb / (unsigned)p.nblk;
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int sy = window_start(wb_y, p.hp, p.wy) - wb_y;
    const int sx = window_start(wb_x, p.wp, p.wx) - wb_x;
    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const uint8_t* s0 = src + (size_t)jb * p.bs_y * p.bs_x;
    const int row = TILE4 ? 0 : (g >> p.lpx) << 2;
    const int col = TILE4 ? 0 : (g & ((1 << p.lpx) - 1)) << 3;
    uint32_t sa[4], sb[4], ha[8], hb[8];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        if (TILE4) {
            sa[y] = *(const uint32_t*)(s0 + 4 * y);
        } else {
            const uint2 v = *(const uint2*)(s0 + (row + y) * p.bs_x + col);
            sa[y] = v.x; sb[y] = v.y;
        }
    }
    mvt::tile_hadamard(sa, ha);
    if (!TILE4) mvt::tile_hadamard(sb, hb);
    const int s_const = 8 * (int)(sa[0] & 0xffu) + 16 * (int)mvt::ZB
        + (TILE4 ? 0 : 8 * (int)(sb[0] & 0xffu) + 16 * (int)mvt::ZB);
    const unsigned gmask = G == 32 ? 0xffffffffu
                                   : ((1u << G) - 1u) << (lane & ~(G - 1));
    for (int d = 0; d < p.d; ++d) {
        const unsigned e = w * (unsigned)p.d + d;
        int* oe = out + (size_t)e * 3;
        if (active != nullptr && active[e] == 0) {   // the group alike
            if (g == 0) oe[0] = oe[1] = oe[2] = INT_MAX;
            continue;
        }
        const int2 o = __ldg(offs + d);
        const int ax = cx + o.x, ay = cy + o.y;
        const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
        const uintptr_t r0 = (uintptr_t)(
            stack + ((size_t)job * p.n_sub + sub) * plane
            + (size_t)((ay >> p.logp) + sy) * p.wp + (ax >> p.logp) + sx);
        unsigned sad = 0, luma = 0;
        int sat = s_const;
        uint32_t ra[4], rb[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            if (TILE4) {
                reference_words<1, false>(r0 + (uintptr_t)y * p.wp, &ra[y]);
            } else {
                uint32_t rr[2];
                reference_words<2, false>(
                    r0 + (uintptr_t)((row + y) * p.wp + col), rr);
                ra[y] = rr[0]; rb[y] = rr[1];
            }
        }
        mvt::tile_stats3(ra, sa, ha, sad, sat, luma);
        if (!TILE4) mvt::tile_stats3(rb, sb, hb, sad, sat, luma);
        for (int sh = G >> 1; sh > 0; sh >>= 1) {
            sad += __shfl_xor_sync(gmask, sad, sh);
            sat += __shfl_xor_sync(gmask, sat, sh);
            luma += __shfl_xor_sync(gmask, luma, sh);
        }
        if (g == 0) {
            oe[0] = (int)sad; oe[1] = sat; oe[2] = (int)luma;
        }
    }
}

}  // namespace

// The committed launch's ints (csrc/probe_block.cu::K4pArg); lanes for the
// items, not the entries.
extern "C" int mvt_probe_block3_shared(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        const int* a, void* stream) {
    K4pParams p;
    p.n_sub = a[B_SUB]; p.hp = a[B_HP]; p.wp = a[B_WP]; p.nblk = a[B_NBLK];
    p.k = a[B_K]; p.d = a[B_D]; p.bs_y = a[B_BSY]; p.bs_x = a[B_BSX];
    p.logp = a[B_LOGP]; p.min_dy = a[B_MINDY]; p.min_dx = a[B_MINDX];
    p.wy = a[B_WY]; p.wx = a[B_WX]; p.lg = a[B_LG]; p.parts = a[B_PARTS];
    p.lpx = a[B_LPX];
    const long long items = (long long)a[B_JOBS] * p.nblk * p.k;
    if (items == 0 || p.d == 0) return 0;
    if (p.parts != 1) return (int)cudaErrorInvalidValue;
    p.n_lanes = (unsigned)(items << p.lg);
    const int threads = a[B_THREADS];
    const unsigned blocks = (p.n_lanes + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (a[B_TILE4])
        probe_block3_shared_kernel<true><<<blocks, threads, 0, st>>>(
            (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
            (const uint8_t*)src, (const int2*)offs, (const uint8_t*)active,
            (int*)out, p);
    else
        probe_block3_shared_kernel<false><<<blocks, threads, 0, st>>>(
            (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
            (const uint8_t*)src, (const int2*)offs, (const uint8_t*)active,
            (int*)out, p);
    return (int)cudaGetLastError();
}
