// The three-stat per-block probe's previous body (K4' up to its
// redesign): csrc/probe_block.cu's probe_block_stats3_kernel as the port
// first wrote it, `group` lanes per (job, block, candidate, offset) over
// fixed CTAs of 128, each 4x4 tile of S - R taken pixel by pixel, every
// entry computed (its wrapper masked the output after it), with the helpers
// it took from csrc/satd.cuh.  Kept only so that k4p_timing.py can time it
// beside the committed body: that script appends this file to the text of
// csrc/probe_block.cu (whose window_start it uses) and builds the result
// with nvcc.  The port does not build it.

namespace {

struct Stats3PreviousParams {
    int n_sub, hp, wp;     // stack [J, n_sub, hp, wp]
    int nblk, k, d;        // blocks per job, K, D
    int bs_y, bs_x, logp;
    int min_dy, min_dx;    // most negative offsets of the set
    int wy, wx;            // window of the offset set, full-pel pixels
    long long total;       // J * nblk * K warps of work
};

struct Stats3 {
    int sad, satd, luma;
};

// Lanes per block for a block size: the partitions, rounded up to a power of
// two, at most a warp.
inline int stats3_group(int bs_y, int bs_x) {
    const int parts = bs_x < 8 ? 1 : (bs_y / 4) * (bs_x / 8);
    int g = 1;
    while (g < parts && g < 32) g <<= 1;
    return g;
}

// One 4x4 tile: adds its SAD and reference sum to st and returns the sum of
// the absolute Hadamard coefficients of S - R.
__device__ __forceinline__ int tile_stats(const uint8_t* __restrict__ s,
                                          int s_stride,
                                          const uint8_t* __restrict__ r,
                                          int r_stride, Stats3& st) {
    int d[4][4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int rv = r[y * r_stride + x];
            const int dv = (int)s[y * s_stride + x] - rv;
            d[y][x] = dv;
            st.sad += abs(dv);
            st.luma += rv;
        }
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        const int a0 = d[y][0] + d[y][1], a1 = d[y][0] - d[y][1];
        const int a2 = d[y][2] + d[y][3], a3 = d[y][2] - d[y][3];
        d[y][0] = a0 + a2; d[y][1] = a1 + a3;
        d[y][2] = a0 - a2; d[y][3] = a1 - a3;
    }
    int acc = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        const int a0 = d[0][x] + d[1][x], a1 = d[0][x] - d[1][x];
        const int a2 = d[2][x] + d[3][x], a3 = d[2][x] - d[3][x];
        acc += abs(a0 + a2) + abs(a1 + a3) + abs(a0 - a2) + abs(a1 - a3);
    }
    return acc;
}

// (SAD, SATD, reference sum) of one block, valid in every lane of the group
// after the call.  s / r point at the block's top-left pixel; g_lane is the
// lane's index inside its group of `group` lanes.
__device__ __forceinline__ Stats3 block_stats3(const uint8_t* __restrict__ s,
                                               int s_stride,
                                               const uint8_t* __restrict__ r,
                                               int r_stride, int bs_y,
                                               int bs_x, int g_lane,
                                               int group, bool active) {
    Stats3 st = {0, 0, 0};
    if (active) {
        if (bs_x < 8) {                       // the 4x4 block: one tile
            if (g_lane == 0)
                st.satd = tile_stats(s, s_stride, r, r_stride, st) >> 1;
        } else {
            const int px_n = bs_x >> 3;
            const int parts = (bs_y >> 2) * px_n;
            for (int p = g_lane; p < parts; p += group) {
                const int y0 = (p / px_n) << 2, x0 = (p % px_n) << 3;
                const uint8_t* sp = s + y0 * s_stride + x0;
                const uint8_t* rp = r + y0 * r_stride + x0;
                const int h = tile_stats(sp, s_stride, rp, r_stride, st)
                              + tile_stats(sp + 4, s_stride, rp + 4, r_stride,
                                           st);
                st.satd += h >> 1;
            }
        }
    }
    for (int sh = group >> 1; sh > 0; sh >>= 1) {
        st.sad += __shfl_xor_sync(0xffffffffu, st.sad, sh);
        st.satd += __shfl_xor_sync(0xffffffffu, st.satd, sh);
        st.luma += __shfl_xor_sync(0xffffffffu, st.luma, sh);
    }
    return st;
}


// The three-stat form: `group` lanes per (job, block, candidate, offset).
__global__ void probe_block3_previous_kernel(
        const uint8_t* __restrict__ stack, const int* __restrict__ cand_y,
        const int* __restrict__ cand_x, const uint8_t* __restrict__ src,
        const int* __restrict__ offs, int* __restrict__ out,
        Stats3PreviousParams p, int group) {
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long item = gt / group;          // ((job, block), k, d) flat
    const int g_lane = (int)(gt % group);
    const bool active = item < p.total * p.d;
    const long long w = active ? item / p.d : 0;       // (job, block, k)
    const int d = active ? (int)(item % p.d) : 0;
    const long long jb = w / p.k;
    const int job = (int)(jb / p.nblk);

    const int cy = cand_y[w], cx = cand_x[w];
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int shift_y = window_start(wb_y, p.hp, p.wy) - wb_y;
    const int shift_x = window_start(wb_x, p.wp, p.wx) - wb_x;

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const int ax = cx + offs[2 * d], ay = cy + offs[2 * d + 1];
    const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
    const int oy = (ay >> p.logp) + shift_y;
    const int ox = (ax >> p.logp) + shift_x;
    const uint8_t* r = stack + ((size_t)job * p.n_sub + sub) * plane
                       + (size_t)oy * p.wp + ox;
    const uint8_t* s = src + (size_t)jb * p.bs_y * p.bs_x;
    const Stats3 st = block_stats3(s, p.bs_x, r, p.wp, p.bs_y,
                                             p.bs_x, g_lane, group, active);
    if (active && g_lane == 0) {
        int* o = out + (size_t)item * 3;
        o[0] = st.sad; o[1] = st.satd; o[2] = st.luma;
    }
}

}  // namespace

extern "C" int mvt_probe_block3_previous(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int k, int d, int bs_y, int bs_x, int logp,
        int min_dy, int min_dx, int wy, int wx, int u16, void* stream) {
    // the three stats are defined for 8-bit stacks only
    if (u16) return (int)cudaErrorInvalidValue;
    Stats3PreviousParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk; p.k = k; p.d = d;
    p.bs_y = bs_y; p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy;
    p.min_dx = min_dx; p.wy = wy; p.wx = wx;
    p.total = (long long)n_jobs * nblk * k;
    if (p.total == 0 || d == 0) return 0;
    const int group = stats3_group(bs_y, bs_x);
    const int threads = 128;
    const long long lanes = p.total * d * group;
    const long long blocks = (lanes + threads - 1) / threads;
    probe_block3_previous_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
        (const uint8_t*)src, (const int*)offs, (int*)out, p, group);
    return (int)cudaGetLastError();
}
