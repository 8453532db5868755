// The per-block probe's previous body (K4 and K4 u16 up to their
// redesign): csrc/probe_block.cu's probe_block_kernel<T> as the port first
// wrote it, a warp per (job, block, candidate) that walks the D offsets one
// after another.  Kept only so that k4_timing.py can time it beside the
// committed body: that script appends this file to the text of
// csrc/probe_block.cu (whose window_start it uses) and
// builds the result with nvcc.  The port does not build it.

namespace {

struct BlockProbeParams {
    int n_sub, hp, wp;     // stack [J, n_sub, hp, wp]
    int nblk, k, d;        // blocks per job, K, D
    int bs_y, bs_x, logp;
    int min_dy, min_dx;    // most negative offsets of the set
    int wy, wx;            // window of the offset set, full-pel pixels
    long long total;       // J * nblk * K warps of work
};

// T: the pixel type (uint8_t, or uint16_t for 9- to 16-bit clips).
template <typename T>
__global__ void probe_block_previous_kernel(
        const T* __restrict__ stack, const int* __restrict__ cand_y,
        const int* __restrict__ cand_x, const T* __restrict__ src,
        const int* __restrict__ offs,  // [D, 2]
        int* __restrict__ out, BlockProbeParams p) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
    if (w >= p.total) return;
    const long long jb = w / p.k;            // (job, block) flat
    const int job = (int)(jb / p.nblk);

    const int cy = cand_y[w], cx = cand_x[w];
    const int wb_y = (cy + p.min_dy) >> p.logp;
    const int wb_x = (cx + p.min_dx) >> p.logp;
    const int shift_y = window_start(wb_y, p.hp, p.wy) - wb_y;
    const int shift_x = window_start(wb_x, p.wp, p.wx) - wb_x;

    const int pelm = (1 << p.logp) - 1;
    const size_t plane = (size_t)p.hp * p.wp;
    const T* stack_j = stack + (size_t)job * p.n_sub * plane;
    const int npix = p.bs_y * p.bs_x;
    const T* s = src + (size_t)jb * npix;
    int* o = out + (size_t)w * p.d;
    for (int d = 0; d < p.d; ++d) {
        const int ax = cx + offs[2 * d], ay = cy + offs[2 * d + 1];
        const int sub = (ax & pelm) | ((ay & pelm) << p.logp);
        const int oy = (ay >> p.logp) + shift_y;
        const int ox = (ax >> p.logp) + shift_x;
        const T* r = stack_j + sub * plane + (size_t)oy * p.wp + ox;
        int acc = 0;
        for (int i = lane; i < npix; i += 32) {
            const int y = i / p.bs_x, x = i % p.bs_x;
            acc += abs((int)r[(size_t)y * p.wp + x] - (int)s[i]);
        }
        for (int sh = 16; sh > 0; sh >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, sh);
        if (lane == 0) o[d] = acc;
    }
}

}  // namespace

// u16: 1 for uint16 stack and source blocks, 0 for uint8.
extern "C" int mvt_probe_block_previous(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, void* out, int n_jobs, int n_sub,
        int hp, int wp, int nblk, int k, int d, int bs_y, int bs_x, int logp,
        int min_dy, int min_dx, int wy, int wx, int u16, void* stream) {
    BlockProbeParams p;
    p.n_sub = n_sub; p.hp = hp; p.wp = wp; p.nblk = nblk; p.k = k; p.d = d;
    p.bs_y = bs_y; p.bs_x = bs_x; p.logp = logp; p.min_dy = min_dy;
    p.min_dx = min_dx; p.wy = wy; p.wx = wx;
    p.total = (long long)n_jobs * nblk * k;
    if (p.total == 0 || d == 0) return 0;
    const int warps = 4;
    const long long blocks = (p.total + warps - 1) / warps;
    if (u16)
        probe_block_previous_kernel<uint16_t><<<
            (unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
            (const uint16_t*)stack, (const int*)cand_y, (const int*)cand_x,
            (const uint16_t*)src, (const int*)offs, (int*)out, p);
    else
        probe_block_previous_kernel<uint8_t><<<
            (unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)stack, (const int*)cand_y, (const int*)cand_x,
            (const uint8_t*)src, (const int*)offs, (int*)out, p);
    return (int)cudaGetLastError();
}
