// The uint16 tiled probe's previous body (K2 u16 up to its redesign):
// csrc/probe.cu's probe_kernel on uint16 stacks, a warp per (job, block,
// candidate).  Kept only so that k2u16_timing.py can time it, whole and cut,
// beside csrc/probe.cu::probe16_kernel: that script appends this file to
// the text of csrc/probe.cu (whose ProbeParams, candidate_valid, ref_word,
// probe_params and pow2 it uses) and builds the result with nvcc.  The
// port does not build it.

namespace {

// sum of |a - b| over the two 16-bit pixels of two words, added into acc:
// max.u16x2 - min.u16x2 (no borrow crosses the halves) and one IDP.2A
__device__ __forceinline__ unsigned sad16(uint32_t a, uint32_t b,
                                          unsigned acc) {
    uint32_t hi, lo;
    asm("max.u16x2 %0, %1, %2;" : "=r"(hi) : "r"(a), "r"(b));
    asm("min.u16x2 %0, %1, %2;" : "=r"(lo) : "r"(a), "r"(b));
    return __dp2a_lo(hi - lo, 0x0101u, acc);
}

// WPL: source words a lane holds in registers (1, 2, 4, 8, 16), or 0 for
// the generic body.
template <int WPL>
__global__ void __launch_bounds__(256)
probe16_previous_kernel(const uint16_t* __restrict__ stack,
                        const int* __restrict__ cand_y,
                        const int* __restrict__ cand_x,
                        const uint16_t* __restrict__ src,
                        const int* __restrict__ offs,  // [D, 2] (dx, dy)
                        const uint8_t* __restrict__ active,
                        int* __restrict__ out, ProbeParams p) {
    using T = uint16_t;
    constexpr int PPW = 2;                    // pixels a word
    constexpr int PB = 2;                     // bytes a pixel
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
    int row0 = 0, col0 = 0, step_r = 0, step_c = 0;
    if (WPL > 0) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const int wi = g + i * p.g;
            const int row = wi / p.wpr, c4 = PPW * (wi - row * p.wpr);
            soff[i] = (row * p.wp + c4) * PB;
            sw[i] = *(const uint32_t*)(s + row * p.bs_x + c4);
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
                    uint32_t v = ref_word(rb + soff[i], 3);
                    acc = sad16(v, sw[i], acc);
                }
            } else {
                int row = row0, col = col0;
                for (int wi = lane; wi < p.nw; wi += 32) {
                    const uint32_t sv = *(const uint32_t*)(
                        s + row * p.bs_x + PPW * col);
                    acc = sad16(
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

}  // namespace

extern "C" int mvt_probe16_previous(
        const void* stack, const void* cand_y, const void* cand_x,
        const void* src, const void* offs, const void* active, void* out,
        int n_jobs, int n_sub, int hp, int wp, int nblk, int row_len, int k,
        int d, int tile, int bs_y, int bs_x, int logp, int min_dy, int min_dx,
        int wy, int cxs, int wy_total, int wx_total, int center_y,
        int center_x, void* stream) {
    ProbeParams p = probe_params(
        n_jobs, n_sub, hp, wp, nblk, row_len, k, d, tile, bs_y, bs_x, logp,
        min_dy, min_dx, wy, cxs, wy_total, wx_total, center_y, center_x, 2);
    if (p.total == 0 || d == 0) return 0;
    int wpl = 0;
    if (p.nw <= 32 && pow2(p.nw)) {
        p.g = p.nw;
        wpl = 1;
    } else if (p.nw % 32 == 0 && pow2(p.nw / 32) && p.nw / 32 <= 16) {
        wpl = p.nw / 32;
    }
    const unsigned blocks = (unsigned)((p.total + 7) / 8);
    cudaStream_t st = (cudaStream_t)stream;
#define MVT_PREVIOUS(W)                                                     \
    probe16_previous_kernel<W><<<blocks, 256, 0, st>>>(                     \
        (const uint16_t*)stack, (const int*)cand_y, (const int*)cand_x,     \
        (const uint16_t*)src, (const int*)offs, (const uint8_t*)active,     \
        (int*)out, p)
    switch (wpl) {
        case 1: MVT_PREVIOUS(1); break;
        case 2: MVT_PREVIOUS(2); break;
        case 4: MVT_PREVIOUS(4); break;
        case 8: MVT_PREVIOUS(8); break;
        case 16: MVT_PREVIOUS(16); break;
        default: MVT_PREVIOUS(0); break;
    }
#undef MVT_PREVIOUS
    return (int)cudaGetLastError();
}
