// The three block statistics of the SATD cost modes (dct 5-10), shared by
// the three-stat forms of the two probes (the three-stat SAD map forms them
// from transform tables of its own, csrc/sadmap.cu::sadmap3_kernel).
//
// Replaces the in-kernel stat body of the TPU kernels,
// mvtools_tpu/ops/probe.py::_eval_offsets / _kernel_satd.
//
// For a source block S and a reference block R of bs_y x bs_x 8-bit pixels:
//
//   sad  = sum |S - R|
//   luma = sum R
//   satd = the reference's scalar composition (Satd_C,
//          SADFunctions.cpp:713-741): the block is cut into 8x4 partitions;
//          a partition is two 4x4 tiles side by side, each transformed by the
//          unnormalised 4x4 Hadamard H D H^T; the two tiles' sums of absolute
//          coefficients are added and THEN halved (>> 1), and the partitions'
//          halves are summed.  A 4x4 block is one tile, halved.
//
// Everything is int32 (a coefficient is at most 16 * 255, a 32x32 block's
// sum at most 64 * 16 * 16 * 255).
//
// Work split: a GROUP of G lanes (G a power of two, 1..32, the same for a
// whole launch) owns one block; a lane takes whole 8x4 partitions, G apart,
// so the >> 1 needs no exchange between lanes; the group's partial sums are
// then added with xor shuffles that stay inside the group.  Every lane of a
// warp must call block_stats3 (the shuffles are warp-wide); a lane whose
// group has no block passes active = false and contributes nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mvt {

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

}  // namespace mvt
