// The three block statistics of the SATD cost modes (dct 5-10), and the
// 4x4 Hadamard transforms in biased 16-bit halves that the three-stat forms
// of the SAD map (K1', csrc/sadmap.cu::sadmap3_kernel) and of the tiled
// probe (K2', csrc/probe.cu::probe_stats3_kernel) build them from.
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
// The transforms (K1', K2').  By linearity, H(S - R) = H(S) - H(R), so a
// source tile's transform is made once and set against each reference
// tile's.  Coefficients are unsigned 16-bit halves of 32-bit words, each
// biased by Z (an 8-bit tile's coefficients lie in [-2040, 2040], its DC in
// [0, 4080], so a biased value lies in [Z - 4080, Z + 4080] and no half can
// carry into the other).  With u = H + Z,
//
//   sum |H(S) - H(R)| over a tile = sum u_S + sum u_R - 2 sum min(u_S, u_R)
//
// and sum u over a tile = 16 * (its top-left pixel) + 16 Z (the columns of
// the 4-point Hadamard sum to (4, 0, 0, 0)).  A tile's sum of |coefficients|
// is even (every coefficient has the parity of the tile's pixel sum), so its
// half is exact, and the SATD of a block is the sum over its tiles of
//
//   8 (S00 + R00) + 16 Z - sum over the tile's 8 words of (min.lo + min.hi)
//
// one VIMNMX.U16x2 and one IDP.2A per two coefficients: an 8x4 partition
// halves the sum of its two tiles, which is the sum of their halves.
//
// block_stats3 (K4') takes the transform of S - R instead: a GROUP of G
// lanes (G a power of two, 1..32, the same for a whole launch) owns one
// block; a lane takes whole 8x4 partitions, G apart, so the >> 1 needs no
// exchange between lanes; the group's partial sums are then added with xor
// shuffles that stay inside the group.  Every lane of a warp must call
// block_stats3 (the shuffles are warp-wide); a lane whose group has no
// block passes active = false and contributes nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mvt {

constexpr uint32_t ZB = 16384u;                 // the bias Z
constexpr uint32_t ZP = ZB | (ZB << 16);        // Z in both halves

__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// The 4-point Hadamard of one row of four pixels (bytes of w, in order):
// A = (c0 | c1 << 16), B = (c2 | c3 << 16), each biased by Z, in the order
// of ops/sad.py::_hadamard4.
__device__ __forceinline__ void row_pass(uint32_t w, uint32_t& A,
                                         uint32_t& B) {
    const uint32_t e = __byte_perm(w, 0u, 0x4240);   // (p0, p2)
    const uint32_t f = __byte_perm(w, 0u, 0x4341);   // (p1, p3)
    const uint32_t g = e + f + ZP;                   // (s0, s2)
    const uint32_t k = e - f + ZP;                   // (s1, s3)
    const uint32_t pp = __byte_perm(g, k, 0x5410);   // (s0, s1)
    const uint32_t qq = __byte_perm(g, k, 0x7632);   // (s2, s3)
    A = pp + qq - ZP;
    B = pp - qq + ZP;
}

// The 4-point Hadamard down four rows of biased words, in place.
__device__ __forceinline__ void col_pass(uint32_t& a, uint32_t& b,
                                         uint32_t& c, uint32_t& e) {
    const uint32_t s0 = a + b - ZP, s1 = a - b + ZP;
    const uint32_t s2 = c + e - ZP, s3 = c - e + ZP;
    a = s0 + s2 - ZP; b = s1 + s3 - ZP;
    c = s0 - s2 + ZP; e = s1 - s3 + ZP;
}

// The 8 words of the transform of the 4x4 tile whose rows are the words
// w[0..3] (pixels in byte order), stored as two uint4 at dst.
__device__ __forceinline__ void tile_words(const uint32_t (&w)[4],
                                           uint4* dst) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) row_pass(w[y], a[y], b[y]);
    col_pass(a[0], a[1], a[2], a[3]);
    col_pass(b[0], b[1], b[2], b[3]);
    dst[0] = make_uint4(a[0], a[1], a[2], a[3]);
    dst[1] = make_uint4(b[0], b[1], b[2], b[3]);
}


// The transform of a 4x4 tile into registers: h[0..3] the A words of rows
// 0..3 after the column pass, h[4..7] the B words (tile_words' order).
__device__ __forceinline__ void tile_hadamard(const uint32_t (&w)[4],
                                              uint32_t (&h)[8]) {
#pragma unroll
    for (int y = 0; y < 4; ++y) row_pass(w[y], h[y], h[4 + y]);
    col_pass(h[0], h[1], h[2], h[3]);
    col_pass(h[4], h[5], h[6], h[7]);
}

// One 4x4 tile of a K2' entry: the reference rows r[0..3] (pixels in byte
// order) against the source rows sw and the source transform hs; adds the
// tile's SAD and reference sum to sad and luma, and its SATD part less the
// source constant (8 S00 + 16 Z, which the caller adds once) to sat.
__device__ __forceinline__ void tile_stats3(const uint32_t (&r)[4],
                                            const uint32_t (&sw)[4],
                                            const uint32_t (&hs)[8],
                                            unsigned& sad, int& sat,
                                            unsigned& luma) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        sad = __dp4a(__vabsdiffu4(r[y], sw[y]), 0x01010101u, sad);
        luma = __dp4a(r[y], 0x01010101u, luma);
    }
    sat = (int)__dp4a(r[0], 8u, (unsigned)sat);          // + 8 R00
    uint32_t hr[8];
    tile_hadamard(r, hr);
    // - sum (min.lo + min.hi): halves are below 2^15, so the signed two-way
    // product with bytes (-1, -1) subtracts both
#pragma unroll
    for (int k = 0; k < 8; ++k)
        sat = __dp2a_lo((int)min_u16x2(hs[k], hr[k]), 0xffff, sat);
}

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
