// Pixels packed in 32-bit words, for the SAD kernels that sum a word of
// pixels at a time (sadmap.cu's sad map, probe.cu's tiled probe).
//
// PixWord<T> for the pixel type T of a stack (uint8_t, or uint16_t for 9- to
// 16-bit clips): PPW pixels a word (LOG_PPW its log), SH bits a pixel, and
// sad(), the sum of |a - b| over the pixels of two words added into a 32-bit
// accumulator.
//
//   8-bit:  four pixels; VABSDIFF4.U8 and one IDP.4A, as before.
//   16-bit: two pixels; |a - b| per half as max.u16x2 - min.u16x2 (each half
//           of the maximum is at least that of the minimum, so no borrow
//           crosses the halves; VIMNMX.U16x2 is native on sm_90), the two
//           halves added by one IDP.2A.  No partial sum is kept in 16 bits:
//           two differences of 65 535 would overflow it.  The largest block
//           sum the search admits (a 16x16 block of 0 against one of 65 535,
//           16 776 960) fits the accumulator with room.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mvt {

template <typename T>
struct PixWord;

template <>
struct PixWord<uint8_t> {
    static constexpr int PPW = 4, LOG_PPW = 2, SH = 8;
    static __device__ __forceinline__ unsigned sad(uint32_t a, uint32_t b,
                                                   unsigned acc) {
        return __dp4a(__vabsdiffu4(a, b), 0x01010101u, acc);
    }
};

template <>
struct PixWord<uint16_t> {
    static constexpr int PPW = 2, LOG_PPW = 1, SH = 16;
    static __device__ __forceinline__ unsigned sad(uint32_t a, uint32_t b,
                                                   unsigned acc) {
        uint32_t hi, lo;
        asm("max.u16x2 %0, %1, %2;" : "=r"(hi) : "r"(a), "r"(b));
        asm("min.u16x2 %0, %1, %2;" : "=r"(lo) : "r"(a), "r"(b));
        return __dp2a_lo(hi - lo, 0x0101u, acc);
    }
};

}  // namespace mvt
