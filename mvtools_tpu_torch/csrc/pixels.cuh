// Pixels packed in 32-bit words, for the SAD kernels that sum a word of
// pixels at a time: probe.cu's 8-bit tiled probe and sadmap.cu's 8-bit sad
// map.
//
// PixWord<T> for the pixel type T of a stack (uint8_t): PPW pixels a word
// (LOG_PPW its log), SH bits a pixel, and sad(), the sum of |a - b| over the
// pixels of two words added into a 32-bit accumulator: VABSDIFF4.U8 and one
// IDP.4A for four pixels.
//
// The uint16 kernels do not sum |a - b| word by word: they take
// sum S + sum R - 2 sum min(S, R).  The sad map spends one min.u16x2 and one
// IDP.2A a word, the two sums made once per block and per window position
// (sadmap.cu::sadmap16_kernel); the tiled probe one min.u16x2 and two IDP.2A
// (sum R and sum min), sum S once per block (probe.cu::probe16_kernel).
// No partial sum is kept in 16 bits: two differences of 65 535 would
// overflow it.

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

}  // namespace mvt
