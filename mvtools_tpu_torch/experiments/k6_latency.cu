// Two probes of the least dependent latency of one step of K6's level scan
// (csrc/exact_scan.cu), for k6_timing.py's latency bound.  A step cannot
// end before one load that misses L1 has come back from L2 and the CTA has
// summed a candidate's SAD and passed a barrier:
//
// * l2_chase: one thread follows a chain of indices through a buffer that
//   fits in L2 and not in L1, each load (ld.global.cg: L2 only) waiting for
//   the one before;
// * cta_reduce: a CTA of 256 threads (K6's) repeats what a step does after
//   its loads: two five-step xor-shuffle sums, lane 0 of each warp writes
//   its slot to shared memory (two buffers by round parity, as in K6), one
//   barrier, every thread reads the eight slots and takes their minimum,
//   which the next round depends on.
//
// Each is timed by CUDA events over many rounds (k6_timing.py).  The port
// does not build this file.

#include <cuda_runtime.h>

__global__ void l2_chase(const int* next, int steps, int* sink) {
    int i = 0;
    for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
    *sink = i;
}

__global__ void __launch_bounds__(256) cta_reduce(int rounds, int* sink) {
    __shared__ long long slot[2][8];    // two buffers by round parity
    int a = threadIdx.x, b = threadIdx.x * 3;
    long long m = 0;
    for (int r = 0; r < rounds; ++r) {
#pragma unroll
        for (int o = 16; o; o >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            b += __shfl_xor_sync(0xffffffffu, b, o);
        }
        long long* s = slot[r & 1];
        if ((threadIdx.x & 31) == 0)
            s[threadIdx.x >> 5] = (long long)a * 7 + b + m;
        __syncthreads();
        m = s[0];
        for (int w = 1; w < 8; ++w) m = s[w] < m ? s[w] : m;
        a = (int)(m & 1023) + threadIdx.x;
        b = (int)(m >> 10 & 1023);
    }
    if (threadIdx.x == 0) *sink = (int)m;
}

extern "C" int mvt_l2_chase(const void* next, int steps, void* sink,
                            void* stream) {
    l2_chase<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                (int*)sink);
    return (int)cudaGetLastError();
}

extern "C" int mvt_cta_reduce(int rounds, void* sink, void* stream) {
    cta_reduce<<<1, 256, 0, (cudaStream_t)stream>>>(rounds, (int*)sink);
    return (int)cudaGetLastError();
}
