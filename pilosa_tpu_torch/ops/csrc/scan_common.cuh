// Shared pieces of the two row scans (row_scan.cu, masked_row_scan.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Threads per scan block: eight warps.
#define PILOSA_SCAN_THREADS 256

// Sum of v over the block; the total is valid in thread 0 only.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ int pilosa_block_sum(int v) {
    __shared__ int warp_sums[32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    if (lane == 0) warp_sums[wid] = v;
    __syncthreads();
    if (wid == 0) {
        v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

// Popcount of one row of W words, ANDed word by word with `mask` when
// MASKED. Threads stride the row in 16-byte groups when both pointers are
// 16-byte aligned and W is a multiple of 4 (every shard width the index
// supports), else word by word. Returns this thread's partial sum.
template <bool MASKED>
__device__ __forceinline__ int pilosa_row_popc(const uint32_t* __restrict__ row,
                                               const uint32_t* __restrict__ mask,
                                               int W) {
    int acc = 0;
    const bool vec = (W & 3) == 0 && (((uintptr_t)row) & 15) == 0 &&
                     (!MASKED || (((uintptr_t)mask) & 15) == 0);
    if (vec) {
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
        const uint4* m4 = reinterpret_cast<const uint4*>(mask);
        const int W4 = W >> 2;
        for (int i = threadIdx.x; i < W4; i += blockDim.x) {
            uint4 v = __ldg(r4 + i);
            if (MASKED) {
                const uint4 m = __ldg(m4 + i);
                v.x &= m.x; v.y &= m.y; v.z &= m.z; v.w &= m.w;
            }
            acc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
    } else {
        for (int i = threadIdx.x; i < W; i += blockDim.x) {
            uint32_t v = __ldg(row + i);
            if (MASKED) v &= __ldg(mask + i);
            acc += __popc(v);
        }
    }
    return acc;
}
