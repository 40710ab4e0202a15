// The tile loop shared by the self-gram (gram.cu) and the cross gram
// (cross_gram.cu):
//   out[i, j] = sum_s sum_w popc(A[s, ia[i], w] & B[s, ib[j], w])
// for i < Ua, j < Ub, each operand read in place through its index array
// and its own shard and row strides (in words; the W words of a row are
// contiguous). The self-gram is the case A = B, ia = ib.
//
// Each block owns a 64 x 64 tile of outputs and a contiguous chunk of
// k-steps, one k-step being 32 words of one shard. Per step it stages the
// tile's 64 A rows and 64 B rows in shared memory, word-major with one
// word of padding so both the stores and the reads are free of bank
// conflicts. Each of the 256 threads keeps a 4 x 4 block of int32 sums in
// registers, and at the end adds them into out with atomicAdd. Integer
// atomics are exact in any order. The caller zeroes out and keeps every
// total within int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GRAM_TILE 64
#define GRAM_KW 32
#define GRAM_THREADS 256

// One operand: n rows, row i at bits + idx[i] * row_stride, shard s of it
// a further s * shard_stride words on.
struct PilosaGramOperand {
    const uint32_t* bits;
    long long shard_stride;
    long long row_stride;
    const int32_t* idx;
    int n;
};

__device__ __forceinline__ void pilosa_gram_tile(
    const PilosaGramOperand A, const PilosaGramOperand B,
    int32_t* __restrict__ out, int W, int tiles_b, long long steps_total,
    long long steps_per_chunk) {
    __shared__ uint32_t sA[GRAM_KW][GRAM_TILE + 1];
    __shared__ uint32_t sB[GRAM_KW][GRAM_TILE + 1];
    // word offset of each tile row's shard-0 words; -1 past the operand
    __shared__ long long offA[GRAM_TILE];
    __shared__ long long offB[GRAM_TILE];

    const int ti = blockIdx.x / tiles_b;
    const int tj = blockIdx.x % tiles_b;
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;

    for (int t = threadIdx.x; t < GRAM_TILE; t += GRAM_THREADS) {
        const int gi = ti * GRAM_TILE + t;
        const int gj = tj * GRAM_TILE + t;
        offA[t] = gi < A.n ? (long long)A.idx[gi] * A.row_stride : -1;
        offB[t] = gj < B.n ? (long long)B.idx[gj] * B.row_stride : -1;
    }
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    const long long wsteps = (W + GRAM_KW - 1) / GRAM_KW;
    const long long k0 = (long long)blockIdx.y * steps_per_chunk;
    long long k1 = k0 + steps_per_chunk;
    if (k1 > steps_total) k1 = steps_total;

    for (long long k = k0; k < k1; ++k) {
        const long long s = k / wsteps;
        const int w0 = (int)(k - s * wsteps) * GRAM_KW;
        const uint32_t* shardA = A.bits + s * A.shard_stride;
        const uint32_t* shardB = B.bits + s * B.shard_stride;
        // One warp loads one row's 32 consecutive words (128 bytes).
        for (int q = threadIdx.x; q < GRAM_TILE * GRAM_KW; q += GRAM_THREADS) {
            const int c = q % GRAM_KW;
            const int r = q / GRAM_KW;
            const int w = w0 + c;
            uint32_t va = 0, vb = 0;
            if (w < W) {
                const long long oa = offA[r];
                const long long ob = offB[r];
                if (oa >= 0) va = __ldg(shardA + oa + w);
                if (ob >= 0) vb = __ldg(shardB + ob + w);
            }
            sA[c][r] = va;
            sB[c][r] = vb;
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < GRAM_KW; ++c) {
            uint32_t a[4], b[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                a[t] = sA[c][ty + 16 * t];
                b[t] = sB[c][tx + 16 * t];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += __popc(a[i] & b[j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gi = ti * GRAM_TILE + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gj = tj * GRAM_TILE + tx + 16 * j;
            if (gi < A.n && gj < B.n && acc[i][j] != 0)
                atomicAdd(out + (size_t)gi * B.n + gj, acc[i][j]);
        }
    }
}

// Grid of a tile launch: (tiles_a * tiles_b) tiles by k-chunks, with
// enough chunks for about four blocks per SM even when one tile covers
// the whole output. Returns a CUDA error code.
static inline int pilosa_gram_grid(int Ua, int Ub, int S, int W, int device,
                                   dim3* grid, int* tiles_b,
                                   long long* steps_total,
                                   long long* steps_per_chunk) {
    int sms = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long tiles_a = (Ua + GRAM_TILE - 1) / GRAM_TILE;
    *tiles_b = (Ub + GRAM_TILE - 1) / GRAM_TILE;
    const long long tiles = tiles_a * (long long)*tiles_b;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    *steps_total = (long long)S * (long long)((W + GRAM_KW - 1) / GRAM_KW);
    long long chunks = (4LL * sms + tiles - 1) / tiles;
    if (chunks < 1) chunks = 1;
    if (chunks > *steps_total) chunks = *steps_total;
    if (chunks > 65535) chunks = 65535;
    *steps_per_chunk = (*steps_total + chunks - 1) / chunks;
    chunks = (*steps_total + *steps_per_chunk - 1) / *steps_per_chunk;
    *grid = dim3((unsigned)tiles, (unsigned)chunks);
    return (int)cudaSuccess;
}
