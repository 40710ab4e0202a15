// Self-gram with a fused row gather:
//   out[i, j] = sum_s sum_w popc(bits[s, idx[i], w] & bits[s, idx[j], w])
// for i, j < U. One launch answers a whole batch of Count(op(Row, Row))
// queries: every pair op is a formula over gram entries.
//
// Replaces: pilosa_tpu/ops/kernels.py, _gram_pallas_kernel (launched by
// _gram_matrix_pallas; the gather is fused the way _gram_gather_fused
// fuses it into one program).
//
// Bound on an H100: bytes. G is symmetric, so the function needs only
// U(U+1)/2 dot products of S * W * 32 bits, 2 int8-equivalent ops per bit:
// 6.98e11 ops at the serving shape (U = 64, S = 160, W = 32768), 0.35 ms
// at the 1,979 int8 TOP/s of the tensor cores, below the 0.40 ms that
// reading the 1.34 GB stack takes. This kernel does not use the tensor
// cores: it does U^2 * S * W AND+popc word operations (2.2e10 at that
// shape) on the integer units, whose popc rate (16 per SM per clock)
// makes it many times slower than that bound.
//
// Design: each block owns a 64 x 64 tile of outputs and a contiguous
// chunk of k-steps, one k-step being 32 words of one shard. Per step it
// stages the tile's 64 A rows and 64 B rows (read through idx, so no
// gathered [S, U, W] copy is made) in shared memory, word-major with one
// word of padding so both the stores and the reads are free of bank
// conflicts. Each of the 256 threads keeps a 4 x 4 block of int32 sums
// in registers, and at the end adds them into out with atomicAdd. Integer
// atomics are exact in any order. The k-steps are split into enough
// chunks to give every SM several blocks even when U <= 64 leaves one
// tile. The caller keeps every pair's total within int32 (it chunks the
// shard axis, pair_gram's _gram_int32_safe).
//
// Left for later: the tensor cores (unpack word tiles to int8 in shared
// memory and issue wgmma with s32 sums, or the binary mma with AND+popc),
// TMA loads into a ring of stages, using the symmetry of the gram to skip
// the lower triangle of tiles, and reading the diagonal tile's rows once.

#include <cuda_runtime.h>
#include <stdint.h>

#define GRAM_TILE 64
#define GRAM_KW 32
#define GRAM_THREADS 256

__global__ void __launch_bounds__(GRAM_THREADS)
pilosa_gram_kernel(const uint32_t* __restrict__ bits,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int R, int W, int U,
                   int tiles_per_side, long long steps_total,
                   long long steps_per_chunk) {
    __shared__ uint32_t sA[GRAM_KW][GRAM_TILE + 1];
    __shared__ uint32_t sB[GRAM_KW][GRAM_TILE + 1];
    __shared__ int rowA[GRAM_TILE];
    __shared__ int rowB[GRAM_TILE];

    const int ti = blockIdx.x / tiles_per_side;
    const int tj = blockIdx.x % tiles_per_side;
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;

    // Stack rows of this tile; -1 past the U-th output row.
    for (int t = threadIdx.x; t < GRAM_TILE; t += GRAM_THREADS) {
        const int gi = ti * GRAM_TILE + t;
        const int gj = tj * GRAM_TILE + t;
        rowA[t] = gi < U ? idx[gi] : -1;
        rowB[t] = gj < U ? idx[gj] : -1;
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
        // One warp loads one row's 32 consecutive words (128 bytes).
        for (int q = threadIdx.x; q < GRAM_TILE * GRAM_KW; q += GRAM_THREADS) {
            const int c = q % GRAM_KW;
            const int r = q / GRAM_KW;
            const int w = w0 + c;
            uint32_t va = 0, vb = 0;
            if (w < W) {
                const int ra = rowA[r];
                const int rb = rowB[r];
                if (ra >= 0) va = __ldg(bits + ((size_t)s * R + ra) * (size_t)W + w);
                if (rb >= 0) vb = __ldg(bits + ((size_t)s * R + rb) * (size_t)W + w);
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
            if (gi < U && gj < U && acc[i][j] != 0)
                atomicAdd(out + (size_t)gi * U + gj, acc[i][j]);
        }
    }
}

// out must be zeroed int32[U, U]; idx int32[U] with 0 <= idx[i] < R.
extern "C" int pilosa_gram_gather(const void* bits, const void* idx, void* out,
                                  int S, int R, int W, int U, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || R <= 0 || W <= 0 || U <= 0) return (int)cudaSuccess;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int tiles_per_side = (U + GRAM_TILE - 1) / GRAM_TILE;
    const long long tiles = (long long)tiles_per_side * tiles_per_side;
    const long long steps_total =
        (long long)S * (long long)((W + GRAM_KW - 1) / GRAM_KW);
    // Enough k-chunks for about four blocks per SM.
    long long chunks = (4LL * sms + tiles - 1) / tiles;
    if (chunks < 1) chunks = 1;
    if (chunks > steps_total) chunks = steps_total;
    if (chunks > 65535) chunks = 65535;
    const long long steps_per_chunk = (steps_total + chunks - 1) / chunks;
    chunks = (steps_total + steps_per_chunk - 1) / steps_per_chunk;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)tiles, (unsigned)chunks);
    pilosa_gram_kernel<<<grid, GRAM_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bits, (const int32_t*)idx, (int32_t*)out, R, W, U,
        tiles_per_side, steps_total, steps_per_chunk);
    return (int)cudaGetLastError();
}
