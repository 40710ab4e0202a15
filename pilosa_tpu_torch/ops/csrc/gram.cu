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
// Design: the 64 x 64 tile loop of gram_tile.cuh with A = B, reading the
// rows through idx, so no gathered [S, U, W] copy is made. The k-steps
// are split into enough chunks to give every SM several blocks even when
// U <= 64 leaves one tile. The caller keeps every pair's total within
// int32 (it chunks the shard axis, pair_gram's _gram_int32_safe).
//
// Left for later: the tensor cores (unpack word tiles to int8 in shared
// memory and issue wgmma with s32 sums, or the binary mma with AND+popc),
// TMA loads into a ring of stages, using the symmetry of the gram to skip
// the lower triangle of tiles, and reading the diagonal tile's rows once.

#include "gram_tile.cuh"

__global__ void __launch_bounds__(GRAM_THREADS)
pilosa_gram_kernel(const PilosaGramOperand op, int32_t* __restrict__ out,
                   int W, int tiles_b, long long steps_total,
                   long long steps_per_chunk) {
    pilosa_gram_tile(op, op, out, W, tiles_b, steps_total, steps_per_chunk);
}

// out must be zeroed int32[U, U]; idx int32[U] with 0 <= idx[i] < R.
extern "C" int pilosa_gram_gather(const void* bits, const void* idx, void* out,
                                  int S, int R, int W, int U, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || R <= 0 || W <= 0 || U <= 0) return (int)cudaSuccess;
    dim3 grid;
    int tiles_b = 0;
    long long steps_total = 0, steps_per_chunk = 0;
    const int code = pilosa_gram_grid(U, U, S, W, device, &grid, &tiles_b,
                                      &steps_total, &steps_per_chunk);
    if (code != (int)cudaSuccess) return code;
    const PilosaGramOperand op = {(const uint32_t*)bits, (long long)R * W,
                                  (long long)W, (const int32_t*)idx, U};
    pilosa_gram_kernel<<<grid, GRAM_THREADS, 0, (cudaStream_t)stream>>>(
        op, (int32_t*)out, W, tiles_b, steps_total, steps_per_chunk);
    return (int)cudaGetLastError();
}
