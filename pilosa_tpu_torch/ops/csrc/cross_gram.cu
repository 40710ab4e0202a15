// Cross gram over row subsets of two operands, both gathers fused:
//   out[i, j] = sum_s sum_w popc(A[s, ia[i], w] & B[s, ib[j], w])
// as int32[Ua, Ub]. One launch gives every combination count of a
// two-field GroupBy(Rows(f), Rows(g)), and one level of the k-level
// GroupBy (A = the running prefix masks, B = the level's field stack).
//
// Replaces: pilosa_tpu/ops/kernels.py, _cross_gram_pallas_kernel
// (launched by _cross_gram_pallas; its callers cross_gram_gather,
// cross_pair_gram and combo_counts_gram gather and, for the prefix,
// transpose the operands first). This kernel reads each operand in place
// through a pointer, a shard stride and a row stride in words: a field
// stack [S, R, W] with strides (R*W, W), the k-level prefix [C, S, W]
// with strides (W, S*W). No gathered or transposed copy is made.
//
// Bound on an H100: at the two-field serving shape (Ua = Ub = 64 over two
// 160 x 64 x 32768-word stacks) reading both stacks once is 2.684e9 B,
// 0.80 ms at 3.35 TB/s; the 2 * Ua * Ub * S * W * 32 = 1.37e12
// int8-equivalent ops take 0.69 ms at the 1,979 int8 TOP/s of the tensor
// cores, so bytes bound it. The 3-level GroupBy's second level (Ua = 256
// prefix masks, Ub = 64) is bound by its ops: 5.5e12, 2.78 ms. This
// kernel does not use the tensor cores: it does Ua * Ub * S * W AND+popc
// word operations on the integer units (2.15e10 at the two-field shape,
// the same as the gram), at about 16 popc per SM per clock, so it runs
// many times slower than either bound.
//
// Design: the 64 x 64 tile loop of gram_tile.cuh (shared with gram.cu),
// over tiles_a x tiles_b output tiles, with the k-steps (32 words of one
// shard) split into enough chunks for about four blocks per SM, and int32
// atomicAdd into a zeroed output. The caller keeps each total within
// int32 (cross_pair_gram chunks the shard axis; combo_counts_gram
// declines).
//
// Left for later: the tensor cores (int8 unpack in shared memory and
// wgmma with s32 sums, or the binary mma with AND+popc), TMA loads into a
// ring of stages, and tiles shaped for a small Ua: the first k-level step
// of a GroupBy over a 4-row field fills 4 of a tile's 64 A rows, so 15/16
// of its popc work is on zeros.

#include "gram_tile.cuh"

__global__ void __launch_bounds__(GRAM_THREADS)
pilosa_cross_gram_kernel(const PilosaGramOperand A, const PilosaGramOperand B,
                         int32_t* __restrict__ out, int W, int tiles_b,
                         long long steps_total, long long steps_per_chunk) {
    pilosa_gram_tile(A, B, out, W, tiles_b, steps_total, steps_per_chunk);
}

// out must be zeroed int32[Ua, Ub]; ia int32[Ua] indexes A's rows and ib
// int32[Ub] B's, each within its operand. Strides are in words.
extern "C" int pilosa_cross_gram_gather(
    const void* a, long long a_shard_stride, long long a_row_stride,
    const void* ia, int Ua, const void* b, long long b_shard_stride,
    long long b_row_stride, const void* ib, int Ub, void* out, int S, int W,
    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || W <= 0 || Ua <= 0 || Ub <= 0) return (int)cudaSuccess;
    dim3 grid;
    int tiles_b = 0;
    long long steps_total = 0, steps_per_chunk = 0;
    const int code = pilosa_gram_grid(Ua, Ub, S, W, device, &grid, &tiles_b,
                                      &steps_total, &steps_per_chunk);
    if (code != (int)cudaSuccess) return code;
    const PilosaGramOperand A = {(const uint32_t*)a, a_shard_stride,
                                 a_row_stride, (const int32_t*)ia, Ua};
    const PilosaGramOperand B = {(const uint32_t*)b, b_shard_stride,
                                 b_row_stride, (const int32_t*)ib, Ub};
    pilosa_cross_gram_kernel<<<grid, GRAM_THREADS, 0, (cudaStream_t)stream>>>(
        A, B, (int32_t*)out, W, tiles_b, steps_total, steps_per_chunk);
    return (int)cudaGetLastError();
}
