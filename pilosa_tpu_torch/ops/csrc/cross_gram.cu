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
// Bound on an H100: bytes. At the two-field serving shape (Ua = Ub = 64
// over two 160 x 64 x 32768-word stacks) reading both stacks once is
// 2.684e9 B, 0.80 ms at 3.35 TB/s; at the 3-level GroupBy's second level
// (Ua = 256 prefix masks, Ub = 64) 6.71e9 B, 2.00 ms. Their AND+popc work
// takes a fraction of that at the single-bit tensor-core rate measured on
// the card (chip_smoke.py).
//
// Design: the single-bit MMA tile loop of gram_tile.cuh (shared with
// gram.cu) on the plan the wrapper chose (pilosa_tpu_torch/ops/kernels.py,
// cross_gram_plan). The larger side goes on the MMA's M and the smaller on
// N (swap, with the epilogue writing the transpose), so a 4-row side fills
// one 8-wide N tile instead of 4 of 64 M rows, and the C = 256 level is one
// 256 x 64 tile that reads each operand's k-slab once. Tiles are 64 x
// {8, 16, 32, 64}, 128 x 64 or 256 x 64. The k-slabs are split into
// enough chunks for every SM, with int32 atomicAdd into a zeroed output.
// The caller keeps each total within int32 (cross_pair_gram chunks the
// shard axis; combo_counts_gram declines).
//
// Left for later: TMA loads with a producer warp, wgmma, and a persistent
// grid.

#include "gram_tile.cuh"

// out must be zeroed int32[Ua, Ub]; ia int32[Ua] indexes A's rows and ib
// int32[Ub] B's, each within its operand. Strides are in words. Plan:
// swap (B on the MMA's M side), vec16 (16-byte copies), and the tile
// tile_m x tile_n, one of 64 x {8, 16, 32, 64}, 128 x 64, 256 x 64. A plan
// it cannot run returns cudaErrorInvalidValue.
extern "C" int pilosa_cross_gram_gather(
    const void* a, long long a_shard_stride, long long a_row_stride,
    const void* ia, int Ua, const void* b, long long b_shard_stride,
    long long b_row_stride, const void* ib, int Ub, void* out, int S, int W,
    int device, void* stream, int swap, int vec16, int tile_m, int tile_n) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || W <= 0 || Ua <= 0 || Ub <= 0) return (int)cudaSuccess;
    const PilosaGramOperand A = {(const uint32_t*)a, a_shard_stride,
                                 a_row_stride, (const int32_t*)ia, Ua};
    const PilosaGramOperand B = {(const uint32_t*)b, b_shard_stride,
                                 b_row_stride, (const int32_t*)ib, Ub};
    if (vec16 && !(pilosa_gram_vec16_ok(A, W) && pilosa_gram_vec16_ok(B, W)))
        return (int)cudaErrorInvalidValue;
    const PilosaGramOperand& M = swap ? B : A;
    const PilosaGramOperand& N = swap ? A : B;
    // out[i, j] at i * Ub + j: D[m, n] is out[m, n], or out[n, m] swapped
    const long long osm = swap ? 1 : Ub;
    const long long osn = swap ? Ub : 1;
    int32_t* o = (int32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (tile_m == 64) {
        switch (tile_n) {
            case 8: return pilosa_gram_launch<64, 8, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
            case 16: return pilosa_gram_launch<64, 16, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
            case 32: return pilosa_gram_launch<64, 32, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
            case 64: return pilosa_gram_launch<64, 64, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
        }
    } else if (tile_n == 64) {
        switch (tile_m) {
            case 128: return pilosa_gram_launch<128, 64, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
            case 256: return pilosa_gram_launch<256, 64, false>(M, N, o, osm, osn, S, W, vec16, 0, device, st);
        }
    }
    return (int)cudaErrorInvalidValue;
}
