// Self-gram with a fused row gather:
//   out[i, j] = sum_s sum_w popc(bits[s, idx[i], w] & bits[s, idx[j], w])
// for i, j < U. One launch answers a whole batch of Count(op(Row, Row))
// queries: every pair op is a formula over gram entries.
//
// Replaces: pilosa_tpu/ops/kernels.py, _gram_pallas_kernel (launched by
// _gram_matrix_pallas; the gather is fused the way _gram_gather_fused
// fuses it into one program). That kernel fed the MXU with int8 bit slabs
// unpacked in VMEM; this one feeds the packed words to the tensor cores
// as single-bit MMA (AND + popc), with no unpack.
//
// Bound on an H100: bytes. Reading the 1.34 GB stack at the serving shape
// (U = 64, S = 160, W = 32768) takes 0.40 ms at 3.35 TB/s. G is
// symmetric, so the function needs U(U+1)/2 dot products of S * W * 32
// bits; at the single-bit tensor-core rate measured on the card
// (chip_smoke.py) they take a tenth of that.
//
// Design: the tile loop of gram_tile.cuh with M = N, on the plan the
// wrapper chose (pilosa_tpu_torch/ops/kernels.py, gram_plan). U <= 64 is
// one 64 x tile_n tile whose N rows are the first tile_n of its M rows:
// one staged copy serves as both operands, so the stack is read once.
// U > 64 runs the upper-triangle 64 x 64 tiles (tri) and mirrors the
// off-diagonal ones in the epilogue; diagonal tiles stage their rows once.
// The k-slabs are split into enough chunks for every SM even when one
// tile covers the output. The caller keeps every pair's total within int32
// (it chunks the shard axis, pair_gram's _gram_int32_safe).
//
// Left for later: TMA loads with a producer warp, wgmma (its single-bit
// form measured 1.5x the mma.sync rate on the card, which the kernel does
// not need while bytes bound it), and a persistent grid.

#include "gram_tile.cuh"

// out must be zeroed int32[U, U]; idx int32[U] with 0 <= idx[i] < R.
// Plan: vec16 (16-byte copies), tri (upper-triangle 64 x 64 tiles, else
// one tile with U <= tile_n), tile_n in {8, 16, 32, 64}. A plan it cannot
// run returns cudaErrorInvalidValue.
extern "C" int pilosa_gram_gather(const void* bits, const void* idx, void* out,
                                  int S, int R, int W, int U, int device,
                                  void* stream, int vec16, int tri, int tile_n) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || R <= 0 || W <= 0 || U <= 0) return (int)cudaSuccess;
    const PilosaGramOperand op = {(const uint32_t*)bits, (long long)R * W,
                                  (long long)W, (const int32_t*)idx, U};
    if (vec16 && !pilosa_gram_vec16_ok(op, W)) return (int)cudaErrorInvalidValue;
    if (tri ? tile_n != 64 : U > tile_n) return (int)cudaErrorInvalidValue;
    int32_t* o = (int32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile_n) {
        case 8: return pilosa_gram_launch<64, 8, true>(op, op, o, U, 1, S, W, vec16, tri, device, st);
        case 16: return pilosa_gram_launch<64, 16, true>(op, op, o, U, 1, S, W, vec16, tri, device, st);
        case 32: return pilosa_gram_launch<64, 32, true>(op, op, o, U, 1, S, W, vec16, tri, device, st);
        case 64: return pilosa_gram_launch<64, 64, true>(op, op, o, U, 1, S, W, vec16, tri, device, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
