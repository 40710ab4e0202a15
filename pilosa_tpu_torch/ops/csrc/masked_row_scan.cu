// Masked row scan: out[s, r] = sum_w popc(bits[s, r, w] & filt[s, w]).
//
// Replaces: pilosa_tpu/ops/kernels.py, _masked_row_scan_kernel (launched by
// masked_row_counts_pallas); it answers filtered TopN.
//
// Bound on an H100: bytes. The stack is read once (1.34 GB at the serving
// shape, 160 x 64 x 32768 words) plus the S x W filter once; at 3.35 TB/s
// that is 0.40 ms. The AND and popc per word are far below the card's
// integer rate.
//
// Design: the row scan's, with the filter row ANDed in. Blocks are ordered
// blockIdx.x = s*R + r, so the R blocks of one shard run close together
// and read the same 128 KiB filter row from L2 rather than from memory.
//
// Left for later: the row scan's items, and keeping the filter row in
// shared memory for a block that walks several rows of its shard.

#include "scan_common.cuh"

__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_masked_row_scan_kernel(const uint32_t* __restrict__ bits,
                              const uint32_t* __restrict__ filt,
                              int32_t* __restrict__ out, int R, int W) {
    const size_t s = blockIdx.x / (unsigned)R;
    const uint32_t* row = bits + (size_t)blockIdx.x * (size_t)W;
    const uint32_t* mask = filt + s * (size_t)W;
    const int total = pilosa_block_sum(pilosa_row_popc<true>(row, mask, W));
    if (threadIdx.x == 0) out[blockIdx.x] = total;
}

extern "C" int pilosa_masked_row_scan(const void* bits, const void* filt,
                                      void* out, int S, int R, int W,
                                      int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long rows = (long long)S * (long long)R;
    if (rows <= 0 || W <= 0) return (int)cudaSuccess;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    pilosa_masked_row_scan_kernel<<<(unsigned)rows, PILOSA_SCAN_THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const uint32_t*)bits, (const uint32_t*)filt, (int32_t*)out, R, W);
    return (int)cudaGetLastError();
}
