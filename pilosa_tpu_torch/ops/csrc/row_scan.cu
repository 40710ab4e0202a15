// Row scan: out[s, r] = sum_w popc(bits[s, r, w]).
//
// Replaces: pilosa_tpu/ops/kernels.py, _row_scan_kernel (launched by
// row_counts_per_shard_pallas).
//
// Bound on an H100: bytes. Each word is read once and feeds one popc and
// one add, far below the card's integer rate, so the least time is the
// stack's size over the memory rate: 1.34 GB (160 shards x 64 rows x
// 32768 words) at 3.35 TB/s is 0.40 ms.
//
// Design: one block of 256 threads per (s, r) row, blockIdx.x = s*R + r.
// Threads walk the row in 16-byte groups (neighbouring threads on
// neighbouring addresses), popc each word, then reduce with warp shuffles
// and one shared-memory pass; thread 0 writes the row's count. The grid
// covers every row exactly, so S needs no padding and W no word blocks.
//
// Left for later: several rows per block when rows are short (W < 1024
// words leaves most threads idle), and a persistent grid so one row's
// reduction overlaps the next row's loads.

#include "scan_common.cuh"

__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_row_scan_kernel(const uint32_t* __restrict__ bits,
                       int32_t* __restrict__ out, int W) {
    const uint32_t* row = bits + (size_t)blockIdx.x * (size_t)W;
    const int total = pilosa_block_sum(pilosa_row_popc<false>(row, nullptr, W));
    if (threadIdx.x == 0) out[blockIdx.x] = total;
}

extern "C" int pilosa_row_scan(const void* bits, void* out, int S, int R, int W,
                               int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long rows = (long long)S * (long long)R;
    if (rows <= 0 || W <= 0) return (int)cudaSuccess;
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    pilosa_row_scan_kernel<<<(unsigned)rows, PILOSA_SCAN_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)bits, (int32_t*)out, W);
    return (int)cudaGetLastError();
}

// The runtime's message for an error code the entry points returned.
extern "C" const char* pilosa_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
