// Rate probe of the card's tensor-core instructions for a popcount dot
// product: single-bit AND + popc, which NVIDIA's data sheet does not give,
// and int8 beside it. chip_smoke.py times one launch with CUDA events and
// divides the multiply-adds it does, to bound the grams by their
// operations and to show why they take the single-bit route. No kernel of
// the serving path calls it.
//   kind 0: mma.sync.m16n8k256.b1.and.popc, what gram_tile.cuh issues;
//   kind 1: wgmma.m64n64k256.b1.and.popc, the warpgroup form;
//   kind 2: mma.sync.m16n8k32.s8;
//   kind 3: wgmma.m64n64k32.s8.
// mma.sync: 8 warps per block, 8 independent sums per warp, operands in
// registers. wgmma: 2 warpgroups per block, operands in shared memory.
// One block per SM, iters loop trips per warp or warpgroup; the sums go
// to sink so nothing is optimised away.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_ACC 8

template <bool B1>
__global__ void __launch_bounds__(256) pilosa_probe_mma(int iters, int* sink) {
    uint32_t a[4], b[2];
    for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 2654435761u + i;
    for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 40503u + i;
    int acc[PROBE_ACC][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < PROBE_ACC; ++j) {
            if (B1)
                asm volatile(
                    "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                    : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
                    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
            else
                asm volatile(
                    "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                    : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
                    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
        }
    }
    int s = 0;
    for (int j = 0; j < PROBE_ACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    if (s == 0x7eadbeef) sink[0] = s;
}

__device__ __forceinline__ uint64_t pilosa_probe_desc(const void* p) {
    // no swizzle; 8-row core matrices of 16 bytes, 128 B apart along K and
    // 256 B apart along M/N
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(256 >> 4) << 32);
}

#define PILOSA_PROBE_D32                                                          \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
    "%30, %31}, %32, %33, p;\n}\n"
#define PILOSA_PROBE_OUTS                                                         \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),       \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),          \
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),          \
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),          \
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])

// Each instruction reads 32 bytes of each of 64 rows: k256 bits or k32 int8.
template <bool B1>
__global__ void __launch_bounds__(256) pilosa_probe_wgmma(int iters, int* sink) {
    __shared__ __align__(1024) uint8_t sa[4][64 * 32];
    __shared__ __align__(1024) uint8_t sb[4][64 * 32];
    for (int i = threadIdx.x; i < 4 * 64 * 32; i += blockDim.x) {
        (&sa[0][0])[i] = (uint8_t)i;
        (&sb[0][0])[i] = (uint8_t)(i * 7);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    int d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const uint64_t da = pilosa_probe_desc(sa[s]), db = pilosa_probe_desc(sb[s]);
            if (B1)
                asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                             "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
                             PILOSA_PROBE_D32
                             : PILOSA_PROBE_OUTS
                             : "l"(da), "l"(db), "r"(1));
            else
                asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                             "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                             PILOSA_PROBE_D32
                             : PILOSA_PROBE_OUTS
                             : "l"(da), "l"(db), "r"(1));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    int s = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) s += d[i];
    if (s == 0x7eadbeef) sink[0] = s;
}

// Launch one probe (kind 0-3) of iters trips on every SM; *macs gets the
// multiply-adds it does (single-bit or int8). sink is any device int.
extern "C" int pilosa_mma_rate_probe(int kind, int iters, void* sink, int device,
                                     void* stream, long long* macs) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    int* out = (int*)sink;
    const long long per_mma = (long long)sms * 8 * iters * PROBE_ACC * 16 * 8;
    const long long per_wgmma = (long long)sms * 2 * iters * 4 * 64 * 64;
    switch (kind) {
        case 0: pilosa_probe_mma<true><<<sms, 256, 0, st>>>(iters, out); *macs = per_mma * 256; break;
        case 1: pilosa_probe_wgmma<true><<<sms, 256, 0, st>>>(iters, out); *macs = per_wgmma * 256; break;
        case 2: pilosa_probe_mma<false><<<sms, 256, 0, st>>>(iters, out); *macs = per_mma * 32; break;
        case 3: pilosa_probe_wgmma<false><<<sms, 256, 0, st>>>(iters, out); *macs = per_wgmma * 32; break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
