// The tile loop shared by the self-gram (gram.cu) and the cross gram
// (cross_gram.cu):
//   D[m, n] = sum_s sum_w popc(M[s, im[m], w] & N[s, in[n], w])
// for m < M.n, n < N.n, each operand read in place through its index array
// and its own shard and row strides (in words; the W words of a row are
// contiguous). The self-gram is the case M = N.
//
// The product runs on the tensor cores as single-bit MMA,
// mma.sync.m16n8k256.and.popc (BMMA in SASS): one instruction ANDs a
// 16 x 256-bit A tile with an 8 x 256-bit B tile and adds the popcounts
// into 16 x 8 int32 sums. A 256-bit k-step of a row is 8 consecutive
// words, so the packed stack feeds the tensor cores as it is.
//
// A block owns a TM x TN output tile and a contiguous chunk of k-slabs, a
// slab being 32 words (4 k-steps) of one shard. Slabs stream through a
// ring of GRAM_STAGES shared-memory stages filled by cp.async (16-byte
// copies when base, strides and W allow it, else 4-byte ones), gathered
// through the index arrays; words past W and rows past the operand are
// zero-filled, and AND with zero adds nothing. One __syncthreads per slab.
// A row's 128 bytes of a stage are 8 chunks of 16 bytes stored at chunk
// c ^ (row & 7), so both the copies and the ldmatrix reads that build the
// MMA fragments are free of bank conflicts. On a tile of the self-gram
// whose M and N rows are the same (the diagonal), one staged copy serves
// as both operands, so those rows are read once.
//
// The epilogue adds each int32 sum into out[m * osm + n * osn] with
// atomicAdd (exact in any order); the caller zeroes out and keeps every
// total within int32. Swapped strides write the transpose, and a
// triangular self-gram also adds each sum of an off-diagonal tile at the
// mirrored place.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GRAM_KW 32                   // words of a row in one stage (4 k-steps)
#define GRAM_ROW_BYTES (GRAM_KW * 4)
#define GRAM_CHUNKS (GRAM_KW / 4)    // 16-byte chunks of a stage row
#define GRAM_STAGES 4
// the swizzle c ^ (row & 7) stays inside a row of at least 8 chunks
static_assert(GRAM_CHUNKS >= 8 && GRAM_CHUNKS % 8 == 0, "stage row width");

// One operand: n rows, row i at bits + idx[i] * row_stride, shard s of it
// a further s * shard_stride words on.
struct PilosaGramOperand {
    const uint32_t* bits;
    long long shard_stride;
    long long row_stride;
    const int32_t* idx;
    int n;
};

// Warps of a TM x TN tile: each warp owns (16 * MI) x (8 * NI) outputs.
template <int TM, int TN>
struct PilosaGramShape {
    static constexpr int WARPS_N = TN >= 64 ? 2 : 1;
    static constexpr int WARPS_M = (TN >= 64 && TM == 64) ? 2 : 4;
    static constexpr int MI = TM / (16 * WARPS_M);
    static constexpr int NI = TN / (8 * WARPS_N);
    static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
    static constexpr int ROWS = TM + TN;
    static constexpr int STAGE_BYTES = ROWS * GRAM_ROW_BYTES;
    static constexpr int SMEM_BYTES = GRAM_STAGES * STAGE_BYTES;
    static_assert(MI >= 1 && NI >= 1 && (NI == 1 || NI % 2 == 0), "tile shape");
};

__device__ __forceinline__ uint32_t pilosa_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of stage row r (the XOR swizzle).
__device__ __forceinline__ uint32_t pilosa_chunk(int r, int c) {
    return (uint32_t)(r * GRAM_ROW_BYTES + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void pilosa_cp16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void pilosa_cp4(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void pilosa_cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void pilosa_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void pilosa_ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                               uint32_t& r2, uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void pilosa_ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// d += popc(a & b) over one 16 x 8 x 256-bit step.
__device__ __forceinline__ void pilosa_bmma(int* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// tri: blockIdx.x walks the tiles tm <= tn of a self-gram (tiles_n per
// side), and off-diagonal sums are mirrored; else it is tm * tiles_n + tn.
template <int TM, int TN, bool SELF>
__global__ void __launch_bounds__(PilosaGramShape<TM, TN>::THREADS)
pilosa_gram_tiles(const PilosaGramOperand Mop, const PilosaGramOperand Nop,
                  int32_t* __restrict__ out, long long osm, long long osn, int W,
                  int vec16, int tri, int tiles_n, long long steps_total,
                  long long steps_per_chunk) {
    using Sh = PilosaGramShape<TM, TN>;
    extern __shared__ __align__(128) uint8_t pilosa_gram_smem[];
    // each stage row's shard-0 words; null past the operand
    __shared__ const uint32_t* rowp[Sh::ROWS];

    int tm, tn;
    if (tri) {
        int b = blockIdx.x;
        tm = 0;
        while (b >= tiles_n - tm) {
            b -= tiles_n - tm;
            ++tm;
        }
        tn = tm + b;
    } else {
        tm = blockIdx.x / tiles_n;
        tn = blockIdx.x % tiles_n;
    }
    // a self-gram tile whose N rows are the first TN of its M rows
    const bool diag = SELF && tm * TM == tn * TN;
    const int rows = diag ? TM : Sh::ROWS;

    for (int r = threadIdx.x; r < Sh::ROWS; r += Sh::THREADS) {
        const uint32_t* p = nullptr;
        if (r < TM) {
            const int g = tm * TM + r;
            if (g < Mop.n) p = Mop.bits + (long long)Mop.idx[g] * Mop.row_stride;
        } else {
            const int g = tn * TN + (r - TM);
            if (g < Nop.n) p = Nop.bits + (long long)Nop.idx[g] * Nop.row_stride;
        }
        rowp[r] = p;
    }
    __syncthreads();

    const long long k0 = (long long)blockIdx.y * steps_per_chunk;
    const long long k1 = k0 + steps_per_chunk < steps_total ? k0 + steps_per_chunk : steps_total;
    const int nk = (int)(k1 - k0);
    const long long wsteps = (W + GRAM_KW - 1) / GRAM_KW;
    // the next slab to load: shard ls, first word lw
    long long ls = k0 / wsteps;
    int lw = (int)(k0 - ls * wsteps) * GRAM_KW;

    // (plain locals: a lambda that referenced the parameters would copy
    // them to the stack)
    const uint32_t* const any = Mop.bits;  // a valid address for empty copies
    const long long mss = Mop.shard_stride, nss = Nop.shard_stride;
    auto load = [&](int st) {
        const uint32_t base = pilosa_smem_addr(pilosa_gram_smem + st * Sh::STAGE_BYTES);
        const long long offm = ls * mss;
        const long long offn = ls * nss;
        if (vec16) {
            for (int q = threadIdx.x; q < rows * GRAM_CHUNKS; q += Sh::THREADS) {
                const int r = q / GRAM_CHUNKS, c = q % GRAM_CHUNKS;
                const uint32_t* p = rowp[r];
                const int w = lw + c * 4;
                const bool ok = p != nullptr && w < W;
                const uint32_t* src = ok ? p + (r < TM ? offm : offn) + w : any;
                pilosa_cp16(base + pilosa_chunk(r, c), src, ok ? 16 : 0);
            }
        } else {
            for (int q = threadIdx.x; q < rows * GRAM_KW; q += Sh::THREADS) {
                const int r = q / GRAM_KW, j = q % GRAM_KW;
                const uint32_t* p = rowp[r];
                const int w = lw + j;
                const bool ok = p != nullptr && w < W;
                const uint32_t* src = ok ? p + (r < TM ? offm : offn) + w : any;
                pilosa_cp4(base + pilosa_chunk(r, j >> 2) + ((j & 3) << 2), src, ok ? 4 : 0);
            }
        }
        lw += GRAM_KW;
        if (lw >= W) {
            lw = 0;
            ++ls;
        }
    };

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = (warp % Sh::WARPS_M) * 16 * Sh::MI;
    const int wn = (warp / Sh::WARPS_M) * 8 * Sh::NI;

    int acc[Sh::MI][Sh::NI][4];
#pragma unroll
    for (int i = 0; i < Sh::MI; ++i)
#pragma unroll
        for (int j = 0; j < Sh::NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
    for (int st = 0; st < GRAM_STAGES - 1; ++st) {
        if (st < nk) load(st);
        pilosa_cp_commit();
    }

    for (int i = 0; i < nk; ++i) {
        pilosa_cp_wait<GRAM_STAGES - 2>();
        __syncthreads();
        // refill the stage every warp finished with in the last iteration
        if (i + GRAM_STAGES - 1 < nk) load((i + GRAM_STAGES - 1) % GRAM_STAGES);
        pilosa_cp_commit();

        const uint32_t sa =
            pilosa_smem_addr(pilosa_gram_smem + (i % GRAM_STAGES) * Sh::STAGE_BYTES);
        const uint32_t sb = diag ? sa : sa + TM * GRAM_ROW_BYTES;
#pragma unroll
        for (int ks = 0; ks < GRAM_KW / 8; ++ks) {
            uint32_t a[Sh::MI][4], b[Sh::NI][2];
            // A: 16 rows x 8 words as four 8 x 4-word matrices (rows 0-7 and
            // 8-15 of words 0-3, then of words 4-7)
#pragma unroll
            for (int mi = 0; mi < Sh::MI; ++mi) {
                const int r = wm + mi * 16 + (lane & 15);
                pilosa_ldsm_x4(sa + pilosa_chunk(r, 2 * ks + (lane >> 4)),
                               a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
            }
            // B: 8 rows x 8 words per n8 tile, words 0-3 then 4-7
            if (Sh::NI == 1) {
                const int r = wn + (lane & 7);
                pilosa_ldsm_x2(sb + pilosa_chunk(r, 2 * ks + ((lane >> 3) & 1)),
                               b[0][0], b[0][1]);
            } else {
#pragma unroll
                for (int nj = 0; nj < Sh::NI / 2; ++nj) {
                    const int r = wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
                    pilosa_ldsm_x4(sb + pilosa_chunk(r, 2 * ks + ((lane >> 3) & 1)),
                                   b[2 * nj][0], b[2 * nj][1], b[2 * nj + 1][0],
                                   b[2 * nj + 1][1]);
                }
            }
#pragma unroll
            for (int mi = 0; mi < Sh::MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < Sh::NI; ++ni) pilosa_bmma(acc[mi][ni], a[mi], b[ni]);
        }
    }
    pilosa_cp_wait<0>();

    // accumulator e of a 16 x 8 tile: row g + 8 * (e >> 1), column 2t + (e & 1)
    const int g = lane >> 2, t = lane & 3;
    const bool mirror = tri && tm != tn;
#pragma unroll
    for (int mi = 0; mi < Sh::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < Sh::NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = tm * TM + wm + mi * 16 + g + 8 * (e >> 1);
                const int n = tn * TN + wn + ni * 8 + 2 * t + (e & 1);
                const int v = acc[mi][ni][e];
                if (v != 0 && m < Mop.n && n < Nop.n) {
                    atomicAdd(out + m * osm + n * osn, v);
                    if (mirror) atomicAdd(out + n * osm + m * osn, v);
                }
            }
}

// 16-byte copies need 16-byte aligned rows at every shard: the base, both
// strides and W multiples of 4 words.
static inline bool pilosa_gram_vec16_ok(const PilosaGramOperand& op, int W) {
    return ((uintptr_t)op.bits & 15) == 0 && op.shard_stride % 4 == 0 &&
           op.row_stride % 4 == 0 && W % 4 == 0;
}

// Launch the TM x TN tile loop over S shards: a grid of output tiles
// (tiles_m * tiles_n, or the tiles_n (tiles_n + 1) / 2 upper-triangle
// tiles when tri) by k-chunks, with as many chunks as fill every SM with
// the blocks that fit on it in one wave, even when one tile covers the
// whole output. Returns a CUDA error code.
template <int TM, int TN, bool SELF>
static int pilosa_gram_launch(const PilosaGramOperand& Mop, const PilosaGramOperand& Nop,
                              int32_t* out, long long osm, long long osn, int S, int W,
                              int vec16, int tri, int device, cudaStream_t stream) {
    using Sh = PilosaGramShape<TM, TN>;
    auto kern = pilosa_gram_tiles<TM, TN, SELF>;
    // blocks per SM, 0 until this kernel is set up on the device
    static int resident[64];
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[device] == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, Sh::THREADS,
                                                            Sh::SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return (int)err;
        resident[device] = (per_sm < 1 ? 1 : per_sm) * sms;
    }
    const long long tiles_m = (Mop.n + TM - 1) / TM;
    const long long tiles_n = (Nop.n + TN - 1) / TN;
    const long long tiles = tri ? tiles_n * (tiles_n + 1) / 2 : tiles_m * tiles_n;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const long long steps_total = (long long)S * ((W + GRAM_KW - 1) / GRAM_KW);
    long long chunks = resident[device] / tiles;
    if (chunks > steps_total) chunks = steps_total;
    if (chunks > 65535) chunks = 65535;
    if (chunks < 1) chunks = 1;
    const long long steps_per_chunk = (steps_total + chunks - 1) / chunks;
    chunks = (steps_total + steps_per_chunk - 1) / steps_per_chunk;
    kern<<<dim3((unsigned)tiles, (unsigned)chunks), Sh::THREADS, Sh::SMEM_BYTES, stream>>>(
        Mop, Nop, out, osm, osn, W, vec16, tri, (int)tiles_n, steps_total, steps_per_chunk);
    return (int)cudaGetLastError();
}
