// BSI integer fields: the range scan, the sum popcounts and the Min/Max
// narrowing over an int field's bit planes.
//
// Replaces: pilosa_tpu/ops/bsi.py, XLA programs (none is a pallas_call):
//   bsi_range    _range_batch_kernel (:475), _range_count_batch_kernel
//                (:525) and _range_count_scan_kernel (:536), and through
//                them the single conditions (_range_eq_kernel :52,
//                _range_lt_kernel :95, _range_gt_kernel :119, range_between
//                :137);
//   bsi_sum      sum_count (:145) and _sum_batch_kernel (:629);
//   bsi_extreme  _min_max_fused (:211), both extreme_mag (:194) branches.
//
// Operands (ops/bsi.py): planes[S, depth, W] words, a shard's planes W
// words apart, and exists, sign (and filters) rows of W words; each has its
// own shard stride, so the slices of one BSI stack [S, 2+depth, W] are read
// in place.
//
// bsi_range. Bound on an H100: bytes for a few queries (the stack read
// once: 461 MB at the serving shape, 160 x 22 x 32768 words, 0.138 ms at
// 3.35 TB/s), integer operations for many (one LOP3 per query, bound,
// plane, side and word). Design: a block stages a chunk of 128 words of
// every plane of one shard in shared memory, once; then it walks the
// queries in tiles of BSI_RANGE_QT, each thread keeping the tile's two
// borrow accumulators per bound in registers across the planes (LSB to
// MSB: A = magnitude </<= bound, B = magnitude >/>= bound, both one
// three-input function of (accumulator, plane, bound bit)). The bound
// bits of a tile are expanded into full words in shared memory and read
// four at a time. A template on the bound count and on the sides the
// flight needs drops what it does not read. Counts: a warp reduction and
// a shared counter per query, one global atomic per query and block.
//
// bsi_sum. Bound: the POPC pipe (16 per clock per SM) for many filters,
// bytes for one. Design: a block holds 1024 words of one shard for a tile
// of BSI_SUM_QT filters in registers as the filtered non-negative and
// negative columns, then reads each plane's words once and popcounts them
// against every filter of the tile; warp reductions into shared counters,
// one global atomic per counter and block. Left for later: the tensor
// cores (the gram tile loop, as JAX's int8 matmul does it).
//
// bsi_extreme. Bound: bytes (the stack read once). Design: a block takes a
// slice of 2048 words of one shard, 8 per thread in registers for each
// branch, and narrows both from the top plane down with two block-wide
// "any" votes per plane; the next plane's words are loaded before the
// votes. Magnitudes are 64-bit. The host takes the extreme over slices
// and shards and sums the counts that reach it.

#include <cuda_runtime.h>
#include <stdint.h>

// qmeta channels (ops/bsi.py _M_*): bit c of a bound's flag word
enum {
    BSI_A0 = 0, BSI_B0, BSI_OOB, BSI_FNEG, BSI_FNON, BSI_SNEG, BSI_SNON,
    BSI_XOR, BSI_SELA, BSI_SELB, BSI_SELC,
};

__device__ __forceinline__ uint32_t bsi_flag(int flags, int c) {
    return ((flags >> c) & 1) ? 0xffffffffu : 0u;
}

// ---------------------------------------------------------------------------
// bsi_range
// ---------------------------------------------------------------------------

#define BSI_RANGE_THREADS 128
#define BSI_RANGE_QT 8

template <int NB, bool LO, bool HI, bool COUNT>
__global__ void __launch_bounds__(BSI_RANGE_THREADS)
pilosa_bsi_range_kernel(const uint32_t* __restrict__ planes, long long pl_s,
                        const uint32_t* __restrict__ exists, long long ex_s,
                        const uint32_t* __restrict__ sign, long long sg_s,
                        const int* __restrict__ table, int Q, int depth, int S, int W,
                        uint32_t* __restrict__ words, int* __restrict__ counts) {
    constexpr int TB = BSI_RANGE_QT * NB;  // bounds of a tile
    extern __shared__ uint4 bsi_range_smem[];
    uint32_t* s_planes = reinterpret_cast<uint32_t*>(bsi_range_smem);  // [depth][128]
    uint32_t* s_bm = s_planes + depth * BSI_RANGE_THREADS;            // [depth][TB]
    int* s_cnt = reinterpret_cast<int*>(s_bm + depth * TB);           // [Q]
    const int tid = threadIdx.x;
    const int s = blockIdx.y;
    const int n_chunks = (W + BSI_RANGE_THREADS - 1) / BSI_RANGE_THREADS;
    const uint32_t* pl = planes + (long long)s * pl_s;
    if (COUNT)
        for (int q = tid; q < Q; q += BSI_RANGE_THREADS) s_cnt[q] = 0;

    for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
        const int w = chunk * BSI_RANGE_THREADS + tid;
        const bool in = w < W;
        const uint32_t e = in ? __ldg(exists + (long long)s * ex_s + w) : 0u;
        const uint32_t sg = in ? __ldg(sign + (long long)s * sg_s + w) : 0u;
        const uint32_t neg = e & sg, non = e & ~sg;
        __syncthreads();  // the last chunk's readers are done with s_planes
        for (int k = 0; k < depth; ++k)
            s_planes[k * BSI_RANGE_THREADS + tid] = in ? __ldg(pl + (long long)k * W + w) : 0u;

        for (int q0 = 0; q0 < Q; q0 += BSI_RANGE_QT) {
            __syncthreads();  // s_planes written; the last tile's s_bm read
            for (int i = tid; i < depth * TB; i += BSI_RANGE_THREADS) {
                const int k = i / TB, j = i % TB;
                const int q = q0 + j / NB;
                uint32_t bit = 0u;
                if (q < Q) {
                    const int* t = table + ((long long)q * NB + j % NB) * 3;
                    bit = ((uint32_t)(k < 32 ? t[1] : t[2]) >> (k & 31)) & 1u;
                }
                s_bm[i] = 0u - bit;
            }
            __syncthreads();
            int fl[TB];
            uint32_t A[TB], B[TB];
#pragma unroll
            for (int j = 0; j < TB; ++j) {
                const int q = q0 + j / NB;
                fl[j] = q < Q ? __ldg(table + ((long long)q * NB + j % NB) * 3) : 0;
                A[j] = bsi_flag(fl[j], BSI_A0);
                B[j] = bsi_flag(fl[j], BSI_B0);
            }
            if (LO || HI) {
                for (int k = 0; k < depth; ++k) {
                    const uint32_t p = s_planes[k * BSI_RANGE_THREADS + tid];
                    const uint4* bm4 = reinterpret_cast<const uint4*>(s_bm + k * TB);
#pragma unroll
                    for (int v = 0; v < TB / 4; ++v) {
                        const uint4 m4 = bm4[v];
                        const uint32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const int j = 4 * v + u;
                            // bound bit 1: A |= ~p, B &= p; bit 0: A &= ~p, B |= p
                            if (LO) A[j] = (~p & (A[j] | m[u])) | (A[j] & m[u]);
                            if (HI) B[j] = (p & (B[j] | ~m[u])) | (B[j] & ~m[u]);
                        }
                    }
                }
            }
#pragma unroll
            for (int jq = 0; jq < BSI_RANGE_QT; ++jq) {
                const int q = q0 + jq;
                if (q >= Q) continue;  // uniform across the block
                uint32_t r = 0xffffffffu;
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    const int f = fl[jq * NB + b];
                    const uint32_t oob = bsi_flag(f, BSI_OOB);
                    const uint32_t a = A[jq * NB + b] | oob;
                    const uint32_t bb = B[jq * NB + b] & ~oob;
                    const uint32_t term = bsi_flag(f, BSI_XOR) ^
                        ((bsi_flag(f, BSI_SELA) & a) | (bsi_flag(f, BSI_SELB) & bb) |
                         (bsi_flag(f, BSI_SELC) & a & bb));
                    const uint32_t sel = (bsi_flag(f, BSI_SNEG) & neg) | (bsi_flag(f, BSI_SNON) & non);
                    r &= (bsi_flag(f, BSI_FNEG) & neg) | (bsi_flag(f, BSI_FNON) & non) | (sel & term);
                }
                if (COUNT) {
                    const unsigned c = __reduce_add_sync(0xffffffffu, (unsigned)__popc(r));
                    if ((tid & 31) == 0 && c) atomicAdd(&s_cnt[q], (int)c);
                } else if (in) {
                    words[((long long)q * S + s) * W + w] = r;
                }
            }
        }
    }
    if (COUNT) {
        __syncthreads();
        for (int q = tid; q < Q; q += BSI_RANGE_THREADS)
            if (s_cnt[q]) atomicAdd(&counts[(long long)q * S + s], s_cnt[q]);
    }
}

template <int NB, bool LO, bool HI, bool COUNT>
static cudaError_t bsi_range_launch(dim3 grid, size_t smem, cudaStream_t stream,
                                    const uint32_t* planes, long long pl_s,
                                    const uint32_t* exists, long long ex_s,
                                    const uint32_t* sign, long long sg_s,
                                    const int* table, int Q, int depth, int S, int W,
                                    void* out) {
    pilosa_bsi_range_kernel<NB, LO, HI, COUNT><<<grid, BSI_RANGE_THREADS, smem, stream>>>(
        planes, pl_s, exists, ex_s, sign, sg_s, table, Q, depth, S, W,
        COUNT ? nullptr : (uint32_t*)out, COUNT ? (int*)out : nullptr);
    return cudaGetLastError();
}

template <int NB, bool LO, bool HI>
static cudaError_t bsi_range_mode(bool count, dim3 grid, size_t smem, cudaStream_t stream,
                                  const uint32_t* planes, long long pl_s,
                                  const uint32_t* exists, long long ex_s,
                                  const uint32_t* sign, long long sg_s,
                                  const int* table, int Q, int depth, int S, int W,
                                  void* out) {
    return count ? bsi_range_launch<NB, LO, HI, true>(grid, smem, stream, planes, pl_s, exists,
                                                       ex_s, sign, sg_s, table, Q, depth, S, W, out)
                 : bsi_range_launch<NB, LO, HI, false>(grid, smem, stream, planes, pl_s, exists,
                                                        ex_s, sign, sg_s, table, Q, depth, S, W, out);
}

template <int NB>
static cudaError_t bsi_range_sides(bool lo, bool hi, bool count, dim3 grid, size_t smem,
                                   cudaStream_t stream, const uint32_t* planes, long long pl_s,
                                   const uint32_t* exists, long long ex_s,
                                   const uint32_t* sign, long long sg_s,
                                   const int* table, int Q, int depth, int S, int W, void* out) {
#define BSI_RANGE_ARGS count, grid, smem, stream, planes, pl_s, exists, ex_s, sign, sg_s, \
                       table, Q, depth, S, W, out
    if (lo && hi) return bsi_range_mode<NB, true, true>(BSI_RANGE_ARGS);
    if (lo) return bsi_range_mode<NB, true, false>(BSI_RANGE_ARGS);
    if (hi) return bsi_range_mode<NB, false, true>(BSI_RANGE_ARGS);
    return bsi_range_mode<NB, false, false>(BSI_RANGE_ARGS);
#undef BSI_RANGE_ARGS
}

static int bsi_sm_count(int device) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        sms <= 0)
        sms = 132;
    return sms;
}

// table: int32[Q, nb, 3] of (flags, magnitude low, magnitude high) bounds;
// out: int32[Q, S] zeroed counts (count != 0) or int32[Q, S, W] words.
extern "C" int pilosa_bsi_range(const void* planes, long long pl_s, const void* exists,
                                long long ex_s, const void* sign, long long sg_s,
                                const void* table, int Q, int nb, int need_lo, int need_hi,
                                int count, int depth, int S, int W, void* out, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Q <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    if ((nb != 1 && nb != 2) || depth < 0 || depth > 64 || S > 65535 ||
        (count && Q > 4096))
        return (int)cudaErrorInvalidValue;
    const int n_chunks = (W + BSI_RANGE_THREADS - 1) / BSI_RANGE_THREADS;
    // about 16 resident blocks of 128 threads per SM over the whole grid
    const int want = (bsi_sm_count(device) * 16 + S - 1) / S;
    dim3 grid(want < 1 ? 1 : (want > n_chunks ? n_chunks : want), S);
    size_t smem = (size_t)depth * (BSI_RANGE_THREADS + BSI_RANGE_QT * nb) * 4;
    if (count) smem += (size_t)Q * 4;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const uint32_t* p = (const uint32_t*)planes;
    const uint32_t* e = (const uint32_t*)exists;
    const uint32_t* g = (const uint32_t*)sign;
    const int* t = (const int*)table;
    cudaStream_t st = (cudaStream_t)stream;
    if (nb == 1)
        return (int)bsi_range_sides<1>(need_lo, need_hi, count, grid, smem, st, p, pl_s, e, ex_s,
                                       g, sg_s, t, Q, depth, S, W, out);
    return (int)bsi_range_sides<2>(need_lo, need_hi, count, grid, smem, st, p, pl_s, e, ex_s,
                                   g, sg_s, t, Q, depth, S, W, out);
}

// ---------------------------------------------------------------------------
// bsi_sum
// ---------------------------------------------------------------------------

#define BSI_SUM_THREADS 256
#define BSI_SUM_WPT 4
#define BSI_SUM_GROUP (BSI_SUM_THREADS * BSI_SUM_WPT)

template <int QT>
__global__ void __launch_bounds__(BSI_SUM_THREADS)
pilosa_bsi_sum_kernel(const uint32_t* __restrict__ planes, long long pl_s,
                      const uint32_t* __restrict__ exists, long long ex_s,
                      const uint32_t* __restrict__ sign, long long sg_s,
                      const uint32_t* __restrict__ filt, long long f_s, long long f_q,
                      int Q, int depth, int W, int* __restrict__ out) {
    extern __shared__ int bsi_sum_acc[];  // [QT][depth + 1][2]
    const int s = blockIdx.y, q0 = blockIdx.z * QT, tid = threadIdx.x;
    const int per_q = (depth + 1) * 2;
    for (int i = tid; i < QT * per_q; i += BSI_SUM_THREADS) bsi_sum_acc[i] = 0;
    __syncthreads();
    const uint32_t* pl = planes + (long long)s * pl_s;
    const int n_groups = (W + BSI_SUM_GROUP - 1) / BSI_SUM_GROUP;
    for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
        uint32_t pos[QT][BSI_SUM_WPT], neg[QT][BSI_SUM_WPT];
#pragma unroll
        for (int i = 0; i < BSI_SUM_WPT; ++i) {
            const int w = g * BSI_SUM_GROUP + i * BSI_SUM_THREADS + tid;
            const bool in = w < W;
            const uint32_t e = in ? __ldg(exists + (long long)s * ex_s + w) : 0u;
            const uint32_t sg = in ? __ldg(sign + (long long)s * sg_s + w) : 0u;
#pragma unroll
            for (int j = 0; j < QT; ++j) {
                const int q = q0 + j;
                const uint32_t f =
                    (in && q < Q) ? e & __ldg(filt + (long long)s * f_s + (long long)q * f_q + w)
                                  : 0u;
                pos[j][i] = f & ~sg;
                neg[j][i] = f & sg;
            }
        }
        for (int k = 0; k <= depth; ++k) {  // k == depth: the filtered columns
            uint32_t p[BSI_SUM_WPT];
#pragma unroll
            for (int i = 0; i < BSI_SUM_WPT; ++i) {
                const int w = g * BSI_SUM_GROUP + i * BSI_SUM_THREADS + tid;
                p[i] = k == depth ? 0xffffffffu
                                  : (w < W ? __ldg(pl + (long long)k * W + w) : 0u);
            }
#pragma unroll
            for (int j = 0; j < QT; ++j) {
                unsigned cp = 0, cn = 0;
#pragma unroll
                for (int i = 0; i < BSI_SUM_WPT; ++i) {
                    cp += __popc(p[i] & pos[j][i]);
                    cn += __popc(p[i] & neg[j][i]);
                }
                cp = __reduce_add_sync(0xffffffffu, cp);
                cn = __reduce_add_sync(0xffffffffu, cn);
                if ((tid & 31) == 0) {
                    if (cp) atomicAdd(&bsi_sum_acc[j * per_q + 2 * k], (int)cp);
                    if (cn) atomicAdd(&bsi_sum_acc[j * per_q + 2 * k + 1], (int)cn);
                }
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < QT * per_q; i += BSI_SUM_THREADS) {
        const int q = q0 + i / per_q;
        if (q < Q && bsi_sum_acc[i])
            atomicAdd(&out[((long long)s * Q + q) * per_q + i % per_q], bsi_sum_acc[i]);
    }
}

template <int QT>
static cudaError_t bsi_sum_launch(int sms, cudaStream_t stream, const uint32_t* planes,
                                  long long pl_s, const uint32_t* exists, long long ex_s,
                                  const uint32_t* sign, long long sg_s, const uint32_t* filt,
                                  long long f_s, long long f_q, int Q, int depth, int S, int W,
                                  int* out) {
    const int n_groups = (W + BSI_SUM_GROUP - 1) / BSI_SUM_GROUP;
    const int tiles = (Q + QT - 1) / QT;
    if (tiles > 65535) return cudaErrorInvalidValue;
    // about 8 resident blocks of 256 threads per SM over the whole grid
    const long long want = ((long long)sms * 8 + (long long)S * tiles - 1) / ((long long)S * tiles);
    dim3 grid((unsigned)(want > n_groups ? n_groups : (want < 1 ? 1 : want)), S, tiles);
    const size_t smem = (size_t)QT * (depth + 1) * 2 * 4;
    pilosa_bsi_sum_kernel<QT><<<grid, BSI_SUM_THREADS, smem, stream>>>(
        planes, pl_s, exists, ex_s, sign, sg_s, filt, f_s, f_q, Q, depth, W, out);
    return cudaGetLastError();
}

// filt: filter q of shard s at filt + s * f_s + q * f_q (the exists row
// itself for an unfiltered Sum); out: int32[S, Q, depth + 1, 2], zeroed.
extern "C" int pilosa_bsi_sum(const void* planes, long long pl_s, const void* exists,
                              long long ex_s, const void* sign, long long sg_s, const void* filt,
                              long long f_s, long long f_q, int Q, int depth, int S, int W,
                              void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Q <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    if (depth < 0 || depth > 64 || S > 65535) return (int)cudaErrorInvalidValue;
    const int sms = bsi_sm_count(device);
    const uint32_t* p = (const uint32_t*)planes;
    const uint32_t* e = (const uint32_t*)exists;
    const uint32_t* g = (const uint32_t*)sign;
    const uint32_t* f = (const uint32_t*)filt;
    cudaStream_t st = (cudaStream_t)stream;
    int* o = (int*)out;
    if (Q == 1)
        return (int)bsi_sum_launch<1>(sms, st, p, pl_s, e, ex_s, g, sg_s, f, f_s, f_q, Q, depth, S, W, o);
    if (Q == 2)
        return (int)bsi_sum_launch<2>(sms, st, p, pl_s, e, ex_s, g, sg_s, f, f_s, f_q, Q, depth, S, W, o);
    if (Q <= 4)
        return (int)bsi_sum_launch<4>(sms, st, p, pl_s, e, ex_s, g, sg_s, f, f_s, f_q, Q, depth, S, W, o);
    return (int)bsi_sum_launch<8>(sms, st, p, pl_s, e, ex_s, g, sg_s, f, f_s, f_q, Q, depth, S, W, o);
}

// ---------------------------------------------------------------------------
// bsi_extreme
// ---------------------------------------------------------------------------

#define BSI_EXT_THREADS 256
#define BSI_EXT_WPT 8
#define BSI_EXT_SLICE (BSI_EXT_THREADS * BSI_EXT_WPT)

__global__ void __launch_bounds__(BSI_EXT_THREADS)
pilosa_bsi_extreme_kernel(const uint32_t* __restrict__ planes, long long pl_s,
                          const uint32_t* __restrict__ exists, long long ex_s,
                          const uint32_t* __restrict__ sign, long long sg_s,
                          const uint32_t* __restrict__ filt, long long f_s, int depth, int W,
                          int maximal, long long* __restrict__ out) {
    __shared__ int warp_counts[2][BSI_EXT_THREADS / 32];
    const int s = blockIdx.y, slice = blockIdx.x, tid = threadIdx.x;
    const uint32_t* pl = planes + (long long)s * pl_s;
    const int w0 = slice * BSI_EXT_SLICE + tid;
    // branch a: the non-negative columns for Max, the negative ones for
    // Min, narrowed to the largest magnitude; branch b: the other class,
    // narrowed to the smallest
    uint32_t a[BSI_EXT_WPT], b[BSI_EXT_WPT];
    uint32_t any_a = 0u, any_b = 0u;
#pragma unroll
    for (int i = 0; i < BSI_EXT_WPT; ++i) {
        const int w = w0 + i * BSI_EXT_THREADS;
        uint32_t f = 0u, sg = 0u;
        if (w < W) {
            f = __ldg(exists + (long long)s * ex_s + w) & __ldg(filt + (long long)s * f_s + w);
            sg = __ldg(sign + (long long)s * sg_s + w);
        }
        a[i] = f & (maximal ? ~sg : sg);
        b[i] = f & (maximal ? sg : ~sg);
        any_a |= a[i];
        any_b |= b[i];
    }
    const bool has_a = __syncthreads_or(any_a != 0u) != 0;
    const bool has_b = __syncthreads_or(any_b != 0u) != 0;
    unsigned long long mag_a = 0ull, mag_b = 0ull;
    if ((has_a || has_b) && depth > 0) {  // uniform across the block
        uint32_t p[BSI_EXT_WPT];
#pragma unroll
        for (int i = 0; i < BSI_EXT_WPT; ++i) {
            const int w = w0 + i * BSI_EXT_THREADS;
            p[i] = w < W ? __ldg(pl + (long long)(depth - 1) * W + w) : 0u;
        }
        for (int k = depth - 1; k >= 0; --k) {
            uint32_t ha[BSI_EXT_WPT], hb[BSI_EXT_WPT];
            uint32_t oa = 0u, ob = 0u;
#pragma unroll
            for (int i = 0; i < BSI_EXT_WPT; ++i) {
                ha[i] = a[i] & p[i];
                hb[i] = b[i] & ~p[i];
                oa |= ha[i];
                ob |= hb[i];
            }
            if (k > 0) {  // the next plane's words, loaded before the votes
#pragma unroll
                for (int i = 0; i < BSI_EXT_WPT; ++i) {
                    const int w = w0 + i * BSI_EXT_THREADS;
                    p[i] = w < W ? __ldg(pl + (long long)(k - 1) * W + w) : 0u;
                }
            }
            const bool hit_a = __syncthreads_or(oa != 0u) != 0;
            const bool hit_b = __syncthreads_or(ob != 0u) != 0;
            if (hit_a) {
#pragma unroll
                for (int i = 0; i < BSI_EXT_WPT; ++i) a[i] = ha[i];
                mag_a |= 1ull << k;
            }
            if (hit_b) {
#pragma unroll
                for (int i = 0; i < BSI_EXT_WPT; ++i) b[i] = hb[i];
            } else {
                mag_b |= 1ull << k;
            }
        }
    }
    int ca = 0, cb = 0;
#pragma unroll
    for (int i = 0; i < BSI_EXT_WPT; ++i) {
        ca += __popc(a[i]);
        cb += __popc(b[i]);
    }
    ca = (int)__reduce_add_sync(0xffffffffu, (unsigned)ca);
    cb = (int)__reduce_add_sync(0xffffffffu, (unsigned)cb);
    if ((tid & 31) == 0) {
        warp_counts[0][tid >> 5] = ca;
        warp_counts[1][tid >> 5] = cb;
    }
    __syncthreads();
    if (tid == 0) {
        long long ta = 0, tb = 0;
        for (int i = 0; i < BSI_EXT_THREADS / 32; ++i) {
            ta += warp_counts[0][i];
            tb += warp_counts[1][i];
        }
        long long* o = out + ((long long)s * gridDim.x + slice) * 6;
        o[0] = has_a;
        o[1] = has_b;
        o[2] = has_a ? (long long)mag_a : 0;
        o[3] = ta;
        o[4] = has_b ? (long long)mag_b : 0;
        o[5] = tb;
    }
}

// filt: the filter row of shard s at filt + s * f_s (the exists row itself
// unfiltered); out: int64[S, ceil(W / 2048), 6].
extern "C" int pilosa_bsi_extreme(const void* planes, long long pl_s, const void* exists,
                                  long long ex_s, const void* sign, long long sg_s,
                                  const void* filt, long long f_s, int depth, int S, int W,
                                  int maximal, void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (S <= 0 || W <= 0) return (int)cudaSuccess;
    if (depth < 0 || depth > 63 || S > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((W + BSI_EXT_SLICE - 1) / BSI_EXT_SLICE, S);
    pilosa_bsi_extreme_kernel<<<grid, BSI_EXT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)planes, pl_s, (const uint32_t*)exists, ex_s, (const uint32_t*)sign,
        sg_s, (const uint32_t*)filt, f_s, depth, W, maximal, (long long*)out);
    return (int)cudaGetLastError();
}
