// BSI integer fields: the range scan, the sum popcounts and the Min/Max
// narrowing over an int field's bit planes.
//
// Replaces: pilosa_tpu/ops/bsi.py, XLA programs (none is a pallas_call):
//   bsi_range    _range_batch_kernel (:475), _range_count_batch_kernel
//                (:525) and _range_count_scan_kernel (:536), and through
//                them the single conditions (_range_eq_kernel :52,
//                _range_lt_kernel :95, _range_gt_kernel :119, range_between
//                :137);
//   bsi_sum      sum_count (:145): the lone Sum, filtered or not (a
//                flight's filtered Sums are bsi_sum_batch.cu's, on the
//                tensor cores);
//   bsi_extreme  _min_max_fused (:211), both extreme_mag (:194) branches.
//
// Operands (ops/bsi.py): planes[S, depth, W] words, a shard's planes W
// words apart, and exists, sign (and filters) rows of W words; each has its
// own shard stride, so the slices of one BSI stack [S, 2+depth, W] are read
// in place.
//
// bsi_range. Bound on an H100: bytes for a few queries (the stack read
// once: 461 MB at the serving shape, 160 x 22 x 32768 words, 0.138 ms at
// 3.35 TB/s), integer operations for many (one LOP3 per query, bound side,
// plane and word on the 64 integer lanes an SM). Each (bound, side, plane)
// step is one LOP3 of (accumulator, plane word, the bound's bit as a full
// word): A = magnitude </<= bound, B = magnitude >/>= bound, LSB to MSB.
// Design: the host compiles the flight once (ops/bsi.py, range_plan) into
// the kernel's __grid_constant__ parameter: the queries sorted into
// segments of one composition class each (the classes below, a sign
// selection per segment), each query with its output row in the caller's
// order, its accumulators' initial words and its magnitudes; a one-bound
// query carries no padding bound, and each class reads only its sides. A
// block expands the magnitudes into full-word masks in shared memory once
// (four planes a 16-byte broadcast load), then walks chunks of its shard:
// each thread loads V words of every plane into registers once per chunk
// and walks every segment and query against them, the planes in groups of
// four (the depth a uniform guard per group), then the class's epilogue,
// one to three logic ops on (A, B, sel, fil). Counts: per query one warp
// sum added to the warp's own row of shared counters (no atomics), one
// global atomic per query and block at the end; words: V words stored per
// query. No barrier between the first and the last. Left for later: the
// latency at each query's start and end (its parameters, mask loads and
// warp sum) with three warps an SMSP at 4 words a thread; the masks as
// uniform-register operands (nvcc loads them from the parameter with
// vector shifts, slower than the shared-memory broadcast).
//
// bsi_sum. Bound: bytes for the one filter it takes on the main path (the
// POPC pipe, 16 per clock per SM, for many: a flight of filtered Sums goes
// to bsi_sum_batch.cu's single-bit MMA instead). Design: a block holds
// 1024 words of one shard for a tile of BSI_SUM_QT filters in registers as
// the filtered non-negative and negative columns, then reads each plane's
// words once and popcounts them against every filter of the tile; warp
// reductions into shared counters, one global atomic per counter and
// block.
//
// bsi_extreme. Bound: bytes (the stack read once). Design: a block takes a
// slice of 2048 words of one shard, 8 per thread in registers for each
// branch, and narrows both from the top plane down with two block-wide
// "any" votes per plane; the next plane's words are loaded before the
// votes. Magnitudes are 64-bit. The host takes the extreme over slices
// and shards and sums the counts that reach it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

static int bsi_sm_count(int device) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        sms <= 0)
        sms = 132;
    return sms;
}

// ---------------------------------------------------------------------------
// bsi_range
// ---------------------------------------------------------------------------

#define BSI_RANGE_PQ 256            // queries a launch takes (ops/bsi.py _RANGE_PARAM_Q)
#define BSI_RANGE_SEGS 16           // segments a launch takes
#define BSI_RANGE_THREADS 128       // threads a block (ops/bsi.py RANGE_THREADS)
#define BSI_RANGE_SMEM (48 * 1024)  // the warps' counters and the expanded masks

// Composition classes (ops/bsi.py _C_*). sel is the sign class the term
// applies to (the non-negative columns, or the negative ones in a swapped
// segment), fil the other; A, B are the borrow accumulators of the query's
// first bound, A1, B1 of its second.
enum {
    BSI_C_ZERO = 0,  // 0 (words mode; a count stays zero and is not launched)
    BSI_C_EXISTS,    // sel | fil: every column that holds a value
    BSI_C_FILL_A,    // fil | (sel & A):         < / <= t >= 0, > / >= t < 0
    BSI_C_SEL_B,     // sel & B:                 > / >= t >= 0, < / <= t < 0
    BSI_C_EQ,        // sel & A & B:             ==
    BSI_C_NE,        // fil | (sel & ~(A & B)):  !=
    BSI_C_BT_SAME,   // sel & B & A1:            between, both bounds of one sign
    BSI_C_BT_MIX,    // (fil & A) | (sel & A1):  between, t0 < 0 <= t1
    BSI_C_GEN1,      // any other bound: (neg & Tn(A, B)) | (non & To(A, B))
    BSI_C_GEN2,      // any other pair: the same, ANDed over both bounds
    BSI_C_N
};

__host__ __device__ constexpr bool bsi_lo0(int c) {
    return c == BSI_C_FILL_A || c == BSI_C_EQ || c == BSI_C_NE || c == BSI_C_BT_MIX ||
           c == BSI_C_GEN1 || c == BSI_C_GEN2;
}
__host__ __device__ constexpr bool bsi_hi0(int c) {
    return c == BSI_C_SEL_B || c == BSI_C_EQ || c == BSI_C_NE || c == BSI_C_BT_SAME ||
           c == BSI_C_GEN1 || c == BSI_C_GEN2;
}
__host__ __device__ constexpr bool bsi_lo1(int c) {
    return c == BSI_C_BT_SAME || c == BSI_C_BT_MIX || c == BSI_C_GEN2;
}
__host__ __device__ constexpr bool bsi_hi1(int c) { return c == BSI_C_GEN2; }
// bounds of class c whose magnitudes the planes are compared with
__host__ __device__ constexpr int bsi_nb(int c) {
    return (bsi_lo1(c) || bsi_hi1(c)) ? 2 : (bsi_lo0(c) || bsi_hi0(c)) ? 1 : 0;
}

// The flight's plan (ops/bsi.py, range_plan; the same layout as its
// _RANGE_PARAM numpy dtype). Segment g holds queries [seg_end[g - 1],
// seg_end[g]) of class seg_cls[g] & 0xff, swapped when seg_cls[g] >> 8.
// Query i: row[i] = its first mask row | its bounds with planes << 16,
// dest[i] its output row, init[i] the initial A, B of its first bound and
// A1, B1 of its second (0 or ~0: strict or not), mag[i] their magnitudes,
// gen[i] (GEN classes) the truth tables over (A, B), bit A + 2B: Tn and To
// of the first bound in bits 0-3 and 4-7, of the second in 8-11 and 12-15.
struct __align__(16) BsiRangeParam {
    int n_seg, n_q, n_rows, pad;
    int seg_cls[BSI_RANGE_SEGS];
    int seg_end[BSI_RANGE_SEGS];
    int row[BSI_RANGE_PQ];
    int dest[BSI_RANGE_PQ];
    uint32_t gen[BSI_RANGE_PQ];
    uint4 init[BSI_RANGE_PQ];
    unsigned long long mag[BSI_RANGE_PQ][2];
};
static_assert(sizeof(BsiRangeParam) == 11408, "BsiRangeParam layout (ops/bsi.py)");

// bound bit m (a full word) of plane word p, LSB first: A = mag </<= bound
// (bit 1: A | ~p, bit 0: A & ~p), B = mag >/>= bound (bit 1: B & p, bit 0:
// B | p); each one LOP3
__device__ __forceinline__ uint32_t bsi_lo(uint32_t a, uint32_t p, uint32_t m) {
    return (~p & (a | m)) | (a & m);
}
__device__ __forceinline__ uint32_t bsi_hi(uint32_t b, uint32_t p, uint32_t m) {
    return (p & (b | ~m)) | (b & ~m);
}

// truth table t (bit A + 2B) of the words a, b
__device__ __forceinline__ uint32_t bsi_tt(uint32_t t, uint32_t a, uint32_t b) {
    const uint32_t t0 = 0u - (t & 1u), t1 = 0u - ((t >> 1) & 1u);
    const uint32_t t2 = 0u - ((t >> 2) & 1u), t3 = 0u - ((t >> 3) & 1u);
    const uint32_t h0 = (a & t1) | (~a & t0), h1 = (a & t3) | (~a & t2);
    return (b & h1) | (~b & h0);
}

template <int V>
__device__ __forceinline__ void bsi_load(const uint32_t* __restrict__ p, bool ok,
                                         uint32_t (&x)[V]) {
    if constexpr (V == 4) {
        const uint4 t = ok ? __ldcs(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (V == 2) {
        const uint2 t = ok ? __ldcs(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = ok ? __ldcs(p) : 0u;
    }
}

template <int V>
__device__ __forceinline__ void bsi_store(uint32_t* __restrict__ p, const uint32_t (&x)[V]) {
    if constexpr (V == 4) {
        __stcs(reinterpret_cast<uint4*>(p), make_uint4(x[0], x[1], x[2], x[3]));
    } else if constexpr (V == 2) {
        __stcs(reinterpret_cast<uint2*>(p), make_uint2(x[0], x[1]));
    } else {
        __stcs(p, x[0]);
    }
}

// Query i of class C against a thread's V words of every plane (p, in
// groups of four planes) and its sign classes.
template <int C, bool COUNT, int DMAX, int V>
__device__ __forceinline__ void bsi_range_query(
    const BsiRangeParam& P, int i, const uint32_t (&p)[DMAX][V], const uint32_t (&sel)[V],
    const uint32_t (&fil)[V], const uint4* __restrict__ masks, int groups,
    int* __restrict__ w_cnt, uint32_t* __restrict__ out_w, long long q_stride, bool in) {
    constexpr bool LO0 = bsi_lo0(C), HI0 = bsi_hi0(C), LO1 = bsi_lo1(C), HI1 = bsi_hi1(C);
    constexpr int NB = bsi_nb(C);
    uint32_t A[V], B[V], A1[V], B1[V];
    if constexpr (NB > 0) {
        const uint4 init = P.init[i];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            A[v] = init.x; B[v] = init.y; A1[v] = init.z; B1[v] = init.w;
        }
        const uint4* m0 = masks + (size_t)(P.row[i] & 0xffff) * groups;
#pragma unroll
        for (int g = 0; g < DMAX / 4; ++g) {
            if (g >= groups) break;  // uniform
            const uint4 a = m0[g];
            const uint4 b = NB == 2 ? m0[groups + g] : a;
            const uint32_t ma[4] = {a.x, a.y, a.z, a.w};
            const uint32_t mb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const uint32_t x = p[4 * g + j][v];
                    if constexpr (LO0) A[v] = bsi_lo(A[v], x, ma[j]);
                    if constexpr (HI0) B[v] = bsi_hi(B[v], x, ma[j]);
                    if constexpr (LO1) A1[v] = bsi_lo(A1[v], x, mb[j]);
                    if constexpr (HI1) B1[v] = bsi_hi(B1[v], x, mb[j]);
                }
            }
        }
    }
    uint32_t r[V];
    const uint32_t gt = (C == BSI_C_GEN1 || C == BSI_C_GEN2) ? P.gen[i] : 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const uint32_t s = sel[v], f = fil[v];
        if constexpr (C == BSI_C_ZERO) r[v] = 0u;
        else if constexpr (C == BSI_C_EXISTS) r[v] = s | f;
        else if constexpr (C == BSI_C_FILL_A) r[v] = f | (s & A[v]);
        else if constexpr (C == BSI_C_SEL_B) r[v] = s & B[v];
        else if constexpr (C == BSI_C_EQ) r[v] = s & A[v] & B[v];
        else if constexpr (C == BSI_C_NE) r[v] = f | (s & ~(A[v] & B[v]));
        else if constexpr (C == BSI_C_BT_SAME) r[v] = s & B[v] & A1[v];
        else if constexpr (C == BSI_C_BT_MIX) r[v] = (f & A[v]) | (s & A1[v]);
        else {  // GEN: unswapped, fil the negative columns, sel the others
            uint32_t tn = bsi_tt(gt, A[v], B[v]), to = bsi_tt(gt >> 4, A[v], B[v]);
            if constexpr (C == BSI_C_GEN2) {
                tn &= bsi_tt(gt >> 8, A1[v], B1[v]);
                to &= bsi_tt(gt >> 12, A1[v], B1[v]);
            }
            r[v] = (f & tn) | (s & to);
        }
    }
    if constexpr (COUNT) {
        int c = 0;
#pragma unroll
        for (int v = 0; v < V; ++v) c += __popc(r[v]);
        c = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
        if ((threadIdx.x & 31) == 0) w_cnt[i] += c;  // this warp's row
    } else if (in) {
        bsi_store<V>(out_w + (long long)P.dest[i] * q_stride, r);
    }
}

template <bool COUNT, int DMAX, int V>
__global__ void __launch_bounds__(BSI_RANGE_THREADS)
pilosa_bsi_range_kernel(const __grid_constant__ BsiRangeParam P,
                        const uint32_t* __restrict__ planes, long long pl_s,
                        const uint32_t* __restrict__ exists, long long ex_s,
                        const uint32_t* __restrict__ sign, long long sg_s,
                        int depth, int S, int W, void* __restrict__ out) {
    extern __shared__ uint4 bsi_range_smem[];
    constexpr int warps = BSI_RANGE_THREADS / 32;
    const int tid = threadIdx.x, s = blockIdx.y;
    int* s_cnt = reinterpret_cast<int*>(bsi_range_smem);  // [warps][BSI_RANGE_PQ] (counts)
    uint4* masks = bsi_range_smem + (COUNT ? warps * BSI_RANGE_PQ / 4 : 0);  // [n_rows][groups]
    const int groups = (depth + 3) >> 2;
    // each bound's magnitude as full-word masks, four planes an entry
    for (int e = tid; e < P.n_q * 2 * groups; e += BSI_RANGE_THREADS) {
        const int i = e / (2 * groups), b = (e / groups) & 1, g = e % groups;
        const int rw = P.row[i];
        if (b < (rw >> 16)) {
            const uint32_t bits = (uint32_t)(P.mag[i][b] >> (4 * g)) & 15u;
            masks[(size_t)((rw & 0xffff) + b) * groups + g] =
                make_uint4(0u - (bits & 1u), 0u - ((bits >> 1) & 1u), 0u - ((bits >> 2) & 1u),
                           0u - (bits >> 3));
        }
    }
    if (COUNT)
        for (int i = tid; i < warps * BSI_RANGE_PQ; i += BSI_RANGE_THREADS) s_cnt[i] = 0;
    __syncthreads();

    int* w_cnt = s_cnt + (tid >> 5) * BSI_RANGE_PQ;
    constexpr int cw = BSI_RANGE_THREADS * V;
    const int n_chunks = (W + cw - 1) / cw;
    const uint32_t* pl = planes + (long long)s * pl_s;
    const uint32_t* ex = exists + (long long)s * ex_s;
    const uint32_t* sg = sign + (long long)s * sg_s;
    const long long q_stride = (long long)S * W;
    for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
        const int w = chunk * cw + tid * V;
        const bool in = w < W;  // W % V == 0: a thread's words are all in or all out
        uint32_t e[V], g[V], p[DMAX][V];
        bsi_load<V>(ex + w, in, e);
        bsi_load<V>(sg + w, in, g);
#pragma unroll
        for (int k4 = 0; k4 < DMAX / 4; ++k4) {
            if (k4 >= groups) break;  // uniform
#pragma unroll
            for (int j = 0; j < 4; ++j)
                bsi_load<V>(pl + (long long)(4 * k4 + j) * W + w, in && 4 * k4 + j < depth,
                            p[4 * k4 + j]);
        }
        uint32_t neg[V], non[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            neg[v] = e[v] & g[v];
            non[v] = e[v] & ~g[v];
        }
        uint32_t* out_w = COUNT ? nullptr : reinterpret_cast<uint32_t*>(out) + (long long)s * W + w;
        for (int seg = 0; seg < P.n_seg; ++seg) {
            const int cls = P.seg_cls[seg];
            const int q0 = seg ? P.seg_end[seg - 1] : 0, q1 = P.seg_end[seg];
            uint32_t sel[V], fil[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                sel[v] = (cls >> 8) ? neg[v] : non[v];
                fil[v] = (cls >> 8) ? non[v] : neg[v];
            }
#define BSI_SEG(C)                                                                       \
    case C:                                                                              \
        for (int i = q0; i < q1; ++i)                                                    \
            bsi_range_query<C, COUNT, DMAX, V>(P, i, p, sel, fil, masks, groups, w_cnt, \
                                               out_w, q_stride, in);                     \
        break;
            switch (cls & 0xff) {
                BSI_SEG(BSI_C_ZERO)
                BSI_SEG(BSI_C_EXISTS)
                BSI_SEG(BSI_C_FILL_A)
                BSI_SEG(BSI_C_SEL_B)
                BSI_SEG(BSI_C_EQ)
                BSI_SEG(BSI_C_NE)
                BSI_SEG(BSI_C_BT_SAME)
                BSI_SEG(BSI_C_BT_MIX)
                BSI_SEG(BSI_C_GEN1)
                BSI_SEG(BSI_C_GEN2)
                default: break;
            }
#undef BSI_SEG
        }
    }
    if (COUNT) {
        __syncthreads();
        int* counts = reinterpret_cast<int*>(out);
        for (int i = tid; i < P.n_q; i += BSI_RANGE_THREADS) {
            int c = 0;
            for (int k = 0; k < warps; ++k) c += s_cnt[k * BSI_RANGE_PQ + i];
            if (c) atomicAdd(counts + (long long)P.dest[i] * S + s, c);
        }
    }
}

// the instances built: (planes a thread holds, words a thread), as
// ops/bsi.py RANGE_CONFIGS
#define BSI_RANGE_CONFIGS(X) X(20, 4) X(32, 2) X(64, 1)

static bool bsi_range_plan_ok(const BsiRangeParam& P, int count, int n_out) {
    if (P.n_q < 0 || P.n_q > BSI_RANGE_PQ || P.n_seg < 0 || P.n_seg > BSI_RANGE_SEGS ||
        P.n_rows < 0)
        return false;
    int q = 0;
    for (int g = 0; g < P.n_seg; ++g) {
        const int c = P.seg_cls[g] & 0xff, sw = P.seg_cls[g] >> 8;
        if (c >= BSI_C_N || (sw != 0 && sw != 1) || (count && c == BSI_C_ZERO) ||
            P.seg_end[g] < q || P.seg_end[g] > P.n_q)
            return false;
        for (; q < P.seg_end[g]; ++q) {
            const int row = P.row[q] & 0xffff, nb = P.row[q] >> 16;
            if (nb != bsi_nb(c) || (nb && row + nb > P.n_rows) || P.dest[q] < 0 ||
                P.dest[q] >= n_out)
                return false;
        }
    }
    return q == P.n_q;
}

// param: host bytes of one BsiRangeParam (ops/bsi.py, range_plan); out:
// int32[n_out, S] zeroed counts (count != 0) or int32[n_out, S, W] words,
// query i's at row dest[i]. The plan's block shape: grid_x blocks a shard
// of BSI_RANGE_THREADS threads, each block walking chunks of
// BSI_RANGE_THREADS * vec words; (dmax, vec) one of BSI_RANGE_CONFIGS with
// depth <= dmax and W a multiple of vec (and every row vec-word aligned).
// A plan or shape past these returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int pilosa_bsi_range(const void* param, int param_bytes, const void* planes,
                                long long pl_s, const void* exists, long long ex_s,
                                const void* sign, long long sg_s, int depth, int S, int W,
                                int dmax, int vec, int grid_x, int count, void* out, int n_out,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (param_bytes != (int)sizeof(BsiRangeParam)) return (int)cudaErrorInvalidValue;
    BsiRangeParam P;
    memcpy(&P, param, sizeof P);
    const int groups = (depth + 3) / 4;
    const size_t smem = (size_t)(count ? BSI_RANGE_THREADS / 32 * BSI_RANGE_PQ * 4 : 0) +
                        (size_t)P.n_rows * groups * 16;
    if (!bsi_range_plan_ok(P, count, n_out) || depth < 0 || depth > dmax || S < 0 ||
        S > 65535 || W < 0 || vec < 1 || W % vec || grid_x < 1 || smem > BSI_RANGE_SMEM)
        return (int)cudaErrorInvalidValue;
    if (P.n_q == 0 || S == 0 || W == 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)grid_x, (unsigned)S);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* p = (const uint32_t*)planes;
    const uint32_t* e = (const uint32_t*)exists;
    const uint32_t* g = (const uint32_t*)sign;
#define BSI_RANGE_TRY(D, V)                                                          \
    if (dmax == D && vec == V) {                                                     \
        if (count)                                                                   \
            pilosa_bsi_range_kernel<true, D, V><<<grid, BSI_RANGE_THREADS, smem, st>>>(  \
                P, p, pl_s, e, ex_s, g, sg_s, depth, S, W, out);                     \
        else                                                                         \
            pilosa_bsi_range_kernel<false, D, V><<<grid, BSI_RANGE_THREADS, smem, st>>>( \
                P, p, pl_s, e, ex_s, g, sg_s, depth, S, W, out);                     \
        return (int)cudaGetLastError();                                              \
    }
    BSI_RANGE_CONFIGS(BSI_RANGE_TRY)
#undef BSI_RANGE_TRY
    return (int)cudaErrorInvalidValue;
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
