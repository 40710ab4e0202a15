// bsi_sum_batch: a flight's filtered Sums over one BSI field in one launch,
// as single-bit MMA on the tensor cores:
//   out[k, c, q] = sum_s sum_w popc(A[k, c][s, w] & F[q][s, w])
//   A[k, 0] = plane_k & exists & ~sign,  A[k, 1] = plane_k & exists & sign  (k < depth)
//   A[depth, 0] = exists & ~sign,        A[depth, 1] = exists & sign        (the counts)
//   F[q] = row idx[q] of an [S, R, W] operand (shard and row strides in
//          words), a zero row where idx[q] = -1
// out is int32[depth + 1, 2, Q], totals over the shards (the caller zeroes
// it and keeps S * W * 32 within int32).
//
// Replaces: pilosa_tpu/ops/bsi.py _sum_batch_kernel (:628-649), an XLA
// program and no pallas_call: int8 unpack and one MXU matmul of the
// [depth+1] plane rows against the 2Q sign-split filters, accumulated over
// the shards.
//
// Bound on an H100: bytes. At the serving shape (160 shards, depth 20,
// 32768 words) and 64 filters the stack (461 MB) and the filter rows
// (1.34 GB) read once take 0.539 ms at 3.35 TB/s; the 2 (depth + 1) Q S W
// 32-bit popcounts the function needs would hold the POPC pipe (16 a clock
// an SM) about six times as long, which is what bsi.cu's pilosa_bsi_sum
// does for a flight. Here they are single-bit MMA (mma.sync.m16n8k256.and.
// popc, BMMA in SASS), far under the byte bound.
//
// Design: the tile loop of gram_tile.cuh (its copies, swizzle and MMA
// helpers), with the M operand derived in registers. A block owns every M
// row and a tile of TN filters (8-128: a serving flight is one tile, so
// the stack is read about once) over a contiguous chunk of k-slabs (32
// words of one shard); slabs stream through a ring of GRAM_STAGES stages
// filled by cp.async. A stage holds the raw rows (planes 0..depth-1, then
// exists as row depth; rows past it stay zero), the sign row and the
// tile's filters, each gathered in place through its pointer, so a filter
// that is a row of a resident stack is read where it lies. An MMA m-tile
// of 16 rows is 8 raw rows in both sign classes: rows 0-7 are class 0 and
// rows 8-15 class 1 of the same 8 planes, so one ldmatrix.x2 of the raw
// rows gives both halves of the A fragment, ANDed in registers with
// exists & ~sign and exists & sign (a thread's two mask words per k-step,
// read from the stage). ceil((depth + 1) / 8) m-tiles cover the
// 2 (depth + 1) rows with no row padded beyond 8. Each warp owns all
// m-tiles and 8 or 16 filters; one __syncthreads per slab. The epilogue
// adds each int32 sum into out with atomicAdd (exact in any order).

#include "gram_tile.cuh"

// the raw rows an m-tile reads (8 planes, each in both sign classes)
#define BSB_RAW 8

template <int MT, int NI, int WARPS>
struct BsbShape {
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int TN = 8 * NI * WARPS;     // filters a block
    static constexpr int RAW = BSB_RAW * MT;      // raw rows: planes, exists, zeros
    static constexpr int SIGN = RAW;              // the sign row
    static constexpr int ROWS = RAW + 1 + TN;     // then the filters
    static constexpr int STAGE_BYTES = ROWS * GRAM_ROW_BYTES;
    static constexpr int SMEM_BYTES = GRAM_STAGES * STAGE_BYTES;
};

struct BsbOperands {
    const uint32_t* planes;  // plane k of shard s at planes + s * pl_s + k * pl_k
    long long pl_s, pl_k;
    const uint32_t* exists;
    long long ex_s;
    const uint32_t* sign;
    long long sg_s;
    const uint32_t* fbits;   // filter q of shard s at fbits + s * f_s + idx[q] * f_r
    long long f_s, f_r;
    const int32_t* idx;
    int Q, depth, W;
};

template <int MT, int NI, int WARPS>
__global__ void __launch_bounds__(BsbShape<MT, NI, WARPS>::THREADS)
pilosa_bsi_sum_batch_kernel(const BsbOperands op, int32_t* __restrict__ out, int vec16,
                            long long steps_total, long long steps_per_chunk) {
    using Sh = BsbShape<MT, NI, WARPS>;
    extern __shared__ __align__(128) uint8_t bsb_smem[];
    // the rows each slab copies: stage row, shard-0 words, shard stride
    __shared__ const uint32_t* rowp[Sh::ROWS];
    __shared__ const uint32_t* live_p[Sh::ROWS];
    __shared__ long long live_ss[Sh::ROWS];
    __shared__ short live_r[Sh::ROWS];
    __shared__ int n_live;

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * Sh::TN;
    const int depth = op.depth, W = op.W;
    // m-tiles that hold a row of this depth (uniform)
    const int mt = (depth + 1 + BSB_RAW - 1) / BSB_RAW;

    for (int r = tid; r < Sh::ROWS; r += Sh::THREADS) {
        const uint32_t* p = nullptr;
        if (r < depth) {
            p = op.planes + (long long)r * op.pl_k;
        } else if (r == depth) {
            p = op.exists;
        } else if (r == Sh::SIGN) {
            p = op.sign;
        } else if (r > Sh::SIGN) {
            const int q = n0 + (r - Sh::SIGN - 1);
            if (q < op.Q) {
                const int i = op.idx[q];
                if (i >= 0) p = op.fbits + (long long)i * op.f_r;
            }
        }
        rowp[r] = p;
    }
    // every stage zeroed once: a row never copied (past exists, an absent
    // filter, past Q) stays zero, and AND with zero adds nothing
    for (int i = tid; i < Sh::SMEM_BYTES / 16; i += Sh::THREADS)
        reinterpret_cast<uint4*>(bsb_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    if (tid < 32) {  // warp 0 packs the live rows, in order
        int base = 0;
        for (int r0 = 0; r0 < Sh::ROWS; r0 += 32) {
            const int r = r0 + tid;
            const uint32_t* p = r < Sh::ROWS ? rowp[r] : nullptr;
            const unsigned live = __ballot_sync(0xffffffffu, p != nullptr);
            if (p != nullptr) {
                const int j = base + __popc(live & ((1u << tid) - 1u));
                live_p[j] = p;
                live_r[j] = (short)r;
                live_ss[j] = r < depth ? op.pl_s : r == depth ? op.ex_s
                           : r == Sh::SIGN ? op.sg_s : op.f_s;
            }
            base += __popc(live);
        }
        if (tid == 0) n_live = base;
    }
    __syncthreads();
    const int nl = n_live;

    const long long k0 = (long long)blockIdx.y * steps_per_chunk;
    const long long k1 = k0 + steps_per_chunk < steps_total ? k0 + steps_per_chunk : steps_total;
    const int nk = (int)(k1 - k0);
    const long long wsteps = (W + GRAM_KW - 1) / GRAM_KW;
    long long ls = k0 / wsteps;  // the next slab to load: shard ls, first word lw
    int lw = (int)(k0 - ls * wsteps) * GRAM_KW;
    const uint32_t* const any = op.exists;  // a valid address for empty copies

    auto load = [&](int st) {
        const uint32_t base = pilosa_smem_addr(bsb_smem + st * Sh::STAGE_BYTES);
        if (vec16) {
            for (int q = tid; q < nl * GRAM_CHUNKS; q += Sh::THREADS) {
                const int j = q / GRAM_CHUNKS, c = q % GRAM_CHUNKS;
                const int w = lw + c * 4;
                const bool ok = w < W;
                const uint32_t* src = ok ? live_p[j] + ls * live_ss[j] + w : any;
                pilosa_cp16(base + pilosa_chunk(live_r[j], c), src, ok ? 16 : 0);
            }
        } else {
            for (int q = tid; q < nl * GRAM_KW; q += Sh::THREADS) {
                const int j = q / GRAM_KW, x = q % GRAM_KW;
                const int w = lw + x;
                const bool ok = w < W;
                const uint32_t* src = ok ? live_p[j] + ls * live_ss[j] + w : any;
                pilosa_cp4(base + pilosa_chunk(live_r[j], x >> 2) + ((x & 3) << 2), src,
                           ok ? 4 : 0);
            }
        }
        lw += GRAM_KW;
        if (lw >= W) {
            lw = 0;
            ++ls;
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wn = warp * 8 * NI;  // the warp's first filter in the tile

    int acc[MT][NI][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
    for (int st = 0; st < GRAM_STAGES - 1; ++st) {
        if (st < nk) load(st);
        pilosa_cp_commit();
    }

    for (int it = 0; it < nk; ++it) {
        pilosa_cp_wait<GRAM_STAGES - 2>();
        __syncthreads();
        // refill the stage every warp finished with in the last iteration
        if (it + GRAM_STAGES - 1 < nk) load((it + GRAM_STAGES - 1) % GRAM_STAGES);
        pilosa_cp_commit();

        const uint8_t* stage = bsb_smem + (it % GRAM_STAGES) * Sh::STAGE_BYTES;
        const uint32_t sa = pilosa_smem_addr(stage);
        constexpr int F0 = Sh::RAW + 1;  // the tile's first filter row
#pragma unroll
        for (int ks = 0; ks < GRAM_KW / 8; ++ks) {
            // this thread's words t and t + 4 of the k-step: exists and sign,
            // then the two classes' masks
            const uint32_t* ex_lo = reinterpret_cast<const uint32_t*>(
                stage + pilosa_chunk(depth, 2 * ks)) + t;
            const uint32_t* ex_hi = reinterpret_cast<const uint32_t*>(
                stage + pilosa_chunk(depth, 2 * ks + 1)) + t;
            const uint32_t* sg_lo = reinterpret_cast<const uint32_t*>(
                stage + pilosa_chunk(Sh::SIGN, 2 * ks)) + t;
            const uint32_t* sg_hi = reinterpret_cast<const uint32_t*>(
                stage + pilosa_chunk(Sh::SIGN, 2 * ks + 1)) + t;
            const uint32_t e0 = *ex_lo, e1 = *ex_hi, s0 = *sg_lo, s1 = *sg_hi;
            const uint32_t pos0 = e0 & ~s0, neg0 = e0 & s0;
            const uint32_t pos1 = e1 & ~s1, neg1 = e1 & s1;

            uint32_t b[NI][2];
            if (NI == 1) {
                const int r = wn + (lane & 7);
                pilosa_ldsm_x2(sa + pilosa_chunk(F0 + r, 2 * ks + ((lane >> 3) & 1)),
                               b[0][0], b[0][1]);
            } else {
#pragma unroll
                for (int nj = 0; nj < NI / 2; ++nj) {
                    const int r = wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
                    pilosa_ldsm_x4(sa + pilosa_chunk(F0 + r, 2 * ks + ((lane >> 3) & 1)),
                                   b[2 * nj][0], b[2 * nj][1], b[2 * nj + 1][0],
                                   b[2 * nj + 1][1]);
                }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                if (i < mt) {  // uniform: the m-tiles this depth fills
                    // raw rows 8i..8i+7, words 0-3 (lanes 0-7) and 4-7
                    // (lanes 8-15): row g, words t and t + 4
                    uint32_t lo, hi;
                    pilosa_ldsm_x2(sa + pilosa_chunk(BSB_RAW * i + (lane & 7),
                                                     2 * ks + ((lane >> 3) & 1)),
                                   lo, hi);
                    // rows 0-7 of the m-tile: class 0; rows 8-15: class 1
                    const uint32_t a[4] = {lo & pos0, lo & neg0, hi & pos1, hi & neg1};
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni) pilosa_bmma(acc[i][ni], a, b[ni]);
                }
            }
        }
    }
    pilosa_cp_wait<0>();

    // accumulator e of a 16 x 8 tile: row g + 8 * (e >> 1) (plane 8i + g in
    // class e >> 1), column 2t + (e & 1)
    const int Q = op.Q;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = BSB_RAW * i + g;
                const int q = n0 + wn + ni * 8 + 2 * t + (e & 1);
                const int v = acc[i][ni][e];
                if (v != 0 && k <= depth && q < Q)
                    atomicAdd(out + ((long long)k * 2 + (e >> 1)) * Q + q, v);
            }
}

// Launch one instance over S shards: a grid of filter tiles by k-chunks,
// with as many chunks as fill every SM with the blocks that fit on it.
template <int MT, int NI, int WARPS>
static int bsb_launch(const BsbOperands& op, int32_t* out, int S, int vec16, int device,
                      cudaStream_t stream) {
    using Sh = BsbShape<MT, NI, WARPS>;
    auto kern = pilosa_bsi_sum_batch_kernel<MT, NI, WARPS>;
    static int resident[64];  // blocks a wave, 0 until set up on the device
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
    const long long tiles = (op.Q + Sh::TN - 1) / Sh::TN;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const long long steps_total = (long long)S * ((op.W + GRAM_KW - 1) / GRAM_KW);
    long long chunks = resident[device] / tiles;
    if (chunks > steps_total) chunks = steps_total;
    if (chunks > 65535) chunks = 65535;
    if (chunks < 1) chunks = 1;
    const long long steps_per_chunk = (steps_total + chunks - 1) / chunks;
    chunks = (steps_total + steps_per_chunk - 1) / steps_per_chunk;
    kern<<<dim3((unsigned)tiles, (unsigned)chunks), Sh::THREADS, Sh::SMEM_BYTES, stream>>>(
        op, out, vec16, steps_total, steps_per_chunk);
    return (int)cudaGetLastError();
}

// The filter tile: 8 filters a warp alone (Q <= 8), else 16 a warp, up to
// eight warps (128 filters).
template <int MT>
static int bsb_launch_n(const BsbOperands& op, int32_t* out, int S, int vec16, int device,
                        cudaStream_t stream) {
    if (op.Q <= 8) return bsb_launch<MT, 1, 1>(op, out, S, vec16, device, stream);
    if (op.Q <= 16) return bsb_launch<MT, 2, 1>(op, out, S, vec16, device, stream);
    if (op.Q <= 32) return bsb_launch<MT, 2, 2>(op, out, S, vec16, device, stream);
    if (op.Q <= 64) return bsb_launch<MT, 2, 4>(op, out, S, vec16, device, stream);
    return bsb_launch<MT, 2, 8>(op, out, S, vec16, device, stream);
}

// planes: plane k of shard s at planes + s * pl_s + k * pl_k; exists, sign:
// shard s at + s * ex_s, + s * sg_s; filters: row idx[q] (device int32[Q],
// -1 a zero row) of shard s at fbits + s * f_s + idx[q] * f_r. vec16: every
// pointer 16-byte aligned and every stride and W a multiple of 4 words.
// out: int32[depth + 1, 2, Q], zeroed by the caller.
extern "C" int pilosa_bsi_sum_batch(const void* planes, long long pl_s, long long pl_k,
                                    const void* exists, long long ex_s, const void* sign,
                                    long long sg_s, const void* fbits, long long f_s,
                                    long long f_r, const void* idx, int Q, int depth, int S,
                                    int W, int vec16, void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (Q <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    if (depth < 0 || depth > 64 || (long long)S * W * 32 > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    BsbOperands op;
    op.planes = (const uint32_t*)planes;
    op.pl_s = pl_s;
    op.pl_k = pl_k;
    op.exists = (const uint32_t*)exists;
    op.ex_s = ex_s;
    op.sign = (const uint32_t*)sign;
    op.sg_s = sg_s;
    op.fbits = (const uint32_t*)fbits;
    op.f_s = f_s;
    op.f_r = f_r;
    op.idx = (const int32_t*)idx;
    op.Q = Q;
    op.depth = depth;
    op.W = W;
    const int mt = (depth + 1 + BSB_RAW - 1) / BSB_RAW;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* o = (int32_t*)out;
    if (mt <= 3) return bsb_launch_n<3>(op, o, S, vec16, device, st);  // depth <= 23
    if (mt <= 5) return bsb_launch_n<5>(op, o, S, vec16, device, st);  // depth <= 39
    return bsb_launch_n<9>(op, o, S, vec16, device, st);               // depth <= 71
}
