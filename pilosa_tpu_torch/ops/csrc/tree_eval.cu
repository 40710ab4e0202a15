// Tree evaluation: the compiled PQL trees of exec/astbatch.py.
//   pilosa_tree_count: out[b, s] = sum_w popc(tree(leaves of item b)[s, w])
//   pilosa_tree_words: out[s, w] = tree(leaves of one item)[s, w]
// A tree of Row/Intersect/Union/Difference/Xor/Not over field stacks runs
// as a postfix program: a leaf opcode (>= 0) pushes leaf l, the row
// slots[b, l] of stack leaf_stack[l] at shard s; a fold opcode pops two
// operands and pushes AND, OR, XOR, ANDNOT or NOTAND of them. A slot below 0
// is an absent row: a zero leaf, never read. exec/astbatch.py orders each
// program so that it needs at most floor(log2(leaves)) + 1 operand-stack
// entries, so TREE_MAX_DEPTH (32) holds every tree; programs of any length
// and any number of leaves run.
//
// Replaces: pilosa_tpu/exec/astbatch.py, the XLA programs of compiled
// (count mode: _count_scan, a lax.scan over the batch with the tree fused
// per item; bitmap mode: the tree's [S, W] words). No Pallas kernel stands
// behind them.
//
// The count has two routes; the wrapper (ops/kernels.py, tree_plan) picks
// one from the batch's shape before the launch.
//
// Staged route (pilosa_tree_count_staged), for batches whose items share
// rows. The wrapper lists the distinct rows the batch names (one tensor
// passed as several stacks shares its rows), remaps every slot to an index
// into that list, sorts the items by those indices (the leaf with the
// fewest distinct rows first) and cuts them into tiles whose rows fit in
// shared memory. A block owns one tile, one shard and one slice of the
// shard's words (the wrapper cuts each shard into slices of 32 chunks,
// TREE_SLICE_CHUNKS). It walks the slice in chunks of TREE_CHUNK_WORDS (512
// bytes of each row, one warp step of 32 lanes x 16 bytes); each chunk of
// every row of the tile is copied once into a ring of 2-4 shared-memory
// stages by cp.async, and every item of the tile is evaluated from it. A
// warp evaluates a group of TREE_GROUP (8) neighbouring items at a time:
// an opcode is decoded once per group, a leaf that the wrapper marked
// uniform (all 8 items name one row) is loaded once, an absent slot names
// the stage's zero row, and the operand stack (1 or 2 entries a word: the
// route takes programs that need at most 2 with a leaf followed by a fold
// applied to the top) lives in registers. A flat chain of at most 4 steps
// of one fold (Intersect, Union, Xor or Not of rows) runs on an instance
// of its own with the fold fixed at compile time, every step's slots
// loaded first, and the uniform leaves, which the wrapper puts first,
// folded in one register before the chain widens to the 8 items. The
// popcounts run on the tensor cores: the warp's 32 lanes x 4 words of one
// item are the A operand of mma.sync.m16n8k256.and.popc (BMMA), and a B
// operand whose column j is all ones and the rest zeros adds item j's
// popcount into column j of one accumulator shared by the group. Each
// group's accumulator (two int32 a lane) stays in shared memory across
// the slice's chunks; its rows are summed once, after the last chunk, and
// added into out[b, s] with atomicAdd (exact in any order; the wrapper
// zeroes out).
//
// Direct route (pilosa_tree_count), for everything else: a word-by-word
// row (W not a multiple of 4 or an unaligned stack), a program needing more
// than 2 entries, more than 64 leaves, or a batch that shares no rows (one
// item of 300 distinct rows gains nothing from staging). One block of 256
// threads per (item b, shard s), blockIdx.x = b fastest, so the blocks in
// flight share one shard's rows through L2. The block stages the first
// TREE_SMEM_OPS opcodes and the row pointers of the first TREE_SMEM_LEAVES
// leaves in shared memory; the rest of a longer program is read from the
// table, by a second instance of the kernel (LONG) that only such programs
// launch. Threads stride over W in 16-byte groups when every row and the
// output are 16-byte aligned (vec16), else word by word. Each group runs
// the program with the top of the operand stack in registers and the
// entries below it in a small array; a leaf followed by a fold is applied
// to the top directly. The block sums its popcounts with warp shuffles and
// one shared-memory pass and stores one int32 per (b, s). A shard's count
// is at most 32 * W < 2^31 (the wrapper checks W). tree_words runs one
// block per (chunk of TREE_WORDS_CHUNK words, shard) and stores the words.
// A direct table of at most TREE_PARAM_BYTES is passed as the kernel's
// parameter, so a bitmap tree's launch uploads nothing.
//
// Bounds on an H100, at the trees path of chip_smoke.py (1024 items of
// Intersect(Row(f), Row(g), Row(h)) over two 64-row stacks and a 4-row
// stack, S = 160, W = 32768):
// - bytes: the 132 distinct rows read once and B x S counts written,
//   2.77 GB, 0.83 ms at 3.35 TB/s. The staged route reads each chunk of a
//   distinct row from device memory once; the direct route reads every leaf
//   of every item (nominally B x L x S x W x 4 = 64.4 GB, from L2).
// - shared memory: the staged route reads one 512-byte warp row per item
//   and leaf, or one per group for a uniform leaf, 4 cycles each of the
//   SM's 128 bytes per clock: with the items sorted, 2.1 loads per item of
//   this batch, 1.36 ms (chip_smoke.py computes it from the run's layout).
//   This is the staged route's largest floor.
// - popcounts: one BMMA per item and chunk, B x S x W / 128 = 4.2e7, about
//   0.27 ms at the mma.sync rate chip_smoke.py measures; the direct route's
//   one __popc per item, shard and word is 1.28 ms at 16 per clock per SM.
// - instructions and their latency: a group's steps are a dependent chain
//   (slots, then rows, then the fold), and only the 16 warps of one block
//   fit an SM (its stages fill shared memory) to hide it, so the SM issues
//   well below its 4 warp instructions per clock.
//
// Left for later: reuse of rows that neighbouring items share within a
// group without the whole group sharing them (the batch above loads g and
// most f rows once per item), a persistent grid (the W split only cuts
// fixed slices), and more warps per SM (registers and the stage ring bound
// them at 16). TMA bulk copies in place of the cp.async ring were tried:
// slower here, as the copies are not the wall.

#include <string.h>

#include "gram_tile.cuh"
#include "scan_common.cuh"

// Operand-stack entries per word; pilosa_tpu_torch/ops/kernels.py holds the
// same number.
#define TREE_MAX_DEPTH 32
// Opcodes and leaf row pointers staged in shared memory; the rest of a longer
// program is read from device memory.
#define TREE_SMEM_OPS 512
#define TREE_SMEM_LEAVES 256
// Fold opcodes (a leaf opcode is the leaf's index, >= 0).
#define TREE_AND -1
#define TREE_OR -2
#define TREE_XOR -3
#define TREE_ANDNOT -4
#define TREE_NOTAND -5
// Words per block of pilosa_tree_words.
#define TREE_WORDS_CHUNK 8192

__device__ __forceinline__ uint32_t tree_fold(int op, uint32_t a, uint32_t b) {
    switch (op) {
        case TREE_AND: return a & b;
        case TREE_OR: return a | b;
        case TREE_XOR: return a ^ b;
        case TREE_ANDNOT: return a & ~b;
        default: return ~a & b;
    }
}

__device__ __forceinline__ uint4 tree_fold(int op, uint4 a, uint4 b) {
    return make_uint4(tree_fold(op, a.x, b.x), tree_fold(op, a.y, b.y),
                      tree_fold(op, a.z, b.z), tree_fold(op, a.w, b.w));
}

__device__ __forceinline__ int tree_popc(uint32_t v) { return __popc(v); }

__device__ __forceinline__ int tree_popc(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <typename V>
__device__ __forceinline__ V tree_zero();

template <>
__device__ __forceinline__ uint32_t tree_zero<uint32_t>() { return 0u; }

template <>
__device__ __forceinline__ uint4 tree_zero<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }

// Group i (of V-sized groups) of a leaf row; zeros for an absent row.
template <typename V>
__device__ __forceinline__ V tree_load(const uint32_t* row, int i) {
    if (row == nullptr) return tree_zero<V>();
    return __ldg(reinterpret_cast<const V*>(row) + i);
}

// The table the wrapper uploads in one copy:
//   int64 base[P]           each stack's base pointer, int32[S, rows[p], W]
//   int32 rows[P]
//   int32 code[n_ops]       the postfix program
//   int32 leaf_stack[L]     leaf -> stack
//   int32 slots[B, L]       leaf rows per item (< 0: absent)
// and what one block of item b at shard s reads of it: the staged head of
// the program and of the leaf row pointers, and the table for the rest.
struct TreeProgram {
    const int* s_code;
    const uint32_t* const* s_leaf;
    const long long* base;
    const int* rows;
    const int* code;
    const int* leaf_stack;
    const int* slots;  // item b's row
    int n_ops, s, W;
};

__device__ __forceinline__ const uint32_t* tree_leaf_row(const TreeProgram& t, int l) {
    const int slot = t.slots[l];
    if (slot < 0) return nullptr;
    const int p = t.leaf_stack[l];
    return reinterpret_cast<const uint32_t*>(t.base[p]) +
           ((size_t)t.s * t.rows[p] + slot) * (size_t)t.W;
}

// LONG: the program passes the staged head (the launch decides, so a
// program that fits it pays no test per opcode).
template <bool LONG>
__device__ __forceinline__ int tree_op(const TreeProgram& t, int k) {
    return !LONG || k < TREE_SMEM_OPS ? t.s_code[k] : t.code[k];
}

template <bool LONG>
__device__ __forceinline__ const uint32_t* tree_leaf(const TreeProgram& t, int l) {
    return !LONG || l < TREE_SMEM_LEAVES ? t.s_leaf[l] : tree_leaf_row(t, l);
}

// Run the postfix program on group i of the leaves. The top of the operand
// stack lives in `top`, the n - 1 entries below it in `below`.
template <typename V, bool LONG>
__device__ __forceinline__ V tree_eval(const TreeProgram& t, int i) {
    V below[TREE_MAX_DEPTH - 1];
    V top = tree_zero<V>();
    int n = 0;
    for (int k = 0; k < t.n_ops; ++k) {
        const int op = tree_op<LONG>(t, k);
        if (op >= 0) {
            const V v = tree_load<V>(tree_leaf<LONG>(t, op), i);
            const int next = k + 1 < t.n_ops ? tree_op<LONG>(t, k + 1) : 0;
            if (n > 0 && next < 0) {  // leaf, then a fold: fold into the top
                top = tree_fold(next, top, v);
                ++k;
            } else {
                if (n > 0) below[n - 1] = top;
                top = v;
                ++n;
            }
        } else {
            --n;
            top = tree_fold(op, below[n - 1], top);
        }
    }
    return top;
}

// Item b's program at shard s, with its head staged in shared memory.
__device__ __forceinline__ TreeProgram tree_stage(const unsigned char* table, int P,
                                                  int n_ops, int L, int b, int s, int W,
                                                  int* s_code, const uint32_t** s_leaf) {
    TreeProgram t;
    t.base = reinterpret_cast<const long long*>(table);
    t.rows = reinterpret_cast<const int*>(table + 8 * (size_t)P);
    t.code = t.rows + P;
    t.leaf_stack = t.code + n_ops;
    t.slots = t.leaf_stack + L + (size_t)b * L;
    t.s_code = s_code;
    t.s_leaf = s_leaf;
    t.n_ops = n_ops;
    t.s = s;
    t.W = W;
    for (int k = threadIdx.x; k < min(n_ops, TREE_SMEM_OPS); k += blockDim.x)
        s_code[k] = t.code[k];
    for (int l = threadIdx.x; l < min(L, TREE_SMEM_LEAVES); l += blockDim.x)
        s_leaf[l] = tree_leaf_row(t, l);
    __syncthreads();
    return t;
}

template <typename V, bool LONG>
__device__ __forceinline__ void tree_count_body(const unsigned char* table, int P, int n_ops,
                                                int L, int S, int W, int32_t* __restrict__ out) {
    __shared__ int s_code[TREE_SMEM_OPS];
    __shared__ const uint32_t* s_leaf[TREE_SMEM_LEAVES];
    const int b = blockIdx.x;
    const int s = blockIdx.y;
    const TreeProgram t = tree_stage(table, P, n_ops, L, b, s, W, s_code, s_leaf);
    const int groups = W / (int)(sizeof(V) / 4);
    int acc = 0;
    for (int i = threadIdx.x; i < groups; i += blockDim.x)
        acc += tree_popc(tree_eval<V, LONG>(t, i));
    const int total = pilosa_block_sum(acc);
    if (threadIdx.x == 0) out[(size_t)b * S + s] = total;
}

template <typename V, bool LONG>
__device__ __forceinline__ void tree_words_body(const unsigned char* table, int P, int n_ops,
                                                int L, int W, uint32_t* __restrict__ out) {
    __shared__ int s_code[TREE_SMEM_OPS];
    __shared__ const uint32_t* s_leaf[TREE_SMEM_LEAVES];
    const int s = blockIdx.y;
    const TreeProgram t = tree_stage(table, P, n_ops, L, 0, s, W, s_code, s_leaf);
    const int per = (int)(sizeof(V) / 4);
    const int groups = W / per;
    const int g0 = blockIdx.x * (TREE_WORDS_CHUNK / per);
    const int g1 = min(groups, g0 + TREE_WORDS_CHUNK / per);
    V* dst = reinterpret_cast<V*>(out + (size_t)s * W);
    for (int i = g0 + threadIdx.x; i < g1; i += blockDim.x)
        dst[i] = tree_eval<V, LONG>(t, i);
}

// A table of at most TREE_PARAM_BYTES goes to the kernel as its parameter
// (the C entry copies it from the host at the launch: no upload); a longer
// one is read from device memory. ops/kernels.py holds the same number.
#define TREE_PARAM_BYTES 256
struct __align__(16) TreeTableParam {
    unsigned char bytes[TREE_PARAM_BYTES];
};

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_count_kernel(const unsigned char* __restrict__ table, int P, int n_ops, int L,
                         int S, int W, int32_t* __restrict__ out) {
    tree_count_body<V, LONG>(table, P, n_ops, L, S, W, out);
}

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_count_param(const __grid_constant__ TreeTableParam table, int P, int n_ops, int L,
                        int S, int W, int32_t* __restrict__ out) {
    tree_count_body<V, LONG>(table.bytes, P, n_ops, L, S, W, out);
}

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_words_kernel(const unsigned char* __restrict__ table, int P, int n_ops, int L,
                         int W, uint32_t* __restrict__ out) {
    tree_words_body<V, LONG>(table, P, n_ops, L, W, out);
}

template <typename V, bool LONG>
__global__ void __launch_bounds__(PILOSA_SCAN_THREADS)
pilosa_tree_words_param(const __grid_constant__ TreeTableParam table, int P, int n_ops, int L,
                        int W, uint32_t* __restrict__ out) {
    tree_words_body<V, LONG>(table.bytes, P, n_ops, L, W, out);
}

// Launch K<V, LONG> for the route's word width and program length: `table`
// a device pointer, or (host_bytes > 0) host_bytes of host memory passed as
// the kernel's parameter.
#define TREE_DIRECT_LAUNCH(KERNEL, GRID, ...)                                          \
    do {                                                                               \
        const bool lng = tree_long(n_ops, L);                                          \
        if (host_bytes > 0) {                                                          \
            TreeTableParam prm;                                                        \
            memcpy(prm.bytes, table, (size_t)host_bytes);                              \
            auto k = vec16 ? (lng ? KERNEL##_param<uint4, true> : KERNEL##_param<uint4, false>) \
                           : (lng ? KERNEL##_param<uint32_t, true>                       \
                                  : KERNEL##_param<uint32_t, false>);                    \
            k<<<GRID, PILOSA_SCAN_THREADS, 0, st>>>(prm, __VA_ARGS__);                  \
        } else {                                                                       \
            const unsigned char* t = (const unsigned char*)table;                      \
            auto k = vec16 ? (lng ? KERNEL##_kernel<uint4, true> : KERNEL##_kernel<uint4, false>) \
                           : (lng ? KERNEL##_kernel<uint32_t, true>                      \
                                  : KERNEL##_kernel<uint32_t, false>);                   \
            k<<<GRID, PILOSA_SCAN_THREADS, 0, st>>>(t, __VA_ARGS__);                    \
        }                                                                              \
    } while (0)

static bool tree_long(int n_ops, int L) {
    return n_ops > TREE_SMEM_OPS || L > TREE_SMEM_LEAVES;
}

static bool tree_args_ok(int P, int n_ops, int L, int depth, int S, int W, int vec16) {
    return P > 0 && n_ops > 0 && L > 0 && depth >= 1 && depth <= TREE_MAX_DEPTH &&
           S <= 65535 && W < (1 << 26) && !(vec16 && (W & 3));
}

// out: int32[B, S]. table: as above, on the device, or (host_bytes > 0,
// at most TREE_PARAM_BYTES) in host memory, passed as the kernel's
// parameter. depth: the program's operand-stack depth (the wrapper
// computes it). vec16: every row and the table's stacks 16-byte aligned
// with W a multiple of 4. Arguments past the limits (a depth past
// TREE_MAX_DEPTH, W past 2^26, a host table past TREE_PARAM_BYTES) return
// cudaErrorInvalidValue and launch nothing.
extern "C" int pilosa_tree_count(const void* table, int host_bytes, int P, int n_ops, int L,
                                 int depth, int B, int S, int W, int vec16,
                                 void* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!tree_args_ok(P, n_ops, L, depth, S, W, vec16) || host_bytes < 0 ||
        host_bytes > TREE_PARAM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    TREE_DIRECT_LAUNCH(pilosa_tree_count, dim3((unsigned)B, (unsigned)S), P, n_ops, L, S, W,
                       (int32_t*)out);
    return (int)cudaGetLastError();
}

// out: int32[S, W] (16-byte aligned when vec16); table with B = 1.
extern "C" int pilosa_tree_words(const void* table, int host_bytes, int P, int n_ops, int L,
                                 int depth, int S, int W, int vec16, void* out,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!tree_args_ok(P, n_ops, L, depth, S, W, vec16) || host_bytes < 0 ||
        host_bytes > TREE_PARAM_BYTES)
        return (int)cudaErrorInvalidValue;
    if (S <= 0 || W <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    TREE_DIRECT_LAUNCH(pilosa_tree_words,
                       dim3((unsigned)((W + TREE_WORDS_CHUNK - 1) / TREE_WORDS_CHUNK),
                            (unsigned)S),
                       P, n_ops, L, W, (uint32_t*)out);
    return (int)cudaGetLastError();
}

#undef TREE_DIRECT_LAUNCH

// ---------------------------------------------------------------------------
// The staged route
// ---------------------------------------------------------------------------

// Words of a row per stage: one warp step, 32 lanes x 16 bytes.
#define TREE_CHUNK_WORDS 128
#define TREE_CHUNK_BYTES (TREE_CHUNK_WORDS * 4)
// Items per single-bit MMA accumulator (its 8 columns).
#define TREE_GROUP 8
#define TREE_STAGED_MAX_LEAVES 64
// Warps per block: one block per SM (its stages fill shared memory), and
// 128 registers a thread at most.
#define TREE_STAGED_WARPS 16
// Dynamic shared memory a block may have on sm_90.
#define TREE_SMEM_LIMIT 232448
// Step kinds of a program on the staged route (the wrapper's tree_steps):
// push leaf l; fold leaf l into the top; fold the top into the entry below.
// A step is kind | fold << 2 | leaf << 5, fold = -opcode - 1.
#define TREE_PUSH 0
#define TREE_LEAF_FOLD 1
#define TREE_POP_FOLD 2
// A slot of the staged table: the row's index in its tile's stages, with
// this bit set when all 8 items of the group name that row.
#define TREE_UNIFORM (1 << 30)

// Byte offsets of one block's dynamic shared memory: the stage ring (each
// stage the tile's rows and one zero row, which absent slots name), the
// rows' pointers at the block's shard, the steps, the tile's slots and each
// group's accumulator (two int32 a lane). ops/kernels.py
// (_tree_staged_smem) computes the same total.
struct TreeSmem {
    long long stage_bytes, rowp, steps, slots, acc, total;
};

__host__ __device__ __forceinline__ long long tree_pad16(long long n) {
    return (n + 15) & ~15LL;
}

__host__ __device__ __forceinline__ TreeSmem tree_smem(int stages, int rows, int items,
                                                       int L, int n_steps) {
    TreeSmem m;
    m.stage_bytes = (rows + 1LL) * TREE_CHUNK_BYTES;
    m.rowp = stages * m.stage_bytes;
    m.steps = m.rowp + tree_pad16(8LL * rows);
    m.slots = m.steps + tree_pad16(4LL * n_steps);
    m.acc = m.slots + 4LL * L * items;
    m.total = m.acc + 32LL * items;  // 32 lanes x 8 bytes per group of 8
    return m;
}

template <int F>
__device__ __forceinline__ void tree_fold8(uint4 (&dst)[TREE_GROUP], const uint4 (&a)[TREE_GROUP],
                                           const uint4 (&b)[TREE_GROUP]) {
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) dst[j] = tree_fold(-(F + 1), a[j], b[j]);
}

// dst[j] = fold(a[j], b[j]) for the group's items; f is warp-uniform.
__device__ __forceinline__ void tree_fold8(int f, uint4 (&dst)[TREE_GROUP],
                                           const uint4 (&a)[TREE_GROUP],
                                           const uint4 (&b)[TREE_GROUP]) {
    switch (f) {
        case 0: tree_fold8<0>(dst, a, b); break;
        case 1: tree_fold8<1>(dst, a, b); break;
        case 2: tree_fold8<2>(dst, a, b); break;
        case 3: tree_fold8<3>(dst, a, b); break;
        default: tree_fold8<4>(dst, a, b); break;
    }
}

template <int F>
__device__ __forceinline__ void tree_fold1(uint4 (&top)[TREE_GROUP], uint4 v) {
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) top[j] = tree_fold(-(F + 1), top[j], v);
}

// top[j] = fold(top[j], v): a leaf every item of the group shares.
__device__ __forceinline__ void tree_fold1(int f, uint4 (&top)[TREE_GROUP], uint4 v) {
    switch (f) {
        case 0: tree_fold1<0>(top, v); break;
        case 1: tree_fold1<1>(top, v); break;
        case 2: tree_fold1<2>(top, v); break;
        case 3: tree_fold1<3>(top, v); break;
        default: tree_fold1<4>(top, v); break;
    }
}

// Add the popcounts of the group's 8 items into its accumulator (this
// lane's two int32).
__device__ __forceinline__ void tree_popc8(const uint4 (&top)[TREE_GROUP], int2* acc,
                                           const uint32_t (&sel)[TREE_GROUP]) {
    // item j's 128 words are the A operand; B's column j is all ones, so
    // column j of the accumulator holds item j's popcounts by A row (two
    // accumulators, even and odd items, halve the chain of dependent MMAs)
    int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) {
        const uint32_t a[4] = {top[j].x, top[j].y, top[j].z, top[j].w};
        const uint32_t b[2] = {sel[j], sel[j]};
        pilosa_bmma(d[j & 1], a, b);
    }
    // accumulator e: row (lane >> 2) + 8 * (e >> 1), column 2 * (lane & 3) + (e & 1);
    // the rows are summed once, after the last chunk
    int2 sum = *acc;
    sum.x += d[0][0] + d[0][2] + d[1][0] + d[1][2];
    sum.y += d[0][1] + d[0][3] + d[1][1] + d[1][3];
    *acc = sum;
}

// Leaf values of the group's 8 items (this lane's 16 bytes of each row)
// into v: one load when the wrapper marked the slots uniform, else one per
// item (an absent slot names the stage's zero row).
__device__ __forceinline__ void tree_leaf8(uint4 (&v)[TREE_GROUP], const int* s8,
                                           const unsigned char* stage) {
    const int4 lo = *reinterpret_cast<const int4*>(s8);
    if (lo.x & TREE_UNIFORM) {
        const uint4 one = *reinterpret_cast<const uint4*>(
            stage + (lo.x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES);
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j) v[j] = one;
    } else {
        const int4 hi = *reinterpret_cast<const int4*>(s8 + 4);
        const int u[TREE_GROUP] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j)
            v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
    }
}

// Fold a leaf into the top in place: top[j] = fold(top[j], leaf of item j),
// the leaf loaded once when the group's slots are uniform.
__device__ __forceinline__ void tree_leaf_fold8(int f, uint4 (&top)[TREE_GROUP], const int* s8,
                                                const unsigned char* stage) {
    const int4 lo = *reinterpret_cast<const int4*>(s8);
    if (lo.x & TREE_UNIFORM) {
        tree_fold1(f, top, *reinterpret_cast<const uint4*>(
                               stage + (lo.x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES));
    } else {
        const int4 hi = *reinterpret_cast<const int4*>(s8 + 4);
        const int u[TREE_GROUP] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint4 v[TREE_GROUP];
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j)
            v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
        tree_fold8(f, top, top, v);
    }
}

// Evaluate the program for one group of 8 items on one staged chunk and add
// their popcounts into the group's accumulator. The first step, a push,
// loads the top; a program that needs one entry then only folds leaves into
// it in place. Every branch is warp-uniform.
template <int MAXN>
__device__ __forceinline__ void tree_group(const int* s_steps, int n_steps, const int* slots,
                                           int n_items, const unsigned char* stage, int2* acc,
                                           const uint32_t (&sel)[TREE_GROUP]) {
    uint4 top[TREE_GROUP];
    uint4 below[MAXN > 1 ? TREE_GROUP : 1];
    tree_leaf8(top, slots + (s_steps[0] >> 5) * n_items, stage);
    int st = n_steps > 1 ? s_steps[1] : 0;
    for (int k = 1; k < n_steps; ++k) {
        const int next = k + 1 < n_steps ? s_steps[k + 1] : 0;
        const int kind = st & 3;
        const int f = (st >> 2) & 7;
        const int* s8 = slots + (st >> 5) * n_items;
        if (kind == TREE_LEAF_FOLD) {
            tree_leaf_fold8(f, top, s8, stage);
        } else if constexpr (MAXN > 1) {
            if (kind == TREE_PUSH) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) below[j] = top[j];
                tree_leaf8(top, s8, stage);
            } else {
                tree_fold8(f, top, below, top);
            }
        }
        st = next;
    }
    tree_popc8(top, acc, sel);
}

// Wait for all but the newest stages - 2 copy groups: the chunk to
// evaluate has landed.
__device__ __forceinline__ void tree_cp_wait(int stages) {
    if (stages <= 2) pilosa_cp_wait<0>();
    else if (stages == 3) pilosa_cp_wait<1>();
    else pilosa_cp_wait<2>();
}

// Steps of a flat chain (a push, then leaf folds of one fold F: AND, OR,
// XOR or ANDNOT) that the flat instances take, unrolled.
#define TREE_FLAT_STEPS 4

// The group's evaluation for a flat chain of fold F: the slots of every step
// are loaded first; while every leaf so far is one row for the whole group
// the chain is one register, and it widens to the 8 items at the first leaf
// that differs between them (the wrapper puts the leaves with the fewest
// distinct rows first where F allows it).
template <int F>
__device__ __forceinline__ void tree_group_flat(const int (&leaf_off)[TREE_FLAT_STEPS],
                                                int n_steps, const int* slots,
                                                const unsigned char* stage, int2* acc,
                                                const uint32_t (&sel)[TREE_GROUP]) {
    int4 lo[TREE_FLAT_STEPS], hi[TREE_FLAT_STEPS];
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k) {
        if (k < n_steps) {
            lo[k] = *reinterpret_cast<const int4*>(slots + leaf_off[k]);
            hi[k] = *reinterpret_cast<const int4*>(slots + leaf_off[k] + 4);
        }
    }
    uint4 top[TREE_GROUP];
    uint4 one = make_uint4(0u, 0u, 0u, 0u);
    bool wide = false;
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k) {
        if (k >= n_steps) break;
        if (lo[k].x & TREE_UNIFORM) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                stage + (lo[k].x & (TREE_UNIFORM - 1)) * TREE_CHUNK_BYTES);
            if (k == 0) one = v;
            else if (!wide) one = tree_fold(-(F + 1), one, v);
            else tree_fold1<F>(top, v);
        } else {
            const int u[TREE_GROUP] = {lo[k].x, lo[k].y, lo[k].z, lo[k].w,
                                       hi[k].x, hi[k].y, hi[k].z, hi[k].w};
            uint4 v[TREE_GROUP];
#pragma unroll
            for (int j = 0; j < TREE_GROUP; ++j)
                v[j] = *reinterpret_cast<const uint4*>(stage + u[j] * TREE_CHUNK_BYTES);
            if (k == 0) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) top[j] = v[j];
            } else if (!wide) {
#pragma unroll
                for (int j = 0; j < TREE_GROUP; ++j) top[j] = tree_fold(-(F + 1), one, v[j]);
            } else {
                tree_fold8<F>(top, top, v);
            }
            wide = true;
        }
    }
    if (!wide) {
#pragma unroll
        for (int j = 0; j < TREE_GROUP; ++j) top[j] = one;
    }
    tree_popc8(top, acc, sel);
}

// The staged table the wrapper uploads in one copy:
//   int64 rowptr[n_rows]      each tile row's words at shard 0
//   int64 rowstride[n_rows]   its words per shard
//   int32 head[tiles][4]      row offset, rows, item offset, items (a
//                             multiple of TREE_GROUP) of each tile
//   int32 steps[n_steps]
//   int32 slots[n_items * L]  tile t at item offset * L: [L][items], row
//                             indices in the tile (its row count: absent),
//                             TREE_UNIFORM on a group that shares one row
//   int32 ids[n_items]        each item's row of out (< 0: padding)
// blockIdx.x = tile * wsplit + slice (slice chunks each), blockIdx.y = shard.
template <int MAXN, int FLAT>
__global__ void __launch_bounds__(TREE_STAGED_WARPS * 32, 1)
pilosa_tree_count_staged(const unsigned char* __restrict__ table, int tiles, int n_rows,
                         int n_items, int n_steps, int L, int S, int W, int stages,
                         int rows_max, int items_max, int wsplit, int slice,
                         int32_t* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char tree_smem_buf[];
    const TreeSmem m = tree_smem(stages, rows_max, items_max, L, n_steps);
    const int t = blockIdx.x / wsplit;
    const int s = blockIdx.y;
    const int chunks = (W + TREE_CHUNK_WORDS - 1) / TREE_CHUNK_WORDS;
    const int c0 = (blockIdx.x - t * wsplit) * slice;
    const int c1 = min(chunks, c0 + slice);
    if (c0 >= c1) return;

    const long long* rowptr = reinterpret_cast<const long long*>(table);
    const long long* rowstride = rowptr + n_rows;
    const int* ints = reinterpret_cast<const int*>(rowstride + n_rows);
    const int* head = ints + 4 * t;
    const int* steps = ints + 4 * tiles;
    const int* slots = steps + n_steps;
    const int* ids = slots + (size_t)n_items * L;
    const int row_off = head[0], rows = head[1], item_off = head[2], items = head[3];

    const uint32_t stage_bytes = (uint32_t)m.stage_bytes;
    const uint32_t** rowp = reinterpret_cast<const uint32_t**>(tree_smem_buf + m.rowp);
    int* s_steps = reinterpret_cast<int*>(tree_smem_buf + m.steps);
    int* s_slots = reinterpret_cast<int*>(tree_smem_buf + m.slots);
    int2* acc = reinterpret_cast<int2*>(tree_smem_buf + m.acc);
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
        rowp[r] = reinterpret_cast<const uint32_t*>(rowptr[row_off + r]) +
                  (size_t)s * rowstride[row_off + r];
    for (int k = threadIdx.x; k < n_steps; k += blockDim.x) s_steps[k] = steps[k];
    for (int i = threadIdx.x; i < L * items; i += blockDim.x)
        s_slots[i] = slots[(size_t)item_off * L + i];
    for (int i = threadIdx.x; i < items * 4; i += blockDim.x)
        acc[i] = make_int2(0, 0);
    // each stage's zero row (row `rows`): no copy writes it
    for (int i = threadIdx.x; i < stages * (TREE_CHUNK_BYTES / 16); i += blockDim.x)
        *reinterpret_cast<uint4*>(tree_smem_buf + (i / (TREE_CHUNK_BYTES / 16)) * stage_bytes +
                                  rows * TREE_CHUNK_BYTES + (i % (TREE_CHUNK_BYTES / 16)) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    const uint32_t smem0 = pilosa_smem_addr(tree_smem_buf);
    const int words = W;  // (plain locals: the lambda then copies no parameter)
    // chunk c of every tile row into stage st; words past W are zero-filled,
    // and every fold maps zeros to zero
    auto load = [&](int st, int c) {
        const uint32_t base = smem0 + st * stage_bytes;
        const int w0 = c * TREE_CHUNK_WORDS;
        for (int q = threadIdx.x; q < rows * (TREE_CHUNK_BYTES / 16); q += TREE_STAGED_WARPS * 32) {
            const int r = q / (TREE_CHUNK_BYTES / 16);
            const int piece = q % (TREE_CHUNK_BYTES / 16);
            const int w = w0 + piece * 4;
            const bool ok = w < words;
            pilosa_cp16(base + r * TREE_CHUNK_BYTES + piece * 16, rowp[r] + (ok ? w : 0),
                        ok ? 16 : 0);
        }
    };

    const int nk = c1 - c0;
    for (int st = 0; st < stages - 1; ++st) {
        if (st < nk) load(st, c0 + st);
        pilosa_cp_commit();
    }
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int groups = items / TREE_GROUP;
    // B operand of item j: all ones in column j (lanes 4j .. 4j + 3)
    uint32_t sel[TREE_GROUP];
#pragma unroll
    for (int j = 0; j < TREE_GROUP; ++j) sel[j] = (lane >> 2) == j ? 0xffffffffu : 0u;
    // a flat chain's slot columns, in step order
    int leaf_off[TREE_FLAT_STEPS];
#pragma unroll
    for (int k = 0; k < TREE_FLAT_STEPS; ++k)
        leaf_off[k] = k < n_steps && FLAT >= 0 ? (s_steps[k] >> 5) * items : 0;
    for (int i = 0; i < nk; ++i) {
        tree_cp_wait(stages);
        __syncthreads();
        // refill the stage every warp finished with in the last iteration
        if (i + stages - 1 < nk) load((i + stages - 1) % stages, c0 + i + stages - 1);
        pilosa_cp_commit();
        const unsigned char* stage = tree_smem_buf + (i % stages) * stage_bytes + lane * 16;
        for (int g = warp; g < groups; g += TREE_STAGED_WARPS) {
            if constexpr (FLAT >= 0)
                tree_group_flat<FLAT>(leaf_off, n_steps, s_slots + g * TREE_GROUP, stage,
                                      acc + g * 32 + lane, sel);
            else
                tree_group<MAXN>(s_steps, n_steps, s_slots + g * TREE_GROUP, items, stage,
                                 acc + g * 32 + lane, sel);
        }
    }
    pilosa_cp_wait<0>();
    // each group's accumulator: sum its 16 rows (lanes of one column), then
    // add item 2 * lane and 2 * lane + 1 into out
    for (int g = warp; g < groups; g += TREE_STAGED_WARPS) {
        int2 v = acc[g * 32 + lane];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
        }
        if (lane < 4) {
            const int i = item_off + g * TREE_GROUP + 2 * lane;
            if (ids[i] >= 0 && v.x != 0) atomicAdd(out + (size_t)ids[i] * S + s, v.x);
            if (ids[i + 1] >= 0 && v.y != 0) atomicAdd(out + (size_t)ids[i + 1] * S + s, v.y);
        }
    }
}

template <int MAXN, int FLAT>
static int tree_staged_launch(dim3 grid, long long smem, cudaStream_t st,
                              const unsigned char* table, int tiles, int n_rows, int n_items,
                              int n_steps, int L, int S, int W, int stages, int rows_max,
                              int items_max, int wsplit, int slice, int32_t* out, int device) {
    auto kern = pilosa_tree_count_staged<MAXN, FLAT>;
    // set up on each device once
    static bool ready[64];
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[device]) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TREE_SMEM_LIMIT);
        if (err != cudaSuccess) return (int)err;
        ready[device] = true;
    }
    kern<<<grid, TREE_STAGED_WARPS * 32, (size_t)smem, st>>>(table, tiles, n_rows, n_items, n_steps, L, S,
                                                W, stages, rows_max, items_max, wsplit, slice,
                                                out);
    return (int)cudaGetLastError();
}

// out: zeroed int32[B, S]. table: the staged table above, on the device.
// fused_depth: operand-stack entries the steps need (1 or 2). The plan
// (kernels.tree_plan): stages of the ring (2-4), the largest tile's rows
// and items, wsplit slices of each shard's chunks, and flat: the fold of a
// flat chain of at most TREE_FLAT_STEPS steps (0-3: AND, OR, XOR, ANDNOT;
// one entry), or -1. Every row must
// be 16-byte aligned at every shard with W a multiple of 4. A plan it
// cannot run returns cudaErrorInvalidValue and launches nothing.
extern "C" int pilosa_tree_count_staged(const void* table, int tiles, int n_rows, int n_items,
                                        int n_steps, int L, int fused_depth, int S, int W,
                                        int stages, int rows_max, int items_max, int wsplit,
                                        int flat, void* out, int device,
                                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long smem = tree_smem(stages, rows_max, items_max, L, n_steps).total;
    const bool ok = tiles > 0 && n_steps > 0 && L >= 1 && L <= TREE_STAGED_MAX_LEAVES &&
                    (fused_depth == 1 || fused_depth == 2) && stages >= 2 && stages <= 4 &&
                    rows_max >= 0 && items_max > 0 && items_max % TREE_GROUP == 0 &&
                    S > 0 && S <= 65535 && W > 0 && W < (1 << 26) && (W & 3) == 0 &&
                    wsplit >= 1 && (long long)tiles * wsplit <= 0x7fffffffLL &&
                    smem <= TREE_SMEM_LIMIT &&
                    flat >= -1 && flat <= 3 &&
                    (flat < 0 || (fused_depth == 1 && n_steps <= TREE_FLAT_STEPS));
    if (!ok) return (int)cudaErrorInvalidValue;
    const int chunks = (W + TREE_CHUNK_WORDS - 1) / TREE_CHUNK_WORDS;
    const int slice = (chunks + wsplit - 1) / wsplit;
    const dim3 grid((unsigned)(tiles * wsplit), (unsigned)S);
    const unsigned char* t = (const unsigned char*)table;
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* o = (int32_t*)out;
#define TREE_STAGED(MAXN, FLAT)                                                             \
    tree_staged_launch<MAXN, FLAT>(grid, smem, st, t, tiles, n_rows, n_items, n_steps,        \
                                          L, S, W, stages, rows_max, items_max, wsplit, slice, \
                                          o, device)
    switch (flat) {
        case 0: return TREE_STAGED(1, 0);
        case 1: return TREE_STAGED(1, 1);
        case 2: return TREE_STAGED(1, 2);
        case 3: return TREE_STAGED(1, 3);
        default: break;
    }
    return fused_depth == 1 ? TREE_STAGED(1, -1) : TREE_STAGED(2, -1);
#undef TREE_STAGED
}
